"""PoseTrack dataset layer — self-contained COCO-JSON parser with video
indexing (port of detectandtrack_tpu/data/posetrack.py).

Reference parity: `lib/datasets/json_dataset.py` + `roidb.py` +
`dataset_catalog.py`: plain json instead of pycocotools, organized
video-first, since every consumer samples T-frame windows.

Expected JSON schema (PoseTrack v1-style COCO):
  images: [{id, file_name, (vid_id|video_id), (frame_id|index), width,
            height}]
  annotations: [{image_id, bbox [x, y, w, h], keypoints (3K flat),
                 track_id, (head_box), category_id, (score)}]
  categories: [{id, name, keypoints: [...]}]
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class FrameRecord:
    image_id: int
    file_name: str
    video_id: str
    frame_index: int
    width: int
    height: int
    annotations: List[dict] = field(default_factory=list)


class PosetrackDataset:
    """Video-indexed view over a PoseTrack/COCO keypoint JSON."""

    def __init__(self, json_path: str, image_root: str = ""):
        self.json_path = json_path
        self.image_root = image_root
        with open(json_path) as f:
            doc = json.load(f)
        self.categories = doc.get("categories", [])
        kp_names = None
        for cat in self.categories:
            if cat.get("keypoints"):
                kp_names = cat["keypoints"]
        self.keypoint_names = kp_names or []
        self.num_keypoints = len(self.keypoint_names) or 15

        self.frames: Dict[int, FrameRecord] = {}
        for im in doc.get("images", []):
            vid = str(im.get("vid_id", im.get("video_id",
                                              os.path.dirname(
                                                  im.get("file_name", "")))))
            self.frames[im["id"]] = FrameRecord(
                image_id=im["id"],
                file_name=im.get("file_name", ""),
                video_id=vid,
                frame_index=int(im.get("frame_id", im.get("index",
                                                          im["id"]))),
                width=int(im.get("width", 0)),
                height=int(im.get("height", 0)),
            )
        for ann in doc.get("annotations", []):
            fr = self.frames.get(ann.get("image_id"))
            if fr is not None:
                fr.annotations.append(ann)

        self._videos: Dict[str, List[FrameRecord]] = {}
        for fr in self.frames.values():
            self._videos.setdefault(fr.video_id, []).append(fr)
        for v in self._videos.values():
            v.sort(key=lambda fr: fr.frame_index)

    # -- video-level access ------------------------------------------------

    def videos(self) -> List[str]:
        return sorted(self._videos)

    def video_frames(self, video_id: str) -> List[FrameRecord]:
        return self._videos[video_id]

    def image_path(self, fr: FrameRecord) -> str:
        return os.path.join(self.image_root, fr.file_name)

    # -- GT extraction -----------------------------------------------------

    def gt_poses(self, fr: FrameRecord) -> List[dict]:
        """Per-person GT: box (4,), keypoints (K, 3), track_id, head_box."""
        out = []
        for ann in fr.annotations:
            if ann.get("iscrowd"):
                continue
            x, y, w, h = ann.get("bbox", (0, 0, 0, 0))
            box = np.array([x, y, x + w - 1, y + h - 1], np.float32)
            kps = np.asarray(ann.get("keypoints", []), np.float32)
            kps = (kps.reshape(-1, 3) if kps.size else
                   np.zeros((self.num_keypoints, 3), np.float32))
            head = ann.get("head_box") or ann.get("bbox_head")
            out.append({
                "box": box,
                "keypoints": kps,
                "track_id": int(ann.get("track_id", -1)),
                "head_box": (np.asarray(head, np.float32)
                             if head is not None else None),
                "segmentation": ann.get("segmentation"),
            })
        return out

    def clip_windows(self, num_frames: int, stride: int = 1,
                     dense: bool = True) -> List[Tuple[str, int]]:
        """All (video_id, start_index) T-frame windows (clip sampler).

        dense=True slides by 1 frame (training); dense=False tiles the video
        with non-overlapping windows (inference covers each frame once).
        """
        windows = []
        span = (num_frames - 1) * stride + 1
        for vid in self.videos():
            n = len(self._videos[vid])
            if n < span:
                continue
            step = 1 if dense else span
            for s in range(0, n - span + 1, step):
                windows.append((vid, s))
        return windows

    def clip_records(self, video_id: str, start: int, num_frames: int,
                     stride: int = 1) -> List[FrameRecord]:
        """T records starting at `start`; indices past the end clamp to the
        last frame (lets windows cover videos shorter than the clip span)."""
        frames = self._videos[video_id]
        last = len(frames) - 1
        return [frames[min(start + i * stride, last)]
                for i in range(num_frames)]


# Dataset catalog (parity: lib/datasets/dataset_catalog.py): names → paths,
# resolved against cfg.DATA.ROOT.
_CATALOG = {
    "posetrack_v1_train": ("annotations/train.json", "images"),
    "posetrack_v1_val": ("annotations/val.json", "images"),
    "posetrack_synthetic_train": ("synthetic/train.json", "synthetic"),
    "posetrack_synthetic_val": ("synthetic/val.json", "synthetic"),
    # De-saturated regression benchmark: crowded /
    # occluded / truncated / distractor-laden scenes that score mid-range,
    # so ~1-point regressions are visible (data/synthetic.py hard=True).
    "posetrack_synthetic_hard_train": ("synthetic_hard/train.json",
                                       "synthetic_hard"),
    "posetrack_synthetic_hard_val": ("synthetic_hard/val.json",
                                     "synthetic_hard"),
}


def get_dataset(name: str, data_root: str) -> PosetrackDataset:
    if name not in _CATALOG:
        raise KeyError(f"Unknown dataset {name!r}; catalog has "
                       f"{sorted(_CATALOG)}")
    ann, images = _CATALOG[name]
    return PosetrackDataset(os.path.join(data_root, ann),
                            os.path.join(data_root, images))
