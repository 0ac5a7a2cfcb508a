"""Tracking engine: link per-frame detections into tracks, write results,
evaluate (port of detectandtrack_tpu/tracking/engine.py).

Reference parity: `lib/core/tracking_engine.py`: load
detections grouped by video, link frame pairs, assign/propagate track IDs,
write PoseTrack-format results, evaluate MOTA + mAP. Host-only; consumes the
detector's padded (boxes, scores, keypoints, valid) tensors.

Detections input format (per video): a list of frames, each a dict with
  boxes (D, 4) · scores (D,) · keypoints (D, K, >=2) · valid (D,)
optionally features (D, F). Padded rows are dropped via `valid`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from .evaluation import PoseAnnotation, PosetrackEvaluator
from .tracker import Tracker, TrackerConfig


def run_tracker_on_video(
    frames: Sequence[dict],
    tracker: Optional[Tracker] = None,
    cfg=None,
) -> List[dict]:
    """Assign track ids to each frame's detections.

    Returns a list of per-frame dicts with an added `track_ids (D,)` array
    (−1 for dropped/padded detections).
    """
    if tracker is None:
        tracker = Tracker.from_cfg(cfg) if cfg is not None else Tracker()
    tracker.reset()
    out = []
    for frame in frames:
        kwargs = {}
        if frame.get("keypoints") is not None:
            kwargs["keypoints"] = np.asarray(frame["keypoints"])[..., :2]
        if frame.get("features") is not None:
            kwargs["features"] = np.asarray(frame["features"])
        ids = tracker.update(
            np.asarray(frame["boxes"], np.float64),
            np.asarray(frame["scores"], np.float64),
            valid=frame.get("valid"),
            **kwargs)
        out.append({**frame, "track_ids": ids})
    return out


class StreamingTrackingSink:
    """Online detect→track consumer (the streaming mode).

    Passed as `frame_sink` to `engine.inference.run_inference`: each frame's
    detections are handed over as soon as their batch is consumed from the
    device — while the NEXT batch is still in flight on the chip — and fed
    to a per-video Hungarian tracker incrementally. No `detections.pkl`
    intermediary, no second pass over the dataset (parity with the
    two-stage reference pipeline is asserted in tests/test_torch_stream.py:
    identical track ids frame-for-frame).

    Frames can arrive out of order (multi-scale TTA passes land in
    different shape buckets with independent batch timing), so arrivals
    are buffered per video and consumed strictly in frame order — the
    tracker state update sequence is exactly the offline pass's.
    """

    def __init__(self, cfg=None):
        self.cfg = cfg
        self._trackers: Dict[str, Tracker] = {}
        self._buffers: Dict[str, Dict[int, dict]] = {}
        self._next: Dict[str, int] = {}
        self._total: Dict[str, int] = {}
        self.tracked: Dict[str, List[dict]] = {}
        # Max out-of-order frames ever buffered per video. The pipeline
        # bounds this at O(batch × buckets × T): within one video every
        # window feeds the SAME bucket per scale pass (bucket choice is a
        # function of frame size + scale target), so pass-completion skew
        # comes only from other videos' items sharing the queues — at most
        # one batch per bucket — plus the double-buffered consume.
        # tests/test_torch_stream.py asserts the bound under stress.
        self.buffer_high_water: Dict[str, int] = {}

    def __call__(self, vid: str, ordinal: int, total: int, frame: dict):
        if vid not in self._trackers:
            tr = (Tracker.from_cfg(self.cfg) if self.cfg is not None
                  else Tracker())
            tr.reset()
            self._trackers[vid] = tr
            self._buffers[vid] = {}
            self._next[vid] = 0
            self._total[vid] = total
            self.tracked[vid] = []
            self.buffer_high_water[vid] = 0
        self._buffers[vid][ordinal] = frame
        self.buffer_high_water[vid] = max(self.buffer_high_water[vid],
                                          len(self._buffers[vid]))
        buf, tr, out = self._buffers[vid], self._trackers[vid], \
            self.tracked[vid]
        while self._next[vid] in buf:
            fr = buf.pop(self._next[vid])
            kwargs = {}
            if fr.get("keypoints") is not None:
                kwargs["keypoints"] = np.asarray(fr["keypoints"])[..., :2]
            if fr.get("features") is not None:
                kwargs["features"] = np.asarray(fr["features"])
            ids = tr.update(
                np.asarray(fr["boxes"], np.float64),
                np.asarray(fr["scores"], np.float64),
                valid=fr.get("valid"), **kwargs)
            out.append({**fr, "track_ids": ids})
            self._next[vid] += 1
            if self._next[vid] == self._total[vid]:
                # Video complete — free the tracker and buffer.
                del self._trackers[vid], self._buffers[vid]
                break

    def results(self) -> Dict[str, List[dict]]:
        incomplete = [v for v, n in self._next.items()
                      if n != self._total[v]]
        if incomplete:
            raise RuntimeError(
                f"streaming sink finished with incomplete videos: "
                f"{incomplete}")
        return self.tracked


def run_posetrack_tracking(
    detections_by_video: Dict[str, Sequence[dict]],
    cfg=None,
) -> Dict[str, List[dict]]:
    """Stage-2 entry point over a whole dataset (parity: tracking_engine.run)."""
    results = {}
    for video, frames in detections_by_video.items():
        results[video] = run_tracker_on_video(frames, cfg=cfg)
    return results


def write_posetrack_results(
    tracked_by_video: Dict[str, List[dict]],
    output_dir: str,
    keypoint_names: Optional[List[str]] = None,
) -> List[str]:
    """Write per-video PoseTrack-format JSON (annolist-style) results."""
    os.makedirs(output_dir, exist_ok=True)
    paths = []
    for video, frames in tracked_by_video.items():
        annolist = []
        for fi, frame in enumerate(frames):
            annorect = []
            ids = frame["track_ids"]
            for di in range(len(ids)):
                if ids[di] < 0:
                    continue
                box = np.asarray(frame["boxes"][di], float)
                kps = np.asarray(frame["keypoints"][di], float)
                points = [
                    {"id": [k], "x": [float(kps[k, 0])],
                     "y": [float(kps[k, 1])],
                     "score": [float(kps[k, 2]) if kps.shape[1] > 2 else 1.0]}
                    for k in range(kps.shape[0])]
                annorect.append({
                    "x1": [float(box[0])], "y1": [float(box[1])],
                    "x2": [float(box[2])], "y2": [float(box[3])],
                    "score": [float(frame["scores"][di])],
                    "track_id": [int(ids[di])],
                    "annopoints": [{"point": points}],
                })
            name = frame.get("image_name", f"frame_{fi:06d}")
            annolist.append({"image": [{"name": name}],
                             "annorect": annorect})
        safe = video.replace("/", "_")
        path = os.path.join(output_dir, f"{safe}.json")
        with open(path, "w") as f:
            json.dump({"annolist": annolist}, f)
        paths.append(path)
    return paths


def read_posetrack_results(
    output_dir: str,
) -> Dict[str, List[dict]]:
    """Inverse of `write_posetrack_results`: annolist JSONs → tracked dict.

    Keys are the file stems (the writer's "/"→"_"-sanitized video ids).
    Accepts any PoseTrack-annolist-format predictions — this is the entry
    point for scoring third-party results with `--mode eval` (the
    reference ecosystem's external `poseval` scorer role).
    """
    out: Dict[str, List[dict]] = {}
    for name in sorted(os.listdir(output_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(output_dir, name)) as f:
            annolist = json.load(f)["annolist"]
        frames = []
        for entry in annolist:
            rects = entry.get("annorect", [])
            boxes, scores, ids, kps = [], [], [], []
            for r in rects:
                boxes.append([r["x1"][0], r["y1"][0], r["x2"][0],
                              r["y2"][0]])
                scores.append(r.get("score", [1.0])[0])
                ids.append(r.get("track_id", [0])[0])
                pts = r["annopoints"][0]["point"]
                arr = np.zeros((len(pts), 3))
                for p in pts:
                    arr[p["id"][0]] = [p["x"][0], p["y"][0],
                                       p.get("score", [1.0])[0]]
                kps.append(arr)
            n = len(boxes)
            frames.append({
                "boxes": np.asarray(boxes, float).reshape(n, 4),
                "scores": np.asarray(scores, float),
                "track_ids": np.asarray(ids, int),
                "keypoints": (np.stack(kps) if kps
                              else np.zeros((0, 0, 3))),
                "valid": np.ones(n, bool),
            })
        out[name[:-5]] = frames
    return out


def evaluate_tracking(
    tracked_by_video: Dict[str, List[dict]],
    gt_by_video: Dict[str, Sequence[Sequence[PoseAnnotation]]],
    num_joints: int = 15,
) -> Dict[str, float]:
    """PoseTrack mAP + MOTA over tracked results vs per-frame GT poses."""
    ev = PosetrackEvaluator(num_joints)
    for video, frames in tracked_by_video.items():
        ev.start_video()
        gt_frames = gt_by_video.get(video, [])
        for fi, frame in enumerate(frames):
            preds = []
            ids = frame["track_ids"]
            for di in range(len(ids)):
                if ids[di] < 0:
                    continue
                preds.append(PoseAnnotation(
                    keypoints=np.asarray(frame["keypoints"][di], float),
                    box=np.asarray(frame["boxes"][di], float),
                    track_id=int(ids[di]),
                    score=float(frame["scores"][di])))
            gts = list(gt_frames[fi]) if fi < len(gt_frames) else []
            ev.add_frame(gts, preds)
    return ev.summarize()
