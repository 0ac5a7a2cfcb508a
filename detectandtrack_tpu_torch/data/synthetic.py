"""Synthetic PoseTrack-style dataset generator (port of
detectandtrack_tpu/data/synthetic.py).

A generated stand-in for PoseTrack: videos of moving "people" (rectangles
with a deterministic 15-joint skeleton), written as JPEG frames (cv2) and a
PoseTrack-schema COCO JSON with track ids and head boxes.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Tuple

import numpy as np

from ..ops.keypoints import POSETRACK_KEYPOINTS


def _skeleton(box: np.ndarray) -> np.ndarray:
    """Deterministic 15-joint pose inside a person box (x1, y1, x2, y2)."""
    x1, y1, x2, y2 = box
    w, h = x2 - x1, y2 - y1
    # (fx, fy) fractions per joint, roughly humanoid.
    f = {
        "head_top": (0.5, 0.05), "nose": (0.5, 0.12),
        "head_bottom": (0.5, 0.2),
        "right_shoulder": (0.3, 0.3), "left_shoulder": (0.7, 0.3),
        "right_elbow": (0.2, 0.45), "left_elbow": (0.8, 0.45),
        "right_wrist": (0.15, 0.6), "left_wrist": (0.85, 0.6),
        "right_hip": (0.35, 0.55), "left_hip": (0.65, 0.55),
        "right_knee": (0.35, 0.75), "left_knee": (0.65, 0.75),
        "right_ankle": (0.35, 0.95), "left_ankle": (0.65, 0.95),
    }
    kps = np.zeros((15, 3), np.float32)
    for i, name in enumerate(POSETRACK_KEYPOINTS):
        fx, fy = f[name]
        kps[i] = (x1 + fx * w, y1 + fy * h, 2.0)
    return kps


def _draw_rect(frame, xy, size, color):
    """frame[int(y):int(y)+int(h), int(x):int(x)+int(w)] = color, clipped
    to the frame (so truncated people draw their inside part only)."""
    h, w = frame.shape[:2]
    x1i, y1i = int(xy[0]), int(xy[1])
    x1 = max(x1i, 0)
    y1 = max(y1i, 0)
    x2 = min(x1i + int(size[0]), w)
    y2 = min(y1i + int(size[1]), h)
    if x2 > x1 and y2 > y1:
        frame[y1:y2, x1:x2] = color


def _draw_person(frame, xy, size, color):
    """Body rectangle + bright head blob (top fifth, middle half-width) —
    the visual signature the detector learns; identical to the original
    inline drawing for fully-inside people, clip-safe for truncated ones."""
    x, y = xy
    pw, ph = size
    _draw_rect(frame, (x, y), (pw, ph), color)
    xi, yi = int(x), int(y)
    hx1 = max(xi + int(pw / 4), 0)
    hx2 = min(xi + int(3 * pw / 4), frame.shape[1])
    hy1 = max(yi, 0)
    hy2 = min(yi + int(ph / 5), frame.shape[0])
    if hx2 > hx1 and hy2 > hy1:
        frame[hy1:hy2, hx1:hx2] = 255


def generate_synthetic_posetrack(
    out_dir: str,
    num_videos: int = 2,
    frames_per_video: int = 8,
    image_hw: Tuple[int, int] = (256, 320),
    people_per_video: int = 2,
    seed: int = 0,
    write_images: bool = True,
    hard: bool = False,
    json_name: str = "train.json",
    video_prefix: str = "video",
) -> str:
    """Create `<out_dir>/{<json_name>, <video>/<frame>.jpg}`; returns the
    JSON path. Schema matches `PosetrackDataset` expectations.

    `hard=True` is the de-saturated regression benchmark:
    the easy variant scores 99+ mAP/MOTA after minutes of training, so a
    2-point parity regression is invisible there. Hard scenes add, per
    video: 4-8 people with crossing trajectories (real occlusion, drawn in
    depth order), a 4x sqrt-area scale spread (28-130 px), truncation
    (people partially outside the frame; boxes clipped, outside joints
    marked not-visible), 1-3 unannotated person-LIKE distractors (head
    blob and all — score calibration pressure), per-(person, frame)
    annotation dropout (evaluation noise, like real data), and a textured
    noisy background. A trained-150-step model should land mid-range
    (~50-80 mAP), where a ~1-point regression moves the needle
    (tests/test_golden_hard.py pins it).
    """
    rng = np.random.default_rng(seed)
    h, w = image_hw
    os.makedirs(out_dir, exist_ok=True)

    images, annotations = [], []
    img_id, ann_id = 0, 0
    for v in range(num_videos):
        vid = f"{video_prefix}_{v:04d}"
        vdir = os.path.join(out_dir, vid)
        if write_images:
            os.makedirs(vdir, exist_ok=True)
        n_people = (int(rng.integers(4, 9)) if hard else people_per_video)
        # Person trajectories: start box + velocity.
        if hard:
            # 4x sqrt-area spread, tall person-ish aspect; resolution-
            # relative so the hard set keeps its character at the small
            # image sizes the CI golden test uses.
            rel = min(h, w) / 256.0
            sa = rng.uniform(28, 130, n_people) * rel
            ar = rng.uniform(0.45, 0.85, n_people)
            sizes = np.stack([sa * np.sqrt(ar), sa / np.sqrt(ar)], axis=1)
            # Crossing trajectories: everyone heads toward a shared
            # crossing region near mid-sequence -> guaranteed overlap.
            cross = np.array([w, h]) * rng.uniform(0.35, 0.65, 2)
            t_mid = max(frames_per_video - 1, 1) / 2.0
            # Starts may sit partially outside the frame (truncation).
            pos = rng.uniform([-0.15 * w, -0.15 * h],
                              [0.95 * w, 0.95 * h], (n_people, 2))
            vel = (cross - pos - sizes / 2) / t_mid \
                + rng.normal(scale=2.0, size=(n_people, 2))
        else:
            sizes = rng.uniform(60, 110, (n_people, 2))
            pos = rng.uniform(0.05, 0.55, (n_people, 2)) * [w, h]
            vel = rng.uniform(-6, 6, (n_people, 2))
        colors = rng.integers(80, 255, (n_people, 3))
        # Depth order: later indices drawn later = nearer = occluders.
        if hard:
            n_dis = int(rng.integers(1, 4))
            dis_sa = rng.uniform(30, 110, n_dis) * rel
            dis_ar = rng.uniform(0.45, 0.85, n_dis)
            dis_sizes = np.stack(
                [dis_sa * np.sqrt(dis_ar), dis_sa / np.sqrt(dis_ar)], axis=1)
            dis_pos = rng.uniform([0, 0], [0.9 * w, 0.9 * h], (n_dis, 2))
            dis_vel = rng.uniform(-5, 5, (n_dis, 2))
            dis_colors = rng.integers(80, 255, (n_dis, 3))
            drop = rng.random((n_people, frames_per_video)) < 0.08
            # Static background clutter rectangles (not person-like: no
            # head blob, wide aspect).
            n_bg = 6
            bg_pos = rng.uniform([0, 0], [0.9 * w, 0.9 * h], (n_bg, 2))
            bg_sizes = rng.uniform(20, 60, (n_bg, 2)) * [1.6 * rel, 0.7 * rel]
            bg_colors = rng.integers(40, 140, (n_bg, 3))

        for t in range(frames_per_video):
            fname = os.path.join(vid, f"{t:06d}.jpg")
            if hard:
                frame = rng.integers(
                    16, 72, (h, w, 3)).astype(np.uint8)
            else:
                frame = np.full((h, w, 3), 32, np.uint8)
            img_id += 1
            images.append({
                "id": img_id, "file_name": fname, "vid_id": vid,
                "frame_id": t, "width": w, "height": h,
            })
            if hard and write_images:
                for d in range(n_bg):
                    _draw_rect(frame, bg_pos[d], bg_sizes[d], bg_colors[d])
                for d in range(n_dis):
                    _draw_person(frame, dis_pos[d] + dis_vel[d] * t,
                                 dis_sizes[d], dis_colors[d])
            frame_boxes = []                 # (box, p) in draw order
            for p in range(n_people):
                x, y = pos[p] + vel[p] * t
                pw, ph = sizes[p]
                if hard:
                    # Truncation allowed: clip the VISIBLE box to the
                    # frame; drop people fully (or nearly) outside.
                    vx1 = float(np.clip(x, 0, w - 1))
                    vy1 = float(np.clip(y, 0, h - 1))
                    vx2 = float(np.clip(x + pw, 0, w - 1))
                    vy2 = float(np.clip(y + ph, 0, h - 1))
                    if (vx2 - vx1) < 12 * rel or (vy2 - vy1) < 12 * rel:
                        continue
                    box = np.array([x, y, x + pw, y + ph], np.float32)
                else:
                    x = float(np.clip(x, 0, w - pw - 1))
                    y = float(np.clip(y, 0, h - ph - 1))
                    box = np.array([x, y, x + pw, y + ph], np.float32)
                if write_images:
                    _draw_person(frame, (box[0], box[1]), (pw, ph),
                                 colors[p])
                frame_boxes.append((box, p))
            for order, (box, p) in enumerate(frame_boxes):
                x, y = float(box[0]), float(box[1])
                pw = float(box[2] - box[0])
                ph = float(box[3] - box[1])
                if hard and drop[p, t]:
                    continue                 # annotation dropout
                kps = _skeleton(box)
                if hard:
                    # Joints outside the frame or covered by a
                    # later-drawn (nearer) person: labeled, not visible.
                    for j in range(kps.shape[0]):
                        jx, jy = kps[j, 0], kps[j, 1]
                        if not (0 <= jx < w and 0 <= jy < h):
                            kps[j, 2] = 1.0
                            continue
                        for obox, _ in frame_boxes[order + 1:]:
                            if (obox[0] <= jx <= obox[2]
                                    and obox[1] <= jy <= obox[3]):
                                kps[j, 2] = 1.0
                                break
                    # The annotated bbox is the visible (clipped) extent,
                    # PoseTrack-style.
                    x = float(np.clip(x, 0, w - 1))
                    y = float(np.clip(y, 0, h - 1))
                    pw = float(np.clip(box[2], 0, w - 1) - x)
                    ph = float(np.clip(box[3], 0, h - 1) - y)
                # Ellipse segmentation inscribed in the box (12-gon) so
                # mask-head training has real (non-rectangle) targets.
                th = np.linspace(0, 2 * np.pi, 12, endpoint=False)
                poly = np.stack([
                    x + pw / 2 + (pw / 2) * np.cos(th),
                    y + ph / 2 + (ph / 2) * np.sin(th)], axis=1)
                ann_id += 1
                annotations.append({
                    "id": ann_id, "image_id": img_id, "category_id": 1,
                    "bbox": [x, y, float(pw), float(ph)],
                    "keypoints": kps.reshape(-1).tolist(),
                    "track_id": p,
                    "head_box": [x + pw / 4, y, x + 3 * pw / 4, y + ph / 5],
                    "area": float(pw * ph),
                    "iscrowd": 0,
                    "num_keypoints": 15,
                    "segmentation": [poly.reshape(-1).tolist()],
                })
            if write_images:
                import cv2
                cv2.imwrite(os.path.join(out_dir, fname), frame)

    doc = {
        "images": images,
        "annotations": annotations,
        "categories": [{
            "id": 1, "name": "person",
            "keypoints": POSETRACK_KEYPOINTS,
        }],
    }
    json_path = os.path.join(out_dir, json_name)
    with open(json_path, "w") as f:
        json.dump(doc, f)
    return json_path
