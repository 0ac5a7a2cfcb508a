"""Host input pipeline: clip loading → fixed-shape padded batches, and
their prefetch onto the model's device (port of
detectandtrack_tpu/data/pipeline.py; `DeviceLoader` is a torch prefetcher).

Reference parity: `lib/roi_data/minibatch.py` (cv2 read, scale to
SCALES/MAX_SIZE, mean-subtract) and `lib/utils/blob.py`:

- Fixed shapes: every clip is resized-with-aspect then padded into a shape
  bucket (multiples of FPN.COARSEST_STRIDE).
- Layout is (T, H, W, 3) channels-last, the model's clip layout.
- GT is padded to MAX_GT tubes with validity masks.
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..parallel.mesh import Mesh, shard_rows
from .posetrack import FrameRecord, PosetrackDataset


@dataclass
class ClipSpec:
    video_id: str
    start: int
    flipped: bool = False
    # Per-clip sampled TRAIN.SCALES entry (multi-scale train jitter —
    # parity: roi_data/minibatch samples a random scale per minibatch).
    # None → use the caller's default target scale.
    scale_target: Optional[int] = None


def choose_scale(h: int, w: int, target: int, max_size: int) -> float:
    """Reference `prep_im_for_blob` scale rule: short side → target, capped
    so the long side stays <= max_size."""
    short, long = min(h, w), max(h, w)
    scale = target / max(short, 1)
    if round(scale * long) > max_size:
        scale = max_size / max(long, 1)
    return scale


def pick_bucket(h: int, w: int,
                buckets: Sequence[Tuple[int, int]]) -> Tuple[int, int]:
    """Smallest bucket that fits (h, w); largest bucket if none fit."""
    best = None
    for bh, bw in sorted(buckets, key=lambda b: b[0] * b[1]):
        if bh >= h and bw >= w:
            best = (bh, bw)
            break
    return best if best is not None else tuple(
        max(buckets, key=lambda b: b[0] * b[1]))


def load_clip(
    ds: PosetrackDataset,
    spec: ClipSpec,
    num_frames: int,
    frame_stride: int,
    pixel_means: Sequence[float],
    pixel_stds: Sequence[float],
    scale_target: int,
    max_size: int,
    bucket_hw: Optional[Tuple[int, int]] = None,
    buckets: Sequence[Tuple[int, int]] = ((256, 320),),
    max_gt: int = 16,
    num_keypoints: int = 15,
    gt_min_area: float = -1.0,
    mask_size: int = 0,
) -> Dict[str, np.ndarray]:
    """One training/eval example: padded clip + padded GT tubes."""
    import cv2

    records = ds.clip_records(spec.video_id, spec.start, num_frames,
                              frame_stride)
    imgs = []
    for fr in records:
        img = cv2.imread(ds.image_path(fr))
        if img is None:
            raise FileNotFoundError(ds.image_path(fr))
        imgs.append(img)
    h0, w0 = imgs[0].shape[:2]
    scale = choose_scale(h0, w0, scale_target, max_size)
    if bucket_hw is None:
        sh, sw = int(round(h0 * scale)), int(round(w0 * scale))
        bucket_hw = pick_bucket(sh, sw, buckets)
    bh, bw = bucket_hw
    # Never crop: if the chosen bucket cannot fit the scaled image (e.g. a
    # portrait video against landscape-only buckets) shrink the scale so it
    # fits — cropping would leave GT supervision pointing outside the
    # visible area.
    scale = min(scale, bh / max(h0, 1), bw / max(w0, 1))
    sh, sw = int(round(h0 * scale)), int(round(w0 * scale))
    sh, sw = min(sh, bh), min(sw, bw)

    clip = np.zeros((num_frames, bh, bw, 3), np.float32)
    means = np.asarray(pixel_means, np.float32)
    stds = np.asarray(pixel_stds, np.float32)
    for t, img in enumerate(imgs):
        r = cv2.resize(img, (sw, sh), interpolation=cv2.INTER_LINEAR)
        if spec.flipped:
            r = r[:, ::-1]
        clip[t, :sh, :sw] = (r.astype(np.float32) - means) / stds

    # --- GT tubes: group per-frame annotations by track id ---
    t_dim = num_frames
    gt_boxes = np.zeros((max_gt, 4 * t_dim), np.float32)
    gt_kps = np.zeros((max_gt, t_dim, num_keypoints, 3), np.float32)
    gt_valid = np.zeros((max_gt,), bool)
    gt_masks = (np.zeros((max_gt, t_dim, mask_size, mask_size), np.float32)
                if mask_size else None)
    # Per-(track, frame): an unannotated frame of a masked track must NOT
    # supervise the mask head toward an empty mask (missing != empty).
    gt_mask_valid = (np.zeros((max_gt, t_dim), bool) if mask_size
                     else None)

    def rasterize_mask(segm, box):
        """Polygon(s) in ORIGINAL image coords → M×M bitmap in the (scaled)
        GT-box frame (parity: mask_rcnn's polys_to_mask_wrt_box)."""
        bx1, by1 = box[0], box[1]
        bw = max(box[2] - box[0], 1.0)
        bh = max(box[3] - box[1], 1.0)
        bitmap = np.zeros((mask_size, mask_size), np.uint8)
        for poly in segm:
            pts = np.asarray(poly, np.float64).reshape(-1, 2) * scale
            if spec.flipped:
                pts[:, 0] = sw - 1 - pts[:, 0]
            pts[:, 0] = (pts[:, 0] - bx1) / bw * mask_size
            pts[:, 1] = (pts[:, 1] - by1) / bh * mask_size
            cv2.fillPoly(bitmap, [np.round(pts).astype(np.int32)], 1)
        return bitmap.astype(np.float32)

    track_rows: Dict[int, int] = {}
    present: Dict[int, np.ndarray] = {}
    for t, fr in enumerate(records):
        for pose in ds.gt_poses(fr):
            if gt_min_area > 0:
                bx = pose["box"]
                area = max(bx[2] - bx[0] + 1, 0) * max(bx[3] - bx[1] + 1, 0)
                if area * scale * scale < gt_min_area:
                    continue            # TRAIN.GT_MIN_AREA filter
            tid = pose["track_id"]
            if tid not in track_rows:
                if len(track_rows) >= max_gt:
                    continue
                track_rows[tid] = len(track_rows)
                present[tid] = np.zeros(t_dim, bool)
            row = track_rows[tid]
            box = pose["box"] * scale
            kps = pose["keypoints"].copy()
            kps[:, :2] *= scale
            if spec.flipped:
                box = np.array([sw - 1 - box[2], box[1],
                                sw - 1 - box[0], box[3]], np.float32)
                from ..ops.keypoints import flip_keypoints
                kps = flip_keypoints(kps[None], sw)[0]
            gt_boxes[row, 4 * t:4 * t + 4] = box
            gt_kps[row, t] = kps
            present[tid][t] = True
            if mask_size and pose.get("segmentation"):
                gt_masks[row, t] = rasterize_mask(pose["segmentation"], box)
                gt_mask_valid[row, t] = True

    for tid, row in track_rows.items():
        # A tube is valid if the person appears in every frame (tube GT);
        # fill gaps by nearest-frame propagation otherwise.
        if present[tid].all():
            gt_valid[row] = True
        elif present[tid].any():
            idx = np.flatnonzero(present[tid])
            for t in range(t_dim):
                if not present[tid][t]:
                    src = idx[np.argmin(np.abs(idx - t))]
                    gt_boxes[row, 4 * t:4 * t + 4] = (
                        gt_boxes[row, 4 * src:4 * src + 4])
                    gt_kps[row, t] = gt_kps[row, src]
                    gt_kps[row, t, :, 2] = 0          # invisible fill
                    if mask_size:
                        gt_masks[row, t] = gt_masks[row, src]
            gt_valid[row] = True

    out = {
        "clips": clip,
        "gt_boxes": gt_boxes,
        "gt_keypoints": gt_kps,
        "gt_valid": gt_valid,
        "scale": np.float32(scale),
        "image_hw": np.asarray([h0, w0], np.int32),
    }
    if mask_size:
        out["gt_masks"] = gt_masks
        out["gt_mask_valid"] = gt_mask_valid
    return out


class ClipBatcher:
    """Shuffled epoch iterator over clip windows → stacked batches.

    Parity: RoIDataLoader's permutation + minibatch assembly; flipped
    copies double the epoch when `use_flipped`.
    """

    def __init__(self, ds: PosetrackDataset, cfg, train: bool = True,
                 seed: int = 0):
        self.ds = ds
        self.cfg = cfg
        self.train = train
        t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
        self.num_frames = t
        self.stride = cfg.VIDEO.FRAME_STRIDE if cfg.VIDEO.VIDEO_ON else 1
        self.windows = ds.clip_windows(t, self.stride, dense=train)
        self.rng = np.random.default_rng(seed)
        self.use_flipped = train and cfg.TRAIN.USE_FLIPPED

    def specs(self) -> List[ClipSpec]:
        out = [ClipSpec(v, s) for v, s in self.windows]
        if self.use_flipped:
            out += [ClipSpec(v, s, flipped=True) for v, s in self.windows]
        return out

    def _bucket_for(self, spec: ClipSpec) -> Tuple[int, int]:
        cfg = self.cfg
        fr = self.ds.video_frames(spec.video_id)[spec.start]
        target = spec.scale_target or (
            cfg.TRAIN.SCALES[0] if self.train else cfg.TEST.SCALE)
        max_size = cfg.TRAIN.MAX_SIZE if self.train else cfg.TEST.MAX_SIZE
        scale = choose_scale(fr.height or 1, fr.width or 1, target, max_size)
        sh = int(round((fr.height or 1) * scale))
        sw = int(round((fr.width or 1) * scale))
        return pick_bucket(sh, sw, [tuple(b) for b in
                                    cfg.TEST.SHAPE_BUCKETS])

    def _batch_plan(self, batch_size: int):
        """→ [(bucket_hw, [specs])]: whole batches share one shape bucket
        (TRAIN.ASPECT_GROUPING — the lineage groups portrait/landscape so a
        batch pads to one blob shape; here a batch compiles to one bucket)."""
        cfg = self.cfg
        specs = self.specs()
        if self.train:
            self.rng.shuffle(specs)
            if len(cfg.TRAIN.SCALES) > 1:
                # Multi-scale train jitter: sample a TRAIN.SCALES entry per
                # clip per epoch (seeded rng), as the reference samples a
                # random scale per minibatch (roi_data/minibatch
                # `_get_image_blob`). The bucket is chosen for the sampled
                # scale, so jittered clips still batch whole-bucket.
                import dataclasses as _dc
                scales = list(cfg.TRAIN.SCALES)
                specs = [_dc.replace(
                    s, scale_target=int(scales[self.rng.integers(
                        len(scales))])) for s in specs]
        buckets = [tuple(b) for b in cfg.TEST.SHAPE_BUCKETS]
        batches = []

        def emit(bucket, ss):
            # Whole batches, plus ONE remainder batch padded by resampling
            # from the group (train only) — dropping remainders starved
            # aspect/scale groups smaller than the batch of ALL training
            # (and an all-remainder epoch yielded zero batches, spinning
            # the train loop forever).
            for i in range(0, len(ss) - batch_size + 1, batch_size):
                batches.append((bucket, ss[i:i + batch_size]))
            rem = len(ss) % batch_size
            if rem and self.train:
                tail = list(ss[len(ss) - rem:])
                while len(tail) < batch_size:
                    tail.append(ss[int(self.rng.integers(len(ss)))])
                batches.append((bucket, tail))

        if self.train and cfg.TRAIN.ASPECT_GROUPING and (
                len(buckets) > 1 or len(cfg.TRAIN.SCALES) > 1):
            groups: Dict[Tuple[int, int], List[ClipSpec]] = {}
            for s in specs:
                groups.setdefault(self._bucket_for(s), []).append(s)
            for bucket, ss in groups.items():
                emit(bucket, ss)
            self.rng.shuffle(batches)
        else:
            emit(buckets[0], specs)
        return batches

    def epoch(self, batch_size: int,
              num_workers: Optional[int] = None,
              mesh: Optional[Mesh] = None
              ) -> Iterator[Dict[str, np.ndarray]]:
        """Shuffled epoch of stacked batches; clip decode (cv2) runs on
        DATA.NUM_WORKERS threads (cv2 releases the GIL), replacing the
        reference's RoIDataLoader thread pool.

        With a mesh, `batch_size` is the global batch: every rank draws the
        same plan (the batcher's seed is the same on every rank) and
        decodes only its own rows of each batch (`shard_rows`), as JAX's
        multi-process `shard_batch` takes each process's local rows."""
        from concurrent.futures import ThreadPoolExecutor

        cfg = self.cfg
        target = cfg.TRAIN.SCALES[0] if self.train else cfg.TEST.SCALE
        max_size = cfg.TRAIN.MAX_SIZE if self.train else cfg.TEST.MAX_SIZE
        workers = num_workers if num_workers is not None else (
            cfg.DATA.NUM_WORKERS)
        rows = shard_rows(mesh, batch_size)
        batches = [(bucket, ss[rows])
                   for bucket, ss in self._batch_plan(batch_size)]

        def load_one(args):
            bucket, spec = args
            return load_clip(
                self.ds, spec, self.num_frames, self.stride,
                cfg.DATA.PIXEL_MEANS, cfg.DATA.PIXEL_STDS,
                spec.scale_target or target, max_size, bucket_hw=bucket,
                max_gt=cfg.TRAIN.MAX_GT_PER_IM,
                num_keypoints=cfg.KRCNN.NUM_KEYPOINTS,
                gt_min_area=(cfg.TRAIN.GT_MIN_AREA if self.train else -1.0),
                mask_size=(cfg.MRCNN.RESOLUTION
                           if cfg.MODEL.MASK_ON and self.train else 0))

        if workers <= 1:
            for bucket, ss in batches:
                items = [load_one((bucket, s)) for s in ss]
                yield {k: np.stack([it[k] for it in items])
                       for k in items[0]}
            return

        with ThreadPoolExecutor(max_workers=workers) as ex:
            pending = []                 # sliding window of batch futures
            ahead = max(2, cfg.DATA.PREFETCH)
            batch_iter = iter(batches)

            def submit_next():
                try:
                    bucket, ss = next(batch_iter)
                except StopIteration:
                    return False
                pending.append([ex.submit(load_one, (bucket, s))
                                for s in ss])
                return True

            for _ in range(ahead):
                if not submit_next():
                    break
            while pending:
                futs = pending.pop(0)
                items = [f.result() for f in futs]
                submit_next()
                yield {k: np.stack([it[k] for it in items])
                       for k in items[0]}



class DeviceLoader:
    """Threaded prefetch of host batches onto `device` (the BlobsQueue
    replacement): a worker thread pulls `{name: ndarray}` batches from
    `host_iter` and keeps up to `prefetch` of them on the device ahead of
    the consumer.

    On CUDA each array is pinned and copied with `non_blocking=True` on a
    side stream; `__next__` makes the consumer's current stream wait on
    that copy's event and records the batch's tensors on that stream, so
    the caching allocator cannot hand their blocks out again while the
    step still reads them. On the CPU the arrays become tensors as they
    are (no pinning, no stream).

    An error in the worker is re-raised in the consumer as
    `RuntimeError("DeviceLoader worker failed")` from its cause: it is
    never taken for the end of the epoch. `close()` (or leaving a `with`
    block) stops the worker when the consumer stops early.
    """

    def __init__(self, host_iter: Iterator, device, prefetch: int = 2):
        self.host_iter = host_iter
        self.device = torch.device(device)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._q: "queue.Queue" = queue.Queue(maxsize=max(prefetch, 1))
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _to_device(self, batch: Dict[str, np.ndarray]):
        host = {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in batch.items()}
        if self._stream is None:
            return host, None
        with torch.cuda.stream(self._stream):
            out = {k: v.pin_memory().to(self.device, non_blocking=True)
                   for k, v in host.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self.host_iter:
                if not self._put(self._to_device(batch)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the consumer
            # A loader error must surface in the training thread: swallowed
            # here it would look exactly like a clean end of epoch.
            self._error = e
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._done:
            if self._error is not None:
                raise RuntimeError(
                    "DeviceLoader worker failed") from self._error
            raise StopIteration
        batch, event = item
        if event is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(event)
            for v in batch.values():
                v.record_stream(consumer)
        return batch

    def close(self) -> None:
        """Stop the worker (it may be blocked on a full queue) and wait
        for it."""
        self._stop.set()
        self._thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
