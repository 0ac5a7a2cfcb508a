"""Clip detection entry points, dataset-scale inference, and the host-side
hand-off to the tracker.

Port of detectandtrack_tpu/engine/inference.py (`make_detect_fn`,
`make_kps_aug_fns`, `window_proposals`, `clip_slice`,
`detections_to_frames`, `run_inference`, on one device or sharded over the
ranks of a mesh), with the static shapes of the detect outputs
(`detect_output_shapes`). The per-frame dicts feed the
port's host tracker (`tracking/engine.py`).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.config import Config
from ..data.pipeline import ClipSpec, choose_scale, load_clip, pick_bucket
from ..data.posetrack import PosetrackDataset
from ..models.detector import GeneralizedRCNN
from ..parallel.mesh import Mesh, gather_batch, replicate, shard_rows
from ..utils.io import load_object
from .augment import merge_multiscale_detections, rescale_detections


def make_detect_fn(model: GeneralizedRCNN, with_proposals: bool = False,
                   run_rpn: bool = False, flip_tta: bool = False
                   ) -> Callable[..., Dict]:
    """`detect(clips, tubes=None, tubes_valid=None) → {boxes, scores, valid,
    features, keypoints, masks}` on the model's device, under inference
    mode; keypoints and masks where the model predicts them.

    `with_proposals` runs `detect_with_proposals` on the given tubes;
    `run_rpn` keeps the RPN and its NMS running on that path (the
    benchmark's controlled RoI mix) instead of skipping them. `flip_tta`
    runs the model's flip test-time augmentation (`detect_tta`). Masks come
    back as the sigmoid of the last class channel (the person), computed on
    the device: (B, D, T, 2P, 2P).
    """

    def detect(clips: torch.Tensor, tubes: Optional[torch.Tensor] = None,
               tubes_valid: Optional[torch.Tensor] = None) -> Dict:
        with torch.inference_mode():
            if with_proposals:
                out = model.detect_with_proposals(clips, tubes, run_rpn,
                                                  tubes_valid)
            elif flip_tta:
                out = model.detect_tta(clips)
            else:
                out = model(clips)
            return detect_outputs(out)

    return detect


def detect_outputs(out: Dict) -> Dict[str, torch.Tensor]:
    """The model's raw outputs → `make_detect_fn`'s: boxes, scores, valid,
    features, and keypoints and mask probabilities where present."""
    keep = {k: out[k] for k in ("boxes", "scores", "valid", "features")}
    if "keypoints" in out:
        keep["keypoints"] = out["keypoints"]
    if "masks" in out:
        keep["masks"] = torch.sigmoid(out["masks"][..., -1])
    return keep


def detect_output_shapes(model: GeneralizedRCNN, batch: int
                         ) -> Dict[str, Tuple[int, ...]]:
    """The static shape of each of `make_detect_fn`'s outputs for a batch
    of `batch` clips."""
    cfg = model.cfg
    t, d = model.num_frames, cfg.TEST.DETECTIONS_PER_IM
    if cfg.MODEL.RPN_ONLY:
        d, feat = min(d, cfg.RPN.POST_NMS_TOP_N_TEST), 1
    else:
        feat = model.box_head.cls_score.in_features
    shapes = {"boxes": (batch, d, 4 * t), "scores": (batch, d),
              "valid": (batch, d), "features": (batch, d, feat)}
    if hasattr(model, "kps_head"):
        shapes["keypoints"] = (batch, d, t, model.kps_head.num_keypoints, 4)
    if hasattr(model, "mask_head"):
        m = 2 * cfg.MRCNN.ROI_XFORM_RESOLUTION
        shapes["masks"] = (batch, d, t, m, m)
    return shapes


def make_kps_aug_fns(model: GeneralizedRCNN, flip: bool
                     ) -> Tuple[Callable, Callable]:
    """The KPS_AUG second phase: `hm_fn(clips, boxes)` is one scale's pass
    of the body and keypoint head on the final boxes (in that clip's
    coordinates; with the mirrored pass averaged in when `flip`) →
    (B, M, Tk, S, S, K); `decode_fn(hms (S, B, M, Tk, S, S, K), boxes)`
    averages the stacked scales on the device and decodes once at the boxes
    in original coordinates → (B, D, T, K, 4)."""

    def hm_fn(clips: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.keypoint_heatmaps_for_boxes(clips, boxes, flip)

    def decode_fn(hms: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return model.decode_keypoints_from_heatmaps(hms.mean(dim=0),
                                                        boxes)

    return hm_fn, decode_fn


def window_proposals(db: Dict, dataset: PosetrackDataset, vid: str,
                     start: int, t: int, stride: int, kp: int
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """One clip window's proposal tubes from a proposal-file dict
    `{video_id: {frame_idx: (K_i, 4) boxes}}` (original image coords).

    Row k across the window's frames is tube k (the proposal-file
    contract). Frames past the video end clamp to the last frame, as
    `clip_records` does. Returns ((kp, 4·t) float32 tubes, (kp,) bool
    valid): rows are cut to the window's common row count and padded to
    `kp` as invalid.
    """
    n = len(dataset.video_frames(vid))
    vid_db = db.get(vid, {})
    per = []
    for i in range(t):
        idx = min(start + i * stride, n - 1)
        boxes = np.asarray(vid_db.get(idx, np.zeros((0, 4))), np.float32)
        per.append(boxes.reshape(-1, 4))
    k_eff = min(kp, min(len(b) for b in per))
    tubes = np.zeros((kp, 4 * t), np.float32)
    for i in range(t):
        tubes[:k_eff, 4 * i:4 * i + 4] = per[i][:k_eff]
    valid = np.arange(kp) < k_eff
    return tubes, valid


def _host(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def clip_slice(det: Dict, i: int) -> Dict[str, np.ndarray]:
    """Batched padded outputs (tensors or arrays) → clip i's numpy dict."""
    out = {"boxes": _host(det["boxes"][i]).astype(np.float64),
           "scores": _host(det["scores"][i]).astype(np.float64),
           "valid": _host(det["valid"][i]).astype(bool)}
    if det.get("keypoints") is not None:
        out["keypoints"] = _host(det["keypoints"][i]).astype(np.float64)
    if det.get("features") is not None:
        out["features"] = _host(det["features"][i]).astype(np.float32)
    if det.get("masks") is not None:
        out["masks"] = _host(det["masks"][i]).astype(np.float32)
    return out


def detections_to_frames(det: Dict[str, np.ndarray], num_frames: int,
                         scale: float) -> List[Dict[str, np.ndarray]]:
    """One clip's padded outputs (from `clip_slice`) → per-frame dicts in
    original image coordinates; keypoints become [x, y, prob] triples and
    masks stay roi-relative (D, 2P, 2P) probabilities per frame."""
    boxes = np.asarray(det["boxes"], np.float64)             # (D, 4T)
    scores = np.asarray(det["scores"], np.float64)
    valid = np.asarray(det["valid"], bool)
    kps = (np.asarray(det["keypoints"], np.float64)
           if "keypoints" in det else None)                  # (D, T, K, 4)
    per_frame = boxes.reshape(boxes.shape[0], num_frames, 4) / scale
    frames = []
    for t in range(num_frames):
        fr = {"boxes": per_frame[:, t], "scores": scores, "valid": valid}
        if kps is not None:
            k = kps[:, t].copy()
            k[..., :2] /= scale
            fr["keypoints"] = np.stack([k[..., 0], k[..., 1], k[..., 3]],
                                       axis=-1)
        if "features" in det:
            fr["features"] = np.asarray(det["features"], np.float32)
        if "masks" in det:
            fr["masks"] = np.asarray(det["masks"][:, t], np.float32)
        frames.append(fr)
    return frames


def _stage(arrays: Sequence[np.ndarray], device: torch.device
           ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Stack host arrays (a list, or an array's rows) into one tensor on
    `device` → (device tensor, staging buffer). On a CUDA device the arrays
    are stacked straight into a pinned buffer and copied without blocking
    the host; the caller keeps the buffer until that copy has completed (a
    pinned buffer reused earlier would corrupt the batch in flight without
    an error). On the CPU there is no copy and no buffer."""
    if device.type != "cuda":
        return torch.from_numpy(np.stack(arrays)), None
    first = np.asarray(arrays[0])
    host = torch.empty((len(arrays),) + first.shape,
                       dtype=torch.from_numpy(first[:0]).dtype,
                       pin_memory=True)
    np.stack(arrays, out=host.numpy())
    return host.to(device, non_blocking=True), host


def run_inference(
    cfg: Config,
    model: GeneralizedRCNN,
    dataset: PosetrackDataset,
    batch_size: Optional[int] = None,
    max_clips: Optional[int] = None,
    video_range: Optional[Tuple[int, int]] = None,
    frame_sink=None,
    dispatch_log: Optional[Dict] = None,
    mesh: Optional[Mesh] = None,
) -> Dict[str, List[Dict[str, np.ndarray]]]:
    """Detect over the whole dataset on the model's device → per-video
    per-frame detections (original image coordinates).

    Clips tile each video (non-overlapping windows) so every frame is
    covered exactly once; the tail of a video is covered by a final window
    aligned to the video end, and a video shorter than the clip span gets
    one window padded with its last frame. Clips of one shape bucket are
    batched `batch_size` at a time across videos; the last partial batch of
    a bucket is padded by repeating its last clip. Batch i-1 is read back
    after batch i is dispatched. `video_range` restricts the run to a slice
    of the sorted video list; `max_clips` to the first windows.

    With BBOX_AUG scales every clip runs once per scale and the passes are
    merged (union + NMS, `augment.merge_multiscale_detections`); with
    KPS_AUG on top, a second phase re-decodes each scale's clip, runs the
    keypoint head on the merged boxes per scale, keeps the heatmaps on the
    device and decodes their mean once. TEST.PROPOSAL_FILES runs the
    RPN-skipped path on the file's tubes (`window_proposals`).

    `frame_sink(vid, ordinal, total, frame_dict)`, when given, receives
    every finished frame as soon as its batch is read back; a frame covered
    by two windows (the end-aligned tail) is sunk only from its final
    writer, so the sink sees exactly the returned frames
    (`tracking.engine.StreamingTrackingSink`). `dispatch_log`, when given,
    records `(vid, frame_idx) → time.perf_counter()` when the frame's batch
    was handed to the model (a frame written twice keeps its final
    writer's time).

    With a mesh (`parallel/mesh.py`, one process per card), `batch_size`
    is the global batch, as JAX's mesh path takes it: it defaults to the
    world size and must be a multiple of it (one process: 1). The model is
    broadcast from rank 0 first. Every rank walks the same windows, queues,
    padding and tails and keeps the same `dispatch_log`; it decodes and
    detects only its own rows of each batch (`shard_rows`; KPS_AUG
    heatmaps stay on the rank that made them, which decodes its rows), and
    each read-back is gathered over the ranks on the host (`read_back`),
    so every rank returns the same dict. Only rank 0 calls `frame_sink`.
    """
    if batch_size is None:
        batch_size = mesh.size if mesh is not None else 1
    rows = shard_rows(mesh, batch_size)
    replicate(mesh, model)
    if mesh is not None and mesh.rank != 0:
        frame_sink = None
    device = next(model.parameters()).device
    t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
    stride = cfg.VIDEO.FRAME_STRIDE if cfg.VIDEO.VIDEO_ON else 1
    use_flip_aug = cfg.TEST.BBOX_AUG_ENABLED or cfg.TEST.KPS_AUG_ENABLED
    # Precomputed-proposal inference (TEST.PROPOSAL_FILES): config
    # validation rejects the TTA combination, so n_passes == 1 here.
    proposal_db = None
    if cfg.TEST.PROPOSAL_FILES:
        proposal_db = load_object(cfg.TEST.PROPOSAL_FILES[0])
    detect = make_detect_fn(model, with_proposals=proposal_db is not None,
                            flip_tta=use_flip_aug)
    buckets = [tuple(b) for b in cfg.TEST.SHAPE_BUCKETS]
    aug_scales = (list(cfg.TEST.BBOX_AUG_SCALES)
                  if cfg.TEST.BBOX_AUG_ENABLED else [])
    scale_targets = [cfg.TEST.SCALE] + aug_scales
    n_passes = len(scale_targets)
    kps_aug = (cfg.TEST.KPS_AUG_ENABLED and n_passes > 1
               and cfg.MODEL.KEYPOINTS_ON)
    if kps_aug:
        kps_hm_fn, kps_decode_fn = make_kps_aug_fns(model, use_flip_aug)

    # The tiling window list, with end-aligned tails.
    work: List[Tuple[str, int]] = []
    span = (t - 1) * stride + 1
    video_list = dataset.videos()
    if video_range is not None:
        video_list = video_list[video_range[0]:video_range[1]]
    for vid in video_list:
        n = len(dataset.video_frames(vid))
        if n < span:
            work.append((vid, 0))     # one window padded by the last frame
            continue
        starts = list(range(0, n - span + 1, span))
        if starts[-1] + span < n:
            starts.append(n - span)
        for s in starts:
            work.append((vid, s))
    if max_clips is not None:
        work = work[:max_clips]

    # Streaming bookkeeping: the window that writes each frame last (an
    # end-aligned tail overlaps its predecessor), and each frame's ordinal
    # in its video's emit order.
    winner: Dict[Tuple[str, int], int] = {}
    ordinals: Dict[str, Dict[int, int]] = {}
    if frame_sink is not None:
        emitted: Dict[str, set] = {}
        for vid, start in work:
            n_vid = len(dataset.video_frames(vid))
            for fi in range(t):
                idx = start + fi * stride
                if idx < n_vid:
                    winner[(vid, idx)] = start
                    emitted.setdefault(vid, set()).add(idx)
        ordinals = {vid: {idx: i for i, idx in enumerate(sorted(s))}
                    for vid, s in emitted.items()}

    results: Dict[str, Dict[int, Dict[str, np.ndarray]]] = {}
    acc: Dict[Tuple[str, int], List[Dict[str, np.ndarray]]] = {}
    # (device outputs, metas, bucket, staging buffers): the staging buffers
    # stay referenced until the entry is consumed, and consuming reads the
    # outputs back, which the card computes only after their inputs landed.
    pending: List = []

    def emit(vid, start, single):
        # `single` is in original image coordinates already.
        frames = detections_to_frames(single, t, 1.0)
        slot = results.setdefault(vid, {})
        n_vid = len(dataset.video_frames(vid))
        for fi, fr in enumerate(frames):
            idx = start + fi * stride
            if idx < n_vid:                       # drop padded tail frames
                slot[idx] = fr
                if frame_sink is not None and winner[(vid, idx)] == start:
                    frame_sink(vid, ordinals[vid][idx],
                               len(ordinals[vid]), fr)

    # KPS_AUG second phase: merged clips queue per tuple of buckets so each
    # batch stacks one shape per scale pass; the heatmaps stay on the
    # device through the mean and the decode.
    p2_queues: Dict[Tuple, List] = {}
    p2_pending: List = []

    def p2_consume(entry):
        kps, entries, _ = entry
        kps = read_back({"keypoints": kps}, mesh)["keypoints"]
        for i, (vid, start, merged, _) in enumerate(entries):
            merged["keypoints"] = np.asarray(kps[i], np.float64)
            emit(vid, start, merged)

    def p2_submit(key):
        entries = p2_queues.pop(key, [])
        if not entries:
            return
        full = list(entries)
        while len(full) < batch_size:   # pad the tail batch by repetition
            full.append(full[-1])
        full = full[rows]
        boxes_orig = np.stack([e[2]["boxes"] for e in full]).astype(
            np.float32)                                     # (B, D, 4T)
        hms, staged = [], []
        for j in range(n_passes):
            # Re-decode the scaled clip instead of keeping every in-flight
            # window's clip per scale pass in host memory.
            clips_j, buf = _stage([
                load_clip(dataset, ClipSpec(e[0], e[1]), t, stride,
                          cfg.DATA.PIXEL_MEANS, cfg.DATA.PIXEL_STDS,
                          e[3][j][0], cfg.TEST.MAX_SIZE,
                          bucket_hw=e[3][j][2], max_gt=1,
                          num_keypoints=cfg.KRCNN.NUM_KEYPOINTS)["clips"]
                for e in full], device)
            scales_j = np.asarray([e[3][j][1] for e in full], np.float32)
            boxes_j, bbuf = _stage(boxes_orig * scales_j[:, None, None],
                                   device)
            staged += [buf, bbuf]
            hms.append(kps_hm_fn(clips_j, boxes_j))
        boxes_dev, bbuf = _stage(boxes_orig, device)
        kps = kps_decode_fn(torch.stack(hms), boxes_dev)
        p2_pending.append((kps, entries, staged + [bbuf]))
        if len(p2_pending) >= 2:
            for e in p2_pending[:-1]:
                p2_consume(e)
            del p2_pending[:-1]

    def consume(entry):
        det, metas, bucket, _ = entry
        det = read_back(det, mesh)
        for bi, (vid, start, target) in enumerate(metas):
            scale = float(det["scale"][bi])
            single = rescale_detections(clip_slice(det, bi), scale)
            if n_passes == 1:
                emit(vid, start, single)
                continue
            if kps_aug:
                single["_pass"] = (target, scale, bucket)
            passes = acc.setdefault((vid, start), [])
            passes.append(single)
            if len(passes) == n_passes:
                merged = merge_multiscale_detections(passes, t,
                                                     cfg.TEST.NMS)
                if not kps_aug:
                    emit(vid, start, merged)
                else:
                    # Canonical pass order (by bucket, then scale) so the
                    # per-scale stacks share one shape batch-wide.
                    p2p = sorted((p["_pass"] for p in passes),
                                 key=lambda x: (x[2], x[1]))
                    key = tuple(x[2] for x in p2p)
                    q = p2_queues.setdefault(key, [])
                    q.append((vid, start, merged, p2p))
                    if len(q) == batch_size:
                        p2_submit(key)
                del acc[(vid, start)]

    def flush():
        for entry in pending:
            consume(entry)
        pending.clear()
        if kps_aug:
            for key in list(p2_queues):
                p2_submit(key)
            for e in p2_pending:
                p2_consume(e)
            del p2_pending[:]

    # Per-bucket batch queues of (video, start, scale target): a clip lands
    # in the smallest bucket that fits its scaled shape, and is decoded
    # when its batch is submitted, by the rank whose row it is.
    queues: Dict[Tuple[int, int], List] = {b: [] for b in buckets}

    def load(vid, start, target, bucket):
        item = load_clip(
            dataset, ClipSpec(vid, start), t, stride,
            cfg.DATA.PIXEL_MEANS, cfg.DATA.PIXEL_STDS,
            target, cfg.TEST.MAX_SIZE, bucket_hw=bucket,
            max_gt=1, num_keypoints=cfg.KRCNN.NUM_KEYPOINTS)
        if proposal_db is not None:
            item["tubes"], item["tubes_valid"] = window_proposals(
                proposal_db, dataset, vid, start, t, stride,
                cfg.RPN.POST_NMS_TOP_N_TEST)
        return item

    def submit(bucket):
        items = queues[bucket]
        if not items:
            return
        full = list(items)
        while len(full) < batch_size:  # pad the last partial batch
            full.append(full[-1])
        mine = [load(*it, bucket) for it in full[rows]]
        clips, buf = _stage([it["clips"] for it in mine], device)
        staged = [buf]
        if proposal_db is not None:
            # Proposal files are in original image coords; the model runs
            # in bucket coords, so scale each clip's tubes by its scale.
            tubes, tbuf = _stage([it["tubes"] * np.float32(it["scale"])
                                  for it in mine], device)
            tvalid, vbuf = _stage([it["tubes_valid"] for it in mine],
                                  device)
            staged += [tbuf, vbuf]
            det = detect(clips, tubes, tvalid)
        else:
            det = detect(clips)
        if dispatch_log is not None:
            now = time.perf_counter()
            for vid_, start_, _ in items:
                nv = len(dataset.video_frames(vid_))
                for fi in range(t):
                    idx = start_ + fi * stride
                    if idx < nv:      # later (tail) windows overwrite
                        dispatch_log[(vid_, idx)] = now
        # Each row's scale is read back with its outputs (only the rank
        # that decoded a clip knows it); the meta keeps the scale target so
        # phase 2 can re-decode the clip (the pixels are not kept).
        det = dict(det, scale=np.asarray([it["scale"] for it in mine],
                                         np.float32))
        pending.append((det, items, bucket, staged))
        if len(pending) >= 2:          # double-buffer: read the older one
            for entry in pending[:-1]:
                consume(entry)
            del pending[:-1]
        queues[bucket] = []

    for vid, start in work:
        first = dataset.video_frames(vid)[start]
        for target in scale_targets:
            scale = choose_scale(first.height or 1, first.width or 1,
                                 target, cfg.TEST.MAX_SIZE)
            sh = int(round((first.height or 1) * scale))
            sw = int(round((first.width or 1) * scale))
            bucket = pick_bucket(sh, sw, buckets)
            queues[bucket].append((vid, start, target))
            if len(queues[bucket]) == batch_size:
                submit(bucket)
    for b in buckets:
        submit(b)
    flush()

    return {vid: [frames[k] for k in sorted(frames)]
            for vid, frames in results.items()}


def read_back(out: Dict, mesh: Optional[Mesh] = None
              ) -> Dict[str, np.ndarray]:
    """Outputs of this rank's rows (tensors or arrays) → host arrays of the
    global batch: `parallel.mesh.gather_batch` over the mesh, in rank
    order; the host copies alone without one."""
    return gather_batch(mesh, {k: _host(v) for k, v in out.items()})
