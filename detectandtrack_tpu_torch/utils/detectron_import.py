"""Detectron/Caffe2 `.pkl` checkpoint importer (and exporter) for the port
(port of detectandtrack_tpu/utils/detectron_import.py).

Reference parity: `lib/utils/net.initialize_gpu_from_weights_file`: the
reference loads a pickled ``{blob_name: ndarray}`` dict, name-maps
Detectron-style blobs onto the current net, and in VIDEO mode inflates 2D
conv kernels k×k → t×k×k with mean init. The blob → leaf conversion is the
JAX package's numpy code, copied: it fills the flax-named tree of the
model (`utils/params.state_dict_to_jax_params`), which the weight bridge
then loads into the port's state_dict. So the layouts are flax's here too:

- layout conversion (Caffe2 OIHW conv → flax THWIO; (out,in) FC → (in,out);
  Caffe2 IOHW deconv → flax HWIO **with spatial flip**),
- fc6 input reordering: Caffe2 flattens RoI features (C,P,P) row-major,
  the head flattens (T,P,P,C),
- 2D→3D inflation (mean/center, `models/inflate.py` semantics) applied
  per-kernel when the template has t > 1,
- head surgery: COCO-81-class box heads → 2-class person heads (channels
  [background, person]), and COCO-17-keypoint heads → PoseTrack-15 by
  joint-name matching (the 12 limb joints + nose transfer; head_bottom /
  head_top keep their fresh initialization).

`flax_params_to_blobs` is the inverse (parity:
`utils/net.save_model_to_weights_file`); `save_detectron_pkl` writes a
model's weights in the reference's exchange format.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
from torch import nn

from ..models.backbone import STAGE_BLOCKS
from ..ops.keypoints import COCO_KEYPOINTS, POSETRACK_KEYPOINTS
from .checkpoint import _unflatten
from .params import (_flatten, jax_params_to_state_dict,
                     state_dict_to_jax_params)

# COCO detection class index of "person" (background is 0).
_COCO_PERSON = 1
_COCO_NUM_CLASSES = 81


def load_detectron_pkl(path: str) -> Dict[str, np.ndarray]:
    """Load a Detectron-lineage weights pickle → {blob_name: ndarray}."""
    with open(path, "rb") as f:
        data = pickle.load(f, encoding="latin1")
    if isinstance(data, dict) and "blobs" in data:
        data = data["blobs"]
    return {k: np.asarray(v) for k, v in data.items()
            if isinstance(v, np.ndarray) or np.isscalar(v) or (
                hasattr(v, "shape"))}


# ---------------------------------------------------------------------------
# Name derivation: flax param path → candidate Detectron blob names
# ---------------------------------------------------------------------------

_BRANCH = {"a": "branch2a", "b": "branch2b", "c": "branch2c",
           "proj": "branch1"}


def _suffix(leaf: str, is_bn: bool) -> str:
    if is_bn:
        return {"scale": "_bn_s", "bias": "_bn_b"}[leaf]
    return {"kernel": "_w", "bias": "_b"}[leaf]


def blob_candidates(path: Sequence[str], conv_body: str) -> List[str]:
    """Candidate Detectron blob names for one flax param path.

    `path` is the key tuple below 'params', e.g.
    ('backbone', 'res2_0', 'a', 'conv', 'kernel').
    """
    p = list(path)
    leaf = p[-1]
    mod = p[0]
    blocks = STAGE_BLOCKS.get(conv_body, (3, 4, 6, 3))
    last = {f"res{s + 2}": n - 1 for s, n in enumerate(blocks)}

    if mod == "backbone":
        if p[1] == "conv1":
            if p[2] == "conv":
                return ["conv1_w"]
            return [{"scale": "res_conv1_bn_s",
                     "bias": "res_conv1_bn_b"}[leaf]]
        # res{S}_{B} / {a,b,c,proj} / {conv,bn} / leaf
        stage_block, branch, kind = p[1], p[2], p[3]
        base = f"{stage_block}_{_BRANCH[branch]}"
        return [base + _suffix(leaf, kind == "bn")]

    if mod == "fpn":
        kind, name = p[1].split("_", 1)       # lateral_res3 / posthoc_p3
        sfx = _suffix(leaf, False)
        if kind == "lateral":
            stage = name                      # res2..res5
            n = last[stage]
            if stage == "res5":
                return [f"fpn_inner_{stage}_{n}_sum{sfx}"]
            return [f"fpn_inner_{stage}_{n}_sum_lateral{sfx}"]
        if kind == "extra":                   # extra_p6 (EXTRA_CONV_LEVELS)
            # Detectron names the extra coarse conv after its level.
            return [f"fpn_{name}{sfx}", f"fpn_6{sfx}"]
        stage = "res" + name[1]               # p2 → res2
        return [f"fpn_{stage}_{last[stage]}_sum{sfx}"]

    if mod == "rpn_head":
        stem = {"conv": "conv_rpn", "logits": "rpn_cls_logits",
                "deltas": "rpn_bbox_pred"}[p[1]]
        sfx = _suffix(leaf, False)
        # FPN RPN weights are shared across levels; Detectron names them
        # after the level that created them — accept any.
        return [f"{stem}_fpn{l}{sfx}" for l in range(2, 7)] + [stem + sfx]

    if mod == "box_head":
        if p[1].startswith("res5_"):          # Res5BoxHead (C4 family)
            stage_block, branch, kind = p[1], p[2], p[3]
            base = f"{stage_block}_{_BRANCH[branch]}"
            return [base + _suffix(leaf, kind == "bn")]
        return [p[1] + _suffix(leaf, False)]  # fc6/fc7/cls_score/bbox_pred

    if mod == "kps_head":
        sfx = _suffix(leaf, False)
        if p[1] == "kps_score_lowres":
            # Our output layer IS the lineage deconv blob; tolerate the
            # non-deconv name too (USE_DECONV_OUTPUT=False checkpoints).
            return ["kps_score_lowres" + sfx, "kps_score" + sfx]
        return [p[1] + sfx]                   # conv_fcn{i}

    if mod == "mask_head":
        sfx = _suffix(leaf, False)
        if p[1].startswith("mask_fcn") and p[1][-1].isdigit():
            i = p[1][len("mask_fcn"):]
            return [f"_[mask]_fcn{i}{sfx}", f"mask_fcn{i}{sfx}"]
        return [p[1] + sfx]                   # conv5_mask, mask_fcn_logits

    return []


# ---------------------------------------------------------------------------
# Layout conversion (Caffe2 blob → flax leaf shape)
# ---------------------------------------------------------------------------

def _inflate_time(k: np.ndarray, t: int, mode: str) -> np.ndarray:
    """(1, kh, kw, ci, co) → (t, kh, kw, ci, co)."""
    if t == 1:
        return k
    if mode == "mean":
        return np.repeat(k, t, axis=0) / float(t)
    if mode == "center":
        out = np.zeros((t,) + k.shape[1:], k.dtype)
        out[t // 2] = k[0]
        return out
    raise ValueError(f"Unknown inflate mode {mode!r}")


def convert_blob(blob: np.ndarray, path: Sequence[str],
                 target_shape: Tuple[int, ...], inflate_mode: str = "mean",
                 roi_resolution: Optional[int] = None,
                 num_frames: int = 1) -> np.ndarray:
    """One Caffe2 blob → the flax leaf layout (before any head surgery)."""
    blob = np.asarray(blob, np.float32)
    name = path[-1]
    parent = path[-2] if len(path) >= 2 else ""

    if name in ("scale",) or blob.ndim == 1:
        return blob                                        # bias / affine

    if parent == "kps_score_lowres" and blob.ndim == 4:
        # Caffe2 deconv (ci, co, kh, kw) → flax (kh, kw, ci, co), spatially
        # flipped (verified vs torch ConvTranspose2d).
        return np.ascontiguousarray(
            blob.transpose(2, 3, 0, 1)[::-1, ::-1])
    if parent == "conv5_mask":
        return np.ascontiguousarray(
            blob.transpose(2, 3, 0, 1)[::-1, ::-1])

    if blob.ndim == 2:                                     # FC (out, in)
        if parent == "fc6":
            # Reorder the input dim (C,[T,]P,P) → (T,P,P,C), then mean-
            # inflate along T if the source is 2D and the target 3D.
            out_dim, in_dim = blob.shape
            p = roi_resolution
            if p is None:
                raise ValueError("fc6 conversion needs roi_resolution")
            t_tgt = num_frames
            c = target_shape[0] // (t_tgt * p * p)
            if in_dim == c * p * p:                        # 2D source
                w = blob.reshape(out_dim, c, p, p)
                w = w.transpose(2, 3, 1, 0)[None]          # (1, P, P, C, out)
                if t_tgt > 1:
                    w = np.repeat(w, t_tgt, axis=0) / float(t_tgt)
            elif in_dim == c * t_tgt * p * p:              # 3D source
                w = blob.reshape(out_dim, c, t_tgt, p, p)
                w = w.transpose(2, 3, 4, 1, 0)             # (T, P, P, C, out)
            else:
                raise ValueError(
                    f"fc6 blob in_dim {in_dim} matches neither C·P·P="
                    f"{c * p * p} nor C·T·P·P={c * t_tgt * p * p}")
            return w.reshape(-1, out_dim)
        return blob.T                                      # (in, out)

    if blob.ndim == 4:                                     # conv (co,ci,kh,kw)
        k = blob.transpose(2, 3, 1, 0)                     # (kh, kw, ci, co)
        if len(target_shape) == 4:                         # 2D flax conv
            return k
        k = k[None]                                        # (1, kh, kw, ci, co)
        return _inflate_time(k, target_shape[0], inflate_mode)

    if blob.ndim == 5:                                     # conv3d (co,ci,t,kh,kw)
        k = blob.transpose(2, 3, 4, 1, 0)                  # (t, kh, kw, ci, co)
        if k.shape[0] == 1 and len(target_shape) == 5 and target_shape[0] > 1:
            k = _inflate_time(k, target_shape[0], inflate_mode)
        return k

    raise ValueError(f"Cannot convert blob of shape {blob.shape} for "
                     f"{'/'.join(path)}")


# ---------------------------------------------------------------------------
# Head surgery (class-count / joint-count mismatches)
# ---------------------------------------------------------------------------

def _inflate_fc_rows(converted, template_rows, report, full):
    """2D FC kernel → T-frame flat input (frame-major (T, C) rows): tile
    the rows /T so the output equals the 2D head on the frame-mean — the
    FC analogue of mean conv inflation. No-op when rows already match."""
    if (converted.ndim == 2 and converted.shape[0] != template_rows
            and template_rows % converted.shape[0] == 0):
        t = template_rows // converted.shape[0]
        converted = np.tile(converted / t, (t, 1))
        report["surgery"].append(
            f"{full}: FC input rows inflated ×{t} (mean over frames)")
    return converted


def _coco_to_posetrack_joint_map() -> List[Tuple[int, int]]:
    """(posetrack_idx, coco_idx) pairs for joints present in both vocabs."""
    pairs = []
    for pi, name in enumerate(POSETRACK_KEYPOINTS):
        if name in COCO_KEYPOINTS:
            pairs.append((pi, COCO_KEYPOINTS.index(name)))
    return pairs


def _surgery(converted: np.ndarray, template: np.ndarray,
             path: Sequence[str], num_frames: int,
             report: Dict[str, List[str]]) -> Optional[np.ndarray]:
    """Map a converted blob with mismatched head dims onto the template.

    Returns None if no surgery rule applies (caller keeps template init).
    """
    parent = path[-2] if len(path) >= 2 else ""
    leaf = path[-1]
    out = np.array(template)                   # start from fresh init
    full = "/".join(path)

    if parent == "kps_score_lowres":
        # COCO-17 → PoseTrack-15 on the output-channel axis (last).
        if converted.shape[:-1] != template.shape[:-1]:
            return None
        pairs = _coco_to_posetrack_joint_map()
        for pi, ci in pairs:
            out[..., pi] = converted[..., ci]
        report["surgery"].append(
            f"{full}: COCO-{converted.shape[-1]} → "
            f"PoseTrack-{template.shape[-1]} ({len(pairs)} joints mapped)")
        return out

    if parent == "cls_score":
        # COCO 81-class → 2-class: [background, person].
        src_cls = converted.shape[-1]
        if src_cls < 2:
            return None
        converted = _inflate_fc_rows(converted, out.shape[0], report, full)
        if converted.shape[:-1] != out.shape[:-1]:
            return None
        idx = [0, _COCO_PERSON]
        out[..., 0] = converted[..., idx[0]]
        out[..., 1] = converted[..., idx[1]]
        report["surgery"].append(
            f"{full}: {src_cls}-class → 2-class (bg, person)")
        return out

    if path[0] == "rpn_head" and parent == "deltas":
        # 2D RPN box regressor → tube regressor: per-anchor 4 deltas are
        # replicated across the T frames (channel order is A × (T × 4)).
        src = converted.reshape(converted.shape[:-1] + (-1, 4))  # (…, A, 4)
        a = src.shape[-2]
        t_frames = template.shape[-1] // (a * 4)
        if t_frames * a * 4 != template.shape[-1]:
            return None
        rep = np.repeat(src[..., :, None, :], t_frames, axis=-2)
        report["surgery"].append(
            f"{full}: RPN 4-delta → 4·T tube deltas (T={t_frames})")
        return rep.reshape(template.shape)

    if parent == "bbox_pred":
        # (…, src_cls·4) → (…, 2·4·T): person deltas tiled per frame.
        converted = _inflate_fc_rows(converted, out.shape[0], report, full)
        src = converted.reshape(converted.shape[:-1] + (-1, 4))
        if src.shape[-2] < 2:
            return None
        if converted.ndim == 2 and converted.shape[0] != out.shape[0]:
            return None
        t = num_frames
        tgt = out.reshape(out.shape[:-1] + (2, t, 4))
        for slot, cls in enumerate((0, _COCO_PERSON)):
            for f in range(t):
                tgt[..., slot, f, :] = src[..., cls, :]
        report["surgery"].append(
            f"{full}: {src.shape[-2]}-class box deltas → 2-class × T={t}")
        return tgt.reshape(out.shape)

    return None


# ---------------------------------------------------------------------------
# Main entry points (over the flax-named tree of the port's model)
# ---------------------------------------------------------------------------

def _leaves(tree: Mapping) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested dict in the order `jax.tree` walks a flax
    tree: keys sorted at every level."""
    return sorted(_flatten(tree), key=lambda item: item[0])


def import_detectron_weights(
    blobs_or_path,
    model: nn.Module,
    cfg,
    strict: bool = False,
) -> Tuple[Dict[str, Any], Dict[str, List[str]]]:
    """Detectron blobs → a complete state_dict of `model` (which supplies
    the structure, shapes and the values of anything left unmapped).

    Returns (state_dict, report) where report lists mapped / surgery /
    missing / unused blob names. `strict=True` raises if any parameter has
    no source blob (fresh-init heads under surgery still count as
    mapped)."""
    blobs = (load_detectron_pkl(blobs_or_path)
             if isinstance(blobs_or_path, str) else dict(blobs_or_path))
    blobs = {k: v for k, v in blobs.items()
             if not k.endswith("_momentum") and not k.startswith("__")}

    template = state_dict_to_jax_params(model.state_dict(), model)["params"]
    conv_body = cfg.MODEL.CONV_BODY
    t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
    mode = cfg.VIDEO.INFLATE_MODE
    report: Dict[str, List[str]] = {
        "mapped": [], "surgery": [], "missing": [], "unused": []}
    used = set()
    out: Dict[str, Any] = {}                     # "/"-joined path → leaf

    for names, leaf in _leaves(template):
        full = "/".join(names)
        cands = blob_candidates(names, conv_body)
        blob_name = next((c for c in cands if c in blobs), None)
        if blob_name is None:
            report["missing"].append(full)
            out[full] = leaf
            continue
        roi_res = (cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
                   if names[0] == "box_head" else
                   cfg.KRCNN.ROI_XFORM_RESOLUTION)
        converted = convert_blob(blobs[blob_name], names,
                                 tuple(np.shape(leaf)), mode, roi_res,
                                 num_frames=t)
        if converted.shape == tuple(np.shape(leaf)):
            used.add(blob_name)
            out[full] = converted.astype(np.asarray(leaf).dtype)
            report["mapped"].append(f"{full} ← {blob_name}")
            continue
        fixed = _surgery(converted, np.asarray(leaf), names, t, report)
        if fixed is not None:
            # Marked used only on success: a shape-rejected blob stays on
            # the "unused" list, so a dropped checkpoint weight is visible.
            used.add(blob_name)
            out[full] = fixed.astype(np.asarray(leaf).dtype)
        else:
            report["missing"].append(
                f"{full}: shape {converted.shape} vs {np.shape(leaf)}")
            out[full] = leaf

    report["unused"] = sorted(set(blobs) - used)
    if strict and report["missing"]:
        raise ValueError("Unmapped parameters:\n  "
                         + "\n  ".join(report["missing"]))
    return jax_params_to_state_dict(_unflatten(out), model), report


def flax_params_to_blobs(params: Mapping, cfg) -> Dict[str, np.ndarray]:
    """Inverse mapping: a flax-named tree (`state_dict_to_jax_params` of a
    model, with or without the top "params" key) → Detectron-style blob
    dict.

    Parity: `utils/net.save_model_to_weights_file`. Only t=1 (2D) conv
    kernels round-trip exactly; t>1 kernels are exported as Caffe2 NdConv
    (co, ci, t, kh, kw) blobs.
    """
    tree = params["params"] if "params" in params else params
    blobs: Dict[str, np.ndarray] = {}
    conv_body = cfg.MODEL.CONV_BODY
    p_box = cfg.FAST_RCNN.ROI_XFORM_RESOLUTION
    for names, leaf in _leaves(tree):
        cands = blob_candidates(names, conv_body)
        if not cands:
            continue
        name = cands[0]
        arr = np.asarray(leaf, np.float32)
        parent = names[-2] if len(names) >= 2 else ""
        if parent in ("kps_score_lowres", "conv5_mask") and arr.ndim == 4:
            arr = np.ascontiguousarray(
                arr[::-1, ::-1].transpose(2, 3, 0, 1))
        elif arr.ndim == 5:
            if arr.shape[0] == 1:                          # 2D conv
                arr = arr[0].transpose(3, 2, 0, 1)         # (co, ci, kh, kw)
            else:                                          # true 3D conv
                arr = arr.transpose(4, 3, 0, 1, 2)         # (co,ci,t,kh,kw)
        elif arr.ndim == 4:                                # flax 2D conv
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 2:
            if parent == "fc6":
                # The (channels, frames) split comes from the cfg, not a
                # divisibility guess.
                in_dim, out_dim = arr.shape
                c = cfg.FPN.DIM
                t_src = in_dim // (c * p_box * p_box)
                if t_src * c * p_box * p_box != in_dim:
                    raise ValueError(f"fc6 {arr.shape} is not T·{p_box}·"
                                     f"{p_box}·{c} rows")
                w = arr.reshape(t_src, p_box, p_box, c, out_dim)
                if t_src == 1:
                    arr = w[0].transpose(3, 2, 0, 1).reshape(out_dim, -1)
                else:
                    arr = w.transpose(4, 3, 0, 1, 2).reshape(out_dim, -1)
            else:
                arr = arr.T
        blobs[name] = np.ascontiguousarray(arr)
    return blobs


def save_detectron_pkl(path: str, model: nn.Module, cfg) -> None:
    """`model`'s weights → a Detectron `.pkl` ({"blobs": {name: array}})."""
    params = state_dict_to_jax_params(model.state_dict(), model)
    with open(path, "wb") as f:
        pickle.dump({"blobs": flax_params_to_blobs(params, cfg)}, f)
