"""Immutable experiment configuration tree — the port's own copy.

This is detectandtrack_tpu/core/config.py, copied so that the port never
imports the JAX package: the same dataclass tree, YAML loader (`load_cfg`),
dotted overrides and validation. `tests/test_torch_port_copies.py` holds
the two to the same tree for every `configs/video/*.yaml`.

Reference parity: `lib/core/config.py` (SURVEY.md §2.1) — the reference keeps a
global mutable AttrDict `cfg` merged from YAML (`merge_cfg_from_file`) and
dotted CLI overrides (`merge_cfg_from_list`), validated by
`assert_and_infer_cfg`. The TPU-native redesign keeps the same section names
and option vocabulary but the tree is a *frozen* dataclass hierarchy:

- hashable → usable as a jit static argument without recompile surprises;
- immutable → safe to close over in traced functions;
- validated at construction (`assert_and_infer_cfg` runs in `finalize`).

YAML files use the same ``SECTION.KEY: value`` nesting as the reference
(``MODEL: {TYPE: ...}``) so configs read the same way.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping, Optional, Sequence, Tuple

import yaml


def _tup(*xs):
    """Default-factory helper for tuple fields."""
    return field(default_factory=lambda: tuple(xs))


@dataclass(frozen=True)
class ModelCfg:
    # "generalized_rcnn" is the only model family (2D and 3D variants are
    # selected by VIDEO options), mirroring the reference's MODEL.TYPE.
    TYPE: str = "generalized_rcnn"
    # Backbone conv body: resnet18 | resnet50 | resnet101 (FPN wiring is
    # controlled by FPN.FPN_ON, as in the reference's CONV_BODY strings).
    CONV_BODY: str = "resnet50"
    NUM_CLASSES: int = 2  # background + person (PoseTrack)
    KEYPOINTS_ON: bool = True
    MASK_ON: bool = False
    RPN_ONLY: bool = False
    # bfloat16 compute on the backbone/heads (params stay f32). TPU MXU-native.
    COMPUTE_DTYPE: str = "bfloat16"
    # RoIAlign implementation. "pallas" (default): single-launch
    # multilevel patch kernel — per-roi 64x64 patch DMA + two in-VMEM
    # matmuls, ~2.6-3.1x the dense path on v5e; falls back to "dense"
    # off-TPU and for C4 (no FPN level bound on roi span). "dense"
    # (two-einsum MXU form) is exact for any roi; "hybrid"/"gather" are
    # measured-slower alternatives kept for study. Equivalence-tested, with
    # one caveat: the pallas kernel window-clips RoIs wider than 56 cells at
    # their FPN level (aspect >4:1), where it is approximate (and training
    # pairs that clipped forward with an exact dense backward); "dense" is
    # exact everywhere.
    ROI_ALIGN_IMPL: str = "pallas"
    # Frozen-BN as affine channels, as in Detectron lineage.
    FREEZE_BN: bool = True


@dataclass(frozen=True)
class VideoCfg:
    """DetectAndTrack-specific video options (SURVEY.md §2.1 VIDEO.*)."""

    VIDEO_ON: bool = False          # False → per-frame 2D model
    NUM_FRAMES: int = 1             # T, clip length (static!)
    FRAME_STRIDE: int = 1           # temporal stride when sampling clips
    # 3D inflation: temporal kernel size per ResNet stage (conv1, res2..res5).
    # (1,1,1,1,1) with VIDEO_ON means "2D conv applied per frame".
    TIME_KERNEL_DIM: Tuple[int, ...] = _tup(3, 3, 3, 3, 3)
    # Temporal stride of conv1 (paper keeps T; no temporal downsampling).
    TIME_STRIDE_ON: bool = False
    # Keypoint head predicts heatmaps for all T frames, or center frame only.
    PREDICT_ALL_FRAMES: bool = True
    # 2D→3D weight inflation: mean-init (divide by t) per the paper.
    INFLATE_MODE: str = "mean"      # mean | center
    DILATE_TIME: bool = False


@dataclass(frozen=True)
class ResNetCfg:
    # Number of groups / width per group (ResNeXt support in lineage; 1/64 =
    # plain ResNet).
    NUM_GROUPS: int = 1
    WIDTH_PER_GROUP: int = 64
    STRIDE_1X1: bool = True         # Caffe-style stride placement in bottleneck
    TRANS_FUNC: str = "bottleneck"  # bottleneck | basic (auto for resnet18)
    FREEZE_AT: int = 2              # freeze stages <= this at train time
    RES5_DILATION: int = 1


@dataclass(frozen=True)
class FpnCfg:
    FPN_ON: bool = True
    DIM: int = 256
    COARSEST_STRIDE: int = 32       # pad images to multiples of this
    MULTILEVEL_RPN: bool = True
    RPN_MIN_LEVEL: int = 2
    RPN_MAX_LEVEL: int = 6
    MULTILEVEL_ROIS: bool = True
    ROI_MIN_LEVEL: int = 2
    ROI_MAX_LEVEL: int = 5
    ROI_CANONICAL_SCALE: int = 224
    ROI_CANONICAL_LEVEL: int = 4
    EXTRA_CONV_LEVELS: bool = False
    ZERO_INIT_LATERAL: bool = False


@dataclass(frozen=True)
class RpnCfg:
    # Anchor geometry (per-FPN-level sizes derived as in Detectron lineage).
    SIZES: Tuple[int, ...] = _tup(32, 64, 128, 256, 512)
    STRIDE: int = 16                # only used when FPN is off
    ASPECT_RATIOS: Tuple[float, ...] = _tup(0.5, 1.0, 2.0)
    # Fixed-shape contract for TPU: proposal counts are static.
    PRE_NMS_TOP_N_TRAIN: int = 2000
    PRE_NMS_TOP_N_TEST: int = 1000
    POST_NMS_TOP_N_TRAIN: int = 1000
    POST_NMS_TOP_N_TEST: int = 300
    NMS_THRESH: float = 0.7
    MIN_SIZE: float = 0.0
    STRADDLE_THRESH: int = 0
    # Training target assignment.
    POSITIVE_OVERLAP: float = 0.7
    NEGATIVE_OVERLAP: float = 0.3
    FG_FRACTION: float = 0.5
    BATCH_SIZE_PER_IM: int = 256
    SMOOTH_L1_BETA: float = 0.1111111


@dataclass(frozen=True)
class FastRcnnCfg:
    ROI_BOX_HEAD: str = "2mlp_head"     # 2mlp_head | res5_head
    MLP_HEAD_DIM: int = 1024
    ROI_XFORM_METHOD: str = "RoIAlign"
    ROI_XFORM_RESOLUTION: int = 7
    ROI_XFORM_SAMPLING_RATIO: int = 2
    # Training RoI sampling (static counts for XLA).
    BATCH_SIZE_PER_IM: int = 512
    FG_FRACTION: float = 0.25
    FG_THRESH: float = 0.5
    BG_THRESH_HI: float = 0.5
    BG_THRESH_LO: float = 0.0
    BBOX_REG_WEIGHTS: Tuple[float, ...] = _tup(10.0, 10.0, 5.0, 5.0)
    SMOOTH_L1_BETA: float = 1.0


@dataclass(frozen=True)
class KrcnnCfg:
    """Keypoint R-CNN head (SURVEY.md §2.1 keypoint_rcnn_heads)."""

    NUM_KEYPOINTS: int = 15             # PoseTrack v1: 15 joints
    ROI_KEYPOINTS_HEAD: str = "v1convX"
    NUM_STACKED_CONVS: int = 8
    CONV_HEAD_DIM: int = 512
    CONV_HEAD_KERNEL: int = 3
    ROI_XFORM_METHOD: str = "RoIAlign"
    ROI_XFORM_RESOLUTION: int = 14
    ROI_XFORM_SAMPLING_RATIO: int = 2
    UP_SCALE: int = 2                   # deconv ×2 then nearest-upsample ×2
    HEATMAP_SIZE: int = 56
    USE_DECONV_OUTPUT: bool = True
    DECONV_KERNEL: int = 4
    # Loss: softmax-CE over discretized GT location, normalized by visible kps.
    LOSS_WEIGHT: float = 1.0
    NORMALIZE_BY_VISIBLE_KEYPOINTS: bool = True
    # Detections whose (center-frame) short side is below this get zeroed
    # keypoint scores at inference (lineage KRCNN.INFERENCE_MIN_SIZE).
    INFERENCE_MIN_SIZE: int = 0
    # Perf knob: run the keypoint head on only the top-M score-sorted
    # detections (0 = all of TEST.DETECTIONS_PER_IM). Remaining slots get
    # zero keypoints. The kps branch is ~half of inference time at D=100.
    MAX_ROIS_PER_IM: int = 0
    # Training keypoint budget: the keypoint head/loss run on the first M
    # (fg-sorted) sampled RoIs per image.
    TRAIN_MAX_ROIS_PER_IM: int = 64


@dataclass(frozen=True)
class MrcnnCfg:
    """Mask head — present in the lineage API surface, off for PoseTrack."""

    ROI_MASK_HEAD: str = "1up4convs"
    RESOLUTION: int = 28
    ROI_XFORM_METHOD: str = "RoIAlign"
    ROI_XFORM_RESOLUTION: int = 14
    ROI_XFORM_SAMPLING_RATIO: int = 2
    DIM_REDUCED: int = 256
    WEIGHT_LOSS_MASK: float = 1.0
    # Mask-head training RoI budget (0 = all sampled RoIs). Own knob —
    # reusing KRCNN's budget silently coupled mask batch composition to a
    # keypoint setting (review r3).
    TRAIN_MAX_ROIS_PER_IM: int = 64


@dataclass(frozen=True)
class TrainCfg:
    WEIGHTS: str = ""                   # init checkpoint (orbax dir or .npz)
    DATASETS: Tuple[str, ...] = _tup()
    SCALES: Tuple[int, ...] = _tup(600,)
    MAX_SIZE: int = 1000
    IMS_PER_BATCH: int = 2              # per device
    BATCH_SIZE_PER_IM: int = 512
    USE_FLIPPED: bool = True
    CHECKPOINT_PERIOD: int = 5000
    SNAPSHOT_ITERS: int = 5000
    RPN_ON: bool = True
    AUTO_RESUME: bool = True
    ASPECT_GROUPING: bool = True
    GT_MIN_AREA: float = -1.0
    # Fixed-shape contract: max GT boxes per image fed to the XLA graph.
    MAX_GT_PER_IM: int = 64


@dataclass(frozen=True)
class TestCfg:
    DATASETS: Tuple[str, ...] = _tup()
    WEIGHTS: str = ""
    SCALE: int = 800
    MAX_SIZE: int = 1333
    NMS: float = 0.5
    RPN_PRE_NMS_TOP_N: int = 1000
    RPN_POST_NMS_TOP_N: int = 300
    # Fixed-shape detection budget after class NMS.
    DETECTIONS_PER_IM: int = 100
    SCORE_THRESH: float = 0.05
    BBOX_AUG_ENABLED: bool = False
    # Extra TEST.SCALE values for multi-scale TTA (lineage BBOX_AUG.SCALES):
    # each clip runs once per scale (+ flips when enabled) and the union is
    # re-NMS'd in original-image coordinates.
    BBOX_AUG_SCALES: Tuple[int, ...] = _tup()
    KPS_AUG_ENABLED: bool = False
    SOFT_NMS_ENABLED: bool = False
    SOFT_NMS_METHOD: str = "linear"
    SOFT_NMS_SIGMA: float = 0.5
    BBOX_VOTE_ENABLED: bool = False
    # IoU threshold for box voting (lineage TEST.BBOX_VOTE.VOTE_TH).
    BBOX_VOTE_THRESH: float = 0.8
    # Bucketed static input shapes (H, W multiples of FPN.COARSEST_STRIDE);
    # the pipeline pads every image/clip into one of these buckets.
    SHAPE_BUCKETS: Tuple[Tuple[int, int], ...] = _tup((800, 1344),)
    # Precomputed-proposal inference (lineage TEST.PROPOSAL_FILES, Fast
    # R-CNN style — the RPN is skipped): one pickle per TEST.DATASETS
    # entry, `{video_id: {frame_idx: float (K_i, 4) boxes}}` in ORIGINAL
    # image coordinates. For T>1 rows must correspond across frames (row k
    # is tube k). Padded/truncated to RPN.POST_NMS_TOP_N_TEST per clip
    # with a validity mask. Incompatible with BBOX_AUG/KPS_AUG.
    PROPOSAL_FILES: Tuple[str, ...] = _tup()


@dataclass(frozen=True)
class SolverCfg:
    TYPE: str = "sgd"
    BASE_LR: float = 0.02
    LR_POLICY: str = "steps_with_decay"
    GAMMA: float = 0.1
    STEPS: Tuple[int, ...] = _tup(0, 12000, 16000)
    MAX_ITER: int = 18000
    MOMENTUM: float = 0.9
    WEIGHT_DECAY: float = 0.0001
    WEIGHT_DECAY_BN: float = 0.0
    WARM_UP_ITERS: int = 500
    WARM_UP_FACTOR: float = 1.0 / 3.0
    WARM_UP_METHOD: str = "linear"
    # Momentum correction on LR change (Caffe2 CorrectMomentum). optax's
    # SGD form (update = -lr · trace) is natively the corrected variant, so
    # only True is supported (validated below).
    SCALE_MOMENTUM: bool = True
    LOG_LR_CHANGE_THRESHOLD: float = 1.1
    # 0 = off. Global grad-norm clip (not in the reference; needed for
    # from-scratch training where it only ever fine-tuned).
    CLIP_GRAD_NORM: float = 0.0


@dataclass(frozen=True)
class TrackingCfg:
    """Stage-2 linking options (SURVEY.md §2.1 tracking_engine)."""

    # Cost between detections in consecutive frames:
    #   bbox-iou | pose-pckh | cnn-cosine (feature cosine distance)
    DISTANCE_METRIC: str = "bbox-iou"
    # Assignment solver: hungarian | greedy
    BIPARTITE_MATCHING_ALGO: str = "hungarian"
    # Detections below this score are dropped before linking.
    CONF_FILTER_INITIAL_DETS: float = 0.5
    # Cost above this never links (new track instead).
    MAX_COST: float = 0.9
    # Keep-alive: frames a track survives unmatched before being killed.
    MAX_AGE: int = 1
    # PCKh distance normalization factor (fraction of the PCKH_NORM length).
    PCKH_THRESH: float = 0.2
    # PCKh normalization length: "box-diag" (previous box diagonal — a
    # GT-independent proxy; the reference normalizes by head segment
    # length, unavailable at inference) | "kps-span" (previous pose's
    # keypoint extent diagonal).
    PCKH_NORM: str = "box-diag"
    # Optional native (C++) assignment solver; falls back to scipy.
    USE_NATIVE_SOLVER: bool = True


@dataclass(frozen=True)
class DataCfg:
    """Host input pipeline (replaces RoIDataLoader/BlobsQueue; SURVEY §2.1)."""

    NUM_WORKERS: int = 4
    PREFETCH: int = 2                   # double-buffered device_put depth
    PIXEL_MEANS: Tuple[float, ...] = _tup(102.9801, 115.9465, 122.7717)  # BGR
    PIXEL_STDS: Tuple[float, ...] = _tup(1.0, 1.0, 1.0)
    ROOT: str = "data"                  # dataset root directory


@dataclass(frozen=True)
class Config:
    MODEL: ModelCfg = field(default_factory=ModelCfg)
    VIDEO: VideoCfg = field(default_factory=VideoCfg)
    RESNETS: ResNetCfg = field(default_factory=ResNetCfg)
    FPN: FpnCfg = field(default_factory=FpnCfg)
    RPN: RpnCfg = field(default_factory=RpnCfg)
    FAST_RCNN: FastRcnnCfg = field(default_factory=FastRcnnCfg)
    KRCNN: KrcnnCfg = field(default_factory=KrcnnCfg)
    MRCNN: MrcnnCfg = field(default_factory=MrcnnCfg)
    TRAIN: TrainCfg = field(default_factory=TrainCfg)
    TEST: TestCfg = field(default_factory=TestCfg)
    SOLVER: SolverCfg = field(default_factory=SolverCfg)
    TRACKING: TrackingCfg = field(default_factory=TrackingCfg)
    DATA: DataCfg = field(default_factory=DataCfg)
    OUTPUT_DIR: str = "/tmp/detectandtrack_tpu"
    RNG_SEED: int = 3
    DEBUG: bool = False


# ---------------------------------------------------------------------------
# Merge / override machinery (reference: merge_cfg_from_file / _from_list)
# ---------------------------------------------------------------------------

_COERCIBLE = (int, float, bool, str)


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Coerce a YAML/CLI value to the type of the dataclass default."""
    if old is None:
        return value
    if isinstance(old, tuple):
        if isinstance(value, str):
            value = yaml.safe_load(value)
        if not isinstance(value, (list, tuple)):
            raise TypeError(f"{key}: expected sequence, got {type(value).__name__}")
        # Nested tuples (e.g. SHAPE_BUCKETS) are converted recursively.
        return tuple(
            tuple(v) if isinstance(v, (list, tuple)) else v for v in value
        )
    if isinstance(old, bool):
        if isinstance(value, bool):
            return value
        if isinstance(value, str):
            low = value.lower()
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
        raise TypeError(f"{key}: expected bool, got {value!r}")
    if isinstance(old, int) and not isinstance(old, bool):
        if isinstance(value, str):
            value = yaml.safe_load(value)
        if isinstance(value, float) and value != int(value):
            raise TypeError(f"{key}: expected int, got float {value}")
        return int(value)
    if isinstance(old, float):
        if isinstance(value, str):
            value = yaml.safe_load(value)
        return float(value)
    if isinstance(old, str):
        return str(value)
    raise TypeError(f"{key}: cannot coerce {value!r} into {type(old).__name__}")


def _set_dotted(cfg: Any, dotted: str, value: Any, _full: str = "") -> Any:
    """Return a copy of `cfg` with the dotted field replaced."""
    full = _full or dotted
    head, _, rest = dotted.partition(".")
    if not hasattr(cfg, head):
        raise KeyError(f"Unknown config key: {full!r} (no field {head!r})")
    old = getattr(cfg, head)
    if rest:
        new = _set_dotted(old, rest, value, _full=full)
    else:
        if dataclasses.is_dataclass(old):
            raise KeyError(f"{full!r} names a section, not a leaf option")
        new = _coerce(value, old, full)
    return dataclasses.replace(cfg, **{head: new})


def _merge_mapping(cfg: Any, mapping: Mapping[str, Any], prefix: str = "") -> Any:
    for key, value in mapping.items():
        dotted = f"{prefix}{key}"
        if isinstance(value, Mapping):
            cfg = _merge_mapping(cfg, value, prefix=f"{dotted}.")
        else:
            cfg = _set_dotted(cfg, dotted, value)
    return cfg


def merge_cfg_from_file(cfg: Config, yaml_path: str) -> Config:
    """Merge a YAML experiment file into `cfg` (returns a new Config)."""
    with open(yaml_path) as f:
        doc = yaml.safe_load(f) or {}
    if not isinstance(doc, Mapping):
        raise TypeError(f"{yaml_path}: top level must be a mapping")
    return _merge_mapping(cfg, doc)


def merge_cfg_from_list(cfg: Config, opts: Sequence[Any]) -> Config:
    """Merge ``[KEY, value, KEY, value, ...]`` dotted CLI overrides."""
    if len(opts) % 2 != 0:
        raise ValueError("override list must be KEY VALUE pairs")
    for key, value in zip(opts[0::2], opts[1::2]):
        cfg = _set_dotted(cfg, key, value)
    return cfg


def _alias(cfg: Config, src: str, dst: str) -> Config:
    """Lineage-name alias: if `src` was changed from its default, copy it
    into `dst` (error if both were changed to different values)."""
    def get(dotted, root):
        for part in dotted.split("."):
            root = getattr(root, part)
        return root

    default = Config()
    s, d = get(src, cfg), get(dst, cfg)
    s0, d0 = get(src, default), get(dst, default)
    if s == s0:
        return cfg
    if d != d0 and d != s:
        raise ValueError(f"{src}={s} conflicts with {dst}={d}; set one")
    return _set_dotted(cfg, dst, s)


def assert_and_infer_cfg(cfg: Config) -> Config:
    """Validate and derive options (reference: assert_and_infer_cfg).

    Every config field is either consumed by the code, derived here, or
    rejected here — no knob is silently ignored.
    """
    # Lineage-name aliases (the reference's names for the same options).
    cfg = _alias(cfg, "TRAIN.SNAPSHOT_ITERS", "TRAIN.CHECKPOINT_PERIOD")
    cfg = _alias(cfg, "TRAIN.BATCH_SIZE_PER_IM", "FAST_RCNN.BATCH_SIZE_PER_IM")
    cfg = _alias(cfg, "TEST.RPN_PRE_NMS_TOP_N", "RPN.PRE_NMS_TOP_N_TEST")
    cfg = _alias(cfg, "TEST.RPN_POST_NMS_TOP_N", "RPN.POST_NMS_TOP_N_TEST")

    if cfg.MODEL.CONV_BODY not in ("resnet18", "resnet50", "resnet101"):
        raise ValueError(f"Unknown CONV_BODY {cfg.MODEL.CONV_BODY!r}")
    if cfg.MODEL.ROI_ALIGN_IMPL not in ("pallas", "hybrid", "gather",
                                        "dense"):
        raise ValueError("MODEL.ROI_ALIGN_IMPL must be 'pallas', 'hybrid', "
                         "'gather' or 'dense'")
    if cfg.RESNETS.NUM_GROUPS < 1 or cfg.RESNETS.WIDTH_PER_GROUP < 1:
        raise ValueError("RESNETS.NUM_GROUPS/WIDTH_PER_GROUP must be >= 1")
    if cfg.RESNETS.NUM_GROUPS > 1 and cfg.MODEL.CONV_BODY == "resnet18":
        raise ValueError("ResNeXt grouping (RESNETS.NUM_GROUPS > 1) needs a "
                         "bottleneck depth (resnet50/101); basic-block R-18 "
                         "has no grouped transform in the lineage")
    if not cfg.MODEL.FREEZE_BN:
        raise ValueError(
            "MODEL.FREEZE_BN=False is unsupported: BN is implemented as "
            "frozen per-channel affine (the reference's AffineChannel); "
            "there is no batch-stat path")
    if not cfg.SOLVER.SCALE_MOMENTUM:
        raise ValueError(
            "SOLVER.SCALE_MOMENTUM=False is unsupported: the optax SGD "
            "form is natively momentum-corrected on LR changes")
    if cfg.SOLVER.TYPE != "sgd":
        raise ValueError(f"SOLVER.TYPE {cfg.SOLVER.TYPE!r}: only 'sgd' "
                         "(the reference's optimizer) is implemented")
    if cfg.TRACKING.PCKH_NORM not in ("box-diag", "kps-span"):
        raise ValueError(
            f"TRACKING.PCKH_NORM {cfg.TRACKING.PCKH_NORM!r}: must be "
            "'box-diag' or 'kps-span'")
    if cfg.MODEL.NUM_CLASSES > 2:
        raise ValueError(
            f"MODEL.NUM_CLASSES={cfg.MODEL.NUM_CLASSES} is unsupported: "
            "the GT pipeline and proposal targets are person-only "
            "(PoseTrack), so multi-class labels would silently train as "
            "binary — reject loudly instead")
    if cfg.MODEL.RPN_ONLY and (cfg.TEST.BBOX_AUG_ENABLED
                               or cfg.TEST.KPS_AUG_ENABLED):
        raise ValueError(
            "TEST.BBOX_AUG/KPS_AUG with MODEL.RPN_ONLY is unsupported: "
            "the in-graph TTA path runs the RoI heads, which a "
            "proposal-only model does not create")
    if not cfg.TRAIN.RPN_ON:
        raise ValueError(
            "TRAIN.RPN_ON=False is unsupported: the lineage's RPN-off mode "
            "trains against precomputed proposals; the proposal-files path "
            "here (TEST.PROPOSAL_FILES) is inference-only — the RPN is "
            "always part of the one XLA train graph")
    if cfg.TEST.PROPOSAL_FILES:
        if cfg.TEST.BBOX_AUG_ENABLED or cfg.TEST.KPS_AUG_ENABLED:
            raise ValueError(
                "TEST.PROPOSAL_FILES with BBOX_AUG/KPS_AUG is unsupported: "
                "TTA re-runs detection at several scales, but supplied "
                "proposals are single-scale fixed tubes")
        if cfg.MODEL.RPN_ONLY:
            raise ValueError("TEST.PROPOSAL_FILES with MODEL.RPN_ONLY is "
                             "contradictory (proposals in, proposals out)")
        if cfg.TEST.DATASETS and (len(cfg.TEST.PROPOSAL_FILES)
                                  != len(cfg.TEST.DATASETS)):
            raise ValueError(
                "TEST.PROPOSAL_FILES needs one file per TEST.DATASETS "
                f"entry (got {len(cfg.TEST.PROPOSAL_FILES)} files for "
                f"{len(cfg.TEST.DATASETS)} datasets)")
    # TRANS_FUNC is derived from the depth (basic for R-18, bottleneck for
    # R-50/101 — the lineage's per-depth block choice).
    expected_trans = ("basic" if cfg.MODEL.CONV_BODY == "resnet18"
                      else "bottleneck")
    if cfg.RESNETS.TRANS_FUNC != expected_trans:
        cfg = _set_dotted(cfg, "RESNETS.TRANS_FUNC", expected_trans)
    for sec, name in ((cfg.FAST_RCNN, "FAST_RCNN"), (cfg.KRCNN, "KRCNN"),
                      (cfg.MRCNN, "MRCNN")):
        if sec.ROI_XFORM_METHOD != "RoIAlign":
            raise ValueError(f"{name}.ROI_XFORM_METHOD must be RoIAlign "
                             "(RoIPool is not implemented — the reference's "
                             "PoseTrack configs all use RoIAlign)")
    if cfg.MODEL.MASK_ON and cfg.MRCNN.ROI_MASK_HEAD != "1up4convs":
        raise ValueError("MRCNN.ROI_MASK_HEAD: only '1up4convs' (the "
                         "lineage's default mask head; other variants are "
                         "not implemented)")
    if cfg.MODEL.KEYPOINTS_ON:
        if cfg.KRCNN.ROI_KEYPOINTS_HEAD != "v1convX":
            raise ValueError("KRCNN.ROI_KEYPOINTS_HEAD: only v1convX")
        if not cfg.KRCNN.USE_DECONV_OUTPUT:
            raise ValueError("KRCNN.USE_DECONV_OUTPUT=False unsupported "
                             "(v1convX always ends deconv → upsample)")
        if cfg.KRCNN.DECONV_KERNEL != 4:
            raise ValueError("KRCNN.DECONV_KERNEL must be 4 (stride-2 "
                             "deconv geometry is kernel-4 pad-1)")
        expect_hm = 2 * cfg.KRCNN.ROI_XFORM_RESOLUTION * cfg.KRCNN.UP_SCALE
        if cfg.KRCNN.HEATMAP_SIZE != expect_hm:
            raise ValueError(
                f"KRCNN.HEATMAP_SIZE={cfg.KRCNN.HEATMAP_SIZE} inconsistent "
                f"with 2·ROI_XFORM_RESOLUTION·UP_SCALE={expect_hm}")
    if cfg.VIDEO.VIDEO_ON:
        if cfg.VIDEO.TIME_STRIDE_ON:
            raise ValueError(
                "VIDEO.TIME_STRIDE_ON is unsupported: the paper keeps full "
                "temporal resolution (no temporal downsampling)")
        if cfg.VIDEO.NUM_FRAMES < 1:
            raise ValueError("VIDEO.NUM_FRAMES must be >= 1")
        if len(cfg.VIDEO.TIME_KERNEL_DIM) != 5:
            raise ValueError("VIDEO.TIME_KERNEL_DIM needs 5 entries "
                             "(conv1, res2..res5)")
    else:
        if cfg.VIDEO.NUM_FRAMES != 1:
            raise ValueError("NUM_FRAMES > 1 requires VIDEO.VIDEO_ON")
    # MULTILEVEL_RPN/ROIS are derived from FPN_ON (the reference's FPN
    # wiring always uses multi-level RPN + RoI distribution; C4 never does).
    if cfg.FPN.MULTILEVEL_RPN != cfg.FPN.FPN_ON:
        cfg = _set_dotted(cfg, "FPN.MULTILEVEL_RPN", cfg.FPN.FPN_ON)
    if cfg.FPN.MULTILEVEL_ROIS != cfg.FPN.FPN_ON:
        cfg = _set_dotted(cfg, "FPN.MULTILEVEL_ROIS", cfg.FPN.FPN_ON)
    if cfg.RESNETS.RES5_DILATION not in (1, 2):
        raise ValueError("RESNETS.RES5_DILATION must be 1 or 2")
    if cfg.RESNETS.RES5_DILATION != 1 and cfg.FPN.FPN_ON:
        raise ValueError("RES5_DILATION changes res5 to stride 16, which "
                         "breaks the FPN level geometry; use it only with "
                         "FPN.FPN_ON=False (the lineage's dilated-C5 use)")
    if cfg.FPN.FPN_ON:
        if cfg.FPN.RPN_MIN_LEVEL > cfg.FPN.RPN_MAX_LEVEL:
            raise ValueError("FPN RPN level range is empty")
        n_lvl = cfg.FPN.RPN_MAX_LEVEL - cfg.FPN.RPN_MIN_LEVEL + 1
        if len(cfg.RPN.SIZES) != n_lvl:
            raise ValueError(
                f"RPN.SIZES has {len(cfg.RPN.SIZES)} entries but FPN spans "
                f"{n_lvl} levels")
    for h, w in cfg.TEST.SHAPE_BUCKETS:
        s = cfg.FPN.COARSEST_STRIDE
        if h % s or w % s:
            raise ValueError(f"SHAPE_BUCKET ({h},{w}) not multiple of {s}")
    if cfg.MODEL.KEYPOINTS_ON and cfg.KRCNN.NUM_KEYPOINTS < 1:
        raise ValueError("KRCNN.NUM_KEYPOINTS must be positive")
    if cfg.TRACKING.DISTANCE_METRIC not in ("bbox-iou", "pose-pckh", "cnn-cosine"):
        raise ValueError(f"Unknown TRACKING.DISTANCE_METRIC "
                         f"{cfg.TRACKING.DISTANCE_METRIC!r}")
    if cfg.TRACKING.BIPARTITE_MATCHING_ALGO not in ("hungarian", "greedy"):
        raise ValueError("TRACKING.BIPARTITE_MATCHING_ALGO must be "
                         "hungarian|greedy")
    return cfg


def load_cfg(yaml_path: Optional[str] = None,
             opts: Sequence[Any] = ()) -> Config:
    """One-shot loader: defaults → YAML → dotted overrides → validate."""
    cfg = Config()
    if yaml_path:
        cfg = merge_cfg_from_file(cfg, yaml_path)
    if opts:
        cfg = merge_cfg_from_list(cfg, list(opts))
    return assert_and_infer_cfg(cfg)


def cfg_to_dict(cfg: Any) -> Any:
    """Config → plain nested dict (for logging / YAML dump)."""
    if dataclasses.is_dataclass(cfg):
        return {f.name: cfg_to_dict(getattr(cfg, f.name))
                for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [cfg_to_dict(v) for v in cfg]
    return cfg
