"""The main-path model (3D R-50 T=8) at a small bucket with narrow heads,
against the JAX model with bridged weights on the CPU."""

import jax.numpy as jnp
import numpy as np
import torch

from detectandtrack_tpu.models.detector import GeneralizedRCNN
from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
from test_torch_slice import _compare_outputs, _pair

MAIN_CFG = "configs/video/3d_R50_T8_tubes_kps.yaml"
R50_OPTS = [
    "MODEL.COMPUTE_DTYPE", "float32", "TEST.SHAPE_BUCKETS", "[[64, 96]]",
    "RPN.PRE_NMS_TOP_N_TEST", 128, "RPN.POST_NMS_TOP_N_TEST", 32,
    "TEST.DETECTIONS_PER_IM", 12, "TEST.SCORE_THRESH", 0.0,
    "KRCNN.MAX_ROIS_PER_IM", 5, "KRCNN.NUM_STACKED_CONVS", 2,
    "KRCNN.CONV_HEAD_DIM", 16, "FAST_RCNN.MLP_HEAD_DIM", 64,
]


def test_r50_t8_small_clip_both_entry_points():
    """The main-path model at a small bucket: __call__ and
    detect_with_proposals(run_rpn=True) with realistic tubes."""
    clip = np.random.default_rng(7).normal(size=(1, 8, 64, 96, 3)).astype(
        np.float32)
    cfg, jm, params, tm = _pair(MAIN_CFG, R50_OPTS, clip.shape, seed=3)
    tubes = make_realistic_tubes(1, 32, 8, 64, 96, seed=1)
    jout = jm.apply(params, jnp.asarray(clip))
    jprop = jm.apply(params, jnp.asarray(clip), jnp.asarray(tubes), True,
                     method=GeneralizedRCNN.detect_with_proposals)
    with torch.no_grad():
        tout = tm(torch.from_numpy(clip))
        tprop = tm.detect_with_proposals(torch.from_numpy(clip),
                                         torch.from_numpy(tubes), True)
    assert tuple(tout["keypoints"].shape) == (1, 12, 8, 15, 4)
    _compare_outputs(jout, tout)
    _compare_outputs(jprop, tprop)
