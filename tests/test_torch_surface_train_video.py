"""One training step of RPN_ONLY and of center-frame keypoint supervision
(VIDEO.PREDICT_ALL_FRAMES=False) against the JAX package's jitted step on
the CPU; see tests/test_torch_surface_train.py for the method and the
tolerances."""

import numpy as np

from test_torch_surface_train import check_one_step


def test_rpn_only_train_step_matches_jax():
    """RPN_ONLY trains the RPN losses alone, and its model has no RoI
    heads (the JAX model never creates them)."""
    model, metrics, grads = check_one_step(
        "configs/video/rpn_only_proposals.yaml", ["VIDEO.NUM_FRAMES", 2])
    assert set(metrics) == {"loss_rpn_cls", "loss_rpn_bbox", "loss_total"}
    assert {k.split(".")[0] for k, _ in model.named_parameters()} == {
        "backbone", "fpn", "rpn_head"}
    assert np.abs(grads["rpn_head/deltas/kernel"]).max() > 0


def test_center_frame_keypoint_train_step_matches_jax():
    """The keypoint head trains on each tube's center frame only."""
    model, metrics, grads = check_one_step(
        "configs/video/3d_R18_T3_center_kps.yaml", [])
    assert float(metrics["loss_kps"]) > 0
