"""The weight bridge on the model-surface configurations: the RPN-only, C4
(dilated C5 has the same tree) and mask trees map leaf for leaf in both
directions, their shapes are pinned, and a damaged new leaf raises. Also
FPN.EXTRA_CONV_LEVELS (no config sets it): its `fpn/extra_p6` leaf and the
P6 it computes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.models.detector import GeneralizedRCNN
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils.params import (jax_params_to_state_dict,
                                                   state_dict_to_jax_params)
from test_torch_params import _fill, _jax_tree_shapes, _leaves
from test_torch_slice import _pair, both_cfgs

# config → (flax leaves, parameters, top-level modules)
TREES = {
    "rpn_only_proposals": (181, 35_965_475, {"backbone", "fpn", "rpn_head"}),
    "2d_R50_C4_kps": (217, 69_368_996,
                      {"backbone", "rpn_head", "box_head", "kps_head"}),
    "2d_R50_FPN_mask_kps": (219, 61_797_226,
                            {"backbone", "fpn", "rpn_head", "box_head",
                             "kps_head", "mask_head"}),
}


def _tree(name, opts=()):
    """(port config, the JAX model's tree of leaf shapes)."""
    jcfg, cfg = both_cfgs(f"configs/video/{name}.yaml", opts)
    t = cfg.VIDEO.NUM_FRAMES if cfg.VIDEO.VIDEO_ON else 1
    return cfg, _jax_tree_shapes(jcfg, (1, t, 64, 64, 3))


@pytest.mark.parametrize("name", sorted(TREES))
def test_bridge_round_trip_covers_surface_tree(name):
    """Full-size tree: every leaf maps to one port parameter and back, bit
    for bit. RPN_ONLY has no RoI heads (flax never creates them); C4 keeps
    res5 in the backbone (built, never run) and a res4-wide RPN trunk into
    1024 channels."""
    n_leaves, n_params, modules = TREES[name]
    cfg, shapes = _tree(name)
    params = _fill(shapes, np.random.default_rng(0))
    leaves = list(_leaves(params["params"]))
    assert len(leaves) == n_leaves
    assert sum(v.size for _, v in leaves) == n_params
    assert set(params["params"]) == modules
    model = build_model(cfg, device="meta")
    assert {n for n, _ in model.named_children()} == modules
    assert sum(p.numel() for p in model.parameters()) == n_params
    sd = jax_params_to_state_dict(params, model)
    back = dict(_leaves(state_dict_to_jax_params(sd, model)["params"]))
    assert set(back) == {path for path, _ in leaves}
    for path, value in leaves:
        np.testing.assert_array_equal(back[path], value, err_msg=str(path))
    if not cfg.FPN.FPN_ON:
        p = params["params"]
        assert "res5_2" in p["backbone"]
        assert p["rpn_head"]["conv"]["kernel"].shape == (
            1, 3, 3, 1024, 1024)
        assert p["box_head"]["res5_0"]["a"]["conv"]["kernel"].shape[-2] == (
            1024)


@pytest.mark.parametrize("name, damage, match", [
    ("2d_R50_FPN_mask_kps", "drop mask_head/conv5_mask/bias", "conv5_mask"),
    ("2d_R50_C4_kps", "drop box_head/res5_1/b/conv/kernel", "res5_1"),
    ("rpn_only_proposals", "add box_head/fc6/kernel", "box_head"),
])
def test_bridge_raises_on_damaged_surface_leaf(name, damage, match):
    cfg, shapes = _tree(name, ["MODEL.CONV_BODY", "resnet18"])
    params = _fill(shapes, np.random.default_rng(1))
    verb, path = damage.split()
    *parents, leaf = path.split("/")
    node = params["params"]
    for part in parents:
        node = node.setdefault(part, {})
    if verb == "drop":
        del node[leaf]
    else:
        node[leaf] = np.zeros((4, 4), np.float32)
    with pytest.raises(ValueError, match=match):
        jax_params_to_state_dict(params, build_model(cfg, device="meta"))


def test_fpn_extra_conv_levels_matches_jax():
    """P6 as a stride-2 3x3 conv on P5 (in place of the subsample), on a
    3-wide P5, through bridged seeded weights."""
    clip = np.random.default_rng(2).normal(size=(1, 1, 64, 96, 3)).astype(
        np.float32)
    cfg, jm, params, tm = _pair(
        "configs/video/2d_R18_FPN_kps.yaml",
        ["MODEL.COMPUTE_DTYPE", "float32", "FPN.EXTRA_CONV_LEVELS", True,
         "RESNETS.WIDTH_PER_GROUP", 8], clip.shape, seed=4)
    assert "extra_p6" in params["params"]["fpn"]
    want = jm.apply(params, jnp.asarray(clip),
                    method=GeneralizedRCNN.features)
    with torch.no_grad():
        got = tm.features(torch.from_numpy(clip))
    assert tuple(got["p6"].shape) == want["p6"].shape == (1, 1, 1, 2, 256)
    for lvl in ("p5", "p6"):
        np.testing.assert_allclose(got[lvl].numpy(), np.asarray(want[lvl]),
                                   atol=1e-4, rtol=1e-4, err_msg=lvl)
