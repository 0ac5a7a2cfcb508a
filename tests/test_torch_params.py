"""The weight bridge between the JAX package's flax tree and the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from detectandtrack_tpu.models.detector import build_model as jax_build
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils.params import (jax_params_to_state_dict,
                                                   state_dict_to_jax_params)
from test_torch_slice import both_cfgs

MAIN_CFG = "configs/video/3d_R50_T8_tubes_kps.yaml"


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _jax_tree_shapes(cfg, clip_shape):
    shapes = jax.eval_shape(jax_build(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros(clip_shape))
    return jax.tree.map(lambda s: tuple(s.shape), shapes,
                        is_leaf=lambda s: hasattr(s, "shape"))


def _fill(shapes, rng):
    return {k: _fill(v, rng) if isinstance(v, dict) else
            rng.standard_normal(v, dtype=np.float32)
            for k, v in shapes.items()}


def test_bridge_round_trip_covers_main_path_tree():
    """Every leaf of the 3D R-50 T=8 keypoint tree (207 leaves, 157.7 M
    params) maps to one port parameter and back, bit for bit."""
    jcfg, cfg = both_cfgs(MAIN_CFG)
    shapes = _jax_tree_shapes(jcfg, (1, 8, 64, 64, 3))
    params = _fill(shapes, np.random.default_rng(0))
    leaves = list(_leaves(params["params"]))
    assert len(leaves) == 207
    assert sum(v.size for _, v in leaves) == 157_665_908

    model = build_model(cfg, device="meta")
    assert sum(p.numel() for p in model.parameters()) == 157_665_908
    sd = jax_params_to_state_dict(params, model)
    assert set(sd) == set(model.state_dict())
    for key, value in model.state_dict().items():
        assert sd[key].shape == value.shape, key
    back = state_dict_to_jax_params(sd, model)
    got = dict(_leaves(back["params"]))
    assert set(got) == {path for path, _ in leaves}
    for path, value in leaves:
        np.testing.assert_array_equal(got[path], value, err_msg=str(path))


def test_bridge_layouts():
    """Conv (t,kh,kw,ci,co) → (co,ci,t,kh,kw); Dense transposed; the
    deconv flipped into torch's (ci,co,kh,kw); conv1 kept canonical."""
    jcfg, cfg = both_cfgs(MAIN_CFG)
    params = _fill(_jax_tree_shapes(jcfg, (1, 8, 64, 64, 3)),
                   np.random.default_rng(1))
    sd = jax_params_to_state_dict(params, build_model(cfg, device="meta"))
    p = params["params"]
    np.testing.assert_array_equal(
        sd["backbone.res2_0.b.conv.weight"].numpy(),
        p["backbone"]["res2_0"]["b"]["conv"]["kernel"].transpose(4, 3, 0, 1,
                                                                 2))
    np.testing.assert_array_equal(sd["box_head.fc7.weight"].numpy(),
                                  p["box_head"]["fc7"]["kernel"].T)
    k = p["kps_head"]["kps_score_lowres"]["kernel"]
    np.testing.assert_array_equal(
        sd["kps_head.kps_score_lowres.weight"].numpy()[5, 7, 0, 3],
        k[3, 0, 5, 7])
    np.testing.assert_array_equal(sd["backbone.conv1.conv.weight"].numpy(),
                                  p["backbone"]["conv1"]["conv"]["kernel"])


@pytest.mark.parametrize("damage", ["drop", "rename", "reshape"])
def test_bridge_raises_on_unmapped_or_unset(damage):
    jcfg, cfg = both_cfgs(opts=["MODEL.CONV_BODY", "resnet18",
                                "MODEL.COMPUTE_DTYPE", "float32",
                                "KRCNN.NUM_STACKED_CONVS", 1,
                                "KRCNN.CONV_HEAD_DIM", 8,
                                "FAST_RCNN.MLP_HEAD_DIM", 16])
    params = _fill(_jax_tree_shapes(jcfg, (1, 1, 64, 64, 3)),
                   np.random.default_rng(2))
    box = params["params"]["box_head"]
    if damage == "drop":
        del box["fc7"]["bias"]
    elif damage == "rename":
        box["fc8"] = box.pop("fc7")
    else:
        box["fc7"]["kernel"] = box["fc7"]["kernel"][:, :-1]
    with pytest.raises(ValueError, match="fc7"):
        jax_params_to_state_dict(params, build_model(cfg, device="meta"))
