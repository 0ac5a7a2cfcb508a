"""The port's 2D → 3D inflation (`models/inflate.py`) and Detectron `.pkl`
import (`utils/detectron_import.py`) against the JAX package's, on the
same weights: seeded flax params bridged into the port. Every result is
held to JAX's bit for bit (inflation and the blob conversion are the same
float32 arithmetic), the reports name the same leaves in the same order,
and `--mode import-weights` writes the same `.npz` key for key. Also the
port's versions of tests/test_detectron_import.py and of the inflation
tests of tests/test_models.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.cli import launch as jlaunch
from detectandtrack_tpu.models import backbone as jbackbone
from detectandtrack_tpu.models import inflate as jinflate
from detectandtrack_tpu.models.detector import build_model as jax_build
from detectandtrack_tpu.utils import detectron_import as jdi
from detectandtrack_tpu_torch.cli import launch as tlaunch
from detectandtrack_tpu_torch.models import backbone as tbackbone
from detectandtrack_tpu_torch.models import inflate as tinflate
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.ops.keypoints import (COCO_KEYPOINTS,
                                                    POSETRACK_KEYPOINTS)
from detectandtrack_tpu_torch.utils import detectron_import as tdi
from detectandtrack_tpu_torch.utils.params import (jax_params_to_state_dict,
                                                   state_dict_to_jax_params)
from test_torch_slice import _random_params, both_cfgs

_TINY = ["MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
         "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
         "TEST.DETECTIONS_PER_IM", 4, "KRCNN.NUM_STACKED_CONVS", 2,
         "KRCNN.CONV_HEAD_DIM", 32, "TEST.SHAPE_BUCKETS", "[[64, 64]]"]
_VIDEO = ["VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
          "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]"]
_RESNEXT = ["MODEL.CONV_BODY", "resnet50", "MODEL.COMPUTE_DTYPE", "float32",
            "RESNETS.NUM_GROUPS", 2, "RESNETS.WIDTH_PER_GROUP", 4,
            "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
            "TEST.DETECTIONS_PER_IM", 4, "KRCNN.NUM_STACKED_CONVS", 2,
            "KRCNN.CONV_HEAD_DIM", 32, "TEST.SHAPE_BUCKETS", "[[64, 64]]"]
_C4_VIDEO = ["MODEL.CONV_BODY", "resnet50", "MODEL.COMPUTE_DTYPE", "float32",
             "MODEL.KEYPOINTS_ON", False, "FPN.FPN_ON", False,
             "FAST_RCNN.ROI_BOX_HEAD", "res5_head", "VIDEO.VIDEO_ON", True,
             "VIDEO.NUM_FRAMES", 3, "VIDEO.TIME_KERNEL_DIM",
             "[1, 1, 1, 1, 1]", "RPN.SIZES", "[32, 64, 128, 256, 512]",
             "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
             "TEST.DETECTIONS_PER_IM", 4, "TEST.SHAPE_BUCKETS", "[[64, 64]]"]


def _model(opts, seed):
    """(JAX cfg, flax params, port cfg, port model with those params)."""
    jcfg, cfg = both_cfgs(opts=opts)
    t = jcfg.VIDEO.NUM_FRAMES if jcfg.VIDEO.VIDEO_ON else 1
    shapes = jax.eval_shape(jax_build(jcfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, t, 64, 64, 3), jnp.float32))
    shapes = jax.tree.map(lambda s: tuple(s.shape), shapes,
                          is_leaf=lambda s: hasattr(s, "shape"))
    params = _random_params(shapes, np.random.default_rng(seed))
    model = build_model(cfg, device="cpu", seed=seed)
    model.load_state_dict(jax_params_to_state_dict(params, model))
    return jcfg, params, cfg, model


@pytest.fixture(scope="module")
def m2d():
    return _model(_TINY, 0)


@pytest.fixture(scope="module")
def m3d():
    return _model(_TINY + _VIDEO, 1)


def _assert_state_equal(got, model, want_params):
    """A port state_dict equals JAX's flax params (bridged) bit for bit."""
    want = jax_params_to_state_dict(want_params, model)
    assert set(got) == set(want)
    for key in want:
        torch.testing.assert_close(got[key], want[key], rtol=0, atol=0,
                                   msg=key)


def _assert_blobs_equal(got, want):
    assert list(got) == list(want)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def _flax(model):
    return state_dict_to_jax_params(model.state_dict(), model)


def test_blob_name_derivation(m2d, m3d):
    """The explicit names of tests/test_detectron_import.py, then every
    leaf of the 2D, 3D, ResNeXt and C4 models: the port's candidates equal
    JAX's."""
    bc = tdi.blob_candidates
    assert bc(("backbone", "res2_0", "a", "conv", "kernel"),
              "resnet50") == ["res2_0_branch2a_w"]
    assert bc(("backbone", "res3_1", "proj", "bn", "scale"),
              "resnet50") == ["res3_1_branch1_bn_s"]
    assert bc(("backbone", "conv1", "bn", "bias"),
              "resnet50") == ["res_conv1_bn_b"]
    assert bc(("fpn", "lateral_res5", "kernel"),
              "resnet50") == ["fpn_inner_res5_2_sum_w"]
    assert bc(("fpn", "lateral_res4", "kernel"),
              "resnet101") == ["fpn_inner_res4_22_sum_lateral_w"]
    assert bc(("fpn", "posthoc_p3", "bias"), "resnet50") == ["fpn_res3_3_sum_b"]
    assert "conv_rpn_fpn2_w" in bc(("rpn_head", "conv", "kernel"),
                                   "resnet50")
    assert bc(("box_head", "fc6", "kernel"), "resnet50") == ["fc6_w"]
    assert bc(("kps_head", "kps_score_lowres", "kernel"),
              "resnet50")[0] == "kps_score_lowres_w"
    assert "_[mask]_fcn1_w" in bc(("mask_head", "mask_fcn1", "kernel"),
                                  "resnet50")
    models = [m2d[3], m3d[3]] + [
        build_model(both_cfgs(opts=o)[1], device="cpu")
        for o in (_RESNEXT, _C4_VIDEO, _TINY + ["MODEL.MASK_ON", True])]
    for model in models:
        body = model.cfg.MODEL.CONV_BODY
        for names, _ in tdi._leaves(_flax(model)["params"]):
            assert bc(names, body) == jdi.blob_candidates(names, body), names


def test_round_trip_2d(m2d):
    """export → import reproduces every parameter exactly (2D model); the
    blobs, the imported state and the report equal JAX's."""
    jcfg, params, cfg, model = m2d
    blobs = tdi.flax_params_to_blobs(_flax(model), cfg)
    _assert_blobs_equal(blobs, jdi.flax_params_to_blobs(params, jcfg))
    fresh = build_model(cfg, device="cpu", seed=9)
    got, report = tdi.import_detectron_weights(blobs, fresh, cfg,
                                               strict=True)
    assert not report["missing"] and not report["unused"]
    _assert_state_equal(got, model, params)
    want, want_report = jdi.import_detectron_weights(
        blobs, jax.tree.map(np.zeros_like, params), jcfg, strict=True)
    assert report == want_report
    _assert_state_equal(got, model, want)


def test_pkl_file_round_trip(m2d, tmp_path):
    """The port's `.pkl` holds JAX's blobs (Caffe2 OIHW conv1); each
    package reads the other's file."""
    jcfg, params, cfg, model = m2d
    path, jpath = str(tmp_path / "port.pkl"), str(tmp_path / "jax.pkl")
    tdi.save_detectron_pkl(path, model, cfg)
    jdi.save_detectron_pkl(jpath, params, jcfg)
    blobs = tdi.load_detectron_pkl(path)
    assert blobs["conv1_w"].shape == (64, 3, 7, 7)
    _assert_blobs_equal(blobs, jdi.load_detectron_pkl(jpath))
    _assert_blobs_equal(jdi.load_detectron_pkl(path),
                        tdi.load_detectron_pkl(jpath))
    got, report = tdi.import_detectron_weights(
        jpath, build_model(cfg, device="cpu", seed=9), cfg, strict=True)
    assert not report["missing"]
    _assert_state_equal(got, model, params)


def test_import_2d_blobs_into_3d_model(m2d, m3d):
    """2D .pkl → 3D model: mean inflation and the per-frame regressor
    surgery, equal to JAX's import into the same template."""
    jcfg2, params2, cfg2, model2 = m2d
    jcfg3, params3, cfg3, model3 = m3d
    blobs = tdi.flax_params_to_blobs(_flax(model2), cfg2)
    got, report = tdi.import_detectron_weights(blobs, model3, cfg3)
    assert not report["missing"], report["missing"]
    want, want_report = jdi.import_detectron_weights(blobs, params3, jcfg3)
    assert report == want_report
    _assert_state_equal(got, model3, want)
    # conv1: (1,7,7,3,64) → (3,7,7,3,64), repeat / 3 (mean init), in the
    # canonical layout the conv1 kernel reads.
    k2 = model2.state_dict()["backbone.conv1.conv.weight"]
    k3 = got["backbone.conv1.conv.weight"]
    assert tuple(k3.shape) == (3, 7, 7, 3, 64)
    torch.testing.assert_close(k3, k2.repeat(3, 1, 1, 1, 1) / 3.0)
    # t=1 stages copy through unchanged.
    key = "backbone.res2_0.a.conv.weight"
    torch.testing.assert_close(got[key], model2.state_dict()[key], rtol=0,
                               atol=0)
    # fc6: input grows P·P·C → T·P·P·C, tiled / T (Linear: (out, in)).
    f2 = model2.state_dict()["box_head.fc6.weight"]
    f3 = got["box_head.fc6.weight"]
    assert f3.shape[1] == 2 * f2.shape[1]
    torch.testing.assert_close(f3, torch.cat([f2 / 2, f2 / 2], dim=1))
    assert any("rpn_head/deltas" in s for s in report["surgery"])
    assert any("bbox_pred" in s for s in report["surgery"])


def test_coco_head_surgery(m2d):
    """COCO-17 keypoints + 81 classes → PoseTrack-15 + 2 classes, equal to
    JAX's on the same blobs and template."""
    jcfg, params, cfg, model = m2d
    blobs = tdi.flax_params_to_blobs(_flax(model), cfg)
    rng = np.random.default_rng(0)
    ci = blobs["kps_score_lowres_w"].shape[0]
    blobs["kps_score_lowres_w"] = rng.normal(
        size=(ci, 17, 4, 4)).astype(np.float32)
    blobs["kps_score_lowres_b"] = rng.normal(size=(17,)).astype(np.float32)
    hid = blobs["cls_score_w"].shape[1]
    blobs["cls_score_w"] = rng.normal(size=(81, hid)).astype(np.float32)
    blobs["cls_score_b"] = rng.normal(size=(81,)).astype(np.float32)
    blobs["bbox_pred_w"] = rng.normal(size=(324, hid)).astype(np.float32)
    blobs["bbox_pred_b"] = rng.normal(size=(324,)).astype(np.float32)
    got, report = tdi.import_detectron_weights(blobs, model, cfg)
    want, want_report = jdi.import_detectron_weights(blobs, params, jcfg)
    assert len(report["surgery"]) >= 4
    assert report == want_report
    _assert_state_equal(got, model, want)
    # The port's ConvTranspose2d weight is Caffe2's (ci, co, kh, kw) deconv
    # blob itself; joints map by name, head_bottom / head_top keep the
    # template's values.
    ks = got["kps_head.kps_score_lowres.weight"]
    before = model.state_dict()["kps_head.kps_score_lowres.weight"]
    mapped = 0
    for pi, name in enumerate(POSETRACK_KEYPOINTS):
        if name in COCO_KEYPOINTS:
            src = blobs["kps_score_lowres_w"][:, COCO_KEYPOINTS.index(name)]
            np.testing.assert_array_equal(ks[:, pi].numpy(), src)
            mapped += 1
        else:
            torch.testing.assert_close(ks[:, pi], before[:, pi], rtol=0,
                                       atol=0)
    assert mapped == 13
    cs = got["box_head.cls_score.weight"]                 # (2, hid)
    np.testing.assert_array_equal(cs.numpy(), blobs["cls_score_w"][:2])


def test_deconv_semantics_vs_torch(m2d):
    """The imported keypoint deconv computes Caffe2's deconvolution (torch's
    conv_transpose2d of the blob, stride 2, pad 1)."""
    _, _, cfg, model = m2d
    blobs = tdi.flax_params_to_blobs(_flax(model), cfg)
    rng = np.random.default_rng(0)
    w = rng.normal(size=blobs["kps_score_lowres_w"].shape).astype(np.float32)
    blobs["kps_score_lowres_w"] = w
    got, _ = tdi.import_detectron_weights(blobs, model, cfg)
    fresh = build_model(cfg, device="cpu")
    fresh.load_state_dict(got)
    deconv = fresh.kps_head.kps_score_lowres
    x = torch.from_numpy(rng.normal(size=(1, w.shape[0], 6, 6)).astype(
        np.float32))
    with torch.no_grad():
        y = deconv(x) - deconv.bias[:, None, None]
    ref = torch.nn.functional.conv_transpose2d(x, torch.from_numpy(w),
                                               stride=2, padding=1)
    torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-5)


def test_round_trip_resnext():
    """Grouped (ResNeXt) conv kernels survive export → import exactly, as
    in JAX."""
    jcfg, params, cfg, model = _model(_RESNEXT, 2)
    assert model.state_dict()["backbone.res2_0.b.conv.weight"].shape[1] == 4
    blobs = tdi.flax_params_to_blobs(_flax(model), cfg)
    _assert_blobs_equal(blobs, jdi.flax_params_to_blobs(params, jcfg))
    got, report = tdi.import_detectron_weights(
        blobs, build_model(cfg, device="cpu", seed=9), cfg, strict=True)
    assert not report["missing"]
    _assert_state_equal(got, model, params)


def test_c4_video_fc_inflation():
    """A 2D COCO checkpoint into a C4 (res5 head) video model: the
    cls/bbox FC input rows are mean-tiled over T, as in JAX."""
    jcfg, params, cfg, model = _model(_C4_VIDEO, 3)
    rng = np.random.default_rng(0)
    blobs = {
        "cls_score_w": rng.normal(size=(81, 2048)).astype(np.float32),
        "cls_score_b": rng.normal(size=(81,)).astype(np.float32),
        "bbox_pred_w": rng.normal(size=(324, 2048)).astype(np.float32),
        "bbox_pred_b": rng.normal(size=(324,)).astype(np.float32),
    }
    got, report = tdi.import_detectron_weights(blobs, model, cfg)
    want, want_report = jdi.import_detectron_weights(blobs, params, jcfg)
    assert any("FC input rows inflated" in s for s in report["surgery"])
    assert report == want_report
    _assert_state_equal(got, model, want)
    cs = got["box_head.cls_score.weight"]                 # (2, 3·2048)
    x2d = rng.normal(size=(2048,)).astype(np.float32)
    np.testing.assert_allclose(np.tile(x2d, 3) @ cs[1].numpy(),
                               x2d @ blobs["cls_score_w"][1], rtol=1e-4)


def test_cli_import_weights_equals_jax(m2d, tmp_path):
    """`--mode import-weights` of a 2D `.pkl` into the 3D config: the port's
    `imported_weights.npz` equals the JAX CLI's key for key, bit for bit."""
    _, _, cfg2, model2 = m2d
    pkl = str(tmp_path / "r18_2d.pkl")
    tdi.save_detectron_pkl(pkl, model2, cfg2)
    yaml = tmp_path / "tiny3d.yaml"
    yaml.write_text("MODEL:\n  TYPE: generalized_rcnn\n")
    opts = ["--cfg", str(yaml)] + [str(x) for x in _TINY + _VIDEO]

    def zeros_template(cfg, weights, seed=0):
        model = jax_build(cfg)
        shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, 2, 64, 64, 3), jnp.float32))
        return model, jax.tree.map(
            lambda s: np.zeros(s.shape, s.dtype), shapes,
            is_leaf=lambda s: hasattr(s, "shape"))

    mp = pytest.MonkeyPatch()
    mp.setattr(jlaunch, "_init_model", zeros_template)
    try:
        jlaunch.main(["--mode", "import-weights", "--weights", pkl,
                      "--out", str(tmp_path / "jax")] + opts)
    finally:
        mp.undo()
    out = tlaunch.main(["--mode", "import-weights", "--weights", pkl,
                        "--device", "cpu", "--out", str(tmp_path / "port")]
                       + opts)
    assert out == str(tmp_path / "port" / "imported_weights.npz")
    with np.load(out) as a, np.load(
            tmp_path / "jax" / "imported_weights.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- inflation (the port's versions of tests/test_models.py's) -------------

def _conv_affine_pair(features, kernel, cin, seed):
    """(flax params, port ConvAffine holding them) for one conv → affine."""
    jm = jbackbone.ConvAffine(features, kernel=kernel)
    t = kernel[0]
    p = jm.init(jax.random.PRNGKey(seed), jnp.ones((1, t, 8, 8, cin)))
    p = jax.tree.map(np.asarray, p)
    tm = tbackbone.ConvAffine(cin, features, kernel)
    tm.load_state_dict(jax_params_to_state_dict(p, tm))
    return jm, p, tm


def test_inflation_identity_on_constant_clip():
    """A mean-inflated t=3 conv reproduces the 2D output on a time-constant
    clip away from the temporal padding; the inflated state equals JAX's
    inflation bit for bit."""
    jm2, p2, m2 = _conv_affine_pair(16, (1, 3, 3), 8, 0)
    jm3, p3, m3 = _conv_affine_pair(16, (3, 3, 3), 8, 1)
    sd = tinflate.inflate_params(m2.state_dict(), m3.state_dict(),
                                 mode="mean")
    want = jinflate.inflate_params(p2, p3, mode="mean")
    _assert_state_equal(sd, m3, jax.tree.map(np.asarray, want))
    m3.load_state_dict(sd)
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(rng.normal(size=(1, 1, 16, 16, 8)).astype(
        np.float32))
    clip = frame.repeat(1, 5, 1, 1, 1)
    with torch.no_grad():
        out2, out3 = m2(frame), m3(clip)
    for t in (1, 2, 3):
        torch.testing.assert_close(out3[:, t], out2[:, 0], rtol=1e-5,
                                   atol=1e-5)
    assert not torch.allclose(out3[:, 0], out2[:, 0], atol=1e-3)


def test_inflation_center_mode():
    jm2, p2, m2 = _conv_affine_pair(4, (1, 3, 3), 2, 0)
    jm3, p3, m3 = _conv_affine_pair(4, (3, 3, 3), 2, 1)
    sd = tinflate.inflate_params(m2.state_dict(), m3.state_dict(),
                                 mode="center")
    _assert_state_equal(sd, m3, jax.tree.map(np.asarray, jinflate.
                                             inflate_params(p2, p3,
                                                            mode="center")))
    k3 = sd["conv.weight"]                              # (co, ci, t, kh, kw)
    assert not k3[:, :, 0].any() and not k3[:, :, 2].any()
    torch.testing.assert_close(k3[:, :, 1], m2.conv.weight[:, :, 0],
                               rtol=0, atol=0)


def test_inflation_rejects_mismatched_tree():
    _, _, m2 = _conv_affine_pair(4, (1, 3, 3), 2, 0)
    _, _, m3 = _conv_affine_pair(8, (3, 3, 3), 2, 1)
    with pytest.raises(ValueError, match="Cannot inflate"):
        tinflate.inflate_params(m2.state_dict(), m3.state_dict())
    with pytest.raises(ValueError, match="differ"):
        tinflate.inflate_params({"x": torch.zeros(1)}, m3.state_dict())


@pytest.mark.parametrize("mode", ["mean", "center"])
def test_inflate_whole_model_report_equals_jax(mode):
    """The 2D R-18 FPN model onto the 3D T=2 model with t=3 kernels in
    conv1 and res2–res4: conv1 (time axis 0) and the Conv3d kernels (time
    axis 2) inflate as JAX's flax kernels do, and the non-strict report
    keeps the same T-sized heads (fc6, the tube deltas)."""
    video = ["VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
             "VIDEO.TIME_KERNEL_DIM", "[3, 3, 3, 3, 1]"]
    _, p2, _, m2 = _model(_TINY, 4)
    _, p3, _, m3 = _model(_TINY + video, 5)
    sd, skipped = tinflate.inflate_params_report(
        m2.state_dict(), m3.state_dict(), mode=mode)
    want, want_skipped = jinflate.inflate_params_report(p2, p3, mode=mode)
    _assert_state_equal(sd, m3, jax.tree.map(np.asarray, want))
    assert sorted(skipped) == sorted(
        ".".join(k.strip("[]'") for k in s.split("][")[1:]).replace(
            ".kernel", ".weight") for s in want_skipped)
    assert {"box_head.fc6.weight", "rpn_head.deltas.weight"} <= set(skipped)
    assert tinflate.time_axis("backbone.conv1.conv.weight") == 0
    assert sd["backbone.res3_0.b.conv.weight"].shape[2] == 3
    with pytest.raises(ValueError, match="Cannot inflate"):
        tinflate.inflate_params(m2.state_dict(), m3.state_dict(), mode=mode)
