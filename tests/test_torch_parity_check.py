"""The port's parity tool (`detectandtrack_tpu_torch/tools/parity_check.py`)
against the JAX package's (`tools/parity_check.py`, imported as shipped)
on the same files, on the CPU: a tiny R-18 T=2 f32 config (the settings of
tests/test_torch_cli.py's TINY) written as a YAML, a Detectron `.pkl` of
seeded params written by both packages' `save_detectron_pkl` (equal blob
for blob), and a synthetic PoseTrack-format val set. The params' box
regressions (RPN deltas, box head bbox_pred) are zero, so the detections
are anchors: with random regressions the tiny model emits boxes ~2e-5 px
high, whose IoU drops to 0.71 under the 4e-5 px by which the two
packages' CPU convs round apart, and the diff's IoU would measure that
instead of the tool. Both tools print the
same metrics JSON. The diff against a Detectron `detections.pkl` rewritten
from the JAX tool's own `--det-out` gives mean best IoU 1 and a keypoint
pixel delta of 0, for the JAX tool and for the port's.

The JAX tool runs once per file (module fixture). Its CLI's `_init_model`
runs flax's eager init (over a minute on a CPU) only to replace every leaf;
the fixture gives it `jax.eval_shape`'s template instead, as
tests/test_torch_cli.py does, and the rest runs as shipped."""

import argparse
import ast
import contextlib
import importlib.util
import io
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from detectandtrack_tpu.cli import launch as jlaunch
from detectandtrack_tpu.core.config import load_cfg as jax_load_cfg
from detectandtrack_tpu.data.synthetic import generate_synthetic_posetrack
from detectandtrack_tpu.models.detector import build_model as jax_build
from detectandtrack_tpu.utils import detectron_import as jdi
from detectandtrack_tpu.utils.checkpoint import (load_weights_npz as
                                                 jax_load_npz)
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.tools import parity_check as tparity
from detectandtrack_tpu_torch.utils import detectron_import as tdi
from detectandtrack_tpu_torch.utils.params import jax_params_to_state_dict
from test_torch_cli import TINY
from test_torch_slice import _random_params

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_parity_check", os.path.join(REPO, "tools", "parity_check.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tiny_yaml(path):
    """TINY's dotted opts as a nested YAML (the tools pass only --cfg);
    TEST.DATASETS is the tools' own `parity_val`."""
    tree = {"MODEL": {"TYPE": "generalized_rcnn"}}
    for key, value in zip(TINY[::2], TINY[1::2]):
        if key == "TEST.DATASETS":
            continue
        if isinstance(value, str) and value.startswith("["):
            value = ast.literal_eval(value)
        sec, name = key.split(".")
        tree.setdefault(sec, {})[name] = value
    path.write_text(yaml.safe_dump(tree))
    return str(path)


def _template(cfg):
    model = jax_build(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 64, 96, 3), jnp.float32))
    return model, shapes


def _zero_box_regression(tree, path=()):
    """Every box regression zeroed: the RPN's deltas and the box head's
    bbox_pred."""
    if isinstance(tree, dict):
        return {k: _zero_box_regression(v, path + (k,))
                for k, v in tree.items()}
    zero = "bbox_pred" in path or ("rpn_head" in path and "deltas" in path)
    return np.zeros_like(tree) if zero else tree


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The YAML, the `.pkl` (equal from both packages), the val set, and
    the JAX tool's run: its printed JSON and its `our_dets.pkl` rewritten
    as a Detectron `detections.pkl`."""
    root = tmp_path_factory.mktemp("parity")
    cfg_path = _tiny_yaml(root / "tiny.yaml")
    frames = root / "val"
    ann = generate_synthetic_posetrack(
        str(frames), num_videos=2, frames_per_video=3, image_hw=(64, 96),
        seed=11, hard=True, json_name="val.json")

    jcfg = jax_load_cfg(cfg_path)
    _, shapes = _template(jcfg)
    params = _random_params(
        jax.tree.map(lambda s: tuple(s.shape), shapes,
                     is_leaf=lambda s: hasattr(s, "shape")),
        np.random.default_rng(0))
    params = _zero_box_regression(params)
    pkl, port_pkl = str(root / "model.pkl"), str(root / "port_model.pkl")
    jdi.save_detectron_pkl(pkl, params, jcfg)
    cfg = load_cfg(cfg_path)
    model = build_model(cfg, device="cpu", seed=1)
    model.load_state_dict(jax_params_to_state_dict(params, model))
    tdi.save_detectron_pkl(port_pkl, model, cfg)
    with open(pkl, "rb") as f, open(port_pkl, "rb") as g:
        blobs, port_blobs = pickle.load(f)["blobs"], pickle.load(g)["blobs"]
    assert sorted(blobs) == sorted(port_blobs)
    for name in blobs:
        np.testing.assert_array_equal(port_blobs[name], blobs[name], name)

    # The JAX tool writes --det-out only with --ref-dets: its first run
    # diffs against an empty Detectron file.
    empty = str(root / "empty_dets.pkl")
    with open(empty, "wb") as f:
        pickle.dump({"all_boxes": [[], []], "all_keyps": [[], []]}, f)
    jout = str(root / "jax")
    argv = ["--pkl", pkl, "--ann", ann, "--frames", str(frames),
            "--cfg", cfg_path]

    def init_from_template(cfg, weights_path, seed=0):
        model, tpl = _template(cfg)
        if weights_path:
            return model, jax_load_npz(weights_path, tpl)
        return model, jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), tpl,
                                   is_leaf=lambda s: hasattr(s, "shape"))

    mp = pytest.MonkeyPatch()
    mp.setattr(jlaunch, "_init_model", init_from_template)
    mp.setattr(sys, "argv", ["parity_check.py"] + argv + [
        "--out", jout, "--ref-dets", empty])
    try:
        with contextlib.redirect_stdout(io.StringIO()) as printed:
            rc = _jax_tool().main()
    finally:
        mp.undo()
    jax_json = tparity.printed_reports(printed.getvalue())
    with open(os.path.join(jout, "our_dets.pkl"), "rb") as f:
        ref = tparity.to_detectron_detections(pickle.load(f))
    ref_path = str(root / "detections.pkl")
    with open(ref_path, "wb") as f:
        pickle.dump(ref, f)
    return {"argv": argv, "root": root, "jax_out": jout, "jax_rc": rc,
            "jax_json": jax_json, "ref": ref_path}


@pytest.fixture(scope="module")
def port_run(files):
    """The port's tool on the CPU on the same files, diffing against the
    Detectron rewrite of the JAX tool's detections → (rc, printed JSON)."""
    out = str(files["root"] / "port")
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        rc = tparity.main(files["argv"] + ["--out", out, "--device", "cpu",
                                           "--ref-dets", files["ref"]])
    return rc, tparity.printed_reports(printed.getvalue())


def test_port_tool_prints_the_jax_tools_metrics(files, port_run):
    """The same metrics JSON (mAP, MOTA, their deltas against the targets)
    and the same exit code."""
    rc, printed = port_run
    assert len(printed) == 2 and len(files["jax_json"]) == 2
    assert printed[0] == files["jax_json"][0]
    assert printed[0]["mAP"] is not None and rc == files["jax_rc"]


def test_diff_against_the_jax_detections_is_exact(files, port_run):
    """The Detectron rewrite of the JAX tool's `--det-out`, diffed by the
    JAX tool against its own detections and by the port's tool against
    the port's: every frame compared, mean best IoU 1, pixel delta 0."""
    args = argparse.Namespace(ref_dets=files["ref"], out=files["jax_out"])
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        _jax_tool()._diff_against_reference(args)
    want = {"ref_images_compared": 6, "mean_best_iou": 1.0,
            "mean_kp_px_delta": 0.0}
    assert tparity.printed_reports(printed.getvalue()) == [want]
    assert port_run[1][1] == want


def test_tool_stops_without_a_card_unless_asked_for_the_cpu(tmp_path):
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="no CUDA device"):
        tparity.main(["--pkl", "x.pkl", "--ann", "a.json", "--frames", ".",
                      "--out", str(out)])
    assert not out.exists()
