"""The port's CLI against the JAX package's on one `.npz` of weights, on the
CPU: `--mode test` then `--mode track` over a generated hard synthetic set
give the same per-frame detections (scores 1e-4, boxes and keypoints
1e-2, appearance features 1e-3 of their largest entry, on valid rows), the
same `detection_metrics.json` and the same `track_metrics.json` (MOTP to
1e-5); `--mode eval` scores the written tracks as `track`
did. The weights are seeded random flax params of the tiny R-18 T=2 f32
model, saved with the JAX package's `save_weights_npz` and passed to both
CLIs through `--weights`. Also: the `.npz` round trip between the
packages, `--subprocess-shards` and `--vis`, and the mode the port does
not have (`bench`).

The JAX CLI runs once per file (module fixture). Its `_init_model` runs
flax's eager `model.init` only to replace every leaf by the `.npz`, which
takes over a minute on a CPU; the fixture gives it the same template from
`jax.eval_shape` instead, and the rest of the JAX CLI runs as shipped."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectandtrack_tpu.cli import launch as jlaunch
from detectandtrack_tpu.core.config import load_cfg as jax_load_cfg
from detectandtrack_tpu.data.synthetic import generate_synthetic_posetrack
from detectandtrack_tpu.models.detector import build_model as jax_build
from detectandtrack_tpu.utils.checkpoint import (load_weights_npz as
                                                 jax_load_npz)
from detectandtrack_tpu.utils.checkpoint import (save_weights_npz as
                                                 jax_save_npz)
from detectandtrack_tpu_torch.cli import launch as tlaunch
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils.checkpoint import (load_weights_npz,
                                                       save_weights_npz)
from detectandtrack_tpu_torch.utils.io import load_object
from detectandtrack_tpu_torch.utils.params import jax_params_to_state_dict
from test_torch_slice import _random_params

TINY = ["MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
        "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "RPN.PRE_NMS_TOP_N_TEST", 50, "RPN.POST_NMS_TOP_N_TEST", 16,
        "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
        "TEST.SCALE", 64, "TEST.MAX_SIZE", 96,
        "TEST.SHAPE_BUCKETS", "[[64, 96]]",
        "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 32,
        "TEST.DATASETS", "[posetrack_synthetic_hard_val]",
        "TRACKING.CONF_FILTER_INITIAL_DETS", 0.3]


def _template(cfg):
    model = jax_build(cfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 2, 64, 96, 3), jnp.float32))
    return model, shapes


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The set (3 videos: 5, 5 and 3 frames at 64x96), the weights, the
    opts, and the JAX CLI's test + track outputs."""
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    generate_synthetic_posetrack(
        str(data / "synthetic_hard"), num_videos=2, frames_per_video=5,
        image_hw=(64, 96), seed=11, hard=True, json_name="a.json")
    generate_synthetic_posetrack(
        str(data / "synthetic_hard"), num_videos=1, frames_per_video=3,
        image_hw=(64, 96), seed=12, hard=True, json_name="b.json",
        video_prefix="short")
    docs = [json.loads((data / "synthetic_hard" / n).read_text())
            for n in ("a.json", "b.json")]
    off = max(im["id"] for im in docs[0]["images"])
    for im in docs[1]["images"]:
        im["id"] += off
    for an in docs[1]["annotations"]:
        an["image_id"] += off
    for key in ("images", "annotations"):
        docs[0][key] += docs[1][key]
    (data / "synthetic_hard" / "val.json").write_text(json.dumps(docs[0]))

    # The JAX CLI applies the dotted opts only on top of a --cfg file.
    yaml = root / "tiny.yaml"
    yaml.write_text("MODEL:\n  TYPE: generalized_rcnn\n")
    opts = ["--cfg", str(yaml)] + [str(x) for x in TINY + ["DATA.ROOT", data]]
    model, shapes = _template(jax_load_cfg(str(yaml), opts=opts[2:]))
    params = _random_params(
        jax.tree.map(lambda s: tuple(s.shape), shapes,
                     is_leaf=lambda s: hasattr(s, "shape")),
        np.random.default_rng(0))
    weights = str(root / "model_final.npz")
    jax_save_npz(weights, params)

    def init_from_template(cfg, weights_path, seed=0):
        return model, jax_load_npz(weights_path, _template(cfg)[1])

    mp = pytest.MonkeyPatch()
    mp.setattr(jlaunch, "_init_model", init_from_template)
    try:
        for mode in ("test", "track"):
            jlaunch.main(["--mode", mode, "--weights", weights,
                          "--out", str(root / "jax")] + opts)
    finally:
        mp.undo()
    return {"root": root, "weights": weights, "opts": opts,
            "params": params, "jax": root / "jax"}


@pytest.fixture(scope="module")
def port_out(run):
    out = run["root"] / "port"
    for mode in ("test", "track", "eval"):
        tlaunch.main(["--mode", mode, "--device", "cpu", "--batch-size", "3",
                      "--weights", run["weights"], "--out", str(out)]
                     + run["opts"])
    return out


def _json(path):
    with open(path) as f:
        return json.load(f)


def test_cli_test_mode_detections_equal_jax(run, port_out):
    want = load_object(str(run["jax"] / "detections.pkl"))
    got = load_object(str(port_out / "detections.pkl"))
    assert list(got) == list(want) == ["short_0000", "video_0000",
                                       "video_0001"]
    n_valid = 0
    for vid in want:
        assert len(got[vid]) == len(want[vid]) == (3 if vid[0] == "s" else 5)
        for g, w in zip(got[vid], want[vid]):
            assert set(g) == set(w)
            np.testing.assert_array_equal(g["valid"], w["valid"])
            v = w["valid"]
            n_valid += int(v.sum())
            np.testing.assert_allclose(g["scores"][v], w["scores"][v],
                                       atol=1e-4)
            np.testing.assert_allclose(g["boxes"][v], w["boxes"][v],
                                       atol=1e-2)
            np.testing.assert_allclose(g["keypoints"][v], w["keypoints"][v],
                                       atol=1e-2)
            # fc7 of real pixel values (not unit noise) reaches ~500;
            # measured 1.3e-4 of the largest entry.
            np.testing.assert_allclose(
                g["features"][v], w["features"][v],
                atol=1e-3 * max(1.0, np.abs(w["features"]).max()))
    assert n_valid > 0


def test_cli_metrics_equal_jax(run, port_out):
    """Equal, but MOTP: the mean distance of matched joints moves with the
    keypoints' float rounding (1e-4 px), so it is held to 1e-5."""
    for name in ("detection_metrics.json", "track_metrics.json"):
        got, want = _json(port_out / name), _json(run["jax"] / name)
        assert set(got) == set(want)
        motp = (got.pop("MOTP", 0.0), want.pop("MOTP", 0.0))
        assert got == want, name
        assert abs(motp[0] - motp[1]) <= 1e-5, motp
    tracks = sorted(os.listdir(port_out / "tracks"))
    assert tracks == sorted(os.listdir(run["jax"] / "tracks"))
    assert _json(port_out / "track_metrics.json")["num_gt_joints"] > 0


def test_cli_eval_mode_scores_the_written_tracks(run, port_out):
    """`--mode eval` reads the track files back and scores them as `track`
    scored the tracks in memory; the JAX CLI's eval on the same files
    agrees."""
    got = _json(port_out / "eval_metrics.json")
    assert got == _json(port_out / "track_metrics.json")
    out = run["root"] / "jax_eval"
    jlaunch.main(["--mode", "eval", "--detections",
                  str(port_out / "tracks"), "--out", str(out)]
                 + run["opts"])
    assert _json(out / "eval_metrics.json") == got


def test_weights_npz_round_trip(run, tmp_path):
    """A JAX `.npz` loads into the port; the port's `.npz` loads back into
    JAX leaf for leaf."""
    cfg = load_cfg(run["opts"][1], opts=run["opts"][2:])
    model = load_weights_npz(run["weights"], build_model(cfg, device="cpu",
                                                         seed=3))
    want = jax_params_to_state_dict(run["params"], model)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0)
    path = str(tmp_path / "port.npz")
    save_weights_npz(path, model)
    with np.load(path) as a, np.load(run["weights"]) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    back = jax_load_npz(path, _template(jax_load_cfg(
        run["opts"][1], opts=run["opts"][2:]))[1])
    jax.tree.map(np.testing.assert_array_equal, back, run["params"])
    with pytest.raises(ValueError, match="left unset"):
        partial = str(tmp_path / "partial.npz")
        with np.load(path) as a:
            np.savez(partial, **{k: a[k] for k in a.files[1:]})
        load_weights_npz(partial, model)


@pytest.mark.parametrize("argv,needle", [
    (["--mode", "bench"], "benchmark"),
])
def test_modes_not_ported_yet_name_their_roadmap_item(argv, needle):
    with pytest.raises(SystemExit, match="ROADMAP.md") as err:
        tlaunch.main(argv)
    assert needle in str(err.value)


def test_cli_subprocess_shards_equal_one_process(run, port_out, tmp_path,
                                                 monkeypatch):
    """`--mode test --subprocess-shards 2`: two child processes, one video
    range each, on the parent's `--device cpu`, `--batch-size` and
    `--weights`; the merged detections and their metrics equal the
    one-process run's."""
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    out = tmp_path / "shards"
    tlaunch.main(["--mode", "test", "--device", "cpu", "--batch-size", "3",
                  "--subprocess-shards", "2", "--weights", run["weights"],
                  "--out", str(out)] + run["opts"])
    assert sorted(n for n in os.listdir(out) if n.endswith(".pkl")) == [
        "detections.pkl", "detections_range_0_2.pkl",
        "detections_range_2_3.pkl"]
    want = load_object(str(port_out / "detections.pkl"))
    got = load_object(str(out / "detections.pkl"))
    assert list(got) == list(want)
    for vid in want:
        assert len(got[vid]) == len(want[vid])
        for g, w in zip(got[vid], want[vid]):
            assert set(g) == set(w)
            np.testing.assert_array_equal(g["valid"], w["valid"])
            for key, tol in (("scores", 1e-4), ("boxes", 1e-2),
                             ("keypoints", 1e-2)):
                np.testing.assert_allclose(g[key], w[key], atol=tol,
                                           err_msg=key)
    assert _json(out / "detection_metrics.json") == _json(
        port_out / "detection_metrics.json")


def test_cli_vis_writes_the_frames_jax_writes(run, tmp_path):
    """`--mode track --vis` on the JAX CLI's detections: the port writes
    the annotated frames the JAX CLI's `_write_vis` writes, byte for
    byte."""
    dets = str(run["jax"] / "detections.pkl")
    for main, name in ((jlaunch.main, "jax"), (tlaunch.main, "port")):
        main(["--mode", "track", "--vis", "--detections", dets,
              "--out", str(tmp_path / name)] + run["opts"])
    names = sorted(os.listdir(tmp_path / "jax" / "vis"))
    assert names == sorted(os.listdir(tmp_path / "port" / "vis"))
    assert len(names) == 13 and names[0] == "short_0000_000000.jpg"
    for name in names:
        with open(tmp_path / "jax" / "vis" / name, "rb") as a, \
                open(tmp_path / "port" / "vis" / name, "rb") as b:
            assert a.read() == b.read(), name


def test_device_cuda_without_a_card_stops(run, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tlaunch.main(["--mode", "test", "--out", str(tmp_path)]
                     + run["opts"])
    assert not os.path.exists(tmp_path / "detections.pkl")
