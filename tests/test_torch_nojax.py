"""The port stands alone where JAX is not installed (the GPU machine):
every module of detectandtrack_tpu_torch imports, the slice runs detect →
track, one training step of the small model runs, the CLI's demo-data,
test and track modes run a generated set, its import-weights and
train modes import a Detectron `.pkl` and take 2 steps from it, and the
parity tool imports a `.pkl`, streams a generated set and diffs its
detections, on the CPU, in a process where `import jax`, `import flax`,
`import detectandtrack_tpu` (the JAX package) and `import bench` all
fail. No source file of the port and
no line of chip_smoke.py imports the JAX package or `bench`."""

import ast
import glob
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED = ("jax", "jaxlib", "flax", "detectandtrack_tpu", "bench")
_BLOCK_JAX = f"""
import sys
for name in {_BLOCKED!r}:
    sys.modules[name] = None
"""
_NOTHING_BLOCKED_LOADED = f"""
loaded = [m for m in sys.modules if m.split(".")[0] in {_BLOCKED!r}
          and sys.modules[m] is not None]
assert not loaded, loaded
"""

_SLICE = _BLOCK_JAX + """
import importlib, pkgutil
import numpy as np, torch
import detectandtrack_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in mods:
    importlib.import_module(name)
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.tracking.tracker import Tracker, TrackerConfig
from detectandtrack_tpu_torch.engine.inference import (
    clip_slice, detections_to_frames, make_detect_fn)
from detectandtrack_tpu_torch.models.detector import build_model
cfg = load_cfg(opts=[
    "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
    "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
    "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
    "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
    "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
    "TEST.SHAPE_BUCKETS", "[[64, 96]]",
    "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 32])
model = build_model(cfg, device="cpu", seed=0)
clip = torch.from_numpy(np.random.default_rng(0).normal(
    size=(1, 2, 64, 96, 3)).astype(np.float32))
det = make_detect_fn(model)(clip)
assert tuple(det["boxes"].shape) == (1, 4, 8)
assert tuple(det["keypoints"].shape) == (1, 4, 2, 15, 4)
assert all(torch.isfinite(v).all() for v in det.values()
           if v.is_floating_point())
tracker = Tracker(TrackerConfig(score_thresh=0.0))
for fr in detections_to_frames(clip_slice(det, 0), 2, 1.0):
    ids = tracker.update(fr["boxes"], fr["scores"], fr["keypoints"],
                         fr["features"], fr["valid"])
assert (ids >= 0).sum() == int(det["valid"].sum())
from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                    make_train_step)
tcfg = load_cfg(opts=[
    "MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
    "VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES", 2,
    "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
    "RPN.PRE_NMS_TOP_N_TRAIN", 100, "RPN.POST_NMS_TOP_N_TRAIN", 32,
    "RPN.BATCH_SIZE_PER_IM", 32, "FAST_RCNN.BATCH_SIZE_PER_IM", 32,
    "KRCNN.NUM_STACKED_CONVS", 2, "KRCNN.CONV_HEAD_DIM", 32,
    "SOLVER.CLIP_GRAD_NORM", 10.0])
tmodel = build_model(tcfg, device="cpu", seed=0, train=True)
state = create_train_state(tcfg, tmodel)
gt = torch.tensor([[[10.0, 8.0, 50.0, 60.0, 12.0, 8.0, 52.0, 61.0]]])
batch = {"clips": clip, "gt_boxes": gt,
         "gt_keypoints": torch.zeros((1, 1, 2, 15, 3)),
         "gt_valid": torch.ones((1, 1), dtype=torch.bool)}
before = {k: p.detach().clone() for k, p in state.params.items()}
state, metrics = make_train_step(tmodel, tcfg)(state, batch)
assert state.step == 1 and set(metrics) >= {"loss_total", "loss_kps"}
assert all(torch.isfinite(v) for v in metrics.values())
assert any(not torch.equal(before[k], p) for k, p in state.params.items())
""" + _NOTHING_BLOCKED_LOADED + """print("modules", len(mods))
"""


_SURFACE = _BLOCK_JAX + """
import numpy as np, torch
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.tracking.tracker import Tracker, TrackerConfig
from detectandtrack_tpu_torch.engine.inference import (
    clip_slice, detections_to_frames, make_detect_fn)
from detectandtrack_tpu_torch.engine.train import (create_train_state,
                                                    make_train_step)
from detectandtrack_tpu_torch.models.detector import build_model
small = ["MODEL.CONV_BODY", "resnet18", "RESNETS.WIDTH_PER_GROUP", 8,
         "MODEL.COMPUTE_DTYPE", "float32", "MODEL.MASK_ON", True,
         "TEST.SHAPE_BUCKETS", "[[64, 96]]", "TEST.BBOX_AUG_ENABLED", True,
         "RPN.PRE_NMS_TOP_N_TEST", 64, "RPN.POST_NMS_TOP_N_TEST", 16,
         "TEST.DETECTIONS_PER_IM", 4, "TEST.SCORE_THRESH", -1.0,
         "KRCNN.NUM_STACKED_CONVS", 1, "KRCNN.CONV_HEAD_DIM", 8,
         "MRCNN.DIM_REDUCED", 8,
         "RPN.PRE_NMS_TOP_N_TRAIN", 100, "RPN.POST_NMS_TOP_N_TRAIN", 32,
         "RPN.BATCH_SIZE_PER_IM", 32, "FAST_RCNN.BATCH_SIZE_PER_IM", 32,
         "MRCNN.TRAIN_MAX_ROIS_PER_IM", 8, "KRCNN.TRAIN_MAX_ROIS_PER_IM", 8]
cfg = load_cfg("configs/video/2d_R50_C4_kps.yaml", opts=small)
assert not cfg.FPN.FPN_ON and cfg.MODEL.MASK_ON
model = build_model(cfg, device="cpu", seed=0)
clip = torch.from_numpy(np.random.default_rng(0).normal(
    size=(1, 1, 64, 96, 3)).astype(np.float32))
det = make_detect_fn(model, flip_tta=True)(clip)
assert tuple(det["masks"].shape) == (1, 4, 1, 28, 28)
assert tuple(det["features"].shape) == (1, 4, 2048)
assert all(torch.isfinite(v).all() for v in det.values()
           if v.is_floating_point())
frames = detections_to_frames(clip_slice(det, 0), 1, 1.0)
assert frames[0]["masks"].shape == (4, 28, 28)
ids = Tracker(TrackerConfig(score_thresh=0.0)).update(
    frames[0]["boxes"], frames[0]["scores"], frames[0]["keypoints"],
    frames[0]["features"], frames[0]["valid"])
assert (ids >= 0).sum() == int(det["valid"].sum())
tcfg = load_cfg("configs/video/2d_R50_FPN_mask_kps.yaml", opts=small)
tmodel = build_model(tcfg, device="cpu", seed=0, train=True)
state = create_train_state(tcfg, tmodel)
gt = torch.tensor([[[10.0, 8.0, 50.0, 60.0]]])
batch = {"clips": clip, "gt_boxes": gt,
         "gt_keypoints": torch.zeros((1, 1, 1, 15, 3)),
         "gt_valid": torch.ones((1, 1), dtype=torch.bool),
         "gt_masks": torch.ones((1, 1, 1, 28, 28)),
         "gt_mask_valid": torch.ones((1, 1, 1), dtype=torch.bool)}
state, metrics = make_train_step(tmodel, tcfg)(state, batch)
assert set(metrics) >= {"loss_total", "loss_mask", "loss_kps"}
assert all(torch.isfinite(v) for v in metrics.values())
assert tmodel.mask_head.conv5_mask.weight.grad.abs().max() > 0
""" + _NOTHING_BLOCKED_LOADED + """print("surface ok")
"""


_CLI = _BLOCK_JAX + """
import json, os, sys
from detectandtrack_tpu_torch.cli.launch import main
out = sys.argv[1]
main(["--mode", "demo-data", "--out", os.path.join(out, "data", "synthetic")])
opts = ["MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
        "RESNETS.WIDTH_PER_GROUP", "8", "FPN.DIM", "32",
        "FAST_RCNN.MLP_HEAD_DIM", "64",
        "VIDEO.VIDEO_ON", "True", "VIDEO.NUM_FRAMES", "2",
        "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]",
        "RPN.PRE_NMS_TOP_N_TEST", "50", "RPN.POST_NMS_TOP_N_TEST", "16",
        "TEST.DETECTIONS_PER_IM", "4", "TEST.SCORE_THRESH", "-1.0",
        "TEST.SCALE", "64", "TEST.MAX_SIZE", "96",
        "TEST.SHAPE_BUCKETS", "[[64, 96]]",
        "KRCNN.NUM_STACKED_CONVS", "1", "KRCNN.CONV_HEAD_DIM", "16",
        "DATA.ROOT", os.path.join(out, "data"),
        "TEST.DATASETS", "[posetrack_synthetic_val]"]
for mode in ("test", "track"):
    main(["--mode", mode, "--device", "cpu", "--batch-size", "4",
          "--out", os.path.join(out, "run")] + opts)
with open(os.path.join(out, "run", "track_metrics.json")) as f:
    metrics = json.load(f)
assert metrics["num_gt_joints"] > 0, metrics
assert len(os.listdir(os.path.join(out, "run", "tracks"))) == 2
""" + _NOTHING_BLOCKED_LOADED + """print("cli ok")
"""


_FINETUNE = _BLOCK_JAX + """
import json, os, sys
import numpy as np
from detectandtrack_tpu_torch.cli.launch import main
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.data.synthetic import (
    generate_synthetic_posetrack)
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.utils.detectron_import import save_detectron_pkl
out = sys.argv[1]
generate_synthetic_posetrack(os.path.join(out, "data", "synthetic_hard"),
                             num_videos=2, frames_per_video=4,
                             image_hw=(64, 96), seed=3, hard=True)
small = ["MODEL.CONV_BODY", "resnet18", "MODEL.COMPUTE_DTYPE", "float32",
         "RESNETS.WIDTH_PER_GROUP", "8", "FPN.DIM", "32",
         "FAST_RCNN.MLP_HEAD_DIM", "64", "KRCNN.NUM_STACKED_CONVS", "1",
         "KRCNN.CONV_HEAD_DIM", "16", "TEST.SHAPE_BUCKETS", "[[64, 96]]"]
video = ["VIDEO.VIDEO_ON", "True", "VIDEO.NUM_FRAMES", "2",
         "VIDEO.TIME_KERNEL_DIM", "[3, 1, 1, 1, 1]"]
train = ["RPN.PRE_NMS_TOP_N_TRAIN", "100", "RPN.POST_NMS_TOP_N_TRAIN", "32",
         "RPN.BATCH_SIZE_PER_IM", "32", "FAST_RCNN.BATCH_SIZE_PER_IM", "32",
         "TRAIN.SCALES", "[64]", "TRAIN.MAX_SIZE", "96",
         "TRAIN.IMS_PER_BATCH", "1", "SOLVER.MAX_ITER", "2",
         "TRAIN.CHECKPOINT_PERIOD", "1", "SOLVER.BASE_LR", "0.001",
         "DATA.ROOT", os.path.join(out, "data"),
         "TRAIN.DATASETS", "[posetrack_synthetic_hard_train]"]
cfg2 = load_cfg(opts=small)
pkl = os.path.join(out, "r18_2d.pkl")
save_detectron_pkl(pkl, build_model(cfg2, device="cpu", seed=1), cfg2)
run = os.path.join(out, "run")
imported = main(["--mode", "import-weights", "--device", "cpu", "--weights",
                 pkl, "--out", run] + small + video)
final = main(["--mode", "train", "--device", "cpu", "--weights", imported,
              "--out", run] + small + video + train)
assert sorted(os.listdir(os.path.join(run, "checkpoints"))) == ["1.pt", "2.pt"]
with open(os.path.join(run, "training_stats.jsonl")) as f:
    stats = [json.loads(line) for line in f]
assert len(stats) == 1 and np.isfinite(stats[0]["loss_total"]), stats
with np.load(final) as a, np.load(imported) as b:
    assert sorted(a.files) == sorted(b.files)
    assert any(not np.array_equal(a[k], b[k]) for k in a.files)
""" + _NOTHING_BLOCKED_LOADED + """print("finetune ok")
"""


_PARITY = _BLOCK_JAX + """
import contextlib, io, json, os, pickle, sys
from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.data.synthetic import (
    generate_synthetic_posetrack)
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.tools import parity_check
from detectandtrack_tpu_torch.utils.detectron_import import save_detectron_pkl
out = sys.argv[1]
ann = generate_synthetic_posetrack(os.path.join(out, "val"), num_videos=1,
                                   frames_per_video=3, image_hw=(64, 96),
                                   seed=3, hard=True, json_name="val.json")
yaml = os.path.join(out, "tiny.yaml")       # JSON is YAML
with open(yaml, "w") as f:
    json.dump({"MODEL": {"CONV_BODY": "resnet18", "COMPUTE_DTYPE": "float32"},
               "RESNETS": {"WIDTH_PER_GROUP": 8}, "FPN": {"DIM": 32},
               "FAST_RCNN": {"MLP_HEAD_DIM": 64},
               "VIDEO": {"VIDEO_ON": True, "NUM_FRAMES": 2,
                         "TIME_KERNEL_DIM": [3, 1, 1, 1, 1]},
               "KRCNN": {"NUM_STACKED_CONVS": 1, "CONV_HEAD_DIM": 16},
               "TEST": {"SHAPE_BUCKETS": [[64, 96]], "SCALE": 64,
                        "MAX_SIZE": 96, "DETECTIONS_PER_IM": 4,
                        "SCORE_THRESH": -1.0}}, f)
cfg = load_cfg(yaml)
pkl = os.path.join(out, "model.pkl")
save_detectron_pkl(pkl, build_model(cfg, device="cpu", seed=1), cfg)
empty = os.path.join(out, "empty.pkl")
with open(empty, "wb") as f:
    pickle.dump({"all_boxes": [[], []], "all_keyps": [[], []]}, f)
run = os.path.join(out, "run")
argv = ["--pkl", pkl, "--ann", ann, "--frames", os.path.join(out, "val"),
        "--cfg", yaml, "--out", run, "--device", "cpu"]
assert parity_check.main(argv + ["--ref-dets", empty]) in (0, 1)
with open(os.path.join(run, "our_dets.pkl"), "rb") as f:
    ref = parity_check.to_detectron_detections(pickle.load(f))
with open(os.path.join(out, "dets.pkl"), "wb") as f:
    pickle.dump(ref, f)
args = parity_check.parse_args(argv + ["--ref-dets",
                                       os.path.join(out, "dets.pkl")])
with contextlib.redirect_stdout(io.StringIO()) as printed:
    parity_check._diff_against_reference(args)
diff = json.loads(printed.getvalue())
assert diff == {"ref_images_compared": 3, "mean_best_iou": 1.0,
                "mean_kp_px_delta": 0.0}, diff
""" + _NOTHING_BLOCKED_LOADED + """print("parity ok")
"""


def _run(code, cwd, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_port_imports_and_runs_without_jax():
    proc = _run(_SLICE, REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "modules" in proc.stdout


def test_surface_runs_without_jax():
    """A C4 + mask model through flip TTA into the tracker, and one
    MASK_ON training step, with jax/flax blocked."""
    proc = _run(_SURFACE, REPO)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "surface ok" in proc.stdout


def test_cli_runs_without_jax(tmp_path):
    """The port's CLI generates the synthetic sets (`demo-data`), detects
    over the val set (`test`, the tiny R-18 model on the CPU) and tracks and
    scores it (`track`), with jax/flax/the JAX package/bench blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _CLI, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "cli ok" in proc.stdout
    assert os.path.exists(tmp_path / "data" / "synthetic_hard" / "val.json")


def test_finetune_cli_runs_without_jax(tmp_path):
    """`--mode import-weights` of a 2D Detectron `.pkl` into a 3D model,
    then 2 steps of `--mode train` from the imported `.npz` (checkpoints,
    training stats, final weights), with jax/flax/the JAX package/bench
    blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _FINETUNE, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "finetune ok" in proc.stdout


def test_parity_tool_runs_without_jax(tmp_path):
    """The parity tool on the CPU (`--device cpu`): a Detectron `.pkl` of
    the seeded tiny 3D model imported, a generated val set streamed and
    scored, its detections rewritten in Detectron's form and diffed
    against themselves (IoU 1, pixel delta 0), with jax/flax/the JAX
    package/bench blocked."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _PARITY, str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "parity ok" in proc.stdout


def test_chip_smoke_fails_without_card_or_repo(tmp_path):
    """No CUDA device (this machine), and a directory holding only
    chip_smoke.py: both exit nonzero and print no result line."""
    run_smoke = _BLOCK_JAX + (
        "import runpy; runpy.run_path('chip_smoke.py', run_name='__main__')")
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    for cwd in (REPO, str(tmp_path)):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        proc = subprocess.run([sys.executable, "-c", run_smoke], cwd=cwd,
                              env=env, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode != 0, (cwd, proc.stdout)
        assert '"ok": true' not in proc.stdout


def _imports(path):
    """Every module name an import statement of `path` names."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


_PORT_SOURCES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "detectandtrack_tpu_torch", "**", "*.py"),
        recursive=True)) + ["chip_smoke.py"]


def test_walk_packages_reaches_the_tools_and_utils():
    """The no-JAX import run above walks the package with pkgutil: it
    reaches the diagnostic kernel, the profiling utilities, every tool,
    the fine-tuning modules and the data-parallel mesh."""
    import pkgutil

    import detectandtrack_tpu_torch as pkg
    mods = {m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                  pkg.__name__ + ".")}
    want = {f"detectandtrack_tpu_torch.{m}" for m in (
        "kernels.diag_roialign", "utils.env", "utils.profiling",
        "utils.roofline", "tools.diag_roialign", "tools.bench_roialign",
        "tools.bench_conv", "tools.capture_trace", "tools.trace_summary",
        "tools.conv_roofline", "models.inflate", "utils.detectron_import",
        "utils.training_stats", "utils.subprocess_utils", "utils.vis",
        "parallel.mesh", "tools.parity_check")}
    assert want <= mods, want - mods


@pytest.mark.parametrize("path", _PORT_SOURCES)
def test_port_source_imports_no_jax_package(path):
    """The port keeps its own copies of what it needs: no import statement
    in it (or in chip_smoke.py) names the JAX package, `bench` or JAX."""
    bad = [m for m in _imports(os.path.join(REPO, path))
           if m.split(".")[0] in _BLOCKED]
    assert not bad, bad
