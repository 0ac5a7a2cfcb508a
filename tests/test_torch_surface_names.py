"""The port's public surface against the JAX package's, by name: for every
module of detectandtrack_tpu/ and tools/, the public top-level names
(functions, classes, module-level assignments) that the port's module of
the same path (detectandtrack_tpu_torch/<path>, tools/ under
detectandtrack_tpu_torch/tools/) does not define. What remains must be
exactly the exclusions below, each with its reason: a JAX name added
later without a counterpart fails here."""

import ast
import glob
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_A_B = "a TPU A/B form of an op the port has one exact path for"
_K1 = "ported as kernels/roi_align.py::roi_align_multilevel (K1)"
_K3 = ("a form over the Pallas K3; the port's one single-level path is "
       "kernels/roi_align.py::roi_align_pairs (K3)")
_V5E = "a TPU v5e peak; the port's peaks are in utils/roofline.py"

EXCLUDED = {
    "cli/launch.py": {
        "mode_bench": "runs bench.py, the earlier work's benchmark; the "
                      "port's bench and its cells are the benchmark work "
                      "(ROADMAP.md §1 item 1)",
    },
    "kernels/conv1.py": {
        "conv1_s2d_pallas": "ported as kernels/conv1.py::conv1 (K2, "
                            "csrc/conv1.cu)",
    },
    "kernels/roi_align.py": {
        "roi_align_multilevel_pallas": _K1,
        "roi_align_multilevel_batched": _K1,
        "roi_align": _K3,
        "roi_align_3d": _K3,
        "roi_align_batched": _K3,
        "roi_align_dense": _A_B,
        "roi_align_hybrid": _A_B,
        "roi_align_multilevel_dense": _A_B,
        "roi_align_multilevel_gather": _A_B,
        "roi_align_multilevel_hybrid": _A_B,
        "roi_align_reference": "the XLA reference; the port's plain versions "
                               "are roi_align_pairs_reference and "
                               "roi_align_multilevel_reference",
    },
    "models/backbone.py": {
        "Conv1S2D": "the space-to-depth fold of conv1 for the TPU's MXU; "
                    "the port's conv1 runs K2 on the frames as they are",
    },
    "models/detector.py": {
        "init_model": "flax's init; build_model(cfg, seed=) initializes",
    },
    "ops/keypoints.py": {
        "jax_softmax": "a jnp softmax; the port calls torch.softmax",
    },
    "parallel/mesh.py": {
        "replicated": "a NamedSharding spec; the port's replicate "
                      "broadcasts from rank 0",
        "batch_sharded": "a NamedSharding spec; the port's shard_batch "
                         "slices each rank's rows",
    },
    "utils/checkpoint.py": {
        "flatten_params": "flax trees; the port goes through utils/params.py",
        "unflatten_params": "flax trees; the port goes through "
                            "utils/params.py",
    },
    "tools/bench_conv.py": {
        "PEAK": _V5E,
        "timed": "a chained-jit timer for the TPU runtime; the port times "
                 "with CUDA events (utils/profiling.py)",
        "report": "prints MXU shares of the v5e peak; the port prints rows "
                  "against the H100 peaks",
    },
    "tools/conv_roofline.py": {
        "PEAK_FLOPS": _V5E,
        "PEAK_HBM": _V5E,
        "load_events": "reads jax.profiler traces; the port reads "
                       "torch.profiler's (trace_summary.load_trace)",
    },
    "tools/trace_summary.py": {
        "load_events": "reads jax.profiler traces; the port reads "
                       "torch.profiler's (load_trace)",
    },
    "tools/diag_roialign.py": {
        "mini_kernel": "ported as csrc/diag_roialign.cu "
                       "(kernels/diag_roialign.py::diag_pool, D)",
        "PATCH": "kept beside the kernel, kernels/diag_roialign.py::PATCH",
    },
    "tools/dump_hlo.py": {
        "*": "dumps XLA's HLO; the port has no compiled graph, and "
             "capture_trace's stage scopes map kernels to code",
    },
}


def _public_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            names.update(t.id for t in targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


def _missing():
    """{module path: {JAX name without a port counterpart}}; a module with
    no counterpart at all is {"*"}."""
    jax_mods = [os.path.relpath(p, os.path.join(REPO, "detectandtrack_tpu"))
                for p in glob.glob(os.path.join(REPO, "detectandtrack_tpu",
                                                "**", "*.py"),
                                   recursive=True)]
    tools = [os.path.relpath(p, REPO)
             for p in glob.glob(os.path.join(REPO, "tools", "*.py"))]
    out = {}
    for rel in jax_mods + tools:
        src = os.path.join(REPO, "detectandtrack_tpu", rel) \
            if rel not in tools else os.path.join(REPO, rel)
        port = os.path.join(REPO, "detectandtrack_tpu_torch", rel)
        if not os.path.exists(port):
            out[rel] = {"*"}
            continue
        gone = _public_names(src) - _public_names(port)
        if gone:
            out[rel] = gone
    return out


def test_what_the_port_lacks_is_the_documented_exclusions():
    assert all(reason.strip() for names in EXCLUDED.values()
               for reason in names.values())
    assert _missing() == {mod: set(names) for mod, names in EXCLUDED.items()}
