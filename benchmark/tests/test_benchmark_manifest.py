"""The benchmark is driven by data: a configuration, a traffic mix, a cell
and a per-layer metric are added as new files alone, and the harness lists
and validates them. Also: the manifest's names and units keep to the
contract's characters, and nothing the benchmark runs imports JAX, flax,
the JAX package or the root bench."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.harness import FORBIDDEN
from benchmark.manifest import NAME, UNIT, Manifest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def test_manifest_holds():
    m = Manifest.load(BENCH)
    assert m.validate() == []
    for w in m.data["workloads"]:
        names = [x["name"] for x in m.end_to_end(w["name"])]
        assert "setup_s" in names and len(names) >= 2
        assert m.per_layer(w["name"])
        assert m.driver(m.traffic(w["traffic"])).Driver
        assert set(m.limits(w["name"]))


def test_names_and_units():
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = ([c["name"] for c in d["configs"]]
             + [w["name"] for w in d["workloads"]]
             + [w["traffic"] for w in d["workloads"]]
             + [m["name"] for m in d["end_to_end"] + d["per_layer"]]
             + [k for c in d["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), names
    assert all(UNIT.match(m["unit"])
               for m in d["end_to_end"] + d["per_layer"])
    for m in d["per_layer"]:
        assert m["moves"] in {e["name"] for e in d["end_to_end"]}
        assert m["workloads"]
    assert len(json.dumps(d)) < 64 * 1024


def test_added_by_files_alone(tmp_path):
    """Copy the benchmark, add one configuration, one traffic mix, one
    cell and one per-layer metric as new files and entries: the copy
    validates and finds each of them, and no file of the original
    changed."""
    before = {p: p.read_bytes() for p in BENCH.rglob("*")
              if p.is_file() and "__pycache__" not in p.parts}
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH / "configs" / "r50_t8.json").read_text())
    cfg["cfg"]["MODEL"]["CONV_BODY"] = "resnet101"
    (root / "benchmark" / "configs" / "r101_new.json").write_text(
        json.dumps(cfg))
    tr = json.loads((BENCH / "traffic" / "infer_b4.json").read_text())
    tr["batch"] = 2
    (root / "benchmark" / "traffic" / "infer_b2.json").write_text(
        json.dumps(tr))
    (root / "benchmark" / "limits" / "r101_new.infer_b2.json").write_text(
        (BENCH / "limits" / "r50_t8.infer_b4.json").read_text())
    (root / "benchmark" / "metrics" / "peak_gib.infer.py").write_text(
        "def read(view):\n    return view.facts.get('peak_gib')\n")
    d["configs"].append({"name": "r101_new", "source": "https://arxiv.org/"
                         "abs/1712.09184", "file":
                         "benchmark/configs/r101_new.json", "reduced": [],
                         "why": "a later configuration"})
    d["workloads"].append({"name": "r101_new.infer_b2", "config": "r101_new",
                           "traffic": "infer_b2", "chips": 1,
                           "why": "a later cell"})
    for e in d["end_to_end"]:
        if e["name"] == "clips_per_s":
            e["workloads"].append("r101_new.infer_b2")
    d["per_layer"].append({"name": "peak_gib.infer", "unit": "GiB",
                           "better": "lower", "source": "program_counter",
                           "layer": "device", "moves": "clips_per_s",
                           "workloads": ["r101_new.infer_b2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(d))
    m = Manifest.load(root / "benchmark")
    assert m.validate() == []
    cell = m.cell("r101_new.infer_b2")
    assert m.config(cell["config"])["cfg"]["MODEL"]["CONV_BODY"] == \
        "resnet101"
    assert m.traffic(cell["traffic"])["batch"] == 2
    assert m.driver(m.traffic(cell["traffic"])).__name__.endswith(
        "offline_infer")
    assert [x["name"] for x in m.per_layer(cell["name"])] == [
        "peak_gib.infer"]
    view = type("V", (), {"facts": {"peak_gib": 3.5}})()
    assert m.reader("peak_gib.infer")(view) == 3.5
    assert "setup_s" in [x["name"] for x in m.end_to_end(cell["name"])]
    after = {p: p.read_bytes() for p in BENCH.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    assert after == before


def test_broken_manifest_is_named(tmp_path):
    d = json.loads((ROOT / "BENCHMARK.json").read_text())
    d["workloads"][0]["name"] = "bad name"
    d["per_layer"][0]["unit"] = "per cent"
    d["end_to_end"][0]["bound"] = 0.5
    errs = Manifest(d, BENCH).validate()
    assert any("bad name" in e for e in errs)
    assert any("unit" in e for e in errs)
    assert any("bound" in e for e in errs)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_imports():
    """By whole top-level names: detectandtrack_tpu_torch passes."""
    found = {}
    for p in BENCH.rglob("*.py"):
        bad = set(_imports(p)) & FORBIDDEN
        if bad:
            found[str(p)] = bad
    assert found == {}
    for p in BENCH.rglob("*.py"):
        if "tests" in p.relative_to(BENCH).parts:
            continue
        text = p.read_text()
        assert "BENCH_" not in text and "bench.py" not in text, p


def test_refuses_without_a_card(tmp_path):
    """No CUDA card here: the command exits nonzero and prints no result,
    from the checkout and from a folder of BENCHMARK.json and the
    benchmark alone."""
    alone = tmp_path / "alone"
    shutil.copytree(BENCH, alone / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", alone)
    for cwd in (ROOT, alone):
        p = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload",
             "r50_t8.infer_b4", "--seed", str(2 ** 33 + 1), "--seconds", "1",
             "--trace", "0"], cwd=cwd, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert p.returncode != 0
        assert p.stdout.strip() == ""


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-q"]))
