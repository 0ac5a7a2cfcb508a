"""`BENCHMARK.json` and the files it names, found by name.

A cell (`workloads` entry) names a configuration and a traffic mix:

  benchmark/configs/<config>.json     the configuration as it is run
  benchmark/traffic/<traffic>.json    the traffic's parameters; its
                                      "driver" names drivers/<driver>.py
  benchmark/limits/<cell>.json        the limit of each number the cell's
                                      comparison with the reference prints
  benchmark/metrics/<metric>.py       one reader for each per-layer metric

Adding a configuration, a traffic mix, a cell or a metric adds files and
entries; no file changes. `validate` holds the manifest to the rules the
benchmark's contract sets for names, units and references.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
E2E_SOURCES = {"device_trace", "host_clock"}
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


class Manifest:
    def __init__(self, data: Dict, bench_dir: Path = HERE):
        self.data = data
        self.dir = Path(bench_dir)

    @classmethod
    def load(cls, bench_dir: Path = HERE) -> "Manifest":
        root = Path(bench_dir).parent
        with open(root / "BENCHMARK.json") as f:
            return cls(json.load(f), bench_dir)

    # -- lookups --

    def cell(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> Dict:
        with open(self.dir / kind / f"{name}.json") as f:
            return json.load(f)

    def config(self, name: str) -> Dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> Dict:
        return self._json("traffic", name)

    def limits(self, cell: str) -> Dict[str, float]:
        return self._json("limits", cell)

    def driver(self, traffic: Dict):
        return importlib.import_module(
            f"{__package__}.drivers.{traffic['driver']}")

    def reader(self, metric: str):
        """The `read` function of benchmark/metrics/<metric>.py."""
        path = self.dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"{__package__}.metrics.{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def end_to_end(self, cell: str) -> List[Dict]:
        return [m for m in self.data["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> List[Dict]:
        reported = {m["name"] for m in self.end_to_end(cell)}
        return [m for m in self.data["per_layer"]
                if (cell in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]

    # -- the rules --

    def validate(self) -> List[str]:
        """Every broken rule, as a line; [] when the manifest holds."""
        d, errs = self.data, []

        def need(ok, msg):
            if not ok:
                errs.append(msg)

        need(set(d) == TOP_KEYS, f"top-level keys {sorted(d)}")
        configs = {c["name"]: c for c in d.get("configs", [])}
        cells = {w["name"]: w for w in d.get("workloads", [])}
        e2e = {m["name"]: m for m in d.get("end_to_end", [])}
        names = (list(configs) + list(cells) + list(e2e)
                 + [m["name"] for m in d.get("per_layer", [])])
        need(len(configs) == len(d["configs"]), "duplicate configuration")
        need(len(cells) == len(d["workloads"]), "duplicate workload")
        metric_names = [m["name"] for m in d["end_to_end"] + d["per_layer"]]
        need(len(set(metric_names)) == len(metric_names), "duplicate metric")
        for n in names:
            need(bool(NAME.match(n)), f"name {n!r}")
        need(1 <= len(configs) <= 24, "1 to 24 configurations")
        need(1 <= len(cells) <= 24, "1 to 24 workloads")
        need(1 <= len(e2e) <= 16, "1 to 16 end-to-end metrics")
        need(1 <= len(d["per_layer"]) <= 128, "1 to 128 per-layer metrics")
        need("setup_s" in e2e, "no setup_s")
        need(isinstance(d["run_seconds"], int)
             and 1 <= d["run_seconds"] <= 51, "run_seconds")
        for c in configs.values():
            need(set(c) == {"name", "source", "file", "reduced", "why"},
                 f"config {c['name']}: keys")
            need((self.dir.parent / c["file"]).is_file()
                 and c["file"] == f"{self.dir.name}/configs/{c['name']}.json",
                 f"config {c['name']}: file {c['file']}")
            need(len(c["reduced"]) <= 16 and all(
                NAME.match(k) for k in c["reduced"]),
                f"config {c['name']}: reduced")
            need(any(w["config"] == c["name"] for w in cells.values()),
                 f"config {c['name']} used by no workload")
        pairs = set()
        for w in cells.values():
            need(set(w) == {"name", "config", "traffic", "chips", "why"},
                 f"workload {w['name']}: keys")
            need(w["config"] in configs, f"workload {w['name']}: config")
            need(w["chips"] in (1, 4), f"workload {w['name']}: chips")
            need(0 < len(w["why"]) <= 200 and "\n" not in w["why"],
                 f"workload {w['name']}: why")
            need(NAME.match(w["traffic"]) is not None,
                 f"workload {w['name']}: traffic name")
            need((w["config"], w["traffic"]) not in pairs,
                 f"workload {w['name']}: pair repeated")
            pairs.add((w["config"], w["traffic"]))
            tpath = self.dir / "traffic" / f"{w['traffic']}.json"
            need(tpath.is_file(), f"workload {w['name']}: no {tpath.name}")
            if tpath.is_file():
                drv = self.traffic(w["traffic"]).get("driver", "")
                need((self.dir / "drivers" / f"{drv}.py").is_file(),
                     f"traffic {w['traffic']}: no driver {drv!r}")
            need((self.dir / "limits" / f"{w['name']}.json").is_file(),
                 f"workload {w['name']}: no limits file")
            need(len(self.end_to_end(w["name"])) >= 2,
                 f"workload {w['name']}: needs setup_s and another metric")
            need(len(self.per_layer(w["name"])) >= 1,
                 f"workload {w['name']}: no per-layer metric")
        for m in d["end_to_end"] + d["per_layer"]:
            layer = m in d["per_layer"]
            keys = ({"name", "unit", "better", "source", "layer", "moves"}
                    if layer else {"name", "unit", "better", "bound",
                                   "source"})
            need(set(m) - {"workloads"} == keys, f"metric {m['name']}: keys")
            need(bool(UNIT.match(m.get("unit", ""))),
                 f"metric {m['name']}: unit")
            need(m.get("better") in ("lower", "higher"),
                 f"metric {m['name']}: better")
            need(m.get("source") in (SOURCES if layer else E2E_SOURCES),
                 f"metric {m['name']}: source")
            for c in m.get("workloads", []):
                need(c in cells, f"metric {m['name']}: workload {c}")
            if layer:
                need(m["moves"] in e2e, f"metric {m['name']}: moves")
                need(0 < len(m["layer"]) <= 200 and "\n" not in m["layer"],
                     f"metric {m['name']}: layer")
                need((self.dir / "metrics" / f"{m['name']}.py").is_file(),
                     f"metric {m['name']}: no reader")
                for c in m.get("workloads", []):
                    need(m["moves"] in {x["name"]
                                        for x in self.end_to_end(c)},
                         f"metric {m['name']}: {c} lacks {m['moves']}")
            else:
                b = m.get("bound")
                need(isinstance(b, (int, float)) and 0.01 <= b <= 0.25,
                     f"metric {m['name']}: bound")
        return errs


def flatten_cfg(cfg: Dict) -> List:
    """A nested configuration → [KEY, value, ...] dotted pairs."""
    out: List = []
    for group, v in cfg.items():
        if isinstance(v, dict):
            for k, x in v.items():
                out += [f"{group}.{k}", x]
        else:
            out += [group, v]
    return out
