"""The readers of the training step's phases (`idle_ms_per_step.*.train`)
on a hand-made trace: two steps, each a `bench/step` span holding the
program's `train/forward` (with `model/backbone`, `train/targets` and
`train/losses` inside), `train/backward` and `train/update`, then
`bench/wait`, with idle gaps placed in each. Each reader gives its ms a
step, gives None where its span is absent, and the five with the
harness's own spans and the time outside every span add up to the
window's idle time."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark.manifest import Manifest
from benchmark.trace import Trace

BENCH = Path(__file__).resolve().parents[1]
STEP_US = 1000.0
STEPS = 2

# One step's spans and busy intervals, in µs from the step's start.
SPANS = [("bench/step", 10, 900), ("train/forward", 20, 500),
         ("model/backbone", 30, 100), ("train/targets", 150, 200),
         ("train/losses", 250, 300), ("train/backward", 510, 700),
         ("train/update", 710, 880)]
BUSY = [(0, 5), (40, 90), (120, 160), (180, 260), (290, 520), (600, 650),
        (720, 800), (920, 950)]
# The idle gaps between them, piece by piece: [5, 40] is 5 outside every
# span, 10 in bench/step, 10 in train/forward, 10 in model/backbone;
# [90, 120] 10 in model/backbone, 20 in train/forward; [160, 180] in
# train/targets; [260, 290] in train/losses; [520, 600] in train/backward;
# [650, 720] 50 in train/backward, 10 in bench/step, 10 in train/update;
# [800, 920] 80 in train/update, 20 in bench/step, then outside.
EXPECTED_MS = {"model": 0.050, "targets": 0.020, "losses": 0.030,
               "backward": 0.130, "update": 0.090}
PHASES = sorted(EXPECTED_MS)


def make_trace(drop=()) -> Trace:
    """STEPS steps, then `bench/wait` from 1905 to 1990 µs past the last
    step's start, in a window of STEPS × 1000 µs; spans named in `drop`
    left out."""
    spans, kernels = [], []
    for i in range(STEPS):
        off = i * STEP_US
        spans += [(n, s + off, e + off) for n, s, e in SPANS]
        kernels += [("k", s + off, e - s) for s, e in BUSY]
    last = (STEPS - 1) * STEP_US
    spans.append(("bench/wait", last + 905, last + 990))
    spans = [sp for sp in spans if sp[0] not in drop]
    return Trace(kernels=kernels, spans=spans, window=(0.0, STEPS * STEP_US))


def view(trace: Trace):
    return SimpleNamespace(trace=trace, units=STEPS)


def read(phase, v):
    return Manifest.load(BENCH).reader(f"idle_ms_per_step.{phase}.train")(v)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_reads_its_idle_ms_a_step(phase):
    assert read(phase, view(make_trace())) == pytest.approx(
        EXPECTED_MS[phase], abs=1e-12)


@pytest.mark.parametrize("phase", PHASES)
def test_phase_reads_none_without_its_span(phase):
    span = "train/forward" if phase == "model" else f"train/{phase}"
    assert read(phase, view(make_trace(drop={span}))) is None
    # A program without scopes (the harness's spans alone): nothing to read.
    bare = make_trace(drop={n for n, _, _ in SPANS if n != "bench/step"})
    assert read(phase, view(bare)) is None
    assert read(phase, SimpleNamespace(trace=make_trace(), units=0)) is None


def test_phases_add_up_to_the_window_idle():
    tr = make_trace()
    by_span = tr.idle_us_by_span()
    phases_us = sum(read(p, view(tr)) for p in PHASES) * 1e3 * STEPS
    rest_us = by_span["bench/step"] + by_span["bench/wait"] + by_span["idle"]
    assert by_span["bench/step"] == 40.0 * STEPS
    assert phases_us + rest_us == pytest.approx(tr.window_us - tr.busy_us())
    assert set(by_span) == {n for n, _, _ in SPANS} | {"bench/wait", "idle"}


def test_manifest_holds_with_the_phase_readers():
    m = Manifest.load(BENCH)
    assert m.validate() == []
    names = [x["name"] for x in m.per_layer("r50_t8.train_b1")]
    assert [f"idle_ms_per_step.{p}.train" for p in
            ("model", "targets", "losses", "backward", "update")] == \
        names[-5:]
    assert all("r50_t8.train_b1" == w for x in m.data["per_layer"][-5:]
               for w in x["workloads"])
