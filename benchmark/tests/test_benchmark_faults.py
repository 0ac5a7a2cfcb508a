"""The check fails what it must. Each test skips the harness's look for a
card and drives the rest of a run of a cell, cut small, on the CPU, with
its cell's own limits: a sound run comes out correct; with the timed path
broken underneath it comes out not correct, once for each fault the cell
can have (and, in training, for faults planted past the RPN); and the
control, the reference in the system's place at float8,
fails the limits too. On one card there is no exchange between chips to
leave out, and with one clip a step no half of a batch: those faults
cannot occur in these cells."""

import time

import pytest

from benchmark import harness
from benchmark.drivers.finetune import Driver as TrainDriver
from benchmark.drivers.offline_infer import Driver as InferDriver

from small import small_run

INFER = "r50_t8.infer_b4"
TRAIN = "r50_t8.train_b1"


def run_cell(cell, **kw):
    m, run = small_run(cell, **kw)
    return harness.execute(m, run, time.perf_counter())


def failed(result):
    return [k for k, c in result["checks"].items()
            if c["value"] > c["limit"]]


def test_infer_sound():
    res = run_cell(INFER)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"clips_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["score", "box", "keypoint", "dropped"])
def test_infer_answer_altered(monkeypatch, fault):
    """A detection altered where the detect entry produces it."""
    from detectandtrack_tpu_torch.engine import inference
    real = inference.detect_outputs

    def broken(out):
        keep = real(out)
        if fault == "score":
            keep["scores"] = keep["scores"] + 0.05 * keep["valid"]
        elif fault == "box":
            keep["boxes"] = keep["boxes"] + 3.0
        elif fault == "keypoint":
            kp = keep["keypoints"].clone()
            kp[..., 0] += 6.0
            keep["keypoints"] = kp
        else:                       # the best detection dropped
            v = keep["valid"].clone()
            v[:, 0] = False
            keep["valid"] = v
        return keep

    monkeypatch.setattr(inference, "detect_outputs", broken)
    res = run_cell(INFER)
    assert not res["correct"] and failed(res), res["checks"]


def control_fails(run, driver):
    r = driver(run).control_readings()
    return [k for k, lim in run.limits.items() if r[k] > lim]


def test_infer_control_fails():
    _, run = small_run(INFER)
    assert control_fails(run, InferDriver)


def test_traced_run_on_the_cpu():
    """A traced run reads the per-layer metrics it can: on the CPU no
    device kernel runs, so only the FLOP count's share and the host spans
    are read; the breakdown is there, the checks last."""
    res = run_cell(INFER, trace=True)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"mfu_pct.infer",
                                   "dispatch_ms_per_call.infer"}
    assert "breakdown" in res and list(res)[-1] == "checks"


def test_train_sound():
    res = run_cell(TRAIN)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_clips_per_s", "setup_s"}


def test_train_state_unchanged(monkeypatch):
    """A step that returns its state unchanged: no update is applied."""
    from detectandtrack_tpu_torch.engine import train
    monkeypatch.setattr(train.SGDMomentum, "update",
                        lambda self, state: None)
    res = run_cell(TRAIN)
    assert not res["correct"] and failed(res), res["checks"]


def test_train_state_unchanged_in_the_window(monkeypatch):
    """A step that updates through set-up and returns its state unchanged
    once the window runs (as a step captured after eager warm-up steps
    could): the window's probe catches it."""
    from detectandtrack_tpu_torch.engine import train
    real = train.SGDMomentum.update
    ring = small_run(TRAIN)[1].traffic["ring"]

    def late(self, state):
        if state.step < ring:
            real(self, state)

    monkeypatch.setattr(train.SGDMomentum, "update", late)
    res = run_cell(TRAIN)
    bad = failed(res)
    assert not res["correct"] and bad, res["checks"]
    assert all(k.startswith("window.") for k in bad), bad


@pytest.mark.parametrize("fault", ["roi_align_backward", "box_loss",
                                   "keypoint_loss"])
def test_train_fault_past_the_rpn(monkeypatch, fault):
    """The RoIAlign backward returns zero maps, or the box head's or the
    keypoint head's loss is left out of the step: the module medians of
    the leaves downstream catch each."""
    from detectandtrack_tpu_torch.engine import losses
    from detectandtrack_tpu_torch.kernels import roi_align
    if fault == "roi_align_backward":
        real = roi_align.roi_align_backward
        monkeypatch.setattr(roi_align, "roi_align_backward", lambda *a, **k: [
            g.zero_() for g in real(*a, **k)])
    elif fault == "box_loss":
        real = losses.fast_rcnn_losses
        monkeypatch.setattr(losses, "fast_rcnn_losses", lambda *a, **k: tuple(
            x * 0 for x in real(*a, **k)))
    else:
        real = losses.keypoint_loss
        monkeypatch.setattr(losses, "keypoint_loss",
                            lambda *a, **k: real(*a, **k) * 0)
    res = run_cell(TRAIN)
    assert not res["correct"] and failed(res), res["checks"]


def test_train_control_fails():
    _, run = small_run(TRAIN)
    assert control_fails(run, TrainDriver)
