"""The port's training-loop plumbing on the CPU: `data/pipeline.DeviceLoader`
(the torch prefetcher in place of the JAX package's `DeviceLoader`) and the
full-state checkpoints of `utils/checkpoint.py` (`torch.save` in place of
orbax). Their card halves (the side-stream copy, CUDA tensors in a
checkpoint) are in tests/test_torch_cuda.py."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from detectandtrack_tpu_torch.data.pipeline import DeviceLoader
from detectandtrack_tpu_torch.engine.train import TrainState
from detectandtrack_tpu_torch.utils import checkpoint as ckpt


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"clips": rng.normal(size=(2, 2, 8, 8, 3)).astype(np.float32),
             "gt_valid": rng.random((2, 4)) > 0.5,
             "scale": np.full((2,), i, np.float32)} for i in range(n)]


def test_prefetcher_order_and_values_equal_the_host_iterator():
    want = _host_batches(7)
    with DeviceLoader(iter(_host_batches(7)), "cpu", prefetch=2) as loader:
        got = list(loader)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) and g[k].device.type == "cpu"
            np.testing.assert_array_equal(g[k].numpy(), w[k])


def test_prefetcher_reraises_a_worker_error():
    """An error in the worker ends the consumer's loop with
    RuntimeError("DeviceLoader worker failed") from it, after the batches
    made before it: never as a clean end of epoch."""
    def host():
        yield from _host_batches(2)
        raise ValueError("bad clip")

    loader = DeviceLoader(host(), "cpu", prefetch=1)
    got = []
    with pytest.raises(RuntimeError, match="DeviceLoader worker failed") as e:
        for batch in loader:
            got.append(batch)
    assert isinstance(e.value.__cause__, ValueError)
    assert len(got) == 2


def test_prefetcher_pins_nothing_on_the_cpu(monkeypatch):
    def no_pinning(self, *args, **kwargs):
        raise AssertionError("pin_memory called for a CPU target")

    monkeypatch.setattr(torch.Tensor, "pin_memory", no_pinning)
    with DeviceLoader(iter(_host_batches(3)), "cpu") as loader:
        got = list(loader)
    assert len(got) == 3 and not any(v.is_pinned() for b in got
                                     for v in b.values())


def test_prefetcher_close_stops_a_worker_on_a_full_queue():
    """A consumer that stops early (the step loop at MAX_ITER) closes the
    loader; the worker, blocked on the full queue, ends."""
    loader = DeviceLoader(iter(_host_batches(20)), "cpu", prefetch=1)
    next(loader)
    deadline = time.monotonic() + 10
    while loader._q.qsize() < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    loader.close()
    assert not loader._thread.is_alive()


# -- full-state checkpoints ------------------------------------------------

def _state(seed=0, step=0, momentum=True, shapes=None):
    g = torch.Generator().manual_seed(seed)
    shapes = shapes or {"a.weight": (4, 3), "a.bias": (4,), "b.scale": (2,)}
    params = {k: torch.nn.Parameter(torch.randn(s, generator=g))
              for k, s in shapes.items()}
    mom = ({k: torch.randn(p.shape, generator=g) for k, p in params.items()
            if k != "b.scale"} if momentum else {})
    return TrainState(params, mom, step)


def _same(a, b):
    assert a.step == b.step and set(a.params) == set(b.params)
    for k in a.params:
        torch.testing.assert_close(a.params[k], b.params[k], rtol=0, atol=0)
    assert set(a.momentum) == set(b.momentum)
    for k in a.momentum:
        torch.testing.assert_close(a.momentum[k], b.momentum[k], rtol=0,
                                   atol=0)


def test_checkpoint_round_trip_and_snapshot_is_owned(tmp_path):
    """The snapshot is taken when `save_checkpoint` returns: an in-place
    update right after (as the optimizer makes) does not reach the file."""
    d = str(tmp_path / "ck")
    assert ckpt.restore_checkpoint(d, _state()) == (None, None)
    assert ckpt.latest_checkpoint_step(d) is None
    state = _state(0, step=3)
    saved = TrainState({k: p.detach().clone() for k, p in state.params.items()},
                       dict(state.momentum), 3)
    ckpt.save_checkpoint(d, state, 3)
    with torch.no_grad():
        for p in state.params.values():
            p.add_(1.0)
    ckpt.wait_for_checkpoints(d)
    fresh = _state(1, momentum=False)
    restored, step = ckpt.restore_checkpoint(d, fresh)
    assert step == 3
    _same(restored, saved)
    # In place: the fresh state's own parameters now hold the values.
    assert all(restored.params[k] is fresh.params[k] for k in fresh.params)


def test_checkpoint_keeps_the_last_five_and_restores_the_latest(tmp_path):
    d = str(tmp_path / "ck")
    for step in range(1, 8):
        ckpt.save_checkpoint(d, _state(step, step=step), step)
    ckpt.wait_for_checkpoints()
    assert sorted(os.listdir(d)) == [f"{s}.pt" for s in range(3, 8)]
    restored, step = ckpt.restore_checkpoint(d, _state(0, momentum=False))
    assert step == 7
    _same(restored, _state(7, step=7))
    restored, step = ckpt.restore_checkpoint(d, _state(0), step=4)
    _same(restored, _state(4, step=4))


def test_a_cut_off_save_never_becomes_the_latest(tmp_path, monkeypatch):
    """A save that dies mid-write leaves only its temporary file: the
    latest step stays the previous one, and the failure is raised where
    the saves are drained. A stray truncated temporary file is ignored."""
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, _state(2, step=2), 2)
    ckpt.wait_for_checkpoints(d)
    real_save = torch.save

    def cut_off(obj, path):
        with open(path, "wb") as f:
            f.write(b"PK\x03\x04 truncated")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt.torch, "save", cut_off)
    ckpt.save_checkpoint(d, _state(4, step=4), 4)
    with pytest.raises(RuntimeError, match="checkpoint save") as e:
        ckpt.wait_for_checkpoints(d)
    assert isinstance(e.value.__cause__, OSError)
    monkeypatch.setattr(ckpt.torch, "save", real_save)
    with open(os.path.join(d, "9.pt.tmp"), "wb") as f:
        f.write(b"\x80\x02 truncated")
    assert sorted(os.listdir(d)) == ["2.pt", "4.pt.tmp", "9.pt.tmp"]
    assert ckpt.latest_checkpoint_step(d) == 2
    restored, step = ckpt.restore_checkpoint(d, _state(0, momentum=False))
    assert step == 2
    _same(restored, _state(2, step=2))


@pytest.mark.parametrize("kind", ["shape", "missing", "extra", "momentum"])
def test_restore_of_a_mismatched_state_raises_and_changes_nothing(tmp_path,
                                                                  kind):
    d = str(tmp_path / "ck")
    ckpt.save_checkpoint(d, _state(2, step=2), 2)
    ckpt.wait_for_checkpoints(d)
    shapes = {"a.weight": (4, 3), "a.bias": (4,), "b.scale": (2,)}
    if kind == "shape":
        shapes["a.weight"] = (4, 2)
    elif kind == "missing":
        shapes["c.bias"] = (3,)
    elif kind == "extra":
        del shapes["b.scale"]
    template = _state(0, shapes=shapes, momentum=False)
    if kind == "momentum":
        template = _state(0)
        template.momentum["b.scale"] = torch.zeros(2)
    before = {k: p.detach().clone() for k, p in template.params.items()}
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore_checkpoint(d, template)
    for k, p in template.params.items():
        torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0)


def test_one_save_in_flight_per_directory(tmp_path, monkeypatch):
    """A second save of a directory waits for the first to be written."""
    d = str(tmp_path / "ck")
    real_save = torch.save
    gate = threading.Event()
    order = []

    def slow_save(obj, path):
        order.append(("start", obj["step"]))
        if obj["step"] == 1:
            gate.wait(10)
        real_save(obj, path)
        order.append(("end", obj["step"]))

    monkeypatch.setattr(ckpt.torch, "save", slow_save)
    ckpt.save_checkpoint(d, _state(1, step=1), 1)
    threading.Timer(0.2, gate.set).start()
    ckpt.save_checkpoint(d, _state(2, step=2), 2)
    ckpt.wait_for_checkpoints(d)
    assert order == [("start", 1), ("end", 1), ("start", 2), ("end", 2)]
    assert ckpt.latest_checkpoint_step(d) == 2
