"""No forward of the port makes a host decision or an upload after its
first call, so that a CUDA graph can capture it (`engine/graphs.py`), and
`engine/graphs.py` keys its graphs by signature and hands out copies.

On the CPU, with the narrow R-18 of tests/test_torch_stream.py: after a
warm call, a second call of each path runs with every way a tensor reaches
the host (`__bool__`, `.item`, `.tolist`, `.numpy`, `.cpu`, `torch.equal`)
and every upload of a numpy array (`torch.as_tensor`, `torch.from_numpy`)
made to raise: `make_detect_fn` plain, with proposals through the RPN,
flip TTA, and the soft-NMS + box-voting config. The device-side anchor
fields equal `ops/anchors.py::shifted_anchor_field`. The graph wrapper is
driven with a stand-in for `torch.cuda.CUDAGraph` (no CUDA here)."""

import numpy as np
import pytest
import torch

from detectandtrack_tpu_torch.core.config import load_cfg
from detectandtrack_tpu_torch.engine import graphs
from detectandtrack_tpu_torch.engine.inference import (make_detect_fn,
                                                       make_kps_aug_fns)
from detectandtrack_tpu_torch.kernels import nms as knms
from detectandtrack_tpu_torch.models.detector import build_model
from detectandtrack_tpu_torch.models.rpn import anchor_cell_for_level
from detectandtrack_tpu_torch.ops.anchors import shifted_anchor_field
from detectandtrack_tpu_torch.utils.flops import count_flops
from detectandtrack_tpu_torch.utils.synthetic import make_realistic_tubes
from test_torch_stream import TINY

T, H, W = 2, 64, 96
SOFT = ["TEST.SOFT_NMS_ENABLED", True, "TEST.SOFT_NMS_METHOD", "linear",
        "TEST.BBOX_VOTE_ENABLED", True, "TEST.BBOX_VOTE_THRESH", 0.8]


def _model(extra=()):
    cfg = load_cfg(opts=TINY + ["VIDEO.VIDEO_ON", True, "VIDEO.NUM_FRAMES",
                                T] + list(extra))
    return build_model(cfg, device="cpu", seed=0)


def _host_blocked(monkeypatch):
    def refuse(name):
        def fn(*args, **kwargs):
            raise AssertionError(f"host sync in a forward: {name}")
        return fn

    for name in ("__bool__", "item", "tolist", "numpy", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
    monkeypatch.setattr(torch, "equal", refuse("torch.equal"))
    monkeypatch.setattr(torch, "from_numpy", refuse("torch.from_numpy"))
    as_tensor = torch.as_tensor

    def guarded(data, *args, **kwargs):
        if isinstance(data, np.ndarray):
            raise AssertionError("upload in a forward: torch.as_tensor of a "
                                 "numpy array")
        return as_tensor(data, *args, **kwargs)

    monkeypatch.setattr(torch, "as_tensor", guarded)


@pytest.fixture(scope="module")
def model():
    return _model()


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)
    clips = torch.from_numpy(rng.normal(size=(1, T, H, W, 3)).astype(
        np.float32))
    tubes = torch.from_numpy(make_realistic_tubes(1, 16, T, H, W))
    return clips, tubes


@pytest.mark.parametrize("path", ["plain", "proposals_run_rpn", "flip_tta",
                                  "soft_nms"])
def test_second_forward_makes_no_host_sync(path, model, inputs, monkeypatch):
    clips, tubes = inputs
    args = (clips,)
    if path == "soft_nms":
        model = _model(SOFT)
        detect = make_detect_fn(model)
    elif path == "proposals_run_rpn":
        detect = make_detect_fn(model, with_proposals=True, run_rpn=True)
        args = (clips, tubes)
    else:
        detect = make_detect_fn(model, flip_tta=path == "flip_tta")
    assert not isinstance(detect, graphs.GraphedFunction)   # a CPU model
    first = detect(*args)
    with monkeypatch.context() as m:
        _host_blocked(m)
        second = detect(*args)
    assert set(first) == set(second)
    for k in first:
        torch.testing.assert_close(second[k], first[k], rtol=0, atol=0)


def test_kps_aug_fns_make_no_host_sync(model, inputs, monkeypatch):
    clips, _ = inputs
    hm_fn, decode_fn = make_kps_aug_fns(model, flip=True)
    boxes = make_detect_fn(model)(clips)["boxes"]
    hm_fn(clips, boxes)
    with monkeypatch.context() as m:
        _host_blocked(m)
        hms = hm_fn(clips, boxes)
        kps = decode_fn(torch.stack([hms, hms]), boxes)
    assert kps.shape[:2] == boxes.shape[:2]


def test_anchor_field_cache_equals_the_host_field(model, inputs):
    clips, _ = inputs
    make_detect_fn(model)(clips)
    cfg = model.cfg
    fields = model._anchor_fields
    levels = cfg.FPN.RPN_MAX_LEVEL - cfg.FPN.RPN_MIN_LEVEL + 1
    assert sorted(key[0] for key in fields) == list(range(levels))
    for (li, h, w, dev), field in fields.items():
        stride = 2 ** (cfg.FPN.RPN_MIN_LEVEL + li)
        want = shifted_anchor_field(anchor_cell_for_level(cfg, li, stride),
                                    stride, h, w)
        assert dev == torch.device("cpu") and field.dtype == torch.float32
        np.testing.assert_array_equal(field.numpy(), want)
    assert set(model.state_dict()) == set(_model().state_dict())


class _StandInGraph:
    """Replays `fn` on the static inputs into the static outputs, as a
    CUDA graph's replay overwrites them, and like a replay bumps no
    Python counter."""

    def __init__(self, fn, args, kwargs, out):
        self.fn, self.args, self.kwargs, self.out = fn, args, kwargs, out

    def replay(self):
        before = graphs._read_counts()
        new = self.fn(*self.args, **self.kwargs)
        graphs._add_counts(graphs._count_delta(before, graphs._read_counts()),
                           -1)
        for static, x in zip(torch.utils._pytree.tree_leaves(self.out),
                             torch.utils._pytree.tree_leaves(new)):
            static.copy_(x)


class _StandInFactory:
    def __init__(self):
        self.warm_ups = 0

    def warm_up(self, fn, args, kwargs, device):
        self.warm_ups += 1
        return fn(*args, **kwargs)

    def pool(self, device):
        return "pool"

    def capture(self, fn, args, kwargs, device, pool):
        assert pool == "pool"
        out = fn(*args, **kwargs)
        return _StandInGraph(fn, args, kwargs, out), out


def _counted_fn(x, y=None):
    knms.nms_keep.launches += 1        # as a kernel wrapper counts
    out = x * 2.0 + (0.0 if y is None else y)
    return {"out": out, "sum": out.sum(dim=-1)}


def test_graphs_key_by_signature_and_return_fresh_copies(monkeypatch):
    monkeypatch.setattr(knms.nms_keep, "launches", 0)
    factory = _StandInFactory()
    fn = graphs.GraphedFunction(_counted_fn, "stand-in", factory)
    a = torch.arange(6.0).reshape(2, 3)
    first = fn(a)
    assert (fn.captures, fn.replays, factory.warm_ups) == (1, 0, 1)
    assert knms.nms_keep.launches == 1        # warm-up ran, capture did not
    r1 = fn(a + 1)
    r2 = fn(a + 2)
    assert (fn.captures, fn.replays) == (1, 2)
    assert knms.nms_keep.launches == 3        # one a replay
    torch.testing.assert_close(first["out"], a * 2.0)
    torch.testing.assert_close(r1["out"], (a + 1) * 2.0)
    torch.testing.assert_close(r2["out"], (a + 2) * 2.0)
    assert r1["out"].data_ptr() != r2["out"].data_ptr()
    static = fn._graphs[next(iter(fn._graphs))].out_leaves
    assert all(r["out"].data_ptr() != s.data_ptr() for r in (r1, r2)
               for s in static)
    # New signatures: another shape, dtype, or an optional argument given.
    fn(torch.zeros(3, 3))
    fn(a.double())
    fn(a, a)
    fn(a, y=a)
    assert fn.captures == 5 and factory.warm_ups == 5
    torch.testing.assert_close(fn(a, a)["out"], a * 3.0)
    assert fn.captures == 5 and fn.replays == 3
    # The FLOP count goes through the eager function, and captures nothing.
    assert count_flops(fn, a) == count_flops(_counted_fn, a)
    assert fn.captures == 5 and fn.replays == 3


def test_graph_capture_failure_names_the_line():
    class Failing(_StandInFactory):
        def capture(self, fn, args, kwargs, device, pool):
            boxes = torch.zeros(2, 3, 4)          # 3 boxes, 5 flags
            knms.nms_keep(boxes, torch.zeros(5, dtype=torch.bool), 0.5)

    fn = graphs.GraphedFunction(_counted_fn, "failing", Failing())
    with pytest.raises(RuntimeError, match=r"failing: CUDA graph capture "
                       r"failed .* at detectandtrack_tpu_torch/kernels/"
                       r"nms\.py:\d+ in nms_keep_reference"):
        fn(torch.zeros(2))
    assert fn.captures == 0 and not fn._graphs
