"""Captured inference functions: the port's counterpart of `jax.jit` on the
serving path.

The JAX package compiles `make_detect_fn` and the KPS_AUG functions with
`jax.jit` (detectandtrack_tpu/engine/inference.py:75, :80, :109,
:114-115): a request is one device program, dispatched once, that never
waits on the host until its outputs are read. `graphed(fn, name)` gives a
function of tensors the same property on a CUDA device, with one
`torch.cuda.CUDAGraph` per input signature (each tensor's shape, dtype and
device, which arguments are None, the other arguments' values), as jit
keeps one program per shape:

- The first call of a signature is its warm-up: it runs `fn` eagerly on
  a side stream (cuDNN's plans, lazy library loads, the caching
  allocator's first blocks, the model's device constants) and returns that
  run's outputs. Then it copies the inputs into static buffers and
  captures `fn` on them into a memory pool that the wrapper's graphs
  share (`torch.cuda.graph_pool_handle()`).
- Every later call copies its inputs into the signature's static buffers
  on the current stream, replays the graph and returns `clone()`s of the
  static outputs: a caller may hold call i's outputs while call i+1
  replays over the static ones (`run_inference` and the bench do).
  Because each replay's outputs are cloned right after it on the same
  stream, the graphs of one pool may replay in any order.

The graph keeps the addresses of everything it read: the model's
parameters and the device constants it caches (anchor fields, flip
permutations), never a caller's tensor. Parameters updated in place
(`load_state_dict`, `replicate`) are seen by later replays; a model moved
or rebuilt needs a new function.

The kernels' launch counters are Python attributes their wrappers bump,
and a replay runs no Python: each capture records every counter's
increment, takes it back (nothing ran), and each replay adds it. So a
count is of the launches the card ran, one per kernel per call, warm-up
included.

A capture or replay that fails raises, naming the function, the
signature and, for a capture, the port's source line at fault. Nothing
falls back to eager. The function runs under `torch.inference_mode()`.
`.eager` is the wrapped function itself: `utils/flops.count_flops`
counts through it, since a replay shows the FLOP counter nothing.
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils import _pytree as pytree

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counted_entries() -> List[Any]:
    """Every kernel entry point a forward can launch, with its counters."""
    from ..kernels import affine, conv1, nms, roi_align
    return [conv1.conv1, roi_align.roi_align_multilevel,
            roi_align.roi_align_pairs, nms.nms_keep, nms.soft_nms_confirm,
            affine.affine_epilogue]


def _read_counts() -> Dict[Tuple[int, str], Tuple[Any, int]]:
    """(entry id, attribute) → (entry, value) of every `launches*`
    counter."""
    return {(id(fn), attr): (fn, value)
            for fn in _counted_entries()
            for attr, value in vars(fn).items()
            if attr.startswith("launches")}


def _count_delta(before, after) -> List[Tuple[Any, str, int]]:
    """The counters' increments between two `_read_counts`."""
    return [(fn, key[1], value - before[key][1])
            for key, (fn, value) in after.items()
            if value != before[key][1]]


def _add_counts(delta, sign: int = 1) -> None:
    for fn, attr, inc in delta:
        setattr(fn, attr, getattr(fn, attr) + sign * inc)


def _leaf_key(x):
    if torch.is_tensor(x):
        return ("tensor", tuple(x.shape), x.dtype, x.device)
    return ("value", x)


def _where(err: BaseException) -> str:
    """The deepest frame of the port's own code in `err`'s traceback."""
    frames = [f for f in traceback.extract_tb(err.__traceback__)
              if os.path.abspath(f.filename).startswith(_PKG_DIR)
              and not f.filename.endswith("graphs.py")]
    if not frames:
        return "outside the port's code"
    f = frames[-1]
    return (f"{os.path.relpath(f.filename, os.path.dirname(_PKG_DIR))}:"
            f"{f.lineno} in {f.name} ({(f.line or '').strip()})")


class _Captured:
    def __init__(self, graph, inputs, out_leaves, out_spec, counts):
        self.graph = graph
        self.inputs = inputs            # static buffers, in leaf order
        self.out_leaves = out_leaves    # static outputs
        self.out_spec = out_spec
        self.counts = counts            # the launches one replay makes


class GraphedFunction:
    """`fn` captured per input signature (see the module docstring).
    `captures` and `replays` count graphs made and replayed."""

    def __init__(self, fn: Callable, name: str, graph_factory: Any = None):
        self.eager = fn
        self.name = name
        self._graph_factory = graph_factory or _cuda_graph
        self._graphs: Dict[Any, _Captured] = {}
        self._pool = None
        self.captures = 0
        self.replays = 0

    def __call__(self, *args, **kwargs):
        leaves, spec = pytree.tree_flatten((args, kwargs))
        key = (str(spec), tuple(_leaf_key(x) for x in leaves))
        entry = self._graphs.get(key)
        with torch.inference_mode():
            if entry is None:
                return self._warm_up_and_capture(key, leaves, spec)
            return self._replay(key, entry, leaves)

    def _warm_up_and_capture(self, key, leaves, spec):
        tensors = [x for x in leaves if torch.is_tensor(x)]
        device = tensors[0].device if tensors else torch.device("cpu")
        factory = self._graph_factory
        args, kwargs = pytree.tree_unflatten(leaves, spec)
        out = factory.warm_up(self.eager, args, kwargs, device)

        static = [torch.empty(x.shape, dtype=x.dtype, device=x.device)
                  .copy_(x) if torch.is_tensor(x) else x for x in leaves]
        s_args, s_kwargs = pytree.tree_unflatten(static, spec)
        if self._pool is None:
            self._pool = factory.pool(device)
        before = _read_counts()
        try:
            graph, s_out = factory.capture(self.eager, s_args, s_kwargs,
                                           device, self._pool)
        except Exception as err:
            raise RuntimeError(
                f"{self.name}: CUDA graph capture failed for signature "
                f"{key[1]} at {_where(err)}: {err}") from err
        counts = _count_delta(before, _read_counts())
        _add_counts(counts, -1)        # the capture launched nothing
        out_leaves, out_spec = pytree.tree_flatten(s_out)
        self._graphs[key] = _Captured(graph, static, out_leaves, out_spec,
                                      counts)
        self.captures += 1
        return out

    def _replay(self, key, entry, leaves):
        for buf, x in zip(entry.inputs, leaves):
            if torch.is_tensor(x):
                buf.copy_(x)
        try:
            entry.graph.replay()
        except Exception as err:
            raise RuntimeError(f"{self.name}: CUDA graph replay failed for "
                               f"signature {key[1]}: {err}") from err
        _add_counts(entry.counts)
        self.replays += 1
        return pytree.tree_unflatten(
            [x.clone() if torch.is_tensor(x) else x
             for x in entry.out_leaves], entry.out_spec)


class _CudaGraphFactory:
    """Warm-up, pool and capture on a CUDA device."""

    @staticmethod
    def warm_up(fn, args, kwargs, device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            out = fn(*args, **kwargs)
        cur.wait_stream(side)
        for x in pytree.tree_leaves(out):
            if torch.is_tensor(x):
                x.record_stream(cur)       # the caller reads them on `cur`
        return out

    @staticmethod
    def pool(device):
        with torch.cuda.device(device):
            return torch.cuda.graph_pool_handle()

    @staticmethod
    def capture(fn, args, kwargs, device, pool):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(device):
            with torch.cuda.graph(graph, pool=pool,
                                  capture_error_mode="thread_local"):
                out = fn(*args, **kwargs)
        return graph, out


_cuda_graph = _CudaGraphFactory()


def graphed(fn: Callable, name: str) -> GraphedFunction:
    """`fn`, a function of tensors on one CUDA device, captured per input
    signature; see the module docstring."""
    return GraphedFunction(fn, name)
