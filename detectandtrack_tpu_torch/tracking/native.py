"""ctypes loader for the native (C++) assignment solver of the tracker.

The port's copy of detectandtrack_tpu/tracking/native.py. The solver's
source is `csrc/hungarian.cpp`, built with g++ at first use into the
package's `_build/` directory by `kernels/_build.py`, like the CUDA
sources. Where it cannot be built or loaded, this raises: the machines the
port runs on have g++. scipy's `linear_sum_assignment` runs only when the
caller asks for it (use_native=False, TRACKING.USE_NATIVE_SOLVER).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np

from ..kernels import _build

_BIG = 1e5
_F64P = ctypes.POINTER(ctypes.c_double)
_I32P = ctypes.POINTER(ctypes.c_int32)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("hungarian")
    lib.solve_assignment_f64.argtypes = [_F64P, ctypes.c_int, ctypes.c_int,
                                         ctypes.c_double, _I32P]
    lib.solve_greedy_f64.argtypes = lib.solve_assignment_f64.argtypes
    lib.iou_cost_matrix_f64.argtypes = [_F64P, ctypes.c_int, _F64P,
                                        ctypes.c_int, _F64P]
    return lib


def _solve(fn_name: str, cost: np.ndarray,
           forbidden: float) -> List[Tuple[int, int]]:
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    if n == 0 or m == 0:
        return []
    out = np.full(n, -1, np.int32)
    getattr(_lib(), fn_name)(cost.ctypes.data_as(_F64P), n, m, forbidden,
                             out.ctypes.data_as(_I32P))
    return [(i, int(j)) for i, j in enumerate(out) if j >= 0]


def solve_assignment(cost: np.ndarray,
                     forbidden: float = _BIG,
                     use_native: bool = True) -> List[Tuple[int, int]]:
    """Min-cost matching → [(row, col), ...]; entries >= forbidden never
    match. The native solver, or scipy's with use_native=False
    (TRACKING.USE_NATIVE_SOLVER)."""
    if use_native:
        return _solve("solve_assignment_f64", cost, forbidden)
    cost = np.asarray(cost, np.float64)
    if cost.size == 0:
        return []
    from scipy.optimize import linear_sum_assignment
    rows, cols = linear_sum_assignment(np.minimum(cost, forbidden))
    return [(int(r), int(c)) for r, c in zip(rows, cols)
            if cost[r, c] < forbidden]


def solve_greedy_native(cost: np.ndarray,
                        forbidden: float = _BIG) -> List[Tuple[int, int]]:
    """Native greedy matching, globally smallest cost first."""
    return _solve("solve_greedy_f64", cost, forbidden)


def iou_cost_native(prev_boxes: np.ndarray,
                    cur_boxes: np.ndarray) -> np.ndarray:
    """Native 1 - IoU matrix between (P, 4) and (C, 4) boxes."""
    prev = np.ascontiguousarray(prev_boxes, np.float64)
    cur = np.ascontiguousarray(cur_boxes, np.float64)
    p, c = len(prev), len(cur)
    out = np.empty((p, c), np.float64)
    _lib().iou_cost_matrix_f64(prev.ctypes.data_as(_F64P), p,
                               cur.ctypes.data_as(_F64P), c,
                               out.ctypes.data_as(_F64P))
    return out
