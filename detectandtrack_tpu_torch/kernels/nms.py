"""The NMS loops as device kernels: greedy NMS from the sorted boxes to the
keep mask, and soft-NMS's confirmation rounds.

Port of the `jax.lax.while_loop`s in detectandtrack_tpu/ops/nms.py
(`nms_fixed`, :62-89 with its suppression matrix; `soft_nms_fixed`,
:152-178), which keep a JAX request on the device until its outputs are
read. `ops/nms.py` sorts and gathers with torch ops and hands each loop to
these entries:

- `nms_keep(sorted_boxes, valid_sorted, iou_thresh)`: the greedy keep mask
  of score-sorted boxes, the IoU suppression test included (no (N, N)
  tensor on the card).
- `soft_nms_confirm(scores, dmat, overlaps, alive)`: soft-NMS's final
  scores, one confirmation round after another until none confirms.

A CPU tensor runs the plain version (`nms_keep_reference`,
`soft_nms_confirm_reference`): the same loop in torch with a fixed trip
count and no host decision. A CUDA tensor launches the kernels in
`csrc/nms.cu` on the current stream, or raises. Launch counts (one a call,
however many device kernels it runs): `nms_keep.launches`,
`soft_nms_confirm.launches`.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from ..ops.boxes import bbox_overlaps
from . import _build

PROD_CHUNK = 32              # csrc/nms.cu kProdChunk: the decay product's
                             # association (see soft_nms_confirm_reference)
MAX_KEEP_N = 32768           # nms_keep's kernels: at most 512 words a row
MAX_SOFT_N = 7000            # soft_nms_confirm's kernel: 8 bytes a box of
                             # shared memory for the scores (56 KB at 7000)


def greedy_sweep(supp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """The greedy sweep: supp (..., N, N) bool, supp[j, i] = "j outranks
    and suppresses i" (strictly upper triangular), valid (..., N) bool →
    kept (..., N) bool. Box i is kept iff valid and no kept box suppresses
    it; N steps, each on every lane at once."""
    removed = torch.zeros_like(valid)
    cols = []
    for i in range(valid.shape[-1]):
        keep = valid[..., i] & ~removed[..., i]
        cols.append(keep)
        removed = removed | (supp[..., i, :] & keep[..., None])
    return torch.stack(cols, dim=-1)


def nms_keep_reference(sorted_boxes: torch.Tensor, valid_sorted: torch.Tensor,
                       iou_thresh: float) -> torch.Tensor:
    """Greedy NMS's keep mask: sorted_boxes (..., N, 4) in descending score
    order, valid_sorted (..., N) bool → kept (..., N) bool. The suppression
    matrix is `ops/nms.py::nms_fixed`'s: IoU (`bbox_overlaps`) strictly
    above `iou_thresh` (compared in f32), for an earlier box over a later
    one; then `greedy_sweep`."""
    n = valid_sorted.shape[-1]
    rank = torch.arange(n, device=valid_sorted.device)
    supp = ((bbox_overlaps(sorted_boxes, sorted_boxes) > iou_thresh)
            & (rank[:, None] < rank[None, :]))
    return greedy_sweep(supp, valid_sorted)


def soft_nms_round(scores: torch.Tensor, dmat: torch.Tensor,
                   overlaps: torch.Tensor, alive: torch.Tensor,
                   confirmed: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One confirmation round of `soft_nms_confirm_reference` → (prov,
    newly): prov(i) = s_i · Π decays of i's confirmed overlappers, in the
    kernel's fixed order (chunks of PROD_CHUNK rows in index order, each
    chunk's product from 1 in index order, then the chunk products from 1
    in index order); newly = the unconfirmed alive boxes that no
    unconfirmed alive overlapper beats on (prov, -index)."""
    n = scores.shape[-1]
    rank = torch.arange(n, device=scores.device)
    earlier = rank[:, None] < rank[None, :]
    decays = torch.where(confirmed[..., :, None] & overlaps, dmat,
                         torch.ones_like(dmat))
    chunks = F.pad(decays, (0, 0, 0, (-n) % PROD_CHUNK), value=1.0).reshape(
        decays.shape[:-2] + (-1, PROD_CHUNK, n))
    q = torch.ones_like(chunks[..., 0, :])
    for p in range(PROD_CHUNK):
        q = q * chunks[..., p, :]
    prod = torch.ones_like(scores)
    for c in range(q.shape[-2]):
        prod = prod * q[..., c, :]
    prov = scores * prod
    pj, pi = prov[..., :, None], prov[..., None, :]
    beats = (pj > pi) | ((pj == pi) & earlier)
    outranked = ((~confirmed & alive)[..., :, None] & overlaps
                 & beats).any(dim=-2)
    return prov, ~confirmed & alive & ~outranked


def soft_nms_confirm_reference(scores: torch.Tensor, dmat: torch.Tensor,
                               overlaps: torch.Tensor, alive: torch.Tensor,
                               neg_inf: float) -> torch.Tensor:
    """Soft-NMS's bulk confirmation: scores (..., N) f32, dmat (..., N, N)
    f32 decay of i by j, overlaps (..., N, N) bool (j can decay i; no
    diagonal), alive (..., N) bool → final (..., N) f32, each box's score
    when confirmed (`neg_inf` for the dead).

    A round (`soft_nms_round`): every unconfirmed alive box that no
    unconfirmed alive overlapper beats on (prov, -index) is confirmed at
    prov(i). N rounds: a round after the last confirmation changes
    nothing, so no host decision ends the loop."""
    confirmed = torch.zeros_like(alive)
    final = torch.full_like(scores, neg_inf)
    for _ in range(scores.shape[-1]):
        prov, newly = soft_nms_round(scores, dmat, overlaps, alive,
                                     confirmed)
        final = torch.where(newly, prov, final)
        confirmed = confirmed | newly
    return final


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("nms")
    lib.dat_nms_keep.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    lib.dat_nms_keep.restype = ctypes.c_int
    lib.dat_soft_nms_on_chip.argtypes = [ctypes.c_int]
    lib.dat_soft_nms_on_chip.restype = ctypes.c_int
    lib.dat_soft_nms_confirm.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.dat_soft_nms_confirm.restype = ctypes.c_int
    return lib


def _lanes(x: torch.Tensor, trailing: int) -> int:
    n = 1
    for d in x.shape[:x.dim() - trailing]:
        n *= d
    return n


def nms_keep(sorted_boxes: torch.Tensor, valid_sorted: torch.Tensor,
             iou_thresh: float) -> torch.Tensor:
    """Greedy NMS's keep mask (..., N) bool from score-sorted boxes (..., N,
    4) f32 and valid_sorted (..., N) bool (see `nms_keep_reference`). CPU
    tensors run the plain version; CUDA tensors launch the mask and sweep
    kernels or raise."""
    if not sorted_boxes.is_cuda:
        return nms_keep_reference(sorted_boxes, valid_sorted, iou_thresh)
    what = "nms_keep kernel"
    n = valid_sorted.shape[-1]
    if (sorted_boxes.dtype != torch.float32
            or valid_sorted.dtype != torch.bool
            or tuple(sorted_boxes.shape) != tuple(valid_sorted.shape) + (4,)
            or valid_sorted.device != sorted_boxes.device):
        raise ValueError(f"{what}: sorted_boxes (..., N, 4) f32 and "
                         f"valid_sorted (..., N) bool on one device, got "
                         f"{tuple(sorted_boxes.shape)} {sorted_boxes.dtype},"
                         f" {tuple(valid_sorted.shape)} {valid_sorted.dtype}")
    if n > MAX_KEEP_N:
        raise ValueError(f"{what}: N={n} > {MAX_KEEP_N}")
    lanes = _lanes(valid_sorted, 1)
    boxes = sorted_boxes.contiguous()
    if boxes.data_ptr() % 16:                  # the kernel reads float4s
        boxes = boxes.clone()
    valid = valid_sorted.contiguous()
    kept = torch.empty_like(valid)
    w = (n + 63) // 64
    scratch = torch.empty(lanes * w * (64 * w + 1), dtype=torch.int64,
                          device=boxes.device)     # the bits, then vwords
    lib = _lib()
    with torch.cuda.device(boxes.device):
        err = lib.dat_nms_keep(boxes.data_ptr(), valid.data_ptr(),
                               scratch.data_ptr(), kept.data_ptr(), lanes, n,
                               float(iou_thresh),
                               torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{what} launch")
    nms_keep.launches += 1
    return kept


nms_keep.launches = 0


def soft_nms_confirm(scores: torch.Tensor, dmat: torch.Tensor,
                     overlaps: torch.Tensor, alive: torch.Tensor,
                     neg_inf: float) -> torch.Tensor:
    """Soft-NMS's final scores (..., N) f32 (see
    `soft_nms_confirm_reference`). CPU tensors run the plain version; CUDA
    tensors launch the rounds kernel or raise."""
    if not scores.is_cuda:
        return soft_nms_confirm_reference(scores, dmat, overlaps, alive,
                                          neg_inf)
    what = "soft_nms_confirm kernel"
    n = scores.shape[-1]
    sq = tuple(scores.shape) + (n,)
    if (scores.dtype != torch.float32 or dmat.dtype != torch.float32
            or overlaps.dtype != torch.bool or alive.dtype != torch.bool
            or tuple(dmat.shape) != sq or tuple(overlaps.shape) != sq
            or alive.shape != scores.shape
            or len({t.device for t in (scores, dmat, overlaps, alive)}) != 1):
        raise ValueError(f"{what}: scores (..., N) f32, dmat (..., N, N) "
                         f"f32, overlaps (..., N, N) bool and alive (..., "
                         f"N) bool on one device, got {tuple(scores.shape)}"
                         f" {scores.dtype}, {tuple(dmat.shape)} "
                         f"{dmat.dtype}, {tuple(overlaps.shape)} "
                         f"{overlaps.dtype}, {tuple(alive.shape)} "
                         f"{alive.dtype}")
    if n > MAX_SOFT_N:
        raise ValueError(f"{what}: N={n} > {MAX_SOFT_N}")
    scores, dmat, overlaps, alive = (t.contiguous() for t in (
        scores, dmat, overlaps, alive))
    final = torch.empty_like(scores)
    lanes = _lanes(scores, 1)
    lib = _lib()
    cols = q = None
    if not lib.dat_soft_nms_on_chip(n):       # state past shared memory
        cols = torch.empty((lanes, (n + 63) // 64, n), dtype=torch.int64,
                           device=scores.device)
        q = torch.empty((lanes, (n + 31) // 32, n), dtype=torch.float32,
                        device=scores.device)
    with torch.cuda.device(scores.device):
        err = lib.dat_soft_nms_confirm(
            scores.data_ptr(), dmat.data_ptr(), overlaps.data_ptr(),
            alive.data_ptr(), final.data_ptr(),
            None if cols is None else cols.data_ptr(),
            None if q is None else q.data_ptr(), lanes, n, neg_inf,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{what} launch")
    soft_nms_confirm.launches += 1
    return final


soft_nms_confirm.launches = 0
