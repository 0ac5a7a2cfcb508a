"""The NMS loops as device kernels: greedy NMS's keep sweep and soft-NMS's
confirmation rounds.

Port of the `jax.lax.while_loop`s in detectandtrack_tpu/ops/nms.py
(`nms_fixed`, :79-89; `soft_nms_fixed`, :152-178), which keep a JAX
request on the device until its outputs are read. `ops/nms.py` computes
each loop's inputs with torch ops and hands the loop to these entries:

- `nms_keep(supp, valid)`: the greedy keep mask of score-sorted boxes,
  from the strictly upper-triangular suppression matrix.
- `soft_nms_confirm(scores, dmat, overlaps, alive)`: soft-NMS's final
  scores, one confirmation round after another until none confirms.

A CPU tensor runs the plain version (`nms_keep_reference`,
`soft_nms_confirm_reference`): the same loop in torch with a fixed trip
count and no host decision. A CUDA tensor launches the kernel in
`csrc/nms.cu` on the current stream, or raises. Launch counts:
`nms_keep.launches`, `soft_nms_confirm.launches`.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build

PROD_CHUNK = 32              # csrc/nms.cu kProdChunk: the decay product's
                             # association (see soft_nms_confirm_reference)
MAX_KEEP_N = 32768           # nms_keep's kernel: at most 512 words a row
MAX_SOFT_N = 7000            # soft_nms_confirm's kernel: 7 bytes a box of
                             # 48 KB shared memory


def nms_keep_reference(supp: torch.Tensor, valid: torch.Tensor
                       ) -> torch.Tensor:
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


def soft_nms_confirm_reference(scores: torch.Tensor, dmat: torch.Tensor,
                               overlaps: torch.Tensor, alive: torch.Tensor,
                               neg_inf: float) -> torch.Tensor:
    """Soft-NMS's bulk confirmation: scores (..., N) f32, dmat (..., N, N)
    f32 decay of i by j, overlaps (..., N, N) bool (j can decay i; no
    diagonal), alive (..., N) bool → final (..., N) f32, each box's score
    when confirmed (`neg_inf` for the dead).

    A round: prov(i) = s_i · Π decays of i's confirmed overlappers; every
    unconfirmed alive box that no unconfirmed alive overlapper beats on
    (prov, -index) is confirmed at prov(i). The product is taken in a
    fixed order, the kernel's: chunks of PROD_CHUNK rows in index order,
    each chunk's product from 1 in index order, then the chunk products
    from 1 in index order. N rounds: a round after the last confirmation
    changes nothing, so no host decision ends the loop."""
    n = scores.shape[-1]
    dev = scores.device
    rank = torch.arange(n, device=dev)
    earlier = rank[:, None] < rank[None, :]
    pad = (-n) % PROD_CHUNK
    confirmed = torch.zeros_like(alive)
    final = torch.full_like(scores, neg_inf)
    for _ in range(n):
        decays = torch.where(confirmed[..., :, None] & overlaps, dmat,
                             torch.ones_like(dmat))
        chunks = F.pad(decays, (0, 0, 0, pad), value=1.0).reshape(
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
        newly = ~confirmed & alive & ~outranked
        final = torch.where(newly, prov, final)
        confirmed = confirmed | newly
    return final


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load_library("nms")
    lib.dat_nms_keep.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.dat_nms_keep.restype = ctypes.c_int
    lib.dat_soft_nms_confirm.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_float,
                                                      ctypes.c_void_p])
    lib.dat_soft_nms_confirm.restype = ctypes.c_int
    return lib


def _lanes(x: torch.Tensor, trailing: int) -> int:
    n = 1
    for d in x.shape[:x.dim() - trailing]:
        n *= d
    return n


def nms_keep(supp: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy NMS's keep mask (..., N) bool from supp (..., N, N) bool and
    valid (..., N) bool (see `nms_keep_reference`). CPU tensors run the
    plain version; CUDA tensors launch the sweep kernel or raise."""
    if not supp.is_cuda:
        return nms_keep_reference(supp, valid)
    what = "nms_keep kernel"
    n = valid.shape[-1]
    if (supp.dtype != torch.bool or valid.dtype != torch.bool
            or tuple(supp.shape) != tuple(valid.shape) + (n,)
            or valid.device != supp.device):
        raise ValueError(f"{what}: supp (..., N, N) and valid (..., N) must "
                         f"be bool on one device, got {tuple(supp.shape)} "
                         f"{supp.dtype}, {tuple(valid.shape)} {valid.dtype}")
    if n > MAX_KEEP_N:
        raise ValueError(f"{what}: N={n} > {MAX_KEEP_N}")
    lanes = _lanes(valid, 1)
    supp = supp.contiguous()
    valid = valid.contiguous()
    kept = torch.empty_like(valid)
    bits = torch.empty((lanes, n, (n + 63) // 64), dtype=torch.int64,
                       device=supp.device)
    lib = _lib()
    with torch.cuda.device(supp.device):
        err = lib.dat_nms_keep(supp.data_ptr(), valid.data_ptr(),
                               bits.data_ptr(), kept.data_ptr(), lanes, n,
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
    lib = _lib()
    with torch.cuda.device(scores.device):
        err = lib.dat_soft_nms_confirm(
            scores.data_ptr(), dmat.data_ptr(), overlaps.data_ptr(),
            alive.data_ptr(), final.data_ptr(), _lanes(scores, 1), n,
            neg_inf, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{what} launch")
    soft_nms_confirm.launches += 1
    return final


soft_nms_confirm.launches = 0
