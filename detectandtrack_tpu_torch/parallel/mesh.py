"""Data parallelism over processes, one per card: the port of
detectandtrack_tpu/parallel/mesh.py for `torch.distributed`.

The JAX package runs one program over a 1-D `data` mesh: parameters
replicated, the batch sharded on dim 0, and the gradient `pmean` inserted
under `shard_map`. PyTorch's idiom is one process per card: every rank
holds the model on its own device, takes its rows of the global batch, and
the ranks meet only in collectives. `Mesh` names that group; at world size
1 (no process group) every helper is the identity, as JAX's one-device mesh
is.

The backend is `nccl` when each rank has a card of its own, and `gloo` on
the CPU and where ranks share a card (NCCL refuses two ranks on one
device; gloo all-reduces and broadcasts CUDA tensors through the host).
Collectives of host arrays (`gather_batch`) run on the CPU under gloo and
on the rank's card under NCCL.
"""

from __future__ import annotations

import dataclasses
import datetime
import logging
import os
from typing import Any, Dict, List, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

DATA_AXIS = "data"
# Every collective of the group, the rendezvous included, fails after this
# long rather than hang on a rank that died.
TIMEOUT = datetime.timedelta(minutes=10)

logger = logging.getLogger(__name__)


def maybe_init_distributed(device: str = "cuda",
                           init_method: Optional[str] = None) -> bool:
    """Start the process group when a multi-process launch asks for it,
    before any other use of the card → whether this call started it.

    Asked for by torchrun's environment (`WORLD_SIZE`, `RANK`,
    `LOCAL_RANK`, with `MASTER_ADDR`/`MASTER_PORT` for the default
    `env://` rendezvous) or by `DAT_DISTRIBUTED=1` (a world of 1 unless
    `WORLD_SIZE` says otherwise); with neither it returns False and touches
    nothing, as it does when the group is already up. On `device` "cuda"
    the rank's card (`LOCAL_RANK` modulo the cards) is made current first,
    so nothing is allocated on another rank's card; `init_method` (e.g.
    `file://...`) replaces `env://`.
    """
    env = os.environ
    if not ("WORLD_SIZE" in env or env.get("DAT_DISTRIBUTED") == "1"):
        return False
    if dist.is_initialized():
        return False
    world = int(env.get("WORLD_SIZE", "1"))
    rank = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", "0"))
    local_world = int(env.get("LOCAL_WORLD_SIZE", str(world)))
    backend = "gloo"
    if torch.device(device).type == "cuda":
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError("--device cuda, but torch finds no CUDA "
                               "device; pass --device cpu to run on the CPU")
        torch.cuda.set_device(local_rank % cards)
        if local_world <= cards:
            backend = "nccl"
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world, rank=rank, timeout=TIMEOUT)
    logger.info("process group: rank %d of %d, backend %s, %s axis over "
                "%s", rank, world, backend, DATA_AXIS,
                f"cuda:{torch.cuda.current_device()}"
                if torch.device(device).type == "cuda" else "cpu")
    return True


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The data-parallel group as one rank sees it."""
    rank: int
    size: int                       # the world size
    device: torch.device            # this rank's
    group: Any = None               # the process group; None in one process
    backend: Optional[str] = None   # "nccl", "gloo"; None in one process


def make_mesh(device="cuda") -> Mesh:
    """The mesh of the running process group (a world of 1 without one);
    "cuda" means the rank's current card."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        return Mesh(0, 1, device)
    return Mesh(dist.get_rank(), dist.get_world_size(), device,
                dist.group.WORLD, dist.get_backend())


def shard_rows(mesh: Optional[Mesh], n: int) -> slice:
    """This rank's rows of a global batch of `n` (a multiple of the world
    size)."""
    if mesh is None or mesh.size == 1:
        return slice(0, n)
    if n % mesh.size:
        raise ValueError(f"a global batch of {n} does not split over "
                         f"{mesh.size} ranks")
    per = n // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_batch(mesh: Optional[Mesh], batch: Mapping[str, Any]
                ) -> Dict[str, Any]:
    """This rank's rows (dim 0) of every array or tensor of `batch`."""
    rows = shard_rows(mesh, len(next(iter(batch.values()))))
    return {k: v[rows] for k, v in batch.items()}


def replicate(mesh: Optional[Mesh], obj):
    """Broadcast a module's parameters and buffers, or a `TrainState`'s
    parameters and momentum, from rank 0, in place → obj."""
    if mesh is None or mesh.size == 1:
        return obj
    if isinstance(obj, nn.Module):
        tensors = list(obj.parameters()) + list(obj.buffers())
    else:
        tensors = list(obj.params.values()) + [obj.momentum[k] for k in
                                               sorted(obj.momentum)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, src=0, group=mesh.group)
    return obj


def pmean(mesh: Optional[Mesh], tensors: Sequence[torch.Tensor]
          ) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor: one all-reduce of all of
    them flattened together (one per dtype), then a division by the world
    size, as JAX's `pmean` (psum / n). The results are views of the
    reduced buffer, equal on every rank."""
    tensors = list(tensors)
    if mesh is None or mesh.size == 1:
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    by_dtype: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault(t.dtype, []).append(i)
    for idx in by_dtype.values():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        dist.all_reduce(flat, group=mesh.group)
        flat /= mesh.size
        pieces = flat.split([tensors[i].numel() for i in idx])
        for i, piece in zip(idx, pieces):
            out[i] = piece.view(tensors[i].shape)
    return out


def gather_batch(mesh: Optional[Mesh], arrays: Mapping[str, np.ndarray]
                 ) -> Dict[str, np.ndarray]:
    """Host arrays of this rank's rows → the global batch's, concatenated on
    dim 0 in rank order (every rank passes the same names, shapes and
    dtypes; one all-gather of their bytes)."""
    if mesh is None or mesh.size == 1:
        return dict(arrays)
    keys = sorted(arrays)
    arrs = [np.ascontiguousarray(arrays[k]) for k in keys]
    buf = torch.from_numpy(np.concatenate(
        [a.reshape(-1).view(np.uint8) for a in arrs]))
    if mesh.backend == "nccl":
        buf = buf.to(mesh.device)
    parts = [torch.empty_like(buf) for _ in range(mesh.size)]
    dist.all_gather(parts, buf, group=mesh.group)
    parts = [p.cpu().numpy() for p in parts]
    out, off = {}, 0
    for k, a in zip(keys, arrs):
        out[k] = np.concatenate([p[off:off + a.nbytes].view(a.dtype)
                                 .reshape(a.shape) for p in parts])
        off += a.nbytes
    return out


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank."""
    if mesh is None or mesh.size == 1:
        return
    if mesh.backend == "nccl":
        dist.barrier(group=mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(group=mesh.group)
