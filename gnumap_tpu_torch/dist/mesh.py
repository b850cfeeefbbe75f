"""The reads x index mesh on torch.distributed — the counterpart of
gnumap_tpu/dist/mesh.py.

JAX drives every device of a ``Mesh(("reads", "index"))`` from one process
through ``shard_map``.  In torch one process owns one device, so the mesh is
a world of ``R * S`` ranks: rank ``r * S + s`` holds reads block ``r`` and
index shard ``s``.

  * axis "reads"  — data parallelism: the batch's rows split into R blocks
    (the reference's read-partitioned MPI mode);
  * axis "index"  — the CSR k-mer index split by k-mer range into S shards
    (the reference's genome-partitioned MPI mode, BASELINE.json config 5).

Each axis is a set of process groups: the "reads" group of a rank holds the
ranks of its index shard (fixed s), the "index" group the ranks of its
reads block (fixed r).  ``reads_sharding`` and ``replicated`` of the JAX
module have no meaning without ``NamedSharding``: a rank takes its rows of a
global batch through ``Mesh.batch_range`` and keeps its index shard and the
replicated arrays on its own device.

Collectives go through ``all_gather`` / ``all_reduce`` here, on the backend
of the process group: NCCL on each rank's card, or gloo, whose tensors are
staged through host memory when they live on a card.  The backend decides
the staging, never a caught exception, and ``COMM`` counts the calls, their
seconds, the bytes through them and the bytes staged.  Without an
initialised process group the mesh is one rank and every collective returns
its input.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

READS_AXIS = "reads"
INDEX_AXIS = "index"


@dataclasses.dataclass
class CommStats:
    """What this process's collectives cost: calls, seconds (a card is
    synchronised before and after each call, so pending compute is not
    counted), bytes in and out of the collectives, and bytes copied
    between a card and host memory for gloo."""
    calls: int = 0
    seconds: float = 0.0
    bytes: int = 0
    staged_bytes: int = 0

    def reset(self) -> None:
        self.calls, self.seconds, self.bytes, self.staged_bytes = 0, 0.0, 0, 0


COMM = CommStats()


def _wire_device(group) -> torch.device:
    """Where the backend of ``group`` takes its tensors: host memory for
    gloo, this rank's card for NCCL."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _sync(*devs) -> None:
    for d in devs:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's ``t`` in ``group`` (the world when None), in group-rank
    order, on ``t``'s device."""
    if not dist.is_initialized():
        return [t]
    wire = _wire_device(group)
    _sync(t.device, wire)
    t0 = time.perf_counter()
    src = t.contiguous()
    if src.device != wire:
        src = src.to(wire)
        COMM.staged_bytes += src.numel() * src.element_size()
    n = dist.get_world_size(group)
    out = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(out, src, group=group)
    nbytes = src.numel() * src.element_size()
    if wire != t.device:
        out = [x.to(t.device) for x in out]
        COMM.staged_bytes += n * nbytes
    _sync(t.device, wire)
    COMM.calls += 1
    COMM.bytes += (n + 1) * nbytes
    COMM.seconds += time.perf_counter() - t0
    return out


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce(t: torch.Tensor, op: str = "sum", group=None) -> torch.Tensor:
    """The elementwise ``op`` ("sum", "max" or "min") of every rank's ``t``
    in ``group`` (the world when None), as a new tensor on ``t``'s device.
    Integer tensors reduce exactly; a float sum's order is the backend's."""
    if not dist.is_initialized():
        return t.clone()
    wire = _wire_device(group)
    _sync(t.device, wire)
    t0 = time.perf_counter()
    buf = t.to(wire, copy=True).contiguous()
    nbytes = buf.numel() * buf.element_size()
    if wire != t.device:
        COMM.staged_bytes += nbytes
    dist.all_reduce(buf, op=_OPS[op], group=group)
    if wire != t.device:
        buf = buf.to(t.device)
        COMM.staged_bytes += nbytes
    _sync(t.device, wire)
    COMM.calls += 1
    COMM.bytes += 2 * nbytes
    COMM.seconds += time.perf_counter() - t0
    return buf


def local_rank() -> int:
    """This process's rank on its host: ``LOCAL_RANK`` when the launcher
    sets it, else the global rank (one host)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    return int(os.environ.get("LOCAL_RANK", rank))


def rank_device(device="cuda") -> torch.device:
    """The device a rank owns: ``cuda:{local_rank % device_count}``, or the
    CPU when the caller asks for it.  Raises without a card."""
    device = torch.device(device)
    if device.type == "cpu":
        return device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}: use cuda or cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch finds no CUDA "
                           "card (torch.cuda.is_available() is False)")
    return torch.device("cuda", local_rank() % torch.cuda.device_count())


@dataclasses.dataclass
class Mesh:
    """This rank's view of the reads x index mesh: ``shape[READS_AXIS]``,
    ``shape[INDEX_AXIS]``, its coordinates ``(r, s)``, the process groups of
    its two axes (None without a process group) and its device."""
    shape: Dict[str, int]
    coords: Tuple[int, int]
    groups: Dict[str, Optional[object]]
    device: torch.device

    @property
    def size(self) -> int:
        return self.shape[READS_AXIS] * self.shape[INDEX_AXIS]

    def batch_range(self, B: int) -> Tuple[int, int]:
        """This rank's rows [lo, hi) of a global batch of B rows (its reads
        block); B must divide by the read shards."""
        R = self.shape[READS_AXIS]
        if B % R:
            raise ValueError(f"batch_size {B} must divide by read shards {R}")
        r = self.coords[0]
        return r * (B // R), (r + 1) * (B // R)

    def all_gather(self, t: torch.Tensor, axis: str) -> List[torch.Tensor]:
        """Every rank's ``t`` along ``axis``, in axis order."""
        return all_gather(t, self.groups[axis])

    def all_reduce(self, t: torch.Tensor, op: str = "sum",
                   axis: Optional[str] = None) -> torch.Tensor:
        """``op`` over ``axis``, or over both axes when None."""
        if axis is None:
            return all_reduce(t, op, None)
        return all_reduce(t, op, self.groups[axis])


def make_mesh(read_shards: Optional[int] = None, index_shards: int = 1,
              device="cuda") -> Mesh:
    """The (read_shards, index_shards) mesh over the initialised world (one
    rank when there is no process group).  ``read_shards`` None takes every
    rank: world / index_shards.  Every rank must call this, in the same
    order as every other mesh, since it creates the axes' groups."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if read_shards is None:
        if n % index_shards:
            raise ValueError(f"{n} devices not divisible by "
                             f"index_shards={index_shards}")
        read_shards = n // index_shards
    need = read_shards * index_shards
    if need > n:
        raise ValueError(f"need {need} devices, have {n}")
    if need < n:
        raise ValueError(f"a {read_shards} x {index_shards} mesh takes "
                         f"{need} ranks, one device each; the world has {n}")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = dist.get_rank() if dist.is_initialized() else 0
    R, S = read_shards, index_shards
    groups: Dict[str, Optional[object]] = {READS_AXIS: None, INDEX_AXIS: None}
    if dist.is_initialized():
        for s in range(S):          # reads groups: one per index shard
            g = dist.new_group([r * S + s for r in range(R)])
            if rank % S == s:
                groups[READS_AXIS] = g
        for r in range(R):          # index groups: one per reads block
            g = dist.new_group([r * S + s for s in range(S)])
            if rank // S == r:
                groups[INDEX_AXIS] = g
    return Mesh({READS_AXIS: R, INDEX_AXIS: S}, (rank // S, rank % S),
                groups, dev)
