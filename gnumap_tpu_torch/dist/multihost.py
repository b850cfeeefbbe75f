"""Multi-host execution on torch.distributed — the counterpart of
gnumap_tpu/dist/multihost.py, the reference's MPI layer.

Reference analog (SURVEY.md §3.5): ``mpirun -np R gnumap`` — each rank loads
the genome, maps its 1/R of the reads, coverage arrays ``MPI_Reduce`` to rank
0, SAM chunks gathered and merged at rank 0.

  * the process group comes from ``initialize``: ``init_process_group``
    with a TCP rendezvous at the coordinator, NCCL when each rank has a card
    of its own, gloo otherwise (two ranks on one card, or the CPU);
  * reads partition by FILE BYTE RANGE for plain single-FASTQ input (host h
    parses only bytes [h/R, (h+1)/R) of the file, record-aligned by
    fastq_ranges); multi-file or prb/int inputs fall back to BATCH-stride
    partitioning (host h keeps global batches h, h+R, ...);
  * the coverage/tally merge is a CHUNKED ``all_gather`` of the float64 BIT
    PATTERN (an int32 view — no arithmetic on the wire) followed by a
    host-ordered reduction per chunk at every host: bit-reproducible
    whatever the topology, peak extra memory R x chunk, and byte-identical
    to a single-process run whenever the per-position weight sums are
    exactly representable.  Never ``all_reduce`` on float64: its order
    depends on the topology;
  * SAM shards are written per host with per-batch byte offsets and merged
    by GLOBAL batch index at host 0 over the shared filesystem.

The host-only functions (``strided``, ``_next_record_start``,
``fastq_ranges``, ``shard_paths``, ``write_shard_index``,
``merge_sam_shards``) are copies of the JAX package's, held to them by
tests/test_torch_hostlib.py.  ``merge_sam_shards_gp`` is the port's own: a
streaming merge that refuses shards out of order, byte-equal to the JAX
merge on shards in the writer's order (the same tests).
"""

from __future__ import annotations

import heapq
import itertools
import json
import os
from typing import Iterable, Iterator, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from gnumap_tpu_torch.dist import mesh as mesh_mod


def backend_for(device, world_size: int) -> str:
    """"nccl" when the rank's device is a card and each rank of this host
    (``LOCAL_WORLD_SIZE``, else the whole world) has a card of its own;
    "gloo" otherwise."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    if (torch.device(device).type == "cuda" and dist.is_nccl_available()
            and torch.cuda.device_count() >= local):
        return "nccl"
    return "gloo"


def initialize(coordinator: str, num_hosts: int, host_id: int,
               device="cuda") -> str:
    """Join the process group of ``num_hosts`` ranks at ``coordinator``
    (host:port, rank 0's address) as rank ``host_id``; a rank on a card
    takes ``cuda:{local_rank % device_count}``.  Returns the backend."""
    dev = torch.device(device)
    backend = backend_for(dev, num_hosts)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_hosts, rank=host_id)
    if dev.type == "cuda":
        torch.cuda.set_device(mesh_mod.rank_device(dev))
    return backend


def shutdown() -> None:
    """Leave the process group (when there is one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def strided(batches: Iterable, num_hosts: int, host_id: int) -> Iterator:
    """Host h's read partition: global batches h, h+R, h+2R, ..."""
    for i, b in enumerate(batches):
        if i % num_hosts == host_id:
            yield b


def allreduce_f64(local: np.ndarray,
                  chunk_elems: int = 8 << 20,
                  op: str = "sum") -> np.ndarray:
    """Deterministic cross-host float64 reduce (the MPI_Reduce analog);
    ``op`` = "sum" or "min".

    Chunked all_gather of the int32 bit view (exact), then an explicitly
    host-ordered reduction per chunk — every host computes the identical
    result, and peak transient memory is R x chunk (64 MiB per peer at
    the default chunk), independent of array size.  Chunking cannot change
    any bit: each element is still reduced host 0..R-1 in order."""
    shape = local.shape
    flat = np.ascontiguousarray(local, dtype=np.float64).reshape(-1)
    out = np.empty_like(flat)
    for lo in range(0, max(flat.size, 1), chunk_elems):
        part = flat[lo:lo + chunk_elems]
        if part.size == 0:
            break
        bits = torch.from_numpy(part.view(np.int32).copy())
        g = mesh_mod.all_gather(bits)
        parts = np.stack([x.numpy() for x in g]).view(np.float64)
        acc = parts[0].copy()
        for r in range(1, parts.shape[0]):
            if op == "min":
                np.minimum(acc, parts[r], out=acc)
            else:
                acc += parts[r]
        out[lo:lo + chunk_elems] = acc
    return out.reshape(shape)


def _next_record_start(f, off: int, limit: int = 1 << 20) -> int:
    """Byte offset of the first FASTQ record starting at or after ``off``.

    A record start is a line beginning with '@' whose line+2 begins with
    '+' (quality lines that begin with '@' fail that check because two
    lines later is the NEXT record's sequence line, never '+')."""
    f.seek(off)
    win = f.read(limit)
    lines = win.split(b"\n")
    # byte offset of each line start within the window
    pos = 0
    starts = []
    for ln in lines:
        starts.append(pos)
        pos += len(ln) + 1
    first = 0 if off == 0 else 1          # skip the partial first line
    for i in range(first, len(lines) - 2):
        if lines[i].startswith(b"@") and lines[i + 2].startswith(b"+"):
            return off + starts[i]
    return off + len(win)                  # no record in window (EOF tail)


def fastq_ranges(path: str, num_hosts: int) -> List[Tuple[int, int]]:
    """Record-aligned byte ranges partitioning one FASTQ file across hosts.

    Every byte belongs to exactly one host (all hosts compute the same
    boundaries), and host ranges are contiguous in file order, so the
    host-major merge reproduces the single-process read order."""
    size = os.path.getsize(path)
    cuts = [0]
    with open(path, "rb") as f:
        for h in range(1, num_hosts):
            cuts.append(min(size, _next_record_start(
                f, h * size // num_hosts)))
    cuts.append(size)
    return [(cuts[h], cuts[h + 1]) for h in range(num_hosts)]


def barrier(name: str) -> None:
    """Every rank waits here until all have arrived (``name`` labels the
    point for the reader; torch's barrier has no names)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shard_paths(output: str, host_id: int) -> Tuple[str, str]:
    return (f"{output}.sam.host{host_id}",
            f"{output}.sam.host{host_id}.idx")


def write_shard_index(idx_path: str,
                      spans: List[Tuple[int, int, int, int]]) -> None:
    """spans: (order_major, order_minor, byte_start, byte_end) per batch.
    Stride partitioning orders by (global_batch=k*R+h,); byte-range
    partitioning by (host, local_batch) — both encoded as (major, minor)."""
    with open(idx_path, "w") as f:
        for row in spans:
            f.write(json.dumps(row) + "\n")


def _gp_shard_records(output: str, h: int):
    """((batch, read, key), h, line) for each record of host h's
    genome-partitioned shard, in file order: the shard and its index are
    read line by line, together.  Raises RuntimeError where the two differ
    in length or a row does not rise strictly above the one before it
    (the writer emits them rising, and the merge relies on it)."""
    body, idx = shard_paths(output, h)
    prev = None
    with open(body, "rb") as fb, open(idx) as fi:
        for n, (line, meta) in enumerate(
                itertools.zip_longest(fb, fi), start=1):
            if line is None or meta is None:
                raise RuntimeError(
                    f"gp shard {h}: records and index rows differ in "
                    f"number at line {n}")
            row = tuple(json.loads(meta))
            if prev is not None and row <= prev:
                raise RuntimeError(
                    f"gp shard {h}: index row {list(row)} at line {n} does "
                    f"not rise above {list(prev)}")
            prev = row
            yield row, h, line


def merge_sam_shards_gp(output: str, num_hosts: int, header: str) -> None:
    """Host-0 SAM merge for the GENOME-PARTITIONED mode: a read's records
    are split across hosts (host h owns segments h, h+R, ...), so the
    merge interleaves at RECORD granularity.  Each host's shard holds its
    records in (global batch, read, (2*pos + strand) key) order and its
    index file carries one (batch, read, key) row per record, aligned 1:1
    with the shard's lines; coordinates partition across hosts, so keys
    never tie and the merged order is exactly the single-process
    segmented emission order (read-ascending, hits by (pos, strand)).
    A streaming k-way merge: one record of each host in memory at a time;
    a host whose rows do not rise strictly raises RuntimeError (naming the
    host and line) rather than emit out of order."""
    with open(output + ".sam", "wb") as out:
        out.write(header.encode())
        for _, _, line in heapq.merge(*(_gp_shard_records(output, h)
                                        for h in range(num_hosts))):
            out.write(line)
    for h in range(num_hosts):
        body, idx = shard_paths(output, h)
        os.remove(body)
        os.remove(idx)


def merge_sam_shards(output: str, num_hosts: int, header: str) -> None:
    """Host-0 merge: interleave per-batch shard chunks by their global
    order key, producing the same record order as a single-process run."""
    chunks = []   # (major, minor, host, start, end)
    for h in range(num_hosts):
        body, idx = shard_paths(output, h)
        with open(idx) as f:
            for line in f:
                maj, mino, s, e = json.loads(line)
                chunks.append((maj, mino, h, s, e))
    chunks.sort()
    handles = [open(shard_paths(output, h)[0], "rb")
               for h in range(num_hosts)]
    try:
        with open(output + ".sam", "wb") as out:
            out.write(header.encode())
            for maj, mino, h, s, e in chunks:
                handles[h].seek(s)
                out.write(handles[h].read(e - s))
    finally:
        for f in handles:
            f.close()
    for h in range(num_hosts):
        body, idx = shard_paths(output, h)
        os.remove(body)
        os.remove(idx)
