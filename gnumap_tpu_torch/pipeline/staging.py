"""Host staging of one mapper's copies to and from its device: a fixed ring
of buffers, reused batch after batch.

A batch's uploads (read codes and qualities, lengths) leave from host
buffers with ``non_blocking``, and its blob comes back into one, so that
map_stream's device work overlaps the host finish of earlier batches.  On a
card these buffers are pinned.  Pinning a fresh copy of every upload and
allocating a fresh pinned blob every batch would go through PyTorch's
caching host allocator once per copy; the ring instead allocates each
buffer once, at the batch's shape, and hands the same ones out again.

A slot holds one batch's buffers, by name.  It is handed out again only
when
  * nothing holds its buffers but the slot itself (PyTorch's count of the
    references to a buffer's storage, which every tensor and numpy view of
    it adds to): the blob a finish decodes is a view of a slot's buffer, so
    a view that survived a finish keeps its slot from being overwritten;
  * the event recorded behind its last copy has completed (``acquire``
    waits for it), so an upload buffer is never written while its
    ``non_blocking`` H2D copy may still read it, nor a blob buffer while
    its D2H copy may still write it.
When map_stream submits a batch it holds ``depth`` others in flight, so its
ring has ``depth`` + 1 slots; the capacity-overflow fallback, which stages
one batch more from inside a finish, has a ring of one slot of its own.  A
caller that holds more slots than its ring has raises rather than waits.

On a card whose mapper replays a captured program (pipeline/graphs.py) an
upload lands in the program's static input, and the blob's copy is queued
right behind the replay on the same stream, so the next replay overwrites
the static output only after that copy.  A slot also owns device buffers
(``keep``): the accumulate path copies a batch's hit rows and PWMs there
at submit, and reads them at the batch's finish, at the addresses the
slot's captured accumulate programs hold.  The views it hands out keep
the slot busy as a pinned buffer's do, so the slot's next batch, which
writes them again, comes after that finish on the same stream.  On the
CPU the buffers are plain tensors, the "device" tensor of an upload is the
buffer itself and nothing is recorded, so the same reuse logic runs in the
tests without a card.  A pinned allocation that fails raises: there is no
pageable fallback.
"""

from __future__ import annotations

import gc
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gnumap_tpu_torch.utils import profiling


def _uses(t: torch.Tensor) -> int:
    """References to ``t``'s storage: one for each tensor over it, and for
    each numpy array made from one."""
    return torch._C._storage_Use_Count(t.untyped_storage()._cdata)


class Slot:
    """One batch's staging buffers, by name (see the module docstring)."""

    def __init__(self, ring: "StagingRing"):
        self._ring = ring
        self.bufs: Dict[str, torch.Tensor] = {}
        self._own: Dict[str, int] = {}   # a buffer's uses with no view alive
        self.kept: Dict[str, torch.Tensor] = {}   # device buffers (keep)
        self._own_kept: Dict[str, int] = {}
        self.event = None            # behind the slot's last copy (card)

    def busy(self) -> bool:
        """Something other than the slot holds one of its buffers, pinned
        or kept (a view that ``keep`` handed out)."""
        return any(_uses(b) > self._own[k] for k, b in self.bufs.items()) \
            or any(_uses(b) > self._own_kept[k] for k, b in self.kept.items())

    def view(self, name: str, shape, dtype: torch.dtype) -> torch.Tensor:
        """A tensor of ``shape`` and ``dtype`` over the buffer ``name``,
        allocated at the first request (and again only for a larger one)."""
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        buf = self.bufs.get(name)
        if buf is None or buf.numel() < n:
            buf = self.bufs[name] = torch.empty(
                max(n, 1), dtype=torch.uint8, pin_memory=self._ring.pinned)
            self._own[name] = _uses(buf)
            self._ring.allocs += 1
        return buf[:n].view(dtype).view(tuple(shape))

    def keep(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A view of the device buffer ``name`` with ``t``'s values (a copy
        queued on the current stream): the same memory batch after batch,
        allocated at the first request and again only for another shape
        or dtype.  The slot is busy while the view lives, so that the next
        batch's copy cannot land under a program that still reads it."""
        buf = self.kept.get(name)
        if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
            buf = self.kept[name] = torch.empty(t.shape, dtype=t.dtype,
                                                device=t.device)
            self._own_kept[name] = _uses(buf)
        return buf.copy_(t).view(buf.shape)

    def record(self) -> Optional["torch.cuda.Event"]:
        """An event behind the copies queued so far (None on the CPU)."""
        if not self._ring.pinned:
            return None
        self.event = torch.cuda.Event()
        self.event.record()
        return self.event

    def upload(self, name: str, arr, out: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
        """``arr`` on the ring's device, through the buffer ``name``: a
        non_blocking copy on a card, the buffer itself on the CPU.  With
        ``out`` (a captured program's static input, pipeline/graphs.py) the
        copy lands there, and ``out`` is returned."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        host = self.view(name, src.shape, src.dtype)
        host.copy_(src)
        if out is not None:
            out.copy_(host, non_blocking=self._ring.pinned)
        elif not self._ring.pinned:
            return host
        else:
            out = host.to(self._ring.device, non_blocking=True)
        self.record()
        return out

    def fetch(self, name: str, blob: torch.Tensor
              ) -> Tuple[torch.Tensor, Optional["torch.cuda.Event"]]:
        """Start ``blob``'s copy into the buffer ``name``: (host tensor,
        the event that marks the copy's end, None on the CPU)."""
        with profiling.span("staging.fetch"):
            host = self.view(name, blob.shape, blob.dtype)
            host.copy_(blob, non_blocking=self._ring.pinned)
            return host, self.record()


class StagingRing:
    """A fixed ring of ``slots`` staging slots for copies to and from
    ``device``."""

    def __init__(self, device, slots: int):
        self.device = torch.device(device)
        self.pinned = self.device.type == "cuda"
        self.slots = [Slot(self) for _ in range(slots)]
        self._next = 0
        self.allocs = 0              # buffers allocated, over the ring's life

    def acquire(self) -> Slot:
        """The next free slot in ring order, once its last copy is done."""
        with profiling.span("staging.acquire"):
            n = len(self.slots)
            for _ in range(2):
                for k in range(n):
                    i = (self._next + k) % n
                    s = self.slots[i]
                    if not s.busy():
                        if s.event is not None:
                            if not s.event.query():
                                profiling.COUNTS["staging.waits"] += 1
                                s.event.synchronize()
                            s.event = None
                        self._next = (i + 1) % n
                        return s
                # a traceback may hold the last views in a reference cycle
                profiling.COUNTS["staging.forced_gc"] += 1
                gc.collect()
            raise RuntimeError(
                f"staging ring: all {n} slots are held (more batches "
                "submitted and not finished than the ring has slots, or a "
                "view of a finished blob kept)")
