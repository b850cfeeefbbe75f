"""Captured device programs: the counterpart of the JAX package's ``jax.jit``
sites (gnumap_tpu/pipeline/mapper.py ``TpuMapper.__init__``), which compile
each device program once and dispatch one executable a batch.

A mapper's ``Programs`` holds one CUDA graph for each (program, the shape
and dtype of every input).  The first call with a key
  * copies the batch into static input tensors allocated for the key;
  * runs the program eagerly on a side stream (the warm-up): kernel
    libraries load, lazy CUDA modules load, ``cudaFuncSetAttribute`` and
    the occupancy queries run, all outside any capture.  Its outputs are
    the batch's result, so the first batch costs what an eager batch costs;
  * captures the program on the same inputs with ``torch.cuda.graph``
    (``capture_error_mode="thread_local"``: the checkpoint and finish pools
    are other threads), under the mapper's device, into a private memory
    pool that holds the program's transient peak for the life of the
    mapper.  Nothing runs during a capture.
Every later call copies the batch into the static inputs and replays the
graph on the current stream: the same kernels in the same order on the same
bits, and the same outputs, which live in the graph's pool and are
overwritten by the next replay (a caller that keeps them past that copies
them, or queues their copy behind the replay on the same stream).

Kernel launches stay counted: the capture records how much it raised each
kernel module's ``LAUNCHES`` and puts the counters back (nothing launched),
and every replay adds those numbers again.

A program may be captured only if its shapes are static and it reads
nothing back to the host (``tests/test_torch_graph.py`` holds the mapper's
programs to that).  A capture or a replay that fails raises; nothing falls
back to an eager run.  On the CPU every call runs the program eagerly, as
the caller asked for the CPU.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_tb
from gnumap_tpu_torch.posterior import accum
from gnumap_tpu_torch.utils import profiling

# the modules whose kernel wrappers count their launches (LAUNCHES)
KERNEL_MODULES = (nw_band, nw_full, nw_pure, nw_tb, accum)


def _counts() -> List[int]:
    return [m.LAUNCHES for m in KERNEL_MODULES]


class Captured:
    """One program captured for one key: the graph, its static inputs by
    name, its static outputs (the program's own structure), the launches
    of one run by kernel module, and the host seconds of its warm-up and
    of its capture (the graphs.warm_up and graphs.capture spans,
    utils/profiling.py)."""

    def __init__(self, graph, inputs: Dict[str, torch.Tensor], outputs,
                 launches: List[Tuple[object, int]], warm_up_s: float,
                 capture_s: float):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.warm_up_s = warm_up_s
        self.capture_s = capture_s
        self.replays = 0

    def replay(self):
        self.graph.replay()
        for mod, n in self.launches:
            mod.LAUNCHES += n
        self.replays += 1
        return self.outputs


class Programs:
    """A mapper's captured device programs on ``device`` (see the module
    docstring).  ``graphed`` is False on the CPU: every call is eager."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.graphed = self.device.type == "cuda"
        self.captured: Dict[tuple, Captured] = {}
        self._side = None

    @staticmethod
    def key(fn: Callable, arrays: Dict[str, np.ndarray]) -> tuple:
        """(program name, (input name, shape, dtype) of every input)."""
        return (fn.__name__,) + tuple(
            (k, tuple(a.shape), np.dtype(a.dtype).str)
            for k, a in arrays.items())

    def __call__(self, fn: Callable, slot, **arrays: np.ndarray):
        """``fn`` on ``arrays`` staged through ``slot``
        (pipeline/staging.py), positional in the order given: eager on the
        CPU; on a card the first call of a key warms up and captures, every
        later one replays."""
        if not self.graphed:
            with profiling.span("graphs.replay"):
                return fn(*(slot.upload(k, a) for k, a in arrays.items()))
        key = self.key(fn, arrays)
        cap = self.captured.get(key)
        if cap is not None:
            with profiling.span("graphs.replay"):
                for k, a in arrays.items():
                    slot.upload(k, a, out=cap.inputs[k])
                return self._replay(cap)
        inputs = {k: torch.empty(a.shape, dtype=torch.from_numpy(
            np.empty(0, a.dtype)).dtype, device=self.device)
            for k, a in arrays.items()}
        for k, a in arrays.items():
            slot.upload(k, a, out=inputs[k])
        args = tuple(inputs.values())
        with profiling.span("graphs.warm_up") as warm:
            out = self._warm_up(fn, args)
        before = _counts()
        try:
            with profiling.span("graphs.capture") as capture:
                graph, outputs = self._capture(fn, args)
        finally:
            after = _counts()
            for mod, n in zip(KERNEL_MODULES, before):
                mod.LAUNCHES = n
        self.captured[key] = Captured(
            graph, inputs, outputs,
            [(m, a - b) for m, a, b in zip(KERNEL_MODULES, after, before)
             if a != b], warm.seconds, capture.seconds)
        return out

    def _replay(self, cap: Captured):
        """cap replayed on the current stream of the mapper's device, the
        one its uploads and fetches use."""
        with torch.cuda.device(self.device):
            return cap.replay()

    def _side_stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(device=self.device)
        return self._side

    def _warm_up(self, fn, args):
        """fn(*args) eagerly on the side stream, ordered after the inputs'
        copies; the current stream then waits for it.  Each input is
        marked as used on the side stream and each output on the current
        one, so that no memory is handed out again while a stream other
        than its own may still use it."""
        with torch.cuda.device(self.device):
            cur = torch.cuda.current_stream()
            side = self._side_stream()
            side.wait_stream(cur)
            for t in args:
                t.record_stream(side)
            with torch.cuda.stream(side):
                out = fn(*args)
            cur.wait_stream(side)
            for t in pytree.tree_leaves(out):
                if isinstance(t, torch.Tensor):
                    t.record_stream(cur)
        return out

    def _capture(self, fn, args):
        """(graph, static outputs) of fn(*args) captured on the side
        stream."""
        with torch.cuda.device(self.device):
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=self._side_stream(),
                                  capture_error_mode="thread_local"):
                outputs = fn(*args)
        return graph, outputs

    def pool_bytes(self) -> int:
        """Bytes the captured programs' private pools hold (the caching
        allocator's segments of each graph's pool)."""
        pools = {tuple(c.graph.pool()) for c in self.captured.values()}
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s["segment_pool_id"]) in pools)
