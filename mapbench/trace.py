"""The traced stretch of a ``--trace 1`` window: ``torch.profiler`` with
CUDA activity only, started at a submit once a share of the window has
passed (after a ``synchronize``, so that no earlier batch's kernels fall
into it) and stopped when the last batch submitted in the stretch has
finished.  The events are read after the window has closed.

Kineto stamps events on the Unix clock (``time.time_ns``); host spans are
on ``perf_counter``, and one pair of readings converts between them.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import numpy as np

# the stretch: from this share of the window, for this share, at most
STRETCH_FROM = 0.4
STRETCH_SHARE = 0.2
STRETCH_MAX_S = 8.0


def _profile():
    import torch
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def warm_profiler(device) -> None:
    """Load CUPTI and kineto in set-up, so that starting the stretch's
    profiler does not stall the window."""
    import torch
    with _profile():
        torch.ones(8, device=device).sum().item()


class Tracer:
    def __init__(self, seconds: float):
        self.t_from = seconds * STRETCH_FROM
        self.t_len = min(seconds * STRETCH_SHARE, STRETCH_MAX_S)
        self.prof = None
        self.state = "wait"
        self.first: Optional[int] = None
        self.last: Optional[int] = None
        self.t0_ns = self.t1_ns = 0
        self._rec = None

    def before_submit(self, index: int) -> None:
        import torch
        rec = self._rec
        elapsed = time.perf_counter() - rec.t_start
        if self.state == "wait" and elapsed >= self.t_from:
            torch.cuda.synchronize()
            self.prof = _profile()
            self.prof.__enter__()
            self.t0_ns = time.time_ns()
            self.first = index
            self.state = "on"
        elif (self.state == "on" and self.last is None
              and elapsed >= self.t_from + self.t_len):
            self.last = index - 1

    def after_finish(self, index: int, rec) -> None:
        if self.state == "on" and self.last is not None \
                and index >= self.last:
            t0 = time.perf_counter()
            self._stop()
            rec.span("tracer", t0, time.perf_counter())

    def _stop(self) -> None:
        self.t1_ns = time.time_ns()
        self.prof.__exit__(None, None, None)
        self.state = "off"

    def close(self) -> None:
        if self.state == "on":
            self._stop()

    def bind(self, rec) -> None:
        self._rec = rec

    def summary(self, rec, kernel_names: Dict[str, str]) -> Optional[dict]:
        """Busy and idle time of the stretch, device time by operation,
        the instances of each named kernel (``kernel_names``: short name ->
        a part of the kernel's symbol), and the idle gaps, each named by the
        benchmark span the host was in when it began."""
        import torch
        if self.prof is None:
            return None
        cuda = torch.autograd.DeviceType.CUDA
        lo, hi = self.t0_ns, self.t1_ns
        ev = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
              for e in self.prof.profiler.kineto_results.events()
              if e.device_type() == cuda]
        ev = [(max(a, lo), min(b, hi), n) for a, b, n in ev
              if b > lo and a < hi]
        by_op: Dict[str, float] = {}
        for a, b, n in ev:
            by_op[n] = by_op.get(n, 0.0) + (b - a) * 1e-9
        kernels = {}
        for short, part in kernel_names.items():
            hits = [b - a for a, b, n in ev if part in n]
            kernels[short] = dict(n=len(hits), seconds=sum(hits) * 1e-9)
        iv = sorted((a, b) for a, b, _ in ev)
        busy = 0
        gaps: List[tuple] = []
        cur = lo
        for a, b in iv:
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if hi > cur:
            gaps.append((cur, hi))
        off = time.time_ns() - time.perf_counter_ns()
        where = _SpanIndex(rec)
        named = sorted(((b - a) * 1e-9, where.at((a - off) * 1e-9))
                       for a, b in gaps)[::-1]
        idle_by_span: Dict[str, float] = {}
        for s, name in named:
            idle_by_span[name] = idle_by_span.get(name, 0.0) + s
        return dict(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                    n_events=len(ev), first=self.first, kernels=kernels,
                    device_ops=sorted(by_op.items(), key=lambda kv: -kv[1]),
                    idle_gaps=[[n, s] for s, n in named],
                    idle_by_span=idle_by_span)


class _SpanIndex:
    """Which benchmark span the host was in at a time on its clock."""

    NAMES = ("parse", "submit", "finish", "fetch", "tracer")

    def __init__(self, rec):
        self.arrays = []
        for name in self.NAMES:
            sp = sorted(rec.spans[name])
            self.arrays.append((name, np.array([a for a, _ in sp]),
                                np.array([b for _, b in sp])))

    def at(self, t: float) -> str:
        for name, starts, ends in self.arrays:
            k = int(np.searchsorted(starts, t, side="right")) - 1
            if k >= 0 and ends[k] > t:
                return name
        return "stream"
