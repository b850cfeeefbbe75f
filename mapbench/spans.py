"""The program's own spans and collector pauses over a run's window, for
the per-layer readers in ``metrics/``.

The port records them itself (``gnumap_tpu_torch/utils/profiling.py``: a
ring of spans stamped with ``time.perf_counter_ns``, the clock of the
window's ``Recorder``, and a ring of the collector's pauses).  A reader
returns None, never 0, when the program keeps no such record (a checkout
whose profiling module has no readers) or its ring no longer holds all of
the range read.
"""

from __future__ import annotations

from typing import Optional


def _reader(name: str):
    from gnumap_tpu_torch.utils import profiling
    return getattr(profiling, name, None)


def window_ns(records) -> tuple:
    """The window, from the call into ``map_stream`` to its return, on the
    program's clock (ns)."""
    rec = records.window.rec
    return int(rec.t_start * 1e9), int(rec.t_end * 1e9)


def spans_ns(names, t0: int, t1: int) -> Optional[int]:
    """Summed durations of the spans of ``names`` that started in
    [t0, t1]."""
    total_ns = _reader("total_ns")
    known = _reader("SPANS") or {}
    if total_ns is None or not all(n in known for n in names):
        return None
    got = [total_ns(n, t0, t1) for n in names]
    return None if None in got else sum(got)


def per_batch_ms(records, *names: str) -> Optional[float]:
    """The spans of ``names`` that started in the window, ms a batch."""
    if not records.n_batches:
        return None
    ns = spans_ns(names, *window_ns(records))
    return None if ns is None else ns * 1e-6 / records.n_batches


def gc_per_batch_ms(records, generation=None) -> Optional[float]:
    """The collector's pauses (of ``generation``, or all) that started in
    the window, ms a batch."""
    gc_ns = _reader("gc_ns")
    if gc_ns is None or not records.n_batches:
        return None
    ns = gc_ns(*window_ns(records), generation=generation)
    return None if ns is None else ns * 1e-6 / records.n_batches
