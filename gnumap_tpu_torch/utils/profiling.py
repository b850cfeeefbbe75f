"""Tracing/profiling hooks — the counterpart of gnumap_tpu/utils/profiling.py
(SURVEY.md §5 "Tracing/profiling").

  * ``trace(dir)`` — a context manager capturing a torch.profiler trace
    (CPU activity, and the card's kernels and copies when there is a card)
    around any mapping region, exported as a Chrome trace
    ``<dir>/trace.<pid>.json`` (Perfetto-viewable);
  * ``annotate(name)`` — a named region that shows up in such traces
    (torch.profiler.record_function) and, on a card, as an NVTX range;
  * per-batch structured stats live in pipeline.mapper.BatchStats and are
    emitted as JSONL by the CLI's ``-v`` (DP cell-updates/sec is
    ``dp_cells / device_s``).
"""

from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir,
                                          f"trace.{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    with torch.profiler.record_function(name):
        if torch.cuda.is_available():
            with torch.cuda.nvtx.range(name):
                yield
        else:
            yield
