#!/usr/bin/env python
"""Where a benchmark window's host time goes, by the port's own spans
(gnumap_tpu_torch/utils/profiling.py), and what the spans cost.

    python3 tools/torch_stream_spans.py --out spans.json
    python3 tools/torch_stream_spans.py --device cpu --tiny   # rehearsal

Four parts, each a key of the JSON written to ``--out`` (``--only`` picks):

  cost    one span (open, close, record) and one collector callback, in ns
          on this host: a loop of spans against the empty loop, and
          ``gc.collect(0)`` with the hook against without it; one full
          collection of the process as it stands, and one after
          ``gc.freeze()`` (undone after);
  window  one window of a benchmark cell (mapbench's set-up, window and
          traced stretch, as ``python3 -m mapbench.run --trace 1`` runs
          them): the program's spans and the collector's pauses a batch,
          the window cut in sixths by span, the finishes of 100 ms or more
          and the full collections inside them, the card's idle gaps in
          the stretch named by the innermost program span open when each
          began (``span_at``), and the counters;
  cli     the CLI on the cell's genome and reads written as files, with
          and without ``--profile`` in turns (off, on, on, off): the
          ``done`` line's ``map_s``, the cost of tracing when it is on;
  ab      (only when asked) windows of one process with the spans and the
          collector hook on and off in turns (on, off, off, on, ...): the
          instrumentation's cost end to end.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from gnumap_tpu_torch.utils import profiling  # noqa: E402

CELL = "ecoli-k12-100bp.sam-unique"


def cost(n: int = 200_000, reps: int = 5) -> dict:
    """ns of one span and of one collector callback (best of ``reps``)."""
    def best(fn):
        out = []
        for _ in range(reps):
            t = time.perf_counter_ns()
            fn()
            out.append(time.perf_counter_ns() - t)
        return min(out) / n

    def empty():
        for _ in range(n):
            pass

    def spans():
        for _ in range(n):
            with profiling.span("stream.walk"):
                pass

    def collections():
        for _ in range(n // 10):
            gc.collect(0)

    base = best(empty)
    ring = profiling.RING
    profiling.RING = profiling.Ring(ring.size, 3)    # keep the real one
    try:
        span_ns = best(spans) - base
    finally:
        profiling.RING = ring
    with_hook = best(collections) * 10
    gc.callbacks.remove(profiling._on_gc)
    try:
        without = best(collections) * 10
    finally:
        gc.callbacks.append(profiling._on_gc)
    full = []
    for frozen in (False, True):
        if frozen:
            gc.freeze()
        t = time.perf_counter_ns()
        gc.collect(2)
        full.append(time.perf_counter_ns() - t)
    gc.unfreeze()
    return dict(span_ns=span_ns, loop_ns=base,
                gc_collect0_ns=without, gc_callback_ns=with_hook - without,
                tracked_objects=len(gc.get_objects()), gc_full_ns=full[0],
                gc_full_frozen_ns=full[1])


def _spec(tiny: bool):
    from mapbench import cell as cells
    if tiny:
        from mapbench.tests import tiny as tiny_mod
        return tiny_mod.spec(tiny_mod.BASE)
    return cells.cell(CELL)


def _gaps(tracer) -> list:
    """The card's idle gaps in the traced stretch, (start, end) in ns of
    perf_counter_ns (mapbench/trace.py's rule: no kernel, copy or
    memset)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    lo, hi = tracer.t0_ns, tracer.t1_ns
    iv = sorted((max(e.start_ns(), lo), min(e.start_ns() + e.duration_ns(),
                                             hi))
                for e in tracer.prof.profiler.kineto_results.events()
                if e.device_type() == cuda
                and e.start_ns() + e.duration_ns() > lo and e.start_ns() < hi)
    gaps, cur = [], lo
    for a, b in iv:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    off = time.time_ns() - time.perf_counter_ns()
    return [(a - off, b - off) for a, b in gaps]


def _overlap(a0, a1, rows) -> int:
    """ns of [a0, a1] that the [start, end] rows cover (rows disjoint)."""
    if not len(rows):
        return 0
    return int(np.clip(np.minimum(rows[:, 1], a1)
                       - np.maximum(rows[:, 0], a0), 0, None).sum())


def window(seed: int, seconds: float, device: str, tiny: bool) -> dict:
    from mapbench import check
    from mapbench.run import RunSetup
    from mapbench.window import run_window
    spec = _spec(tiny)
    sess = RunSetup(spec, seed, device, device == "cuda",
                    time.perf_counter())
    try:
        tracer = None
        if device == "cuda":
            from mapbench.trace import Tracer
            tracer = Tracer(seconds)
        c0 = profiling.counters()
        win = run_window(sess.mapper, sess.path, sess.cfg, seconds,
                         check.KEEP_EVERY, 0, tracer)
        c1 = profiling.counters()
    finally:
        sess.close()
    rec = win.rec
    t0, t1 = int(rec.t_start * 1e9), int(rec.t_end * 1e9)
    done = win.done
    nb = len(done)
    rows = profiling.RING.rows(t0, t1)
    pauses = profiling.GC.rows(t0, t1)
    by = {n: rows[rows[:, 0] == i][:, 1:] for i, n in
          enumerate(profiling.NAMES)}
    out = dict(seed=seed, window_s=win.seconds, batches=nb,
               reads_per_s=sum(b.n_out for b in done) / win.seconds,
               lost=profiling.RING.lost,
               counters={k: c1[k] - c0[k] for k in c1},
               tracked_objects=len(gc.get_objects()))
    out["span_ms_per_batch"] = {
        n: float((v[:, 1] - v[:, 0]).sum()) * 1e-6 / nb
        for n, v in by.items() if len(v)}
    out["outside_ms_per_batch"] = {
        k: sum(b - a for a, b in v) * 1e3 / nb for k, v in rec.spans.items()}
    dur = (pauses[:, 2] - pauses[:, 1]) * 1e-6
    out["gc"] = {
        f"gen{g}": dict(
            per_batch=float((pauses[:, 0] == g).sum()) / nb,
            ms_per_batch=float(dur[pauses[:, 0] == g].sum()) / nb,
            pause_ms=[float(np.percentile(dur[pauses[:, 0] == g], q))
                      for q in (0, 50, 90, 100)]
            if (pauses[:, 0] == g).any() else [],
            collected_median=float(np.median(pauses[pauses[:, 0] == g, 3]))
            if (pauses[:, 0] == g).any() else 0.0)
        for g in range(3)}
    # the window in sixths: each program span by its start, a batch done
    edges = t0 + np.arange(7) * (t1 - t0) / 6
    done_at = np.array([b.done * 1e9 for b in done])
    sixths = []
    for k in range(6):
        a, b = edges[k], edges[k + 1]
        n_k = int(((done_at >= a) & (done_at < b)).sum()) or 1
        d = {n: float(((v[:, 0] >= a) & (v[:, 0] < b))
                      @ (v[:, 1] - v[:, 0])) * 1e-6 / n_k
             for n, v in by.items() if len(v)}
        sel = (pauses[:, 1] >= a) & (pauses[:, 1] < b)
        d["gc"] = float(((pauses[:, 2] - pauses[:, 1]) * sel).sum()) \
            * 1e-6 / n_k
        d["gc_full"] = float(((pauses[:, 2] - pauses[:, 1])
                              * sel * (pauses[:, 0] == 2)).sum()) * 1e-6 / n_k
        sixths.append(dict(batches=n_k, span_ms_per_batch=d))
    out["sixths"] = sixths
    out["slice_reads_per_s"] = win.slice_rates(6)
    # finishes of 100 ms or more, and the full collections inside them
    fin = np.array([(a * 1e9, b * 1e9) for a, b in rec.spans["finish"]])
    full = pauses[pauses[:, 0] == 2][:, 1:3]
    long_ = fin[(fin[:, 1] - fin[:, 0]) >= 100e6]
    out["long_finishes"] = [
        dict(ms=(b - a) * 1e-6, full_gc_ms=_overlap(a, b, full) * 1e-6,
             gc_ms=_overlap(a, b, pauses[:, 1:3]) * 1e-6,
             wait_ms=_overlap(a, b, by["finish.wait"]) * 1e-6,
             decode_ms=_overlap(a, b, by["finish.decode"]) * 1e-6)
        for a, b in long_]
    fd = (fin[:, 1] - fin[:, 0]) * 1e-6
    out["finish_ms"] = [float(np.percentile(fd, q))
                        for q in (0, 25, 50, 75, 90, 99, 100)]
    full_ns = _overlap(0, 1 << 62, full)
    out["full_gc_in_finish_share"] = (
        sum(_overlap(a, b, full) for a, b in fin) / full_ns
        if full_ns else None)
    if tracer is not None and tracer.prof is not None:
        gaps = _gaps(tracer)
        named = {}
        for a, b in gaps:
            name = profiling.span_at(a) or "stream (no span)"
            e = named.setdefault(name, [0, 0.0, 0.0])
            e[0] += 1
            e[1] += (b - a) * 1e-6
            e[2] += _overlap(a, b, full) * 1e-6
        out["idle_gaps_by_span"] = {k: dict(n=v[0], ms=v[1], full_gc_ms=v[2])
                                    for k, v in named.items()}
        out["longest_gaps"] = [
            dict(ms=(b - a) * 1e-6, span=profiling.span_at(a),
                 full_gc_ms=_overlap(a, b, full) * 1e-6)
            for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]]
    return out


class _NoSpan:
    """``profiling.span`` with nothing recorded (the ``ab`` part)."""

    seconds = 0.0

    def __init__(self, name: str):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        pass


def ab(seed: int, seconds: float, n: int, device: str, tiny: bool) -> dict:
    """reads/s of ``n`` windows of one set-up, the spans and the collector
    hook on and off in turns."""
    from mapbench import check
    from mapbench.run import RunSetup
    from mapbench.window import run_window
    sess = RunSetup(_spec(tiny), seed, device, False, time.perf_counter())
    on_span, runs = profiling.span, []
    try:
        for k in range(n):
            on = k % 4 in (0, 3)
            profiling.span = on_span if on else _NoSpan
            if on:
                gc.callbacks.append(profiling._on_gc)
            else:
                gc.callbacks.remove(profiling._on_gc)
            win = run_window(sess.mapper, sess.path, sess.cfg, seconds,
                             check.KEEP_EVERY, 0)
            runs.append(dict(on=on, batches=len(win.done), reads_per_s=sum(
                b.n_out for b in win.done) / win.seconds))
            if on:
                gc.callbacks.remove(profiling._on_gc)
            else:
                gc.callbacks.append(profiling._on_gc)
    finally:
        profiling.span = on_span
        sess.close()
    med = {on: statistics.median(r["reads_per_s"] for r in runs
                                 if r["on"] == on) for on in (True, False)}
    return dict(runs=runs, seconds=seconds,
                on_over_off=med[True] / med[False] - 1)


def cli(seed: int, n_reads: int, device: str, tiny: bool) -> dict:
    """map_s of the CLI with and without --profile, in turns."""
    from mapbench.genome import make_genome
    from mapbench.traffic import make_pool, write_fastq
    spec = _spec(tiny)
    m = spec.config["mapper"]
    g = make_genome(spec.config, seed)
    mix = dict(spec.mix, pool_reads=n_reads)
    work = tempfile.mkdtemp(prefix="stream-spans-")
    fa, fq = os.path.join(work, "g.fa"), os.path.join(work, "r.fastq")
    with open(fa, "w") as f:
        f.write(f">{g.contig}\n")
        f.write(np.frombuffer(b"ACGT", np.uint8)[g.codes].tobytes().decode())
        f.write("\n")
    write_fastq(make_pool(g, mix, seed), g.contig, fq)
    argv = [sys.executable, "-m", "gnumap_tpu_torch.cli.main", "-g", fa,
            "-m", str(m["mer_size"]), "-j", str(m["seed_jump"]),
            "-q", str(m["max_candidates"]), "-k",
            str(m["max_hits_per_seed"]), "-L", str(m["max_read_len"]),
            "-B", str(m["batch_size"]), "--no-sgr", "--device", device, fq]
    runs = []
    try:
        for on in (False, True, True, False):
            extra = ["--profile", os.path.join(work, "prof")] if on else []
            r = subprocess.run(argv + ["-o", os.path.join(work, "out")]
                               + extra, cwd=ROOT, capture_output=True,
                               text=True, timeout=1200)
            if r.returncode:
                raise RuntimeError(r.stderr[-4000:])
            done = json.loads(r.stdout.splitlines()[-1])
            runs.append(dict(profile=on, map_s=done["map_s"],
                             reads=done["reads"],
                             finish_wait_ms=done["spans_ms"].get(
                                 "finish.wait")))
    finally:
        subprocess.run(["rm", "-rf", work])
    off = [r["map_s"] for r in runs if not r["profile"]]
    on = [r["map_s"] for r in runs if r["profile"]]
    return dict(runs=runs, reads=n_reads,
                profile_cost=statistics.mean(on) / statistics.mean(off) - 1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", default="cost,window,cli")
    ap.add_argument("--seed", type=int, default=2147483659)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--cli-reads", type=int, default=1 << 18)
    ap.add_argument("--ab-windows", type=int, default=8)
    ap.add_argument("--ab-seconds", type=float, default=25.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="the cell cut to the CPU (mapbench/tests/tiny.py)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    out = {}
    if args.device == "cuda":
        import torch
        out["card"] = torch.cuda.get_device_name(0)
        out["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    parts = args.only.split(",")
    if "cost" in parts:
        out["cost"] = cost()
        print("cost", json.dumps(out["cost"]), flush=True)
    if "window" in parts:
        out["window"] = window(args.seed, args.seconds, args.device,
                               args.tiny)
        print("window", json.dumps(out["window"]), flush=True)
    if "cli" in parts:
        out["cli"] = cli(args.seed, args.cli_reads, args.device, args.tiny)
        print("cli", json.dumps(out["cli"]), flush=True)
    if "ab" in parts:
        out["ab"] = ab(args.seed, args.ab_seconds, args.ab_windows,
                       args.device, args.tiny)
        print("ab", json.dumps(out["ab"]), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
