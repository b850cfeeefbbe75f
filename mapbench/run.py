"""One run of one benchmark cell: set-up, the measured window, the check.

    python3 -m mapbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (``setup_s``): import the port and start CUDA, load (or build) its
host library, make the configuration's genome from the seed, build its index
with the port's builder, make the traffic's read pool from the seed and
write it as FASTQ under the temporary directory, create the ``TorchMapper``,
and map the first pool batch twice (the eager run and the graph capture,
then a replay).  The window (``window.py``) runs ``map_stream`` on that
mapper for ``--seconds``.  With ``--trace 1`` a stretch of the window is
profiled and the per-layer metrics are printed instead of the end-to-end
ones.  The check (``check.py``) runs after the window, on the device, once
the program's state is freed.

The last line of standard output is the result; the lines before it give
the card, the set-up's steps, the window's counts and the CPU it got, and
the check's sample.
The numbers compared, each with its limit, are the last lines of standard
error and the result's last key.  Without a CUDA card the run exits with 2
and prints no result.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
from typing import Dict, List, Optional

import numpy as np

from mapbench import cell as cells
from mapbench import check, peaks
from mapbench.genome import make_genome
from mapbench.reference.consts import RefConfig
from mapbench.traffic import make_pool, write_fastq

# map_batch calls in set-up: the first captures the batch's program, the
# second replays it
WARM_FEEDS = 2
FORBIDDEN = ("jax", "jaxlib", "flax", "gnumap_tpu")
GIB = float(1 << 30)


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level names."""
    top = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(top & set(FORBIDDEN))


class RunSetup:
    """The set-up of one run: genome, index, pool, mapper, warm-up."""

    def __init__(self, spec: cells.CellSpec, seed: int, device: str,
                 trace: bool, t0: float):
        self.spec, self.seed, self.device = spec, seed, device
        steps: Dict[str, float] = {}
        t = time.perf_counter()

        def step(name):
            nonlocal t
            now = time.perf_counter()
            steps[name] = now - t
            t = now

        import torch
        from gnumap_tpu_torch.config import MapperConfig
        from gnumap_tpu_torch.index import builder
        from gnumap_tpu_torch.io.fastq import batch_reads_native
        from gnumap_tpu_torch.native import lib as native_lib
        from gnumap_tpu_torch.pipeline import mapper as pl
        step("imports")
        if device == "cuda":
            torch.cuda.init()
            torch.empty(1, device="cuda")
        step("cuda_init")
        if not native_lib.available():
            raise RuntimeError("the port's host library did not build or "
                               "load: the stream would run its Python "
                               "fallbacks")
        step("host_lib")
        cfgd = spec.config
        self.genome = make_genome(cfgd, seed)
        self.gen = builder.Genome.from_contigs([(self.genome.contig,
                                                 self.genome.codes)])
        step("genome")
        self.cfg = MapperConfig(**cfgd["mapper"])
        index = builder.build_index(self.gen, self.cfg)
        step("index")
        self.pool = make_pool(self.genome, spec.mix, seed)
        fd, self.path = tempfile.mkstemp(prefix="mapbench-",
                                         suffix=".fastq")
        os.close(fd)
        self.fastq_bytes = write_fastq(self.pool, self.genome.contig,
                                       self.path, self.cfg.phred_offset)
        step("pool")
        self.mapper = pl.TorchMapper(self.gen, index, self.cfg,
                                     device=device,
                                     accumulate=cfgd.get("accumulate",
                                                         "host"))
        del index
        step("mapper")
        first = next(batch_reads_native(self.path, self.cfg))
        for _ in range(WARM_FEEDS):
            hits = self.mapper.map_batch(first)
        if self.cfg.sam_out:
            pl.format_sam_batch_native(self.gen, first, hits)
        if device == "cuda":
            torch.cuda.synchronize()
        step("warmup")
        if trace:
            from mapbench.trace import warm_profiler
            warm_profiler(device)
            step("profiler")
        # set-up's garbage goes now, not in the window
        gc.collect()
        self.steps = steps
        self.setup_s = time.perf_counter() - t0

    def context(self) -> check.Context:
        return check.Context(
            self.genome, self.pool, RefConfig.from_mapper(
                self.spec.config["mapper"]), self.cfg.batch_size,
            WARM_FEEDS, self.device, self.seed,
            self.spec.config.get("limits", {}))

    def free_program(self) -> None:
        import torch
        self.mapper = None
        gc.collect()
        if self.device == "cuda":
            torch.cuda.empty_cache()

    def close(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)


def card() -> dict:
    import torch
    out = dict(kind=torch.cuda.get_device_name(0),
               count=torch.cuda.device_count())
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit,clocks.sm,clocks.max.sm",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=30)
        out["nvidia_smi"] = r.stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        out["nvidia_smi"] = f"not read: {e!r}"
    return out


def end_to_end(spec, sess: RunSetup, win, peak: float) -> dict:
    done = win.done
    lat = win.latencies_ms()
    values = {
        "reads_per_s": sum(b.n_out for b in done) / win.seconds,
        "batch_p95_ms": float(np.percentile(lat, 95)),
        "peak_dev_mem_gib": peak / GIB,
        "setup_s": sess.setup_s,
    }
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in spec.end_to_end}


class Records:
    """What a per-layer metric's reader reads: the window, its spans, the
    traced stretch and the cell's sizes."""

    def __init__(self, sess: RunSetup, win, trace_summary):
        self.cfg = sess.cfg
        self.read_len = sess.pool.read_len
        self.window = win
        self.n_batches = len(win.done)
        self.window_s = win.seconds
        self.span_s = {k: sum(b - a for a, b in v)
                       for k, v in win.rec.spans.items()}
        self.trace = trace_summary
        self.peaks = peaks

    def stretch_batches(self, kernel: str):
        """The batch records of the kernel's instances in the stretch:
        one a batch, in submit order from the stretch's first batch."""
        if self.trace is None:
            return []
        n = self.trace["kernels"][kernel]["n"]
        first = self.trace["first"]
        return self.window.rec.batches[first:first + n]


def per_layer(spec, sess: RunSetup, win, summary) -> dict:
    records = Records(sess, win, summary)
    out = {}
    for m in spec.per_layer:
        mod = cells.metric_module(m["name"])
        v = mod.read(records)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def kernel_symbols(spec) -> Dict[str, str]:
    names = {}
    for m in spec.per_layer:
        k = getattr(cells.metric_module(m["name"]), "KERNEL", None)
        if k:
            names[k] = cells.work_module(k).SYMBOL
    return names


def run_cell(spec: cells.CellSpec, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t0: Optional[float] = None,
             control: bool = False, emit=print):
    """One run; returns (result dict, the judged checks).  ``emit`` gets
    the lines before the result."""
    import torch
    from mapbench.trace import Tracer
    from mapbench.window import run_window
    t0 = time.perf_counter() if t0 is None else t0
    sess = RunSetup(spec, seed, device, trace, t0)
    try:
        emit("setup " + json.dumps(dict(
            setup_s=sess.setup_s, steps=sess.steps,
            fastq_bytes=sess.fastq_bytes, pool_reads=sess.pool.n)))
        tracer = Tracer(seconds) if trace else None
        ctx = sess.context()
        win = run_window(sess.mapper, sess.path, sess.cfg, seconds,
                         check.KEEP_EVERY,
                         int(check.rng_for(seed, 4).integers(
                             0, check.KEEP_EVERY)),
                         tracer)
        peak = reserved = 0.0
        if device == "cuda":
            peak = float(torch.cuda.max_memory_allocated())
            reserved = float(torch.cuda.max_memory_reserved())
        summary = (tracer.summary(win.rec, kernel_symbols(spec))
                   if trace else None)
        lat = win.latencies_ms()
        res = win.result
        wl = dict(window_s=win.seconds, batches=len(win.done),
                  slice_reads_per_s=win.slice_rates(6),
                  batches_fed=len(win.rec.batches),
                  reads=sum(b.n_out for b in win.done),
                  beyond_p95=int((lat > np.percentile(lat, 95)).sum()),
                  latency_ms_median=float(np.median(lat)),
                  span_s={k: sum(b - a for a, b in v)
                          for k, v in win.rec.spans.items()},
                  peak_allocated_bytes=peak, peak_reserved_bytes=reserved,
                  cpu=win.cpu)
        if win.sink is not None:
            wl.update(sam_bytes=win.sink.n_bytes,
                      sam_records=sum(win.sink.records.values()),
                      truth_accuracy_kept=check.truth_accuracy(win, ctx))
        if getattr(res, "tallies", None) is not None:
            wl.update(coverage_sum=float(np.sum(res.coverage)),
                      tallies_sum=float(np.sum(res.tallies)))
        emit("window " + json.dumps(wl))
        if device == "cuda":
            emit("card " + json.dumps(card()))
        if summary is not None:
            emit("trace " + json.dumps(dict(
                window_s=summary["window_s"], busy_s=summary["busy_s"],
                events=summary["n_events"], kernels=summary["kernels"],
                idle_by_span=summary["idle_by_span"])))
        sess.free_program()
        t = time.perf_counter()
        judged = check.judge(win, ctx, control)
        emit("check " + json.dumps(dict(judged["info"],
                                        seconds=time.perf_counter() - t)))
        metrics = (per_layer(spec, sess, win, summary) if trace
                   else end_to_end(spec, sess, win, peak))
        dev = dict(platform="gpu" if device == "cuda" else device,
                   kind=(torch.cuda.get_device_name(0)
                         if device == "cuda" else device),
                   count=1, memory_peak_bytes=int(peak))
        out = dict(correct=bool(judged["correct"]),
                   attempted=sum(b.n_reads for b in win.rec.batches),
                   failed=int(judged["numbers"]["reads_lost"]),
                   metrics=metrics, device=dev)
        if summary is not None:
            dev.update(busy_s=summary["busy_s"],
                       window_s=summary["window_s"])
            out["breakdown"] = dict(
                device_ops=[[n[:160], s] for n, s in
                            summary["device_ops"][:10]],
                idle_gaps=summary["idle_gaps"][:10])
        out["checks"] = {k: {"value": v, "limit": judged["limits"][k]}
                         for k, v in judged["numbers"].items()}
        return out, judged
    finally:
        sess.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    spec = cells.cell(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec.chips:
        print(f"mapbench: {args.workload} needs {spec.chips} CUDA card(s); "
              f"torch finds {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    out, _ = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      t0=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"mapbench: the process loaded {bad}", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
