#!/usr/bin/env python
"""Host memory of the PyTorch port's process, step by step: where each
megabyte of its resident set comes from.

The probe runs the CLI's start-up and map (``gnumap_tpu_torch.cli.main``)
in a fresh subprocess and records, at each step, VmRSS and VmHWM, the
resident set of /proc/self/smaps summed by class (the ten largest
file-backed libraries by name, the rest of the files, [heap], other
anonymous mappings, /dev/nvidia* mappings, everything else), the bytes the
card's caching allocator holds, the caching host allocator's statistics and
CUDA_MODULE_LOADING as the process sees it.  The steps:

  S0  the interpreter            S5  genome read and index built
  S1  import torch               S6  TorchMapper constructed (device_state)
  S2  CUDA initialised           S7  after the first batch's finish
  S3  the CLI module imported    S8  after 8 batches
  S4  kernel and host libraries  S9  after SAM and SGR are written
      loaded through _build

A second process, the floor F0, goes only to S2: what torch and CUDA hold
in any process on the machine.  S5-S9 are recorded from inside
the CLI's own main() (the mapper's constructor, the stream's batch callback,
main's return), so the probe measures the CLI's real order.

    python tools/torch_host_mem.py                      # on the card
    python tools/torch_host_mem.py --device cpu         # without a card
    python tools/torch_host_mem.py --out host_mem.json \\
        --package-root DIR   # probe another checkout's gnumap_tpu_torch

The workload is bench config 2's data as chip_smoke.py's map phase makes it
(a 4,641,652-base random genome, seed 0; 16,384 reads of 100 bp, seed 7, 1%
substitutions), its FASTQ written --repeat times so that S8 has 8 batches
of 8,192 behind it; --genome / --reads take existing files instead.  The
CLI's options after ``--`` (default: chip_smoke.py's CLI_ARGS).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_ARGS = ["-m", "12", "-j", "5", "-L", "104", "-q", "32", "-B", "8192"]
GENOME_LEN = 4_641_652
N_READS = 16_384
READ_LEN = 100
TOP_LIBS = 10
STEPS = ("S0", "S1", "S2", "S3", "S4", "S5", "S6", "S7", "S8", "S9")


# ---------------------------------------------------------------------------
# /proc readers (plain functions: a test feeds them canned text)
# ---------------------------------------------------------------------------

def smaps_class(path: str) -> str:
    """The class of one mapping by its pathname: 'nvidia' (/dev/nvidia*,
    where CUDA's own and pinned host memory may appear), 'heap', 'anon' (no
    pathname, or an [anon:...] name), 'file' (any other file), 'other'
    ([stack], [vdso], /dev/shm, memfd, ...)."""
    if path.startswith("/dev/nvidia"):
        return "nvidia"
    if path == "[heap]":
        return "heap"
    if not path or path.startswith("[anon"):
        return "anon"
    if path.startswith("/") and not path.startswith(("/dev/", "/memfd:")):
        return "file"
    return "other"


def parse_smaps(text: str, top: int = TOP_LIBS) -> dict:
    """Resident kB of an smaps text summed by class.  Returns {"libs":
    {path: kB} of the ``top`` largest files by Rss, "libs_rest": kB of the
    other files, "heap", "anon", "nvidia", "other": kB, "total": kB,
    "anon_largest": [kB] of the five largest anonymous mappings,
    "other_largest": {name: kB} of the three largest 'other' names}."""
    sums = {"heap": 0, "anon": 0, "nvidia": 0, "other": 0}
    files: dict = {}
    others: dict = {}
    anon_sizes = []
    path = None
    for line in text.splitlines():
        head = line.split(None, 5)
        if len(head) >= 5 and "-" in head[0] and ":" not in head[0]:
            path = head[5].strip() if len(head) == 6 else ""
            continue
        if path is None or not line.startswith("Rss:"):
            continue
        kb = int(line.split()[1])
        cls = smaps_class(path)
        if cls == "file":
            files[path] = files.get(path, 0) + kb
        else:
            sums[cls] += kb
            if cls == "anon":
                anon_sizes.append(kb)
            elif cls == "other":
                others[path] = others.get(path, 0) + kb
    ranked = sorted(files.items(), key=lambda kv: (-kv[1], kv[0]))
    libs = dict(ranked[:top])
    rest = sum(kb for _, kb in ranked[top:])
    total = sum(sums.values()) + sum(files.values())
    return {"libs": libs, "libs_rest": rest, **sums, "total": total,
            "anon_largest": sorted(anon_sizes, reverse=True)[:5],
            "other_largest": dict(sorted(
                others.items(), key=lambda kv: (-kv[1], kv[0]))[:3])}


def parse_status(text: str) -> dict:
    """VmRSS, VmHWM (kB) and Threads of a /proc/<pid>/status text, those
    of them that it holds."""
    out = {}
    for line in text.splitlines():
        key, _, val = line.partition(":")
        if key in ("VmRSS", "VmHWM", "Threads"):
            out[key] = int(val.split()[0])
    return out


def attributed_share(classes: dict, rss_kb: int) -> float:
    """Share of VmRSS that the named classes (libraries, heap, anonymous,
    /dev/nvidia*) account for; 'other' is not attributed."""
    named = (sum(classes["libs"].values()) + classes["libs_rest"]
             + classes["heap"] + classes["anon"] + classes["nvidia"])
    return min(named, rss_kb) / max(rss_kb, 1)


# ---------------------------------------------------------------------------
# The probed process
# ---------------------------------------------------------------------------

def snapshot(step: str, t0: float) -> dict:
    """One step's record, printed as a JSON line on stdout."""
    import resource
    with open("/proc/self/status") as f:
        st = parse_status(f.read())
    with open("/proc/self/smaps") as f:
        classes = parse_smaps(f.read())
    # a kernel without VmHWM in its status: getrusage's peak (kB on Linux),
    # which also counts the spawning process's RSS at the spawn
    hwm = st.get("VmHWM",
                 resource.getrusage(resource.RUSAGE_SELF).ru_maxrss)
    rec = {"step": step, "t_s": time.perf_counter() - t0,
           "rss_kb": st["VmRSS"], "hwm_kb": hwm,
           "hwm_source": "VmHWM" if "VmHWM" in st else "getrusage",
           "threads": st.get("Threads"), "classes": classes,
           "attributed": attributed_share(classes, st["VmRSS"]),
           "cuda_module_loading": os.environ.get("CUDA_MODULE_LOADING")}
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        rec["cuda_allocated"] = torch.cuda.memory_allocated()
        rec["cuda_reserved"] = torch.cuda.memory_reserved()
        stats = getattr(torch.cuda, "host_memory_stats", None)
        if stats is not None:
            rec["host_alloc"] = {k: v for k, v in stats().items()
                                 if k.startswith(("allocated_bytes.current",
                                                  "reserved_bytes.current",
                                                  "reserved_bytes.peak",
                                                  "num_host_alloc",
                                                  "num_host_free"))}
    print(json.dumps(rec), flush=True)
    return rec


def child(spec: dict) -> int:
    """The probed process: S0 ... S9, or S0 ... S2 for the floor."""
    t0 = time.perf_counter()
    snapshot("S0", t0)
    sys.path.insert(0, spec["package_root"] or REPO)
    import torch
    snapshot("S1", t0)
    cuda = spec["device"] == "cuda"
    if cuda:
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card (use --device cpu)")
        torch.empty(1, device="cuda")
        torch.cuda.synchronize()
    snapshot("S2", t0)
    if spec["floor"]:
        return 0
    from gnumap_tpu_torch.cli import main as cli
    snapshot("S3", t0)
    from gnumap_tpu_torch import _build
    from gnumap_tpu_torch.native import lib as native_lib
    if not native_lib.available():
        raise SystemExit("native host library did not build or load: "
                         + _build.BUILD_LOG.get("gnumap_host", ""))
    if cuda:
        for name in _build.sources():
            _build.load(name)
    snapshot("S4", t0)

    pl = cli.pl
    real_mapper, real_stream = pl.TorchMapper, pl.map_stream

    class ProbedMapper(real_mapper):
        def __init__(self, *a, **kw):
            snapshot("S5", t0)
            super().__init__(*a, **kw)
            if cuda:
                torch.cuda.synchronize()
            snapshot("S6", t0)

    def probed_stream(*a, batch_callback=None, **kw):
        def cb(idx, stats):
            if batch_callback is not None:
                batch_callback(idx, stats)
            if idx in (1, 8):
                snapshot("S7" if idx == 1 else "S8", t0)
        return real_stream(*a, batch_callback=cb, **kw)

    pl.TorchMapper, pl.map_stream = ProbedMapper, probed_stream
    try:
        rc = cli.main(spec["argv"])
    finally:
        pl.TorchMapper, pl.map_stream = real_mapper, real_stream
    snapshot("S9", t0)
    return rc


def run_child(spec: dict) -> list:
    """A fresh interpreter running child(spec); its step records."""
    p = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--child",
         json.dumps(spec)], capture_output=True, text=True,
        cwd=spec["package_root"] or REPO, timeout=600)
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-4000:])
        raise SystemExit(f"probe child failed (rc {p.returncode})")
    return [json.loads(x) for x in p.stdout.splitlines()
            if x.startswith('{"step"')]


def card():
    """nvidia-smi's name and power limit, or None without one."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return r.stdout.strip().splitlines()[0] if r.returncode == 0 else None


def write_workload(td: str, repeat: int, genome=None, reads=None):
    """Config 2's genome and reads (or the files given), the FASTQ written
    ``repeat`` times into one file."""
    if genome is None or reads is None:
        from gnumap_tpu_torch.utils import sim
        g = sim.random_genome(GENOME_LEN, seed=0)
        genome = os.path.join(td, "genome.fa")
        sim.write_fasta(genome, [("ref_sim", g)])
        reads = os.path.join(td, "one.fastq")
        sim.write_fastq(reads, sim.simulate_reads(
            g, N_READS, READ_LEN, seed=7, sub_rate=0.01, contig="ref_sim"))
    fq = os.path.join(td, "reads.fastq")
    with open(fq, "wb") as dst:
        for _ in range(repeat):
            with open(reads, "rb") as src:
                shutil.copyfileobj(src, dst)
    return genome, fq


def summary(steps: list, floor: list) -> dict:
    """MiB by step and class, F0, and the excess of S7 over F0."""
    def mib(kb):
        return round(kb / 1024, 1)

    by = {r["step"]: r for r in steps}
    f0 = floor[-1]["rss_kb"]
    out = {"rss_mib": {s: mib(r["rss_kb"]) for s, r in by.items()},
           "hwm_mib": {s: mib(r["hwm_kb"]) for s, r in by.items()},
           "f0_rss_mib": mib(f0)}
    if "S7" in by:        # a run of at least one batch
        out["s7_attributed"] = by["S7"]["attributed"]
        out["s7_over_f0_mib"] = mib(by["S7"]["rss_kb"] - f0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--genome", default=None)
    ap.add_argument("--reads", default=None)
    ap.add_argument("--repeat", type=int, default=5,
                    help="write the reads this many times (5 x 16,384 "
                         "reads = 10 batches of 8,192)")
    ap.add_argument("--package-root", default=None,
                    help="checkout whose gnumap_tpu_torch is probed "
                         "(default: this one)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("cli_args", nargs="*",
                    help="the CLI's options (after --)")
    args = ap.parse_args(argv)
    if args.child:
        return child(json.loads(args.child))
    # this process imports no torch: a child's peak RSS where the kernel
    # gives no VmHWM (getrusage) starts from the RSS of the process that
    # spawned it
    root = os.path.abspath(args.package_root) if args.package_root else None
    sys.path.insert(0, root or REPO)
    if args.device == "cuda":
        # build once here, so that the probed process only loads
        from gnumap_tpu_torch import _build
        _build.build(_build.sources())
        _build.build_host()
    with tempfile.TemporaryDirectory(prefix="torch_host_mem_") as td:
        fa, fq = write_workload(td, args.repeat, args.genome, args.reads)
        cli = args.cli_args or CLI_ARGS
        argv_cli = ["-g", fa, "-o", os.path.join(td, "out"), *cli,
                    "--device", args.device, fq]
        base = dict(device=args.device, package_root=root, argv=argv_cli)
        floor = run_child(dict(base, floor=True))
        steps = run_child(dict(base, floor=False))
    res = {"card": card(), "device": args.device, "package_root": root,
           "cli_args": cli, "repeat": args.repeat,
           "floor": floor, "steps": steps, **summary(steps, floor)}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
