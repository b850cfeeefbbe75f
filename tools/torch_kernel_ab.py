#!/usr/bin/env python3
"""Time one CUDA kernel of gnumap_tpu_torch in two or more checkouts on one
card, on the same inputs, in turns.

    python3 tools/torch_kernel_ab.py --parent DIR [DIR ...]
                                     [--kernel nw_band|nw_full|nw_tb|
                                               nw_pure|accum]
                                     [--reps 20]

Each DIR holds another checkout of this repository (for example the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists).  KERNELS names, for each kernel, its wrapper and the function that
makes its input sets from a seed; the sets go to every side in one file.
Each side runs in its own process, builds its own kernel with nvcc and times
the wrapper with chip_smoke.cuda_ms (CUDA events, median of --reps launches
after a warm-up); the order is the parents, this checkout, this checkout, the
parents in reverse.  One JSON line per set: every side's two times, and
whether all outputs are equal.  accum's deltas and accumulators are drawn on
the card from a seed by every side (they are too large for the file), and its
output is the accumulator after one launch on a fresh copy.  Exits non-zero
without a card or when any outputs differ.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    """chip_smoke.py of this checkout, whatever sys.path says."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def score_sets(gap_slack):
    """chip_smoke.py's live-slot sets of a scoring kernel (16,384
    read-strands x 32 candidate slots, reads of 100 bases in L = 104), with
    a band for nw_band (gap_slack 8: band (9, 42)) and without for nw_full
    (gap_slack 16: W 144): (argument names in the wrapper's order, arrays
    every set shares, {set: its own arrays and keyword arguments}, keyword
    arguments of every set)."""
    import numpy as np
    sys.path.insert(0, ROOT)
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.core import packing
    from gnumap_tpu_torch.utils import sim
    chip_smoke = load_chip_smoke()
    B2, C, L = 16_384, 32, 104
    rng = np.random.default_rng(1)
    genome = packing.encode(sim.random_genome(chip_smoke.GENOME_LEN, seed=0))
    emis, sets = chip_smoke.b1_live_sets(rng, genome, B2, C, L)
    cfg = MapperConfig(max_read_len=L, max_candidates=C, gap_slack=gap_slack)
    # rows at and past a read's length are left as they are: they must not
    # change a score, and every side gets the same ones
    shared = dict(emis_t=np.ascontiguousarray(emis.transpose(0, 2, 1)),
                  genome=genome)
    kw = dict(L=L, W=cfg.window_width(), slack=cfg.gap_slack,
              open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    if cfg.band() is not None:
        kw.update(zip(("boff", "bw"), cfg.band()))
    return (("emis_t", "cands", "lens", "genome"), shared,
            {name: dict(cands=c, lens=n) for name, (c, n) in sets.items()},
            kw)


def nw_tb_sets():
    """chip_smoke.py's live-slot sets of the traceback kernel (16,384 hit
    slots, L = 104; reads with substitutions, 1-2 bp indels and tandem-
    repeat ties), each with the band mask (gap_slack 8, W 128, band (9, 42))
    and without a band (gap_slack 16, W 144); returns as score_sets."""
    import numpy as np
    sys.path.insert(0, ROOT)
    from gnumap_tpu_torch.config import MapperConfig
    from gnumap_tpu_torch.core import packing
    from gnumap_tpu_torch.utils import sim
    chip_smoke = load_chip_smoke()
    H, L = 16_384, 104
    rng = np.random.default_rng(2)
    genome = packing.encode(sim.random_genome(chip_smoke.GENOME_LEN, seed=0))
    at = chip_smoke.TANDEM_AT
    genome[at:at + 400] = np.tile(np.array([0, 1, 2, 3], np.int8), 100)
    cfg = MapperConfig(max_read_len=L, max_candidates=32)
    emis, cands, lens = chip_smoke.tb_inputs(rng, genome, H, cfg,
                                             sentinels=False)
    shared = dict(emis_t=np.ascontiguousarray(emis.transpose(0, 2, 1)),
                  genome=genome)
    sets = {}
    for slack in (8, 16):
        c = MapperConfig(max_read_len=L, max_candidates=32, gap_slack=slack)
        band = c.band()
        own = dict(kw_W=c.window_width(), kw_slack=slack,
                   kw_band=np.array(band if band is not None else [], int))
        tag = "banded" if band is not None else "unbanded"
        for name, (cd, ln) in chip_smoke.tb_live_sets(
                np.random.default_rng(3), cands, lens, L).items():
            sets[f"{tag}_{name}"] = dict(cands=cd, lens=ln, **own)
    kw = dict(L=L, open_q=cfg.gap_open_q(), ext_q=cfg.gap_extend_q())
    return ("emis_t", "cands", "lens", "genome"), shared, sets, kw


def nw_pure_sets():
    """chip_smoke.py's hit-slot sets of the pure-diagonal kernel (16,384
    slots, L = 104, scores from this checkout's B1) at band widths 42, 26
    and 62; returns as score_sets.  Needs the card (for the scores)."""
    import numpy as np
    import torch
    sys.path.insert(0, ROOT)
    from gnumap_tpu_torch.core import packing
    from gnumap_tpu_torch.utils import sim
    chip_smoke = load_chip_smoke()
    genome = packing.encode(sim.random_genome(chip_smoke.GENOME_LEN, seed=0))
    at = chip_smoke.TANDEM_AT
    genome[at:at + 400] = np.tile(np.array([0, 1, 2, 3], np.int8), 100)
    genome_t = torch.from_numpy(genome).cuda()
    emis_t, by_slack = chip_smoke.b2_sets(np.random.default_rng(6), genome,
                                          genome_t, 16_384)
    sets = {}
    for own, kw in by_slack.values():
        for name, (cands, lens, scores) in own.items():
            sets[f"bw{kw['bw']}_{name}"] = dict(
                cands=cands, lens=lens, scores=scores,
                **{"kw_" + k: v for k, v in kw.items()})
    return (("emis_t", "cands", "lens", "scores", "genome"),
            dict(emis_t=emis_t, genome=genome), sets, {})


def accum_sets():
    """chip_smoke.py's delta sets of the ordered accumulator (131,072 slots;
    coverage and tallies shapes; n_real = all, 8,794, 1, 0 in order and
    8,794 in any order): span starts and sizes only, the worker draws the
    rest on the card (accum_args)."""
    import numpy as np
    chip_smoke = load_chip_smoke()
    sets = {}
    for k, (name, (base, n, rowmul, nrows, R)) in enumerate(
            chip_smoke.b5_sets(np.random.default_rng(5)).items()):
        sets[name] = dict(base_units=base, n_real=np.int32(n),
                          nrows=np.int32(nrows), rows=np.int32(R),
                          seed=np.int32(50 + k), kw_rowmul=rowmul)
    return (("arr", "base_units", "deltas", "n_real"), {}, sets, {})


def accum_args(z, name, dev):
    """The accumulator kernel's arguments for one set, drawn on the card."""
    own = {k: z[f"{k}__{name}"] for k in ("base_units", "n_real", "nrows",
                                          "rows", "seed")}
    return list(load_chip_smoke().b5_tensors(
        own["base_units"], int(own["n_real"]), int(own["nrows"]),
        int(own["rows"]), int(own["seed"]), dev))


# kernel -> (module of its wrapper, wrapper, maker of its input sets)
KERNELS = {
    "nw_band": ("gnumap_tpu_torch.align.nw_band", "nw_scores_banded",
                lambda: score_sets(8)),
    "nw_full": ("gnumap_tpu_torch.align.nw_full", "nw_scores_full",
                lambda: score_sets(16)),
    "nw_tb": ("gnumap_tpu_torch.align.nw_tb", "nw_traceback", nw_tb_sets),
    "nw_pure": ("gnumap_tpu_torch.align.nw_pure", "nw_pure_banded",
                nw_pure_sets),
    "accum": ("gnumap_tpu_torch.posterior.accum", "apply_deltas", accum_sets),
}


def keyword(v):
    """A keyword argument as the wrapper takes it: an int; or, from an
    array, a tuple of ints (the band), None when it is empty."""
    import numpy as np
    v = np.asarray(v)
    if v.ndim == 0:
        return int(v)
    return tuple(int(x) for x in v) if v.size else None


def worker(root: str, kernel: str, inputs: str, reps: int) -> int:
    """Time the kernel of the checkout at ``root`` on every set in
    ``inputs``; print {set: [ms, sha1 of the outputs]}."""
    sys.path.insert(0, root)
    import numpy as np
    import torch
    module, wrapper, _ = KERNELS[kernel]
    fn = getattr(importlib.import_module(module), wrapper)
    cuda_ms = load_chip_smoke().cuda_ms
    z = np.load(inputs)
    dev = torch.device("cuda")
    order = [str(a) for a in z["order"]]
    common = {k[3:]: keyword(z[k]) for k in z.files
              if k.startswith("kw_") and "__" not in k}
    shared = {a: torch.from_numpy(z["shared_" + a]).to(dev)
              for a in order if "shared_" + a in z.files}
    out = {}
    for name in [str(s) for s in z["sets"]]:
        tail = "__" + name
        kw = dict(common, **{k[3:-len(tail)]: keyword(z[k]) for k in z.files
                             if k.startswith("kw_") and k.endswith(tail)})
        if kernel == "accum":      # in place: the output is a fresh copy's
            args = accum_args(z, name, dev)
            got = fn(args[0].clone(), *args[1:], **kw)
        else:
            args = [shared[a] if a in shared
                    else torch.from_numpy(z[f"{a}__{name}"]).to(dev)
                    for a in order]
            got = fn(*args, **kw)
        torch.cuda.synchronize()
        got = got if isinstance(got, (tuple, list)) else (got,)
        sha = hashlib.sha1()
        for t in got:
            sha.update(t.cpu().numpy().tobytes())
        out[name] = [cuda_ms(lambda: fn(*args, **kw), reps), sha.hexdigest()]
        del args, got
    print(json.dumps(out))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", nargs="+", help="the other checkouts")
    ap.add_argument("--kernel", default="nw_band", choices=sorted(KERNELS))
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--worker", nargs=2, metavar=("ROOT", "INPUTS"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker[0], args.kernel, args.worker[1], args.reps)
    if not args.parent:
        ap.error("--parent is required")
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA card", file=sys.stderr)
        return 2
    order, shared, sets, kw = KERNELS[args.kernel][2]()
    arrays = dict(order=np.array(order), sets=np.array(list(sets)))
    arrays.update({"kw_" + k: v for k, v in kw.items()})
    arrays.update({"shared_" + k: v for k, v in shared.items()})
    for name, own in sets.items():
        arrays.update({f"{k}__{name}": v for k, v in own.items()})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    runs = []
    with tempfile.TemporaryDirectory(prefix="kernel_ab_") as tmp:
        path = os.path.join(tmp, "inputs.npz")
        np.savez(path, **arrays)
        sides = [(os.path.relpath(os.path.abspath(d), ROOT), d)
                 for d in args.parent] + [("change", ROOT)]
        for side, root in sides + sides[::-1]:
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--kernel",
                 args.kernel, "--reps", str(args.reps), "--worker",
                 os.path.abspath(root), path],
                cwd=root, capture_output=True, text=True)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            runs.append((side, json.loads(r.stdout.strip().splitlines()[-1])))
    equal = True
    for name in sets:
        ms = {s: [x[name][0] for side, x in runs if side == s]
              for s, _ in sides}
        same = len({x[name][1] for _, x in runs}) == 1
        equal &= same
        print(json.dumps(dict(kernel=args.kernel, set=name, ms=ms,
                              outputs_equal=same)))
    print(smi)
    return 0 if equal else 1


if __name__ == "__main__":
    sys.exit(main())
