"""Cells cut to a size the CPU maps in seconds, for the tests only: the
same files and code paths, a small genome, pool and batch.

``CELLS`` are the cells of ``BENCHMARK.json``.  ``VARIANTS`` are paths the
harness runs that no cell takes yet, made from the E. coli cell: gapped
reads, and SNP mode with device accumulation over repeat families (the
chr21 cells wait for a genome with chr21's own repeats, PERF.md)."""

from __future__ import annotations

from mapbench import cell as cells

BASE = "ecoli-k12-100bp.sam-unique"
CELLS = tuple(w["name"] for w in cells.benchmark()["workloads"])

_SNP = dict(
    families={"n": 3, "copies": 6, "unit_len": 300},
    accumulate="device",
    limits={"reads_lost": 0, "cov_gap": 1e-3, "tally_gap": 1e-3},
    mapper=dict(max_hits_per_seed=24, hit_capacity=8, sam_out=False,
                snp_mode=True))
VARIANTS = {
    "sam-indel": (None, dict(indel_rate=0.1)),
    "snp-repeat25": (_SNP, dict(repeat_read_frac=0.25)),
    "snp-unique": (_SNP, {}),
}
RUNS = CELLS + tuple(VARIANTS)


def spec(name: str, genome_len: int = 40000, pool: int = 1024,
         batch: int = 128, **mix):
    """A cell of ``BENCHMARK.json`` or a variant, cut to the CPU."""
    config, extra = VARIANTS.get(name, (None, {}))
    s = cells.cell(BASE if name in VARIANTS else name)
    s.config = dict(s.config, genome_len=genome_len)
    mapper = dict(s.config["mapper"], batch_size=batch, mer_size=10)
    if config:
        s.config.update({k: v for k, v in config.items() if k != "mapper"})
        mapper.update(config["mapper"])
    if s.config.get("families"):
        s.config["families"] = {"n": 3, "copies": 6, "unit_len": 300}
    s.config["mapper"] = mapper
    s.mix = dict(s.mix, pool_reads=pool, **dict(extra, **mix))
    return s


def run(name: str, seed: int = 2 ** 31 + 7, seconds: float = 1.5,
        control: bool = False, lines=None, **kw):
    from mapbench import run as run_mod
    emit = (lambda s: lines.append(s)) if lines is not None else \
        (lambda s: None)
    return run_mod.run_cell(spec(name, **kw), seed, seconds, trace=False,
                            device="cpu", control=control, emit=emit)
