"""SGR / SGREX coverage-track emission (reference output layer, SURVEY.md §1
L5; formats from the GNUMAP papers).

SGR:   ``contig<TAB>pos<TAB>coverage`` per genome position (1-based), only
       positions with coverage >= min_coverage_emit.
SGREX: extended per-base record for SNP mode:
       ``contig pos refbase cov a c g t snp_pvalue`` (GNUMAP-SNP).
"""

from __future__ import annotations

from typing import IO

import numpy as np

from gnumap_tpu_torch.index.builder import Genome


def write_sgr(f: IO[str], genome: Genome, coverage: np.ndarray,
              min_emit: float = 1e-6) -> None:
    from gnumap_tpu_torch.native import lib as native_lib
    native = native_lib.available()
    for ci, name in enumerate(genome.names):
        s = int(genome.starts[ci])
        l = int(genome.lengths[ci])
        cov = coverage[s:s + l]
        (nz,) = np.nonzero(cov >= min_emit)
        if native and len(nz) > 4096:
            # chunked native formatting: ~60-90 s of per-line f-strings
            # at chr21 scale otherwise (printf %.4f == Python :.4f,
            # tests/test_native.py)
            CH = 1 << 20
            for lo in range(0, len(nz), CH):
                sel = nz[lo:lo + CH]
                f.write(native_lib.format_sgr(
                    name, sel.astype(np.int64) + 1,
                    cov[sel]).decode("utf-8"))
            continue
        for p in nz:
            f.write(f"{name}\t{int(p) + 1}\t{cov[p]:.4f}\n")


_BASE_CH = "ACGTN"


def write_sgrex(f: IO[str], genome: Genome, coverage: np.ndarray,
                tallies: np.ndarray, pvalues: np.ndarray,
                min_emit: float = 1e-6) -> None:
    """Per-base tallies + SNP p-value, only covered positions."""
    for ci, name in enumerate(genome.names):
        s = int(genome.starts[ci])
        l = int(genome.lengths[ci])
        cov = coverage[s:s + l]
        (nz,) = np.nonzero(cov >= min_emit)
        for p in nz:
            gp = s + int(p)
            t = tallies[gp]
            f.write(f"{name}\t{int(p) + 1}\t{_BASE_CH[genome.codes[gp]]}"
                    f"\t{cov[p]:.4f}\t{t[0]:.4f}\t{t[1]:.4f}\t{t[2]:.4f}"
                    f"\t{t[3]:.4f}\t{pvalues[gp]:.6g}\n")
