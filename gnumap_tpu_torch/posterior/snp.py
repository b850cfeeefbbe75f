"""SNP calling from fractional per-base tallies (GNUMAP-SNP capability,
SURVEY.md §2 "SNP mode").

The per-position evidence is the posterior-weighted PWM mass accumulated by
the mapper (tallies[p, b] = sum over alignments of w * P(base=b)).  The call
is a likelihood-ratio test of "all observations drawn from the reference
base with error rate eps" against the MLE base distribution; the statistic
is chi-square with 1 df (frozen; the reference's exact test statistic was
unverifiable — empty mount — and the papers describe an LRT of this shape).
"""

from __future__ import annotations

import math

import numpy as np

ERROR_RATE = 0.01


def _chi2_sf_1df(x: np.ndarray) -> np.ndarray:
    erfc = np.frompyfunc(math.erfc, 1, 1)
    return erfc(np.sqrt(np.maximum(x, 0.0) / 2.0)).astype(np.float64)


def snp_pvalues(g_codes: np.ndarray, coverage: np.ndarray,
                tallies: np.ndarray, eps: float = ERROR_RATE) -> np.ndarray:
    """p-value per genome position (1.0 where uncovered or genome N)."""
    G = len(g_codes)
    pvals = np.ones(G, dtype=np.float64)
    covered = np.nonzero((coverage > 0) & (g_codes < 4))[0]
    if covered.size == 0:
        return pvals
    t = tallies[covered]                                 # (n, 4)
    c = t.sum(axis=1)
    ok = c > 0
    covered, t, c = covered[ok], t[ok], c[ok]
    ref = g_codes[covered].astype(np.int64)
    p_null = np.full((len(covered), 4), eps / 3.0)
    np.put_along_axis(p_null, ref[:, None], 1.0 - eps, axis=1)
    freq = t / c[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        ll_alt = np.where(t > 0, t * np.log(np.maximum(freq, 1e-300)), 0.0)
        ll_null = t * np.log(p_null)
    lrt = 2.0 * (ll_alt.sum(axis=1) - ll_null.sum(axis=1))
    pvals[covered] = _chi2_sf_1df(lrt)
    return pvals


def call_snps(g_codes: np.ndarray, coverage: np.ndarray, tallies: np.ndarray,
              alpha: float = 1e-3, min_cov: float = 2.0):
    """Significant non-reference sites: (positions, alt_base, pvalue)."""
    pv = snp_pvalues(g_codes, coverage, tallies)
    alt = np.argmax(tallies, axis=1)
    mask = (pv < alpha) & (coverage >= min_cov) & (alt != g_codes) & \
        (g_codes < 4)
    pos = np.nonzero(mask)[0]
    return pos, alt[pos], pv[pos]
