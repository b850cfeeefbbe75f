"""Batched probabilistic NW in plain int32 torch ops — the counterpart of
gnumap_tpu/align/nw_ref.py, and the plain version of the banded kernel
(align/nw_band.py) and of the CPU scoring path.

Score-only affine-gap fitting alignment over many (read, candidate-window)
pairs: a Python loop over read rows (``lax.scan`` in the reference), each
row one set of tensor updates over (pairs, W+1) int32 state.  The in-row gap
chain is the frozen prefix-max unrolling of oracle.nw_align
(``torch.cummax`` for ``lax.cummax``).  Scores are equal integers to the
reference on every device.

Padded-read handling [FROZEN]: rows at or beyond a read's length have
all-zero emission and free read-gap transitions (open = extend = 0); the
score is captured at each read's true last row.  Length-0 reads keep the
initial capture, 0 (``cap0``), as the reference does.
"""

from __future__ import annotations

import torch

from gnumap_tpu_torch.config import NEG_INF


def nw_scores(emis: torch.Tensor, windows: torch.Tensor, lens: torch.Tensor,
              *, open_q: int, ext_q: int, band=None) -> torch.Tensor:
    """Alignment scores for P independent pairs.

    emis int32[P, L, 5] (pad rows all-zero), windows int32[P, W] (codes,
    N = 4), lens int32[P], band (boff, bw) [FROZEN v3] or None
    -> int32[P]."""
    return nw_scores_multi(emis, windows[:, None, :], lens, open_q, ext_q,
                           band=band)[:, 0]


def nw_scores_multi(emis: torch.Tensor, windows: torch.Tensor,
                    lens: torch.Tensor, open_q: int, ext_q: int,
                    band=None) -> torch.Tensor:
    """One emission table shared across C candidate windows per read:
    emis int32[B, L, 5], windows int32[B, C, W] -> scores int32[B, C]."""
    B, L, _ = emis.shape
    _, C, W = windows.shape
    dev = emis.device
    i32 = torch.int32
    jj = torch.arange(W + 1, dtype=i32, device=dev)
    neg = torch.full((B, C, 1), NEG_INF, dtype=i32, device=dev)
    ramp = jj * ext_q
    iy_off = open_q + (jj[1:] - 1) * ext_q
    win = windows.long()
    lens = lens.to(i32)
    M = torch.zeros((B, C, W + 1), dtype=i32, device=dev)
    Ix = torch.full((B, C, W + 1), NEG_INF, dtype=i32, device=dev)
    Iy = Ix.clone()
    cap = torch.zeros((B, C), dtype=i32, device=dev)   # len-0 reads score 0
    zero = torch.zeros((), dtype=i32, device=dev)
    for i in range(1, L + 1):
        in_read = (i - 1 < lens)[:, None, None]
        opn = torch.where(in_read, open_q, zero)
        ext = torch.where(in_read, ext_q, zero)
        e = torch.gather(emis[:, i - 1, None, :].expand(B, C, 5), 2, win)
        prev_best = torch.maximum(torch.maximum(M, Ix), Iy)
        M_new = torch.cat(
            [neg, torch.clamp_min(e + prev_best[..., :-1], NEG_INF)], dim=-1)
        if band is not None:                 # [FROZEN v3]: M masked pre-pm
            boff, bw = band
            off_b = (jj < i - boff) | (jj > i - boff + bw - 1)
            off_b[0] = False
            M_new = M_new.masked_fill(off_b, NEG_INF)
        Ix_new = torch.clamp_min(torch.maximum(M - opn, Ix - ext), NEG_INF)
        pm = torch.cummax(M_new + ramp, dim=-1).values
        Iy_new = torch.cat(
            [neg, torch.clamp_min(pm[..., :-1] - iy_off, NEG_INF)], dim=-1)
        if band is not None:
            Ix_new = Ix_new.masked_fill(off_b, NEG_INF)
            Iy_new = Iy_new.masked_fill(off_b, NEG_INF)
        fin = torch.maximum(M_new, Ix_new).amax(dim=-1)
        cap = torch.where((lens == i)[:, None], fin, cap)
        M, Ix, Iy = M_new, Ix_new, Iy_new
    return cap


def max_read_scores(emis: torch.Tensor) -> torch.Tensor:
    """Max attainable score per read: sum_i max_b emis[i, b] (b < 4).
    Pad rows are all-zero and contribute 0.  int32[B]."""
    return emis[..., :4].amax(dim=-1).sum(dim=-1, dtype=torch.int32)
