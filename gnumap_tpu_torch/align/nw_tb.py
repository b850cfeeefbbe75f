"""Exact traceback of retained hits — the counterpart of
gnumap_tpu/align/nw_pallas.py::nw_traceback_pallas, banded (``band`` =
MapperConfig.band()) and unbanded (``band=None``, gap_slack >= 14) calls,
plus the host decode of its ops rows (``decode_ops``).

``nw_traceback`` is the wrapper of the hand-written CUDA kernel
csrc/nw_tb.cu (which replaces the Pallas ``_nw_tb_kernel``).  For CPU
tensors it runs the plain version, ``nw_traceback_plain``: the Pallas body
in torch ops — a forward pass over rows, vectorised over (hits x window
columns), storing 4 direction bits per cell, then a lockstep backwalk over
rows with gathers.  For CUDA tensors it launches the kernel or raises.

Direction bits per cell (row i, window column j = c + 1):
  bits 0..1  M's diagonal predecessor: 0 = M, 1 = Ix, 2 = Iy, preferred in
             that order on ties
  bit  2     Ix came from M above (M - open >= Ix - ext)
  bit  3     Iy opened from M on the left (M - open >= Iy - ext)
Output per (hit, row i): (deletions after read base i + 1 << 1) | (1 if
that base is an insertion); jfin = the oracle's pos_in_window.  Bit-identical
to oracle.nw_align(traceback=True) on retained (score > 0) hits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from gnumap_tpu.config import NEG_INF
from gnumap_tpu_torch.align.nw_band import SENTINEL, check_tensor, \
    gather_windows

# Kernel launches by nw_traceback (the plain version does not count).
LAUNCHES = 0


def ops_width(L: int) -> int:
    """Lp: the ops row width, L rounded up to a multiple of 8."""
    return (L + 7) // 8 * 8


def decode_ops(ops_row: np.ndarray, length: int):
    """Host-side decode of one hit's ops row -> (cigar, ref_len).

    ops_row[i] = (n_deletions_after_consuming_read_base_i+1 << 1) | op_bit
    for i in [0, length); op_bit 1 = I, 0 = M.  Forward CIGAR is
    c_1 D^{d_1} c_2 D^{d_2} ... c_len (no leading/trailing D by
    construction — the walk starts/ends on a consume)."""
    row = ops_row[:length]
    d = row >> 1
    opb = row & 1
    n_ins = int(opb.sum())
    n_del = int(d.sum())
    if n_ins == 0 and n_del == 0:
        return f"{length}M", length
    parts = []
    run_op, run_n = None, 0
    for i in range(length):
        op = "I" if opb[i] else "M"
        if op == run_op:
            run_n += 1
        else:
            if run_n:
                parts.append(f"{run_n}{run_op}")
            run_op, run_n = op, 1
        if d[i]:
            parts.append(f"{run_n}{run_op}")
            parts.append(f"{int(d[i])}D")
            run_op, run_n = None, 0
    if run_n:
        parts.append(f"{run_n}{run_op}")
    return "".join(parts), (length - n_ins) + n_del


def _shift(x, fill):
    """Column c of the result <- column c - 1 of x; column 0 <- fill."""
    if not torch.is_tensor(fill):
        fill = torch.full_like(x[:, :1], fill)
    return torch.cat([fill, x[:, :-1]], dim=1)


def _at(x, col, fill):
    """x[h, col[h]] per hit, fill where col < 0."""
    v = torch.gather(x, 1, col.clamp(min=0).long()[:, None])[:, 0]
    return torch.where(col >= 0, v, fill)


def _traceback_rows(emis, win, lens, *, open_q, ext_q, band):
    """The Pallas body on H live hits: emis int32[H, L, 5], win int64[H, W]
    window codes, lens int32[H] in [1, L], band (boff, bw) or None ->
    (ops int16[H, L], jfin int32[H])."""
    H, L, _ = emis.shape
    W = win.shape[1]
    dev = emis.device
    i32 = torch.int32
    rows = int(lens.max())
    c = torch.arange(W, dtype=i32, device=dev)
    j = c + 1                                            # DP column
    M = torch.zeros((H, W), dtype=i32, device=dev)
    Ix = torch.full((H, W), NEG_INF, dtype=i32, device=dev)
    Iy = Ix.clone()
    endm, endix = Ix.clone(), Ix.clone()
    m0 = torch.zeros((H, 1), dtype=i32, device=dev)
    ix0 = torch.full((H, 1), NEG_INF, dtype=i32, device=dev)
    ix0e = ix0.clone()
    dirs = torch.zeros((H, rows, W), dtype=torch.uint8, device=dev)
    for i in range(1, rows + 1):
        e = torch.gather(emis[:, i - 1], 1, win)
        m_sh, ix_sh = _shift(M, m0), _shift(Ix, ix0)
        diag = _shift(torch.maximum(torch.maximum(M, Ix), Iy),
                      torch.maximum(m0, ix0))
        m_dir = torch.where(m_sh == diag, 0, torch.where(ix_sh == diag, 1, 2))
        ix_bit = (M - open_q) >= (Ix - ext_q)
        M_new = torch.clamp_min(e + diag, NEG_INF)
        Ix_new = torch.clamp_min(torch.maximum(M - open_q, Ix - ext_q),
                                 NEG_INF)
        if band is not None:
            boff, bw = band
            off = (j < i - boff) | (j > i - boff + bw - 1)
            M_new = M_new.masked_fill(off, NEG_INF)
            Ix_new = Ix_new.masked_fill(off, NEG_INF)
        pm = torch.cummax(M_new + j * ext_q, dim=1).values
        Iy_new = torch.clamp_min(_shift(pm, NEG_INF) - open_q - c * ext_q,
                                 NEG_INF)
        if band is not None:
            Iy_new = Iy_new.masked_fill(off, NEG_INF)
        iy_bit = ((_shift(M_new, NEG_INF) - open_q)
                  >= (_shift(Iy_new, NEG_INF) - ext_q))
        dirs[:, i - 1] = (m_dir | (ix_bit.to(i32) << 2)
                          | (iy_bit.to(i32) << 3)).to(torch.uint8)
        M, Ix, Iy = M_new, Ix_new, Iy_new
        ix0 = torch.clamp_min(torch.maximum(m0 - open_q, ix0 - ext_q),
                              NEG_INF)
        m0 = torch.full_like(m0, NEG_INF)
        end = (lens == i)[:, None]
        endm = torch.where(end, M, endm)
        endix = torch.where(end, Ix, endix)
        ix0e = torch.where(end, ix0, ix0e)
    # end cell: smallest column, M preferred over Ix; column 0 wins ties
    fin = torch.maximum(endm, endix)
    best = fin.amax(dim=1)
    end_c = torch.where(fin == best[:, None], c, W).amin(dim=1)
    at0 = ix0e[:, 0] >= best
    j0 = torch.where(at0, 0, end_c + 1).to(i32)
    st0 = torch.where(at0 | (_at(endm, end_c, NEG_INF)
                             < _at(endix, end_c, NEG_INF)), 1, 0).to(i32)
    # lockstep backwalk: hit h is active on rows len_h .. 1
    ops = torch.zeros((H, L), dtype=i32, device=dev)
    started = torch.zeros(H, dtype=torch.bool, device=dev)
    zero = torch.zeros(H, dtype=i32, device=dev)
    jj, st = zero, zero
    lane = c.expand(H, W)
    for r in range(rows, 0, -1):
        init = lens == r
        jj = torch.where(init, j0, jj)
        st = torch.where(init, st0, st)
        started = started | init
        d = dirs[:, r - 1].to(i32)
        # deletion run: nearest open bit at or left of j - 1
        last_set = torch.cummax(torch.where((d >> 3) & 1 == 1, lane, -1),
                                dim=1).values
        c_lane = _at(last_set, jj - 1, -1)
        is_iy = started & (st == 2)
        d_cnt = torch.where(is_iy, jj - c_lane, zero)
        jj = torch.where(is_iy, c_lane, jj)
        st = torch.where(is_iy, 0, st)
        # consume this row's read base
        mext = _at(d & 3, jj - 1, 0)
        ixe = _at((d >> 2) & 1, jj - 1, 0)
        is_m = started & (st == 0)
        is_i = started & (st == 1)
        st = torch.where(is_m, mext, torch.where(
            is_i, torch.where((jj == 0) | (ixe != 1), 1, 0), st)).to(i32)
        jj = torch.where(is_m, jj - 1, jj)
        ops[:, r - 1] = torch.where(started, (d_cnt << 1) | is_i.to(i32), 0)
    return ops.to(torch.int16), jj


def nw_traceback_plain(emis_t, cands, lens, genome, *, L, W, slack, open_q,
                       ext_q, band, chunk: int = 4096):
    """Plain torch version of the kernel, over the live hits (valid anchor,
    length in [1, L]) only, ``chunk`` hits at a time to bound the
    (hits, L, W) direction store."""
    H = cands.shape[0]
    dev = cands.device
    ops = torch.zeros((H, ops_width(L)), dtype=torch.int16, device=dev)
    jfin = torch.zeros(H, dtype=torch.int32, device=dev)
    live = (cands != SENTINEL) & (lens > 0) & (lens <= L)
    idx = live.nonzero()[:, 0]
    for p0 in range(0, idx.shape[0], chunk):
        h = idx[p0:p0 + chunk]
        win = gather_windows(cands[h], genome, W, slack).long()
        o, jf = _traceback_rows(emis_t[h].transpose(1, 2), win, lens[h],
                                open_q=open_q, ext_q=ext_q, band=band)
        ops[h, :L] = o
        jfin[h] = jf
    return ops, jfin


def nw_traceback(emis_t: torch.Tensor, cands: torch.Tensor,
                 lens: torch.Tensor, genome: torch.Tensor, *, L: int, W: int,
                 slack: int, open_q: int, ext_q: int, band):
    """Exact traceback for H retained hits.

    emis_t int32[H, 5, L]  the hit's read-strand emission table
    cands  int32[H]        candidate anchors (SENTINEL = empty slot)
    lens   int32[H]        true read lengths
    genome int8[G]         base codes (N = 4)
    band   (boff, bw)      the [FROZEN v4] band (MapperConfig.band), or
                           None for the unbanded recurrence
    returns (ops int16[H, Lp], jfin int32[H]), Lp = L rounded up to 8;
    SENTINEL slots and length 0 give zeros."""
    boff, bw = band if band is not None else (0, 0)
    kw = dict(L=L, W=W, slack=slack, open_q=open_q, ext_q=ext_q)
    if emis_t.device.type == "cpu":
        return nw_traceback_plain(emis_t, cands, lens, genome, band=band,
                                  **kw)
    if emis_t.device.type != "cuda":
        raise ValueError(f"nw_traceback: unsupported device {emis_t.device} "
                         "(cpu runs the plain version, cuda the kernel)")
    H = cands.shape[0]
    dev = emis_t.device
    check_tensor("emis_t", emis_t, torch.int32, (H, 5, L), dev)
    check_tensor("cands", cands, torch.int32, (H,), dev)
    check_tensor("lens", lens, torch.int32, (H,), dev)
    check_tensor("genome", genome, torch.int8, (genome.shape[0],), dev)
    Lp = ops_width(L)
    ops = torch.empty((H, Lp), dtype=torch.int16, device=dev)
    jfin = torch.empty(H, dtype=torch.int32, device=dev)
    if H == 0:
        return ops, jfin
    from gnumap_tpu_torch import _build
    fn = _build.load("nw_tb").nw_tb_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(emis_t.data_ptr(), cands.data_ptr(), lens.data_ptr(),
                genome.data_ptr(), genome.shape[0], ops.data_ptr(),
                jfin.data_ptr(), H, L, Lp, W, slack, int(band is not None),
                boff, bw, open_q, ext_q, stream)
    if rc == -1:
        raise ValueError(f"nw_tb kernel: window width {W} not built "
                         "(W <= 256)")
    if rc != 0:
        raise RuntimeError(f"nw_tb kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return ops, jfin
