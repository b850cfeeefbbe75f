"""Pure-diagonal detection over retained hits — the counterpart of
gnumap_tpu/align/nw_pallas.py::nw_pure_banded ([FROZEN v6] traceback
split).

``nw_pure_banded`` is the wrapper of the hand-written CUDA kernel
csrc/nw_pure.cu (which replaces the Pallas ``_nw_band_pure_kernel`` and its
epilogue).  For CPU tensors it runs the plain version,
``nw_pure_banded_plain``; for CUDA tensors it launches the kernel or raises.

Both run the port's banded DP (align/nw_band.py's kernel and nw_ref), which
follows oracle.nw_align at row 1's last band lane (Ix = -open there; the
Pallas kernels floor it to NEG_INF).  B2's test ``max(M, Ix) == score``
compares its own end-row values with B1's scores, so it must run B1's DP.
The two DPs agree wherever no emission is below -open, so at default
scoring (pure, jfin) equal the JAX ``nw_pure_banded`` exactly.

Callers gate on the banded config, open_q > 0 and ext_q > 0 (the exactness
argument at nw_pallas.py:554-583 needs them).
"""

from __future__ import annotations

import ctypes

import torch

from gnumap_tpu_torch.config import NEG_INF
from gnumap_tpu_torch.align.nw_band import SENTINEL, check_tensor

DEEP = -(1 << 30)   # emission poison outside window columns [1, W]

# Kernel launches by nw_pure_banded (the plain version does not count).
LAUNCHES = 0


def _row_codes(ws, genome, wi, W):
    """Window codes at window indices wi (one per band lane) of windows
    starting at ws: N (4) outside the genome, the poison code 5 outside
    window columns [1, W].  int64[H, bw]."""
    G = genome.shape[0]
    p = ws[:, None] + wi[None, :]
    code = genome[p.clamp(0, max(G - 1, 0))].long()
    code = torch.where((p < 0) | (p >= G), 4, code)
    return torch.where(((wi < 0) | (wi >= W))[None, :], 5, code)


def nw_pure_banded_plain(emis_t, cands, lens, scores, genome, *, L, W, slack,
                         boff, bw, open_q, ext_q):
    """Plain int32 torch version of the kernel, over the live hits (valid
    anchor, length in [1, L], score > 0) only: the band DP in band
    coordinates (lane b on row i is window column i + b - boff), with the
    gapless diagonal sum gl, end-row captures at each hit's length, and the
    epilogue of nw_pallas.py:770-783."""
    H = cands.shape[0]
    dev = cands.device
    i32 = torch.int32
    pure = torch.zeros(H, dtype=torch.bool, device=dev)
    jfin = torch.zeros(H, dtype=i32, device=dev)
    hit = ((cands != SENTINEL) & (lens > 0) & (lens <= L)
           & (scores > 0)).nonzero()[:, 0]
    if hit.numel() == 0:
        return pure, jfin
    n = hit.numel()
    lens, scores = lens[hit].to(i32), scores[hit]
    rows = int(lens.max())
    ws = torch.div(cands[hit].long() - slack, 8, rounding_mode="floor") * 8
    # emission rows of 8: codes 0..4, DEEP for the poison code 5
    er = torch.cat([emis_t[hit].transpose(1, 2)[:, :rows],
                    torch.full((n, rows, 3), DEEP, dtype=i32, device=dev)],
                   dim=2)
    b = torch.arange(bw, dtype=i32, device=dev)
    colT = torch.arange(bw + 1, dtype=i32, device=dev) - boff
    mT = torch.where((colT >= 0) & (colT <= W), 0, NEG_INF).to(i32)
    D = mT[:bw].expand(n, bw).clone()
    T = torch.clamp_min(mT - open_q, NEG_INF - ext_q).expand(n, bw + 1)
    T = T.clone()
    gl = torch.zeros((n, bw), dtype=i32, device=dev)
    capm = torch.full((n, bw), NEG_INF, dtype=i32, device=dev)
    capix = capm.clone()
    capgl = capm.clone()
    neg = torch.full((n, 1), NEG_INF, dtype=i32, device=dev)
    for i in range(1, rows + 1):
        # lane b on row i reads window index i - 1 + b - boff
        code = _row_codes(ws, genome, (i - 1 - boff) + b.long(), W)
        e = torch.gather(er[:, i - 1], 1, code)
        mn = torch.clamp_min(e + D, NEG_INF)
        ixn = torch.clamp_min(T[:, 1:], NEG_INF)
        # Iy chain: q after lane k is max over k' <= k of
        # mn[k'] - open - (k - k') ext; lane b reads q after lane b - 1
        pm = torch.cummax(mn + b * ext_q, dim=1).values
        iyn = torch.cat([neg, torch.clamp_min(
            pm[:, :-1] - open_q - b[:-1] * ext_q, NEG_INF)], dim=1)
        D = torch.maximum(torch.maximum(mn, ixn), iyn)
        T = torch.cat([torch.maximum(mn - open_q, ixn - ext_q), neg], dim=1)
        gl = torch.clamp_min(gl + e, NEG_INF)
        end = (lens == i)[:, None]
        capm = torch.where(end, mn, capm)
        capix = torch.where(end, ixn, capix)
        capgl = torch.where(end, gl, capgl)
    eq = torch.maximum(capm, capix) == scores[:, None]
    end_ll = torch.where(eq, b.expand(n, bw), bw).amin(dim=1)
    found = end_ll < bw
    at = torch.where(found, end_ll, 0).long()[:, None]
    cm = torch.gather(capm, 1, at)[:, 0]
    ci = torch.gather(capix, 1, at)[:, 0]
    cg = torch.gather(capgl, 1, at)[:, 0]
    ok = found & (cm >= ci) & (cg == scores)
    pure[hit] = ok
    jfin[hit] = torch.where(ok, end_ll - boff, 0).to(i32)
    return pure, jfin


def nw_pure_banded(emis_t: torch.Tensor, cands: torch.Tensor,
                   lens: torch.Tensor, scores: torch.Tensor,
                   genome: torch.Tensor, *, L: int, W: int, slack: int,
                   boff: int, bw: int, open_q: int, ext_q: int):
    """(pure bool[H], jfin int32[H]) for H retained hits.

    emis_t int32[H, 5, L]  the hit's read-strand emission table
    cands  int32[H]        candidate anchors (SENTINEL = empty slot)
    lens   int32[H]        true read lengths
    scores int32[H]        B1's scores of the hits
    genome int8[G]         base codes (N = 4)
    pure[h] proves the frozen backwalk emits all-M from window column
    jfin[h]; SENTINEL slots, length 0 and score <= 0 give (False, 0)."""
    kw = dict(L=L, W=W, slack=slack, boff=boff, bw=bw, open_q=open_q,
              ext_q=ext_q)
    if emis_t.device.type == "cpu":
        return nw_pure_banded_plain(emis_t, cands, lens, scores, genome, **kw)
    if emis_t.device.type != "cuda":
        raise ValueError(f"nw_pure_banded: unsupported device "
                         f"{emis_t.device} (cpu runs the plain version, "
                         "cuda the kernel)")
    H = cands.shape[0]
    dev = emis_t.device
    check_tensor("emis_t", emis_t, torch.int32, (H, 5, L), dev)
    for name, t in (("cands", cands), ("lens", lens), ("scores", scores)):
        check_tensor(name, t, torch.int32, (H,), dev)
    check_tensor("genome", genome, torch.int8, (genome.shape[0],), dev)
    pure = torch.empty(H, dtype=torch.bool, device=dev)
    jfin = torch.empty(H, dtype=torch.int32, device=dev)
    if H == 0:
        return pure, jfin
    from gnumap_tpu_torch import _build
    fn = _build.load("nw_pure").nw_pure_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(emis_t.data_ptr(), cands.data_ptr(), lens.data_ptr(),
                scores.data_ptr(), genome.data_ptr(), genome.shape[0],
                pure.data_ptr(), jfin.data_ptr(), H, L, W, slack, boff, bw,
                open_q, ext_q, stream)
    if rc == -1:
        raise ValueError(f"nw_pure kernel: band width {bw} not built "
                         "(bw = 4 * gap_slack + 10, gap_slack <= 13)")
    if rc != 0:
        raise RuntimeError(f"nw_pure kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return pure, jfin
