"""Unbanded NW scoring for every (read-strand, candidate) pair — the
counterpart of gnumap_tpu/align/nw_pallas.py::nw_scores_pallas, the scoring
path when MapperConfig.band() is None (gap_slack >= 14).

``nw_scores_full`` is the wrapper of the hand-written CUDA kernel
csrc/nw_full.cu (which replaces the Pallas ``_nw_kernel``).  For CPU tensors
it runs the plain version, ``nw_scores_full_plain``: the int32 torch DP of
align/nw_ref.py without a band over gathered genome windows.  For CUDA
tensors it launches the kernel or raises; there is no fallback.

Both forms return NEG_INF at SENTINEL candidates (and for len > L), and 0
for length-0 reads, as the Pallas kernel does (its all-pad-row run keeps
row 0's M = 0); neither is ever retained, since retention needs a
score > 0.
"""

from __future__ import annotations

import ctypes

import torch

from gnumap_tpu.config import NEG_INF
from gnumap_tpu_torch.align import nw_ref
from gnumap_tpu_torch.align.nw_band import SENTINEL, check_tensor, \
    gather_windows

# Kernel launches by nw_scores_full (the plain version does not count).
LAUNCHES = 0


def nw_scores_full_plain(emis_t, cands, lens, genome, *, L, W, slack,
                         open_q, ext_q, chunk: int = 16384):
    """Plain torch version of the kernel: nw_ref.nw_scores without a band
    over the gathered windows of the live (non-SENTINEL, len <= L) pairs
    only, ``chunk`` pairs at a time to bound the (pairs, W+1) state."""
    live = (cands != SENTINEL) & ((lens >= 0) & (lens <= L))[:, None]
    rows, cols = live.nonzero(as_tuple=True)
    out = torch.full(cands.shape, NEG_INF, dtype=torch.int32,
                     device=cands.device)
    for p0 in range(0, rows.shape[0], chunk):
        r, c = rows[p0:p0 + chunk], cols[p0:p0 + chunk]
        win = gather_windows(cands[r, c], genome, W, slack)
        out[r, c] = nw_ref.nw_scores(
            emis_t[r].transpose(1, 2), win, lens[r], open_q=open_q,
            ext_q=ext_q, band=None)
    return out


def nw_scores_full(emis_t: torch.Tensor, cands: torch.Tensor,
                   lens: torch.Tensor, genome: torch.Tensor, *, L: int,
                   W: int, slack: int, open_q: int,
                   ext_q: int) -> torch.Tensor:
    """Unbanded scores for every (read-strand, candidate) pair.

    emis_t int32[B2, 5, L]  emission tables, code-major (pad rows zero)
    cands  int32[B2, C]     candidate anchors, SENTINEL-padded
    lens   int32[B2]        true read lengths
    genome int8[G]          base codes (N = 4)
    returns int32[B2, C]    scores, NEG_INF at sentinels, 0 at length 0
    """
    kw = dict(L=L, W=W, slack=slack, open_q=open_q, ext_q=ext_q)
    if emis_t.device.type == "cpu":
        return nw_scores_full_plain(emis_t, cands, lens, genome, **kw)
    if emis_t.device.type != "cuda":
        raise ValueError(f"nw_scores_full: unsupported device "
                         f"{emis_t.device} (cpu runs the plain version, "
                         "cuda the kernel)")
    B2, C = cands.shape
    dev = emis_t.device
    check_tensor("emis_t", emis_t, torch.int32, (B2, 5, L), dev)
    check_tensor("cands", cands, torch.int32, (B2, C), dev)
    check_tensor("lens", lens, torch.int32, (B2,), dev)
    check_tensor("genome", genome, torch.int8, (genome.shape[0],), dev)
    out = torch.empty((B2, C), dtype=torch.int32, device=dev)
    if B2 == 0 or C == 0:
        return out
    from gnumap_tpu_torch import _build
    fn = _build.load("nw_full").nw_full_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                             ctypes.c_void_p]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(emis_t.data_ptr(), cands.data_ptr(), lens.data_ptr(),
                genome.data_ptr(), genome.shape[0], out.data_ptr(), B2, C, L,
                W, slack, open_q, ext_q, stream)
    if rc == -1:
        raise ValueError(f"nw_full kernel: window width {W} not built "
                         "(W <= 256)")
    if rc != 0:
        raise RuntimeError(f"nw_full kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return out
