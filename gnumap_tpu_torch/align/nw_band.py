"""Banded NW scoring for every (read-strand, candidate) pair — the counterpart
of gnumap_tpu/align/nw_pallas.py::nw_scores_banded ([FROZEN v4] band).

``nw_scores_banded`` is the wrapper of the hand-written CUDA kernel
csrc/nw_band.cu (which replaces the Pallas ``_nw_band_kernel``).  For CPU
tensors it runs the plain version, ``nw_scores_banded_plain``: the int32
torch DP of align/nw_ref.py over gathered genome windows.  For CUDA tensors
it launches the kernel or raises; there is no fallback.

The genome is read as int8 base codes (0..4, N = 4) in device memory; a
window position outside the genome reads as N.  Both forms return NEG_INF at
SENTINEL candidates and for length-0 reads (the Pallas kernel never latches
a score for them; nw_ref's initial capture would give 0 — neither is ever
retained, since retention needs a score > 0).
"""

from __future__ import annotations

import ctypes

import torch

from gnumap_tpu_torch.config import NEG_INF, WINDOW_ALIGN
from gnumap_tpu_torch.align import nw_ref

SENTINEL = 2 ** 31 - 1

# Kernel launches by nw_scores_banded (the plain version does not count).
LAUNCHES = 0


def gather_windows(cands: torch.Tensor, genome: torch.Tensor, W: int,
                   slack: int) -> torch.Tensor:
    """Genome windows for candidate anchors: int32[..., W], N outside the
    genome ([FROZEN] window rule: start floor-aligned to WINDOW_ALIGN)."""
    G = genome.shape[0]
    ws = torch.div(cands.long() - slack, WINDOW_ALIGN,
                   rounding_mode="floor") * WINDOW_ALIGN
    idx = ws[..., None] + torch.arange(W, device=cands.device)
    oob = (idx < 0) | (idx >= G)
    win = genome[idx.clamp(0, max(G - 1, 0))].to(torch.int32)
    return torch.where(oob, 4, win)


def nw_scores_banded_plain(emis_t, cands, lens, genome, *, L, W, slack, boff,
                           bw, open_q, ext_q, chunk: int = 16384):
    """Plain torch version of the kernel: nw_ref.nw_scores with the band
    over the gathered windows of the live (non-SENTINEL, len > 0) pairs
    only, ``chunk`` pairs at a time to bound the (pairs, W+1) state."""
    live = (cands != SENTINEL) & ((lens > 0) & (lens <= L))[:, None]
    rows, cols = live.nonzero(as_tuple=True)
    out = torch.full(cands.shape, NEG_INF, dtype=torch.int32,
                     device=cands.device)
    for p0 in range(0, rows.shape[0], chunk):
        r, c = rows[p0:p0 + chunk], cols[p0:p0 + chunk]
        win = gather_windows(cands[r, c], genome, W, slack)
        out[r, c] = nw_ref.nw_scores(
            emis_t[r].transpose(1, 2), win, lens[r], open_q=open_q,
            ext_q=ext_q, band=(boff, bw))
    return out


def check_tensor(name, t, dtype, shape, device):
    """Raise unless t has the dtype, shape and device a kernel takes and is
    contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def nw_scores_banded(emis_t: torch.Tensor, cands: torch.Tensor,
                     lens: torch.Tensor, genome: torch.Tensor, *, L: int,
                     W: int, slack: int, boff: int, bw: int, open_q: int,
                     ext_q: int) -> torch.Tensor:
    """Banded scores for every (read-strand, candidate) pair.

    emis_t int32[B2, 5, L]  emission tables, code-major (pad rows zero)
    cands  int32[B2, C]     candidate anchors, SENTINEL-padded
    lens   int32[B2]        true read lengths
    genome int8[G]          base codes (N = 4)
    (boff, bw)              the [FROZEN v4] band (MapperConfig.band)
    returns int32[B2, C]    scores, NEG_INF at sentinels and length-0 reads
    """
    kw = dict(L=L, W=W, slack=slack, boff=boff, bw=bw, open_q=open_q,
              ext_q=ext_q)
    if emis_t.device.type == "cpu":
        return nw_scores_banded_plain(emis_t, cands, lens, genome, **kw)
    if emis_t.device.type != "cuda":
        raise ValueError(f"nw_scores_banded: unsupported device "
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
    lib = _build.load("nw_band")
    fn = lib.nw_band_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                             ctypes.c_void_p]
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(emis_t.data_ptr(), cands.data_ptr(), lens.data_ptr(),
                genome.data_ptr(), genome.shape[0], out.data_ptr(), B2, C, L,
                W, slack, boff, bw, open_q, ext_q, stream)
    if rc == -1:
        raise ValueError(f"nw_band kernel: band width {bw} not built "
                         "(bw = 4 * gap_slack + 10, gap_slack <= 13)")
    if rc == -2:
        raise ValueError(f"nw_band kernel: L = {L}, C = {C} do not fit a "
                         "block's shared memory or its 16-bit slot list")
    if rc != 0:
        raise RuntimeError(f"nw_band kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return out
