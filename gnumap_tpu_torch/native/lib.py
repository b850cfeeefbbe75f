"""ctypes bindings for the native host runtime (C++), built at first use by
``gnumap_tpu_torch/_build.py`` (``build_host``), with a pure-Python fallback.

Components (reference analogs in SURVEY.md §2):
  * nw_traceback — exact integer NW + CIGAR traceback (ScoredSeq::align)
  * emission_int — integer PWM x S emission table
  * parse_fastq_chunk — FASTQ fast path (SeqReader)
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from gnumap_tpu_torch import _build

_lock = threading.Lock()
_lib = None
_tried = False


def get_lib():
    """The loaded shared library, or None (fallback to Python paths)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = _build.build_host()
        if so is None:
            return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        lib.nw_traceback.restype = ctypes.c_int64
        lib.nw_traceback.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_char_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.emission_int.restype = None
        lib.emission_int.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p]
        lib.finish_hits.restype = None
        lib.finish_hits.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,          # pwm, lens
            ctypes.c_void_p, ctypes.c_int64,           # genome, G
            ctypes.c_void_p, ctypes.c_void_p,          # S_plus, S_minus
            ctypes.c_void_p, ctypes.c_void_p,          # read_idx, strand
            ctypes.c_void_p, ctypes.c_int32,           # cand, H
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,  # Lmax, W, slack
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,  # open, ext, neg
            ctypes.c_int32, ctypes.c_int32,             # band_off, band_w
            ctypes.c_void_p, ctypes.c_void_p,          # out score, pos
            ctypes.c_void_p, ctypes.c_void_p,          # out ref_len, cigar
            ctypes.c_int32, ctypes.c_int32]            # stride, n_threads
        lib.build_csr_index.restype = ctypes.c_int64
        lib.build_csr_index.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.suffix_array_sais.restype = None
        lib.suffix_array_sais.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p]
        lib.scatter_coverage.restype = None
        lib.scatter_coverage.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
        lib.scatter_tallies.restype = None
        lib.scatter_tallies.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_double]
        lib.format_sam_batch.restype = ctypes.c_int64
        lib.format_sam_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # codes,
            ctypes.c_int32, ctypes.c_int32,                      # quals,lens
            ctypes.c_char_p, ctypes.c_void_p,                    # names
            ctypes.c_char_p, ctypes.c_void_p,                    # rnames
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # read,flag,
            ctypes.c_void_p, ctypes.c_void_p,                    # rn,pos,mapq
            ctypes.c_char_p, ctypes.c_void_p,                    # cigars
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # score,xs,w
            ctypes.c_int64,                                      # Nh
            ctypes.c_void_p, ctypes.c_void_p,                    # unmapped,
            ctypes.c_void_p,                                     # skip; n_slow
            ctypes.c_void_p, ctypes.c_int64]                     # out
        lib.format_sgr.restype = ctypes.c_int64
        lib.format_sgr.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p,
            ctypes.c_int64]
        lib.parse_fastq_chunk.restype = ctypes.c_int32
        lib.parse_fastq_chunk.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def nw_traceback(emis: np.ndarray, window: np.ndarray, open_q: int,
                 ext_q: int, neg_inf: int, band=None):
    """(score, pos_in_window, cigar, ref_len) — bit-identical to
    oracle.nw_align(traceback=True).  ``band`` = MapperConfig.band()
    ([FROZEN v3]) or None."""
    lib = get_lib()
    emis = np.ascontiguousarray(emis, dtype=np.int32)
    window = np.ascontiguousarray(window, dtype=np.int8)
    L, W = emis.shape[0], window.shape[0]
    boff, bw = band if band is not None else (0, 0)
    buf = ctypes.create_string_buffer(4 * L + 64)
    pos = ctypes.c_int32()
    rl = ctypes.c_int32()
    score = lib.nw_traceback(
        emis.ctypes.data, window.ctypes.data, L, W,
        open_q, ext_q, neg_inf, boff, bw, buf, len(buf), ctypes.byref(pos),
        ctypes.byref(rl))
    return int(score), int(pos.value), buf.value.decode(), int(rl.value)


def emission_int(pwm_q: np.ndarray, S_q: np.ndarray) -> np.ndarray:
    lib = get_lib()
    pwm_q = np.ascontiguousarray(pwm_q, dtype=np.int32)
    S_q = np.ascontiguousarray(S_q, dtype=np.int32)
    L = pwm_q.shape[0]
    out = np.empty((L, 5), dtype=np.int32)
    lib.emission_int(pwm_q.ctypes.data, S_q.ctypes.data, L, out.ctypes.data)
    return out


def parse_fastq_chunk(chunk, max_reads: int, max_len: int,
                      phred_offset: int, is_final: bool = True,
                      lo: int = 0, hi: "int | None" = None):
    """-> (names, codes, quals, lens, consumed_bytes, n_truncated)

    ``chunk`` is bytes or any other buffer (the reader's ``bytearray``);
    only its bytes [lo, hi) are parsed, in place, and ``consumed_bytes``
    counts from ``lo``."""
    lib = get_lib()
    data = np.frombuffer(chunk, np.uint8)
    hi = len(data) if hi is None else hi
    if not 0 <= lo <= hi <= len(data):
        raise ValueError(f"byte range [{lo}, {hi}) outside a buffer of "
                         f"{len(data)} bytes")
    codes = np.empty((max_reads, max_len), dtype=np.int8)
    quals = np.empty((max_reads, max_len), dtype=np.int16)
    lens = np.empty(max_reads, dtype=np.int32)
    name_cap = 256 * max_reads
    name_buf = ctypes.create_string_buffer(name_cap)
    name_off = np.empty(max_reads, dtype=np.int64)
    consumed = ctypes.c_int64()
    n_trunc = ctypes.c_int64()
    nr = lib.parse_fastq_chunk(
        data.ctypes.data + lo, hi - lo, max_reads, max_len, phred_offset,
        1 if is_final else 0,
        codes.ctypes.data, quals.ctypes.data, lens.ctypes.data,
        name_buf, name_cap, name_off.ctypes.data, ctypes.byref(consumed),
        ctypes.byref(n_trunc))
    names = []
    raw = name_buf.raw
    for i in range(nr):
        o = int(name_off[i])
        names.append(raw[o:raw.index(b"\0", o)].decode())
    return (names, codes[:nr], quals[:nr], lens[:nr], int(consumed.value),
            int(n_trunc.value))


CIGAR_STRIDE = 512


def finish_hits(pwm_q: np.ndarray, lens: np.ndarray, genome: np.ndarray,
                S_plus: np.ndarray, S_minus: np.ndarray,
                read_idx: np.ndarray, strand: np.ndarray,
                cand: np.ndarray, Lmax: int, W: int, slack: int,
                open_q: int, ext_q: int, neg_inf: int, band=None,
                n_threads: int = 0):
    """Batched emission+window+traceback for H hits (worker threads).
    -> (scores int64[H], pos int32[H], ref_len int32[H], cigars list[str])
    """
    import os as _os
    lib = get_lib()
    H = len(read_idx)
    pwm_q = np.ascontiguousarray(pwm_q, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    genome = np.ascontiguousarray(genome, np.int8)
    read_idx = np.ascontiguousarray(read_idx, np.int32)
    strand = np.ascontiguousarray(strand, np.int8)
    cand = np.ascontiguousarray(cand, np.int32)
    Sp = np.ascontiguousarray(S_plus, np.int32)
    Sm = np.ascontiguousarray(S_minus, np.int32)
    score = np.empty(H, np.int64)
    pos = np.empty(H, np.int32)
    rl = np.empty(H, np.int32)
    cig = np.zeros(H * CIGAR_STRIDE, np.int8)
    if n_threads <= 0:
        n_threads = max(1, min(8, _os.cpu_count() or 1))
    boff, bw = band if band is not None else (0, 0)
    lib.finish_hits(
        pwm_q.ctypes.data, lens.ctypes.data, genome.ctypes.data,
        len(genome), Sp.ctypes.data, Sm.ctypes.data,
        read_idx.ctypes.data, strand.ctypes.data, cand.ctypes.data, H,
        Lmax, W, slack, open_q, ext_q, neg_inf, boff, bw,
        score.ctypes.data, pos.ctypes.data, rl.ctypes.data,
        cig.ctypes.data, CIGAR_STRIDE, n_threads)
    raw = cig.tobytes()
    cigars = []
    for h in range(H):
        seg = raw[h * CIGAR_STRIDE:(h + 1) * CIGAR_STRIDE]
        cigars.append(seg[:seg.index(0)].decode())
    return score, pos, rl, cigars


def suffix_array(codes: np.ndarray) -> np.ndarray:
    """Linear-time SA-IS suffix array of codes + sentinel (int32[n+1]);
    byte-identical to index/fm.py's numpy prefix-doubling path."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.int8)
    sa = np.empty(len(codes) + 1, np.int32)
    lib.suffix_array_sais(codes.ctypes.data, len(codes), sa.ctypes.data)
    return sa


def build_csr_index(codes: np.ndarray, m: int):
    """O(G) counting-sort CSR build; byte-identical to the NumPy path."""
    lib = get_lib()
    codes = np.ascontiguousarray(codes, np.int8)
    nb = 4 ** m
    bucket_start = np.zeros(nb + 1, np.int32)
    positions = np.empty(len(codes), np.int32)
    n = lib.build_csr_index(codes.ctypes.data, len(codes), m,
                            bucket_start.ctypes.data, positions.ctypes.data)
    # shrink in place: copying the valid prefix out would hold the
    # positions twice at the build's peak
    positions.resize(n, refcheck=False)
    return bucket_start, positions


def scatter_coverage(coverage: np.ndarray, pos: np.ndarray, rl: np.ndarray,
                     w: np.ndarray) -> None:
    """Ordered in-place coverage scatter — bit-identical to the NumPy
    np.add.at path (pipeline.mapper._scatter_coverage)."""
    lib = get_lib()
    pos = np.ascontiguousarray(pos, np.int64)
    rl = np.ascontiguousarray(rl, np.int64)
    w = np.ascontiguousarray(w, np.float64)
    assert coverage.dtype == np.float64 and coverage.flags.c_contiguous
    lib.scatter_coverage(pos.ctypes.data, rl.ctypes.data, w.ctypes.data,
                         len(pos), coverage.ctypes.data, coverage.shape[0])


def scatter_tallies(tallies: np.ndarray, pwm_q: np.ndarray,
                    lens: np.ndarray, b_idx: np.ndarray, minus: np.ndarray,
                    pos: np.ndarray, w: np.ndarray, cigars,
                    pwm_scale: float) -> None:
    """Ordered in-place SNP tally scatter (per-base fractional A/C/G/T).
    ``cigars``: list of str, "" = pure match of the read's full length.
    Bit-identical to pipeline.mapper._scatter_tallies."""
    lib = get_lib()
    pwm_q = np.ascontiguousarray(pwm_q, np.int32)
    lens = np.ascontiguousarray(lens, np.int32)
    b_idx = np.ascontiguousarray(b_idx, np.int32)
    minus = np.ascontiguousarray(minus, np.int8)
    pos = np.ascontiguousarray(pos, np.int64)
    w = np.ascontiguousarray(w, np.float64)
    stride = max(8, max((len(c) for c in cigars), default=0) + 1)
    cbuf = np.zeros(len(cigars) * stride, np.int8)
    view = cbuf.view(np.uint8)
    for h, c in enumerate(cigars):
        if c:
            enc = c.encode()
            view[h * stride:h * stride + len(enc)] = np.frombuffer(enc,
                                                                   np.uint8)
    assert tallies.dtype == np.float64 and tallies.flags.c_contiguous
    lib.scatter_tallies(
        pwm_q.ctypes.data, lens.ctypes.data, pwm_q.shape[1],
        b_idx.ctypes.data, minus.ctypes.data, pos.ctypes.data,
        w.ctypes.data, len(pos), cbuf.ctypes.data, stride,
        tallies.ctypes.data, tallies.shape[0], float(pwm_scale))


def _utf8_offsets(strings):
    """(UTF-8 bytes of the strings joined, int64 byte offsets [n + 1]):
    offsets count bytes, so a name after a non-ASCII one starts where the
    formatter looks for it."""
    enc = [x.encode("utf-8") for x in strings]
    off = np.zeros(len(enc) + 1, np.int64)
    if enc:
        np.cumsum([len(e) for e in enc], out=off[1:])
    return b"".join(enc), off


def _sam_batch_args(codes, quals, lens, names, rnames,
                    hit_read, hit_flag, hit_rname, hit_pos, hit_mapq,
                    cigars, hit_score, hit_xs, hit_weight,
                    unmapped, skip=None):
    """(arrays the C formatter reads, in its argument order without the
    output buffer, capacity that bounds the output).  The last array,
    int64[1], is where the formatter writes its count of XS:f / XP:f
    fields written by snprintf.  The arrays must stay referenced while the
    formatter runs."""
    codes = np.ascontiguousarray(codes, np.int8)
    quals = np.ascontiguousarray(quals, np.int16)
    lens = np.ascontiguousarray(lens, np.int32)
    B, Lmax = codes.shape
    name_b, name_off = _utf8_offsets(names)
    rname_b, rname_off = _utf8_offsets(rnames)
    Nh = len(hit_read)
    hit_read = np.ascontiguousarray(hit_read, np.int32)
    hit_flag = np.ascontiguousarray(hit_flag, np.int32)
    hit_rname = np.ascontiguousarray(hit_rname, np.int32)
    hit_pos = np.ascontiguousarray(hit_pos, np.int64)
    hit_mapq = np.ascontiguousarray(hit_mapq, np.int32)
    hit_score = np.ascontiguousarray(hit_score, np.int32)
    hit_xs = np.ascontiguousarray(hit_xs, np.float64)
    hit_weight = np.ascontiguousarray(hit_weight, np.float64)
    cigar_b, cigar_off = (cigars if isinstance(cigars, tuple)
                          else _utf8_offsets(cigars))
    unmapped = np.ascontiguousarray(unmapped, np.uint8)
    skip_arr = (np.ascontiguousarray(skip, np.uint8)
                if skip is not None else None)
    # capacity: every HIT repeats its read's qname and may use the
    # longest contig name (multi-mapped reads with long headers overflowed
    # the old per-read estimate); all in bytes
    name_lens = np.diff(name_off)
    max_rn = int(np.diff(rname_off).max()) if len(rnames) else 0
    cap = ((int(name_lens[hit_read].sum()) if Nh else 0)
           + Nh * (max_rn + 2 * Lmax + 128) + len(cigar_b)
           + int(name_off[-1]) + B * (2 * Lmax + 64) + 1024)
    args = (codes, quals, lens, B, Lmax, name_b, name_off, rname_b,
            rname_off, hit_read, hit_flag, hit_rname, hit_pos, hit_mapq,
            cigar_b, cigar_off, hit_score, hit_xs, hit_weight, Nh, unmapped,
            skip_arr, np.zeros(1, np.int64))
    return args, cap


def _c_args(args):
    """numpy arrays -> their data pointers (None stays NULL)."""
    return [a.ctypes.data if isinstance(a, np.ndarray) else a for a in args]


_out = threading.local()


def _out_buffer(cap: int) -> np.ndarray:
    """This thread's SAM output buffer, at least ``cap`` bytes: reused from
    batch to batch, grown geometrically, never zero-filled."""
    buf = getattr(_out, "buf", None)
    size = 0 if buf is None else len(buf)
    if size < cap:
        buf = _out.buf = np.empty(max(cap, 2 * size), np.uint8)
    return buf


def format_sam_batch_view(*args, **kwargs):
    """format_sam_batch's output without a copy: (a memoryview of this
    thread's output buffer, valid until the thread's next call; the XS:f /
    XP:f fields the formatter wrote with snprintf, non-finite or
    |x| >= 1e9).  Takes format_sam_batch's arguments."""
    cargs, cap = _sam_batch_args(*args, **kwargs)
    buf = _out_buffer(cap)
    n = get_lib().format_sam_batch(*_c_args(cargs), buf.ctypes.data, cap)
    if n < 0:
        raise RuntimeError("format_sam_batch: output capacity exceeded")
    return memoryview(buf)[:n], int(cargs[-1][0])


def format_sam_batch(codes, quals, lens, names, rnames,
                     hit_read, hit_flag, hit_rname, hit_pos, hit_mapq,
                     cigars, hit_score, hit_xs, hit_weight,
                     unmapped, skip=None) -> bytes:
    """One batch of SAM records as UTF-8 bytes, byte-identical to the
    io/sam.py per-record formatting encoded as UTF-8 (tests/test_native.py;
    names and contig names may be any text).  ``cigars``: list[str], "" =
    pure match of the read's full length, or those strings already joined
    as (UTF-8 bytes, int64 byte offsets [Nh + 1]); ``skip``: optional
    bool[B] to emit nothing for a read (genome-partitioned multi-host
    mode).  Raises RuntimeError if the output would exceed the capacity
    bound."""
    view, _ = format_sam_batch_view(
        codes, quals, lens, names, rnames, hit_read, hit_flag, hit_rname,
        hit_pos, hit_mapq, cigars, hit_score, hit_xs, hit_weight, unmapped,
        skip)
    return view.tobytes()


def format_sgr(name: str, pos: np.ndarray, val: np.ndarray) -> bytes:
    """SGR lines for one contig (1-based positions), byte-identical to the
    io/sgr.py per-line f-string path encoded as UTF-8."""
    lib = get_lib()
    pos = np.ascontiguousarray(pos, np.int64)
    val = np.ascontiguousarray(val, np.float64)
    nb = name.encode("utf-8")
    cap = len(pos) * (len(nb) + 48) + 64
    out = ctypes.create_string_buffer(cap)
    n = lib.format_sgr(nb, len(nb), pos.ctypes.data, val.ctypes.data,
                       len(pos), out, cap)
    if n < 0:
        raise RuntimeError("format_sgr: capacity exceeded")
    return out.raw[:n]
