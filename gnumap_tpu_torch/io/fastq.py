"""Read I/O: FASTA / FASTQ / Illumina ``_prb.txt``/``_int.txt`` parsing and
fixed-shape device batching.

TPU-native replacement for the reference's ``SeqReader``/``SeqManager``
thread pool (SURVEY.md §1 L2 [REPO?]): instead of mutex-guarded read handout
to pthreads, a streaming parser yields **fixed-shape padded batches**
(compile-once static shapes) that are double-buffered to the device by the
pipeline.  A C++ fast path for parsing lives in gnumap_tpu_torch/native (optional;
this file is the always-available implementation).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Iterator, List, Tuple

import numpy as np

logger = logging.getLogger("gnumap_tpu_torch.io")

from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.core import packing, pwm as pwm_mod
from gnumap_tpu_torch.utils import profiling


def read_fasta(path: str) -> List[Tuple[str, str]]:
    contigs: List[Tuple[str, str]] = []
    name, parts = None, []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if name is not None:
                    contigs.append((name, "".join(parts)))
                name, parts = line[1:].split()[0], []
            else:
                parts.append(line)
    if name is not None:
        contigs.append((name, "".join(parts)))
    return contigs


@dataclasses.dataclass
class ReadRecord:
    name: str
    codes: np.ndarray        # int8[L]
    pwm_q: "np.ndarray | None"  # int32[L, 4] probability rows; None for
                                # purely quality-derived reads (FASTQ) —
                                # the PWM is then a (qual, code) table
                                # lookup done lazily / on device
    quals: np.ndarray        # int16[L] Phred values (for SAM round-trip)


def iter_fastq(path: str, cfg: MapperConfig, start: int = 0,
               stop: "int | None" = None) -> Iterator[ReadRecord]:
    """Parse FASTQ records; with (start, stop) only the RECORD-ALIGNED byte
    range [start, stop) — the multi-host byte partition
    (dist.multihost.fastq_ranges)."""
    with open(path) as f:
        if start:
            f.seek(start)
        while True:
            if stop is not None and f.tell() >= stop:
                return
            hdr = f.readline()
            if not hdr:
                return
            seq = f.readline().strip()
            f.readline()                      # '+'
            qual = f.readline().strip()
            codes = packing.encode(seq)
            q = np.frombuffer(qual.encode(), dtype=np.uint8).astype(
                np.int32) - cfg.phred_offset
            yield ReadRecord(hdr[1:].strip().split()[0], codes, None,
                             q.astype(np.int16))


def iter_fasta_reads(path: str, cfg: MapperConfig,
                     default_qual: int = 30) -> Iterator[ReadRecord]:
    """FASTA reads get a flat default quality (reference accepts FASTA input)."""
    for name, seq in read_fasta(path):
        codes = packing.encode(seq)
        q = np.full(len(codes), default_qual, dtype=np.int32)
        yield ReadRecord(name, codes, None, q.astype(np.int16))


def _trim_points(codes: np.ndarray, lens: np.ndarray, adaptor: np.ndarray,
                 min_overlap: int, max_mismatch_frac: float) -> np.ndarray:
    """Vectorized leftmost-adaptor-match per read.  FROZEN semantics: the
    new length is the leftmost p in [0, len - min_overlap] where the read
    suffix codes[p:p+n] (n = min(len - p, A)) matches adaptor[:n] with at
    most int(max_mismatch_frac * n) mismatches, N (code 4) on either side
    counting as a mismatch; len unchanged when no p qualifies.

    codes: int8[B, L] (pad 4); lens: int32[B] -> int32[B] new lengths."""
    B, L = codes.shape
    A = len(adaptor)
    if A == 0 or L == 0:
        return lens.astype(np.int32, copy=True)
    padded = np.concatenate([codes, np.full((B, A), 4, np.int8)], axis=1)
    win = np.lib.stride_tricks.sliding_window_view(padded, A, axis=1)[:, :L]
    mism = (win != adaptor) | (win == 4) | (adaptor == 4)[None, None, :]
    csum = np.cumsum(mism, axis=2)                      # (B, L, A)
    p = np.arange(L, dtype=np.int64)[None, :]
    n = np.minimum(lens[:, None].astype(np.int64) - p, A)
    nc = np.clip(n, 1, A)
    counts = np.take_along_axis(csum, (nc - 1)[:, :, None], axis=2)[..., 0]
    ok = ((p <= lens[:, None] - min_overlap)
          & (counts <= (max_mismatch_frac * nc).astype(np.int64)))
    any_ok = ok.any(axis=1)
    first = np.argmax(ok, axis=1)
    return np.where(any_ok, first, lens).astype(np.int32)


def trim_adaptor(codes: np.ndarray, quals: np.ndarray,
                 adaptor: np.ndarray, min_overlap: int = 4,
                 max_mismatch_frac: float = 0.1):
    """3' adaptor trimming (reference SeqReader adaptor-trim flag,
    SURVEY.md §5 "Config"): truncate at the leftmost position where the
    read suffix matches a prefix of the adaptor with at most
    ``max_mismatch_frac`` mismatches (N never matches).  FROZEN."""
    L = len(codes)
    new_len = int(_trim_points(codes[None, :], np.array([L], np.int32),
                               adaptor, min_overlap, max_mismatch_frac)[0])
    if new_len != L:
        return codes[:new_len], quals[:new_len]
    return codes, quals


def trim_adaptor_batch(batch: "ReadBatch", adaptor: np.ndarray,
                       min_overlap: int = 4,
                       max_mismatch_frac: float = 0.1) -> "ReadBatch":
    """Adaptor-trim a whole fixed-shape batch in place of the per-record
    path (used by the native FASTQ fast path, which produces batches
    directly).  Identical to per-record trim_adaptor for reads that fit
    max_read_len; reads longer than max_read_len are trimmed after
    truncation here (the per-record path trims before)."""
    new_lens = _trim_points(batch.codes, batch.lens, adaptor,
                            min_overlap, max_mismatch_frac)
    if np.array_equal(new_lens, batch.lens):
        return batch
    cut = np.arange(batch.codes.shape[1])[None, :] >= new_lens[:, None]
    codes = np.where(cut, np.int8(4), batch.codes).astype(np.int8)
    quals = np.where(cut, np.int16(0), batch.quals).astype(np.int16)
    pw = None
    if batch.pwm_arr is not None:
        pw = np.where(cut[:, :, None], 0, batch.pwm_arr).astype(np.int32)
    return ReadBatch(batch.names, codes, pw, new_lens, quals, batch.n)


def iter_prb(path: str, cfg: MapperConfig) -> Iterator[ReadRecord]:
    """Illumina ``_prb.txt``: per base, 4 whitespace-separated values per
    position (positions separated by tabs).  Values may be log-odds-like
    integers or raw intensities; rows are shifted positive and renormalized
    (reference ``centers.h`` quantization analog [REPO?])."""
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            groups = [g for g in line.split("\t") if g.strip()]
            rows = np.array([[float(v) for v in g.split()] for g in groups])
            if rows.shape[-1] != 4:
                raise ValueError(f"{path}:{ln+1}: expected 4 values per base")
            rows = rows - rows.min(axis=-1, keepdims=True)
            codes = np.argmax(rows, axis=-1).astype(np.int8)
            pq = pwm_mod.pwm_from_probs(rows)
            # synthesize Phred from the max probability for SAM round-trip
            pmax = pq.max(axis=-1) / 4096.0
            q = np.clip(np.round(-10.0 * np.log10(np.maximum(1e-6, 1.0 - pmax))),
                        2, 60).astype(np.int16)
            yield ReadRecord(f"prb_{ln}", codes, pq, q)


def iter_int(path: str, cfg: MapperConfig) -> Iterator[ReadRecord]:
    """Illumina ``_int.txt`` raw intensities: lane/tile/x/y prefix columns
    followed by tab-separated groups of 4 channel intensities per cycle.
    Intensities are shifted positive and renormalized into probability rows
    (same PWM quantization as _prb; reference SeqReader intensity mode
    [REPO?])."""
    with open(path) as f:
        for ln, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            groups = [g for g in line.split("\t") if g.strip()]
            # skip leading metadata columns (single numbers, not 4-tuples)
            rows = []
            for g in groups:
                vals = g.split()
                if len(vals) == 4:
                    rows.append([float(v) for v in vals])
            if not rows:
                continue
            arr = np.array(rows)
            arr = arr - arr.min(axis=-1, keepdims=True)
            codes = np.argmax(arr, axis=-1).astype(np.int8)
            pq = pwm_mod.pwm_from_probs(arr)
            pmax = pq.max(axis=-1) / 4096.0
            q = np.clip(np.round(-10.0 * np.log10(
                np.maximum(1e-6, 1.0 - pmax))), 2, 60).astype(np.int16)
            yield ReadRecord(f"int_{ln}", codes, pq, q)


def apply_adaptor_trim(records: Iterator[ReadRecord], cfg: MapperConfig,
                       adaptor: str) -> Iterator[ReadRecord]:
    """Wrap a record stream with 3' adaptor trimming."""
    ad = packing.encode(adaptor)
    for r in records:
        codes, quals = trim_adaptor(r.codes, r.quals, ad)
        if len(codes) != len(r.codes):
            pw = None if r.pwm_q is None else r.pwm_q[:len(codes)]
            r = ReadRecord(r.name, codes, pw, quals.astype(np.int16))
        yield r


@dataclasses.dataclass
class ReadBatch:
    """Fixed-shape padded batch: the device-facing unit of work.

    ``pwm_arr`` is None for purely quality-derived batches (the common
    FASTQ case): the mapper then ships only (codes, quals) to the device
    and reconstructs the PWM there with one table gather (core/pwm.py
    pwm_table) — 8x less host->device traffic than the (B, L, 4) int32
    array.  The ``pwm_q`` property materializes the identical array
    host-side on demand (SNP tallies, overflow fallback, oracle checks)."""
    names: List[str]
    codes: np.ndarray        # int8[B, Lmax], pad = N
    pwm_arr: "np.ndarray | None"  # int32[B, Lmax, 4], pad rows all-zero
    lens: np.ndarray         # int32[B], 0 for pad reads
    quals: np.ndarray        # int16[B, Lmax] Phred (0 pad)
    n: int                   # actual number of reads (<= B)

    @property
    def pwm_q(self) -> np.ndarray:
        if self.pwm_arr is None:
            pw = pwm_mod.pwm_rows_from_table(self.codes, self.quals)
            L = self.codes.shape[1]
            in_read = np.arange(L)[None, :] < self.lens[:, None]
            self.pwm_arr = np.where(in_read[:, :, None], pw,
                                    0).astype(np.int32)
        return self.pwm_arr


def batch_reads(reads: Iterator[ReadRecord], cfg: MapperConfig
                ) -> Iterator[ReadBatch]:
    """Group a read stream into fixed (batch_size, max_read_len) batches.

    Pad positions get all-zero PWM rows (emission contributes exactly 0, so
    scores are invariant to padding — frozen property, tested).  Reads longer
    than max_read_len are truncated; a warning is logged once per stream
    with the first offender, and a count is logged at stream end.
    """
    B, L = cfg.batch_size, cfg.max_read_len
    buf: List[ReadRecord] = []
    n_trunc = 0

    def flush() -> ReadBatch:
        nonlocal n_trunc
        codes = np.full((B, L), 4, dtype=np.int8)
        lens = np.zeros(B, dtype=np.int32)
        quals = np.zeros((B, L), dtype=np.int16)
        names = []
        lazy = all(r.pwm_q is None for r in buf)
        pw = None if lazy else np.zeros((B, L, 4), dtype=np.int32)
        for i, r in enumerate(buf):
            if len(r.codes) > L:
                if n_trunc == 0:
                    logger.warning(
                        "read %s (%d bp) exceeds max_read_len=%d; "
                        "truncating (raise -L to keep full reads)",
                        r.name, len(r.codes), L)
                n_trunc += 1
            n = min(len(r.codes), L)
            codes[i, :n] = r.codes[:n]
            if not lazy:
                rp = (r.pwm_q if r.pwm_q is not None else
                      pwm_mod.pwm_rows_from_table(r.codes, r.quals))
                pw[i, :n] = rp[:n]
            quals[i, :n] = r.quals[:n]
            lens[i] = n
            names.append(r.name)
        return ReadBatch(names, codes, pw, lens, quals, len(buf))

    for r in reads:
        buf.append(r)
        if len(buf) == B:
            yield flush()
            buf = []
    if buf:
        yield flush()
    if n_trunc:
        logger.warning("%d reads were truncated to max_read_len=%d",
                       n_trunc, L)


# batch_reads_native's buffer starts at 2 * CHUNK bytes and doubles only
# when one record fills it
CHUNK = 8 << 20


def batch_reads_native(path: str, cfg: MapperConfig, start: int = 0,
                       stop: "int | None" = None):
    """Native (C++) FASTQ fast path: chunked parse straight into fixed-shape
    batches; falls back to the Python parser when the lib is unavailable.
    (start, stop) restrict to a record-aligned byte range, the multi-host
    byte partition.  Reference SeqManager analog (SURVEY.md §1 L2).

    One buffer serves the whole stream: the file is read into it with
    ``readinto`` and parsed in place from the offset ``lo`` of its first
    unparsed byte to ``hi``, the end of what was read.  It is read again
    only when a parse comes back short of ``4 * B`` records, after the
    unparsed remainder (less than one parse's worth) moves to its front;
    a buffer that stays full doubles.  Only the parse after the file's (or
    the range's) last byte is final."""
    from gnumap_tpu_torch.native import lib as native_lib
    if not native_lib.available():
        yield from batch_reads(iter_fastq(path, cfg, start, stop), cfg)
        return
    B, L = cfg.batch_size, cfg.max_read_len
    per_parse = 4 * B
    buf = bytearray(2 * CHUNK)
    view = memoryview(buf)
    lo = hi = 0
    eof, short = False, True
    n_trunc = 0
    k = 0              # reads in the batch being filled (b_names, ...)
    with open(path, "rb") as f:
        if start:
            f.seek(start)
        left = None if stop is None else stop - start
        while True:
            if short and not eof:
                if 0 < lo < hi:
                    with profiling.span("io.tail"):
                        view[:hi - lo] = view[lo:hi]
                    profiling.COUNTS["io.carry_bytes"] += hi - lo
                hi -= lo
                lo = 0
                if hi == len(buf):          # one record fills the buffer
                    buf = buf + bytes(len(buf))
                    view = memoryview(buf)
                room = len(buf) - hi
                if left is not None:
                    room = min(room, left)
                got = 0
                if room:
                    with profiling.span("io.read"):
                        got = f.readinto(view[hi:hi + room])
                    profiling.COUNTS["io.reads"] += 1
                hi += got
                if left is not None:
                    left -= got
                eof = not got
            if eof and lo == hi:
                break
            profiling.COUNTS["io.chunks"] += 1
            with profiling.span("io.parse_chunk"):
                names, codes, quals, lens, consumed, chunk_trunc = \
                    native_lib.parse_fastq_chunk(buf, per_parse, L,
                                                 cfg.phred_offset,
                                                 is_final=eof, lo=lo, hi=hi)
            if chunk_trunc and n_trunc == 0:
                logger.warning(
                    "%s: reads exceed max_read_len=%d; truncating "
                    "(raise -L to keep full reads)", path, L)
            n_trunc += chunk_trunc
            lo += consumed
            nr = len(names)
            if eof and not nr:
                break
            short = nr < per_parse or lo == hi
            i = 0
            while i < nr:
                take = min(B - k, nr - i)
                j = i + take
                if take == B:
                    yield ReadBatch(names[i:j], codes[i:j], None, lens[i:j],
                                    quals[i:j], B)
                else:
                    if k == 0:
                        b_names = []
                        b_codes = np.full((B, L), 4, np.int8)
                        b_quals = np.zeros((B, L), np.int16)
                        b_lens = np.zeros(B, np.int32)
                    b_names.extend(names[i:j])
                    b_codes[k:k + take] = codes[i:j]
                    b_quals[k:k + take] = quals[i:j]
                    b_lens[k:k + take] = lens[i:j]
                    k += take
                    if k == B:
                        yield ReadBatch(b_names, b_codes, None, b_lens,
                                        b_quals, B)
                        k = 0
                i = j
    if k:
        yield ReadBatch(b_names, b_codes, None, b_lens, b_quals, k)
    if n_trunc:
        logger.warning("%s: %d reads were truncated to max_read_len=%d",
                       path, n_trunc, L)
