"""The native FASTQ reader's one reused buffer
(gnumap_tpu_torch/io/fastq.py ``batch_reads_native``), on the CPU.

The reader parses in place from one ``bytearray`` and reads again only
when a parse comes back short.  It is held, batch for batch and field for
field, to the loop it replaced (``concatenating_reader`` below: every pass
reads ``CHUNK`` bytes, parses ``tail + data`` and keeps ``chunk[consumed:]``
as the next tail), and to the JAX package's reader, on generated FASTQs:
small chunks that put read boundaries inside records at every offset,
names up to 255 characters, reads over ``max_read_len`` (the truncation
count and its warnings), no trailing newline, an empty file, a record
longer than the starting buffer, and the multi-host byte ranges.  Its
counters say how often it reads and how much it carries over.
"""

import logging
import string

import numpy as np
import pytest

from gnumap_tpu import config as jconfig
from gnumap_tpu.io import fastq as jfastq
from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.dist import multihost
from gnumap_tpu_torch.io import fastq as io_fastq
from gnumap_tpu_torch.native import lib as native_lib
from gnumap_tpu_torch.utils import profiling

_parse = native_lib.parse_fastq_chunk
NAME_CHARS = np.array(list(string.ascii_letters + string.digits + "_:.-/|"))


@pytest.fixture(autouse=True)
def native():
    if not native_lib.available():
        pytest.skip("native host library unavailable (no C++ compiler)")


def concatenating_reader(path, cfg, chunk, start=0, stop=None):
    """The reader as it was before it kept one buffer: each pass reads
    ``chunk`` bytes, concatenates them to the unparsed tail, parses that
    and slices the new tail off it."""
    B, L = cfg.batch_size, cfg.max_read_len
    pend_names = []
    pend = None
    tail = b""
    n_trunc = 0
    with open(path, "rb") as f:
        if start:
            f.seek(start)
        remaining = None if stop is None else stop - start
        while True:
            want = chunk if remaining is None else min(chunk, remaining)
            data = f.read(want) if want else b""
            buf = tail + data
            if remaining is not None:
                remaining -= len(data)
            eof = not data
            if not buf:
                break
            names, codes, quals, lens, consumed, chunk_trunc = _parse(
                buf, 4 * B, L, cfg.phred_offset, is_final=eof)
            if chunk_trunc and n_trunc == 0:
                io_fastq.logger.warning(
                    "%s: reads exceed max_read_len=%d; truncating "
                    "(raise -L to keep full reads)", path, L)
            n_trunc += chunk_trunc
            if consumed == 0 and eof and not names:
                break
            tail = buf[consumed:]
            i = 0
            while i < len(names):
                take = min(B - len(pend_names), len(names) - i)
                part = (names[i:i + take], codes[i:i + take],
                        quals[i:i + take], lens[i:i + take])
                if pend is None and take == B:
                    yield io_fastq.ReadBatch(part[0], part[1], None, part[3],
                                             part[2], B)
                else:
                    if pend is None:
                        pend = [np.full((B, L), 4, np.int8),
                                np.zeros((B, L), np.int16),
                                np.zeros(B, np.int32)]
                    k = len(pend_names)
                    pend[0][k:k + take] = part[1]
                    pend[1][k:k + take] = part[2]
                    pend[2][k:k + take] = part[3]
                    pend_names.extend(part[0])
                    if len(pend_names) == B:
                        yield io_fastq.ReadBatch(pend_names, pend[0], None,
                                                 pend[2], pend[1], B)
                        pend_names, pend = [], None
                i += take
            if eof and not names:
                break
    if pend_names:
        yield io_fastq.ReadBatch(pend_names, pend[0], None, pend[2],
                                 pend[1], len(pend_names))
    if n_trunc:
        io_fastq.logger.warning(
            "%s: %d reads were truncated to max_read_len=%d", path, n_trunc,
            L)


def write_fastq(path, n, seed, max_name=24, lens=(30, 70), long_every=0,
                long_len=0, trailing_newline=True):
    """``n`` records from ``seed``: names of 1 to ``max_name`` characters,
    some with a comment after a space or a tab, sequences of ``lens``
    bases (N and lower case among them), every ``long_every``-th of
    ``long_len``, a '+' line that repeats the name now and then."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        name = "".join(rng.choice(NAME_CHARS, rng.integers(1, max_name + 1)))
        if i % 5 == 3:
            name += (" ", "\t")[i % 2] + "1:N:0:ACGT"
        k = (long_len if long_every and i % long_every == long_every - 1
             else int(rng.integers(lens[0], lens[1] + 1)))
        seq = "".join(rng.choice(list("ACGTACGTACGTNacgt"), k))
        qual = "".join(chr(c) for c in rng.integers(35, 75, k))
        plus = "+" + name if i % 7 == 0 else "+"
        out.append(f"@{name}\n{seq}\n{plus}\n{qual}\n")
    text = "".join(out)
    if not trailing_newline:
        text = text[:-1]
    path.write_text(text)
    return str(path)


def same_batches(got, want):
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        assert g.names == w.names, k
        assert g.n == w.n and g.pwm_arr is None and w.pwm_arr is None, k
        for f in ("codes", "quals", "lens"):
            a, b = getattr(g, f), getattr(w, f)
            assert a.dtype == b.dtype and a.shape == b.shape, (k, f)
            assert np.array_equal(a, b), (k, f)


def both(path, cfg, chunk, monkeypatch, caplog, start=0, stop=None):
    """(the reader's batches, the old loop's), each with its warnings."""
    monkeypatch.setattr(io_fastq, "CHUNK", chunk)
    out = []
    for read in (io_fastq.batch_reads_native,
                 lambda *a: concatenating_reader(*a[:2], chunk, *a[2:])):
        caplog.clear()
        with caplog.at_level(logging.WARNING, "gnumap_tpu_torch.io"):
            batches = list(read(path, cfg, start, stop))
        out.append((batches, [r.getMessage() for r in caplog.records]))
    return out


@pytest.mark.parametrize("chunk", [97, 4096, 65536])
def test_reader_equals_the_concatenating_loop(chunk, tmp_path, monkeypatch,
                                              caplog):
    path = write_fastq(tmp_path / "r.fq", 2500, seed=chunk)
    cfg = MapperConfig(batch_size=7, max_read_len=80)
    (got, gw), (want, ww) = both(path, cfg, chunk, monkeypatch, caplog)
    same_batches(got, want)
    assert sum(b.n for b in got) == 2500 and gw == ww == []


@pytest.mark.parametrize("trailing_newline", [True, False])
def test_records_straddle_every_boundary(trailing_newline, tmp_path,
                                         monkeypatch, caplog):
    """Chunks of 1 to 160 bytes put the first read's end, and so every
    later carry-over, at each offset of the first records."""
    path = write_fastq(tmp_path / "r.fq", 40, seed=3, lens=(10, 40),
                       trailing_newline=trailing_newline)
    cfg = MapperConfig(batch_size=3, max_read_len=40)
    for chunk in range(1, 161):
        (got, _), (want, _) = both(path, cfg, chunk, monkeypatch, caplog)
        same_batches(got, want)
        assert sum(b.n for b in got) == 40, chunk


@pytest.mark.parametrize("chunk", [97, 4096])
def test_long_names_and_truncated_reads(chunk, tmp_path, monkeypatch,
                                        caplog):
    path = write_fastq(tmp_path / "r.fq", 600, seed=11, max_name=255,
                       lens=(20, 60), long_every=9, long_len=150)
    cfg = MapperConfig(batch_size=5, max_read_len=64)
    (got, gw), (want, ww) = both(path, cfg, chunk, monkeypatch, caplog)
    same_batches(got, want)
    assert max(len(n) for b in got for n in b.names) == 255
    assert gw == ww == [
        f"{path}: reads exceed max_read_len=64; truncating (raise -L to "
        "keep full reads)",
        f"{path}: {600 // 9} reads were truncated to max_read_len=64"]


@pytest.mark.parametrize("text", ["", "@r0\nACGT\n+\nIIII",
                                  "@r0\nACGT\n+\nIIII\n@r1\nAC\n+\nII"])
def test_small_files_without_trailing_newline(text, tmp_path, monkeypatch,
                                              caplog):
    path = tmp_path / "r.fq"
    path.write_text(text)
    cfg = MapperConfig(batch_size=4, max_read_len=8)
    (got, _), (want, _) = both(str(path), cfg, 1 << 20, monkeypatch, caplog)
    same_batches(got, want)
    assert sum(b.n for b in got) == text.count("@")


def spy(monkeypatch):
    """Wrap the native parse: the buffer's size at each call."""
    sizes = []

    def parse(chunk, *a, **kw):
        sizes.append(len(chunk))
        return _parse(chunk, *a, **kw)

    monkeypatch.setattr(native_lib, "parse_fastq_chunk", parse)
    return sizes


def test_record_longer_than_the_buffer_grows_it(tmp_path, monkeypatch,
                                                caplog):
    path = write_fastq(tmp_path / "r.fq", 300, seed=5, long_every=100,
                       long_len=1500)
    cfg = MapperConfig(batch_size=6, max_read_len=2000)
    sizes = spy(monkeypatch)
    (got, _), (want, _) = both(path, cfg, 256, monkeypatch, caplog)
    same_batches(got, want)
    assert sizes[0] == 512 and max(sizes) == 4096
    assert sorted(sizes) == sizes        # the buffer never shrinks


@pytest.mark.parametrize("hosts", [2, 3])
def test_multihost_byte_ranges(hosts, tmp_path, monkeypatch, caplog):
    path = write_fastq(tmp_path / "r.fq", 1500, seed=hosts)
    cfg = MapperConfig(batch_size=8, max_read_len=80)
    names = []
    for start, stop in multihost.fastq_ranges(path, hosts):
        (got, _), (want, _) = both(path, cfg, 4096, monkeypatch, caplog,
                                   start, stop)
        same_batches(got, want)
        names += [n for b in got for n in b.names]
    whole = list(io_fastq.batch_reads_native(path, cfg))
    assert names == [n for b in whole for n in b.names]
    assert len(names) == 1500


@pytest.mark.parametrize("chunk", [4096, 8 << 20])
def test_equals_the_jax_packages_reader(chunk, tmp_path, monkeypatch):
    path = write_fastq(tmp_path / "r.fq", 3000, seed=17, max_name=255,
                       long_every=13, long_len=120)
    kw = dict(batch_size=64, max_read_len=100)
    monkeypatch.setattr(io_fastq, "CHUNK", chunk)
    got = list(io_fastq.batch_reads_native(path, MapperConfig(**kw)))
    want = list(jfastq.batch_reads_native(path, jconfig.MapperConfig(**kw)))
    same_batches(got, want)


def test_counters_read_carry_and_parse(tmp_path, monkeypatch):
    """Over a file of 20+ chunks: each read carries less than a chunk, the
    buffer stays at twice the chunk, and every parse is counted."""
    chunk = 4096
    path = write_fastq(tmp_path / "r.fq", 1200, seed=23)
    assert (tmp_path / "r.fq").stat().st_size >= 20 * chunk
    cfg = MapperConfig(batch_size=4, max_read_len=80)
    monkeypatch.setattr(io_fastq, "CHUNK", chunk)
    sizes = spy(monkeypatch)
    before = profiling.counters()
    batches = list(io_fastq.batch_reads_native(path, cfg))
    after = profiling.counters()
    d = {k: after[k] - before[k] for k in
         ("io.reads", "io.carry_bytes", "io.chunks")}
    assert sum(b.n for b in batches) == 1200
    assert d["io.reads"] >= 10
    assert d["io.carry_bytes"] / d["io.reads"] < chunk
    assert set(sizes) == {2 * chunk}
    assert d["io.chunks"] == len(sizes)


def test_parse_of_a_buffer_range_equals_the_bytes_form(tmp_path):
    path = write_fastq(tmp_path / "r.fq", 50, seed=29)
    data = open(path, "rb").read()
    buf = bytearray(b"\0" * 13 + data + b"junk")
    lo, hi = 13, 13 + len(data) - 40
    for final in (True, False):
        a = _parse(data[:hi - lo], 64, 80, 33, final)
        b = _parse(buf, 64, 80, 33, final, lo=lo, hi=hi)
        assert a[0] == b[0] and a[4:] == b[4:]
        for x, y in zip(a[1:4], b[1:4]):
            assert x.dtype == y.dtype and np.array_equal(x, y)
    with pytest.raises(ValueError, match="outside"):
        _parse(buf, 64, 80, 33, lo=5, hi=len(buf) + 1)
