"""The port's host staging (gnumap_tpu_torch/pipeline/staging.py, a fixed
ring of buffers for each mapper's copies) and the host-memory probe
(tools/torch_host_mem.py), on the CPU.

The ring holds a fixed number of buffers over a 20-batch stream, hands out
no slot whose tensors are still alive, and changes no output: the CLI's SAM
body and SGR equal the JAX CLI's, and a batch that overflows hit_capacity
(host-finish fallback, staged in a ring of its own) maps as the JAX package
maps it.  The probe's smaps parser sums a canned text by class, and the
probe runs every step of the CLI on the CPU.
"""

import contextlib
import dataclasses
import io
import json
import os
import sys

import numpy as np
import pytest
import torch

from gnumap_tpu.cli import main as jcli
from gnumap_tpu.io import fastq as jfastq
from gnumap_tpu.pipeline import mapper as jm
from gnumap_tpu_torch.cli import main as tcli
from gnumap_tpu_torch.config import MapperConfig as TMapperConfig
from gnumap_tpu_torch.index import builder as tbuilder
from gnumap_tpu_torch.io import fastq as tfastq
from gnumap_tpu_torch.pipeline import mapper as tm

from test_devtb import _pipeline_workload
from test_torch_bridge import to_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from tools import torch_host_mem  # noqa: E402

torch.set_num_threads(1)

FA = os.path.join(ROOT, "testdata", "phix_sim.fa")
FQ = os.path.join(ROOT, "testdata", "phix_sim_200.fastq")
SLOTS = tm.STREAM_DEPTH + 1


def _phix_mapper(batch_size=10):
    cfg = TMapperConfig(mer_size=8, seed_jump=4, max_read_len=40,
                        batch_size=batch_size)
    gen = tbuilder.Genome.from_fasta(FA)
    return tm.TorchMapper(gen, tbuilder.build_index(gen, cfg), cfg,
                          device="cpu"), cfg


def _batches(cfg):
    return list(tfastq.batch_reads_native(FQ, cfg))


def test_ring_holds_a_fixed_set_of_buffers_over_20_batches():
    """200 phiX reads in 20 batches of 10: the stream ring allocates each
    slot's buffers once (lens, packed reads, blob), in the first SLOTS
    batches, and never again; the overflow ring allocates nothing."""
    m, cfg = _phix_mapper()
    batches = _batches(cfg)
    assert len(batches) == 20
    allocs = []
    res = tm.map_stream(m, iter(batches),
                        batch_callback=lambda i, s: allocs.append(
                            m._ring.allocs))
    assert res.stats.n_reads == 200 and res.stats.n_mapped > 150
    assert len(allocs) == 20
    assert allocs[-1] == sum(len(s.bufs) for s in m._ring.slots) == 3 * SLOTS
    assert allocs[SLOTS - 1:] == [3 * SLOTS] * (20 - SLOTS + 1)
    assert m._spare.allocs == 0
    assert all(set(s.bufs) == {"lens", "packed", "blob"}
               for s in m._ring.slots)


def test_ring_never_reuses_a_slot_in_flight():
    """Over a 20-batch map_stream every slot handed out belongs to a batch
    whose finish is done; SLOTS submitted and unfinished batches exhaust the
    ring (the next submit raises); a numpy view kept from a finished blob
    keeps its slot out of the ring, and its values unchanged, until it is
    dropped."""
    m, cfg = _phix_mapper()
    batches = _batches(cfg)
    owner = {}          # slot index -> the batch that last staged in it
    finished = set()
    real_acquire, real_finish = m._ring.acquire, m.finish
    order = iter(range(len(batches)))

    def acquire():
        slot = real_acquire()
        i = m._ring.slots.index(slot)
        prev = owner.get(i)
        assert prev is None or prev in finished, (i, prev)
        owner[i] = next(order)
        return slot

    def finish(batch, dev_out, stats=None):
        out = real_finish(batch, dev_out, stats)
        finished.add(next(i for i, b in enumerate(batches) if b is batch))
        return out

    m._ring.acquire, m.finish = acquire, finish
    tm.map_stream(m, iter(batches))
    assert len(finished) == 20 and len(set(owner)) == SLOTS
    m._ring.acquire, m.finish = real_acquire, real_finish

    held = [m.submit(b) for b in batches[:SLOTS]]   # every slot in flight
    with pytest.raises(RuntimeError, match="staging ring"):
        m.submit(batches[SLOTS])
    m.finish(batches[0], held.pop(0))
    kept = held[0][0].numpy()[:8]          # a view of batch 1's blob
    want = kept.copy()
    m.finish(batches[1], held.pop(0))
    # two slots are finished, one of them held by the view: the ring hands
    # out the other one, then refuses
    held.append(m.submit(batches[SLOTS]))
    with pytest.raises(RuntimeError, match="staging ring"):
        m.submit(batches[SLOTS + 1])
    assert np.array_equal(kept, want)
    del kept
    held.append(m.submit(batches[SLOTS + 1]))


def test_kept_rows_alone_keep_their_slot_out_of_the_ring():
    """The accumulate path's submit copies a batch's hit rows and PWMs into
    device buffers its slot keeps (Slot.keep), which the batch's finish
    reads.  With every other view of the batch dropped (its stats' and
    blob's fetches), the rows alone keep the slot out of the ring, and
    their values unchanged, until they are dropped."""
    cfg = TMapperConfig(mer_size=8, seed_jump=4, max_read_len=40,
                        batch_size=10, snp_mode=True)
    gen = tbuilder.Genome.from_fasta(FA)
    m = tm.TorchMapper(gen, tbuilder.build_index(gen, cfg), cfg,
                       device="cpu", accumulate="device")
    batches = _batches(cfg)
    held = [m.submit(b) for b in batches[:SLOTS]]   # every slot in flight
    with pytest.raises(RuntimeError, match="staging ring"):
        m.submit(batches[SLOTS])
    m.finish(batches[0], held.pop(0))
    rows, pwm2 = held.pop(0)[:2]          # batch 1's kept rows only
    want = {k: v.clone() for k, v in rows.items()}, pwm2.clone()
    # one slot is finished and one is held by the rows alone: the ring
    # hands out the finished one, then refuses
    held.append(m.submit(batches[SLOTS]))
    with pytest.raises(RuntimeError, match="staging ring"):
        m.submit(batches[SLOTS + 1])
    assert all(torch.equal(rows[k], want[0][k]) for k in rows)
    assert torch.equal(pwm2, want[1])
    del rows, pwm2
    held.append(m.submit(batches[SLOTS + 1]))


def test_cli_with_the_ring_equals_jax(tmp_path):
    """The port's CLI on the CPU at -B 10 (20 batches through a ring of
    SLOTS slots) writes the JAX CLI's SAM body and SGR bytes."""
    argv = ["-g", FA, "-m", "8", "-j", "4", "-B", "10", "-L", "40", FQ]
    outs = []
    for main, extra, name in ((tcli.main, ["--device", "cpu"], "port"),
                              (jcli.main, [], "jax")):
        out = tmp_path / name
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert main(argv + extra + ["-o", str(out)]) == 0
        done = json.loads(buf.getvalue().splitlines()[-1])
        with open(f"{out}.sam") as f:
            body = "".join(x for x in f if not x.startswith("@PG"))
        with open(f"{out}.sgr", "rb") as f:
            outs.append((body, f.read(), done["mapped"], done["reads"]))
    assert outs[0] == outs[1]
    assert outs[0][3] == 200 and outs[0][2] > 150


def test_overflow_fallback_in_the_stream_equals_jax():
    """The repeat workload of tests/test_devtb.py in batches of 4: some
    batches overflow hit_capacity on the device finish and are re-mapped
    through the host-finish program, staged in the overflow ring, inside
    the stream; SAM records and coverage equal the JAX package's
    (TpuMapper, Pallas in interpret mode, device finish)."""
    cfg, gen, idx, batches = _pipeline_workload(seed=33, n_reads=24,
                                                glen=2000, repeats=True)
    cfg = dataclasses.replace(cfg, batch_size=4, sam_out=True, sgr_out=True)
    recs = [jfastq.ReadRecord(b.names[i], b.codes[i, :b.lens[i]],
                              b.pwm_arr[i, :b.lens[i]],
                              b.quals[i, :b.lens[i]])
            for b in batches for i in range(b.n)]
    jb = list(jfastq.batch_reads(iter(recs), cfg))
    assert len(jb) == 6
    ref = jm.TpuMapper(gen, idx, cfg, align_impl="pallas",
                       finish_impl="device")
    want = jm.map_stream(ref, iter(jb))
    tgen, tidx, tcfg = to_port((gen, idx, cfg))
    port = tm.TorchMapper(tgen, tidx, tcfg, device="cpu")
    got = tm.map_stream(port, iter(to_port(b) for b in jb))
    assert port._spare.allocs > 0          # the fallback ran
    assert got.sam_lines == want.sam_lines
    assert np.array_equal(got.coverage, want.coverage)
    assert got.stats.n_mapped == want.stats.n_mapped > 20


SMAPS = """\
00400000-00420000 r--p 00000000 00:11 146    /usr/bin/python3.12
Size:                128 kB
Rss:                 128 kB
Pss:                 128 kB
VmFlags: rd mr mw me
00420000-00704000 r-xp 00020000 00:11 146    /usr/bin/python3.12
Rss:                 2000 kB
7f0000000000-7f0000100000 r-xp 00000000 00:11 200    /usr/local/lib/libtorch_cuda.so
Rss:                 5000 kB
Anonymous:             0 kB
7f0000100000-7f0000200000 r--p 00100000 00:11 201    /usr/local/lib/libsmall.so
Rss:                   10 kB
7f0000200000-7f0000300000 r--p 00000000 00:11 202    /usr/local/lib/lib with space.so
Rss:                   20 kB
01000000-02000000 rw-p 00000000 00:00 0                                  [heap]
Rss:                 3000 kB
7f1000000000-7f1000100000 rw-p 00000000 00:00 0
Rss:                 4000 kB
7f1000100000-7f1000200000 rw-p 00000000 00:00 0    [anon:glibc arena]
Rss:                  700 kB
7f2000000000-7f2000100000 rw-s 00000000 00:05 7     /dev/nvidiactl
Rss:                  600 kB
7f2000100000-7f2000200000 rw-s 00000000 00:05 8     /dev/nvidia0
Rss:                   50 kB
7f3000000000-7f3000100000 rw-s 00000000 00:05 9     /dev/shm/x (deleted)
Rss:                    8 kB
7f3000100000-7f3000200000 rw-p 00000000 00:00 0     [stack]
Rss:                  132 kB
7f3000200000-7f3000300000 rw-s 00000000 00:01 10    /memfd:cuda (deleted)
Rss:                    4 kB
"""


def test_smaps_parser_sums_by_class():
    c = torch_host_mem.parse_smaps(SMAPS, top=2)
    assert c["libs"] == {"/usr/local/lib/libtorch_cuda.so": 5000,
                         "/usr/bin/python3.12": 2128}
    assert c["libs_rest"] == 30
    assert (c["heap"], c["anon"], c["nvidia"], c["other"]) == (
        3000, 4700, 650, 144)
    assert c["total"] == 5000 + 2128 + 30 + 3000 + 4700 + 650 + 144
    assert c["anon_largest"] == [4000, 700]
    assert c["other_largest"] == {"[stack]": 132,
                                  "/dev/shm/x (deleted)": 8,
                                  "/memfd:cuda (deleted)": 4}
    st = torch_host_mem.parse_status(
        "Name:\tpython\nVmHWM:\t  900 kB\nVmRSS:\t  800 kB\nThreads:\t3\n")
    assert st == {"VmHWM": 900, "VmRSS": 800, "Threads": 3}
    share = torch_host_mem.attributed_share(c, c["total"])
    assert share == pytest.approx(1 - 144 / c["total"])


def test_probe_records_every_step_on_the_cpu(tmp_path):
    """The probe on the phiX data at -B 20 (10 batches), --device cpu: F0
    stops at S2, the run records S0-S9 in order, and the named classes
    hold nearly all of RSS at S7."""
    out = tmp_path / "hm.json"
    assert torch_host_mem.main([
        "--device", "cpu", "--genome", FA, "--reads", FQ, "--repeat", "1",
        "--out", str(out), "--", "-m", "8", "-j", "4", "-L", "40",
        "-B", "20"]) == 0
    res = json.loads(out.read_text())
    assert [r["step"] for r in res["floor"]] == ["S0", "S1", "S2"]
    assert [r["step"] for r in res["steps"]] == list(torch_host_mem.STEPS)
    s7 = res["steps"][7]
    assert s7["attributed"] >= 0.9 and res["s7_attributed"] >= 0.9
    assert s7["rss_kb"] > res["steps"][0]["rss_kb"]
    assert res["f0_rss_mib"] > 0 and "s7_over_f0_mib" in res
