"""The port's captured device programs (gnumap_tpu_torch/pipeline/graphs.py,
the counterpart of the JAX package's jax.jit sites), on the CPU.

  * A host-read guard: every device program that TorchMapper captures on a
    card (tb and packed, on packed reads and on PWMs, the accumulate
    path's map program and the accumulate program itself at its tier of
    slots; every index kind; banded and unbanded) runs under a
    TorchDispatchMode that records each op reading a value back to the host
    or sizing its output by the data.  A CUDA graph can hold none of them.
    The kernel wrappers' plain versions run outside the mode: on the card
    they are the kernels, which read nothing back.
  * Programs' key and launch accounting, with a stand-in for
    torch.cuda.CUDAGraph whose replay recomputes the static outputs in
    place, as a replay overwrites them on the card.
  * The mapper through that stand-in: map_stream's depth-3 pipeline, whose
    batches in flight share the static outputs, gives the eager mapper's
    SAM, SGR and accumulators on every path that captures.
  * AccPrograms (the accumulate program, one graph a staging slot and tier
    of n_keep) through a stand-in graph that reruns the program on the
    arguments it was captured with: the eager mapper's accumulators over
    batches on every slot and two tiers, one capture a key, a replay for
    every other batch.

That submit on the CPU still gives the JAX package's blob is held by
tests/test_torch_devtb.py and tests/test_torch_mapper.py, which compare it.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from gnumap_tpu_torch.align import nw_band, nw_full, nw_pure, nw_tb
from gnumap_tpu_torch.config import MapperConfig
from gnumap_tpu_torch.core import packing
from gnumap_tpu_torch.index import builder, fm
from gnumap_tpu_torch.io import fastq as io_fastq
from gnumap_tpu_torch.pipeline import graphs, mapper as tm
from gnumap_tpu_torch.pipeline.staging import StagingRing
from gnumap_tpu_torch.posterior import accum
from gnumap_tpu_torch.utils import profiling, sim

torch.set_num_threads(1)

# ops that read a value back to the host (a sync on the card) or size their
# output by the data
HOST_READS = {"_local_scalar_dense", "nonzero", "masked_select", "_unique2",
              "unique_consecutive", "is_nonzero", "equal", "item"}
# the kernel wrappers, whose CPU form is the plain version
WRAPPERS = ((nw_band, "nw_scores_banded"), (nw_full, "nw_scores_full"),
            (nw_pure, "nw_pure_banded"), (nw_tb, "nw_traceback"),
            (accum, "apply_deltas"), (accum, "apply_deltas_pair"))
PROGRAMS = ("_device_map_tb_q", "_device_map_tb", "_device_map_packed_q",
            "_device_map_packed", "_device_map_acc_q", "_device_map_acc",
            "_apply_acc")
KINDS = ("csr", "csr_bs", "fm", "fm_bs")


class HostReads(TorchDispatchMode):
    """Records each op in HOST_READS, each index by a boolean mask and each
    repeat_interleave by a tensor of counts, unless ``paused``."""

    def __init__(self):
        super().__init__()
        self.seen = []
        self.paused = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__.rstrip("_")
        if not self.paused and (
                name in HOST_READS
                or (name in ("index", "index_put")
                    and any(isinstance(i, torch.Tensor)
                            and i.dtype == torch.bool for i in args[1]))
                or (name == "repeat_interleave"
                    and "Tensor" in func._overloadname)):
            self.seen.append(str(func))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def guard(monkeypatch):
    """HostReads with each kernel wrapper run outside it."""
    mode = HostReads()
    for mod, name in WRAPPERS:
        real = getattr(mod, name)

        def outside(*a, _real=real, **k):
            mode.paused += 1
            try:
                return _real(*a, **k)
            finally:
                mode.paused -= 1

        monkeypatch.setattr(mod, name, outside)
    return mode


def _workload(kind, banded):
    """(cfg, genome, index, three batches of 16 reads); the batches are
    copies, as ReadBatch.pwm_q fills in the batch's pwm_arr."""
    cfg, gen, idx, batches = _built(kind, banded)
    return cfg, gen, idx, [dataclasses.replace(b) for b in batches]


@functools.lru_cache(maxsize=None)
def _built(kind, banded):
    bs = kind.endswith("_bs")
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=16,
                       max_read_len=40, max_candidates=16, hit_capacity=4,
                       align_score_ratio=0.7, bisulfite=bs,
                       gap_slack=8 if banded else 16, sam_out=True,
                       sgr_out=True, snp_mode=True)
    g = sim.random_genome(6000, seed=31, repeat_frac=0.05, repeat_unit=80)
    gen = builder.Genome.from_contigs([("a", g)])
    idx = {"csr": lambda: builder.build_index(gen, cfg),
           "csr_bs": lambda: builder.build_bs_index(gen, cfg),
           "fm": lambda: fm.build_fm_index(gen, cfg),
           "fm_bs": lambda: fm.build_bs_fm_index(gen, cfg)}[kind]()
    reads = sim.simulate_reads(g, 48, 36, seed=32, sub_rate=0.02,
                               indel_rate=0.05, contig="a", bisulfite=bs)
    recs = []
    for r in reads:
        codes = packing.encode(r.seq)
        q = np.frombuffer(r.qual.encode(), np.uint8).astype(np.int16) - 33
        recs.append(io_fastq.ReadRecord(r.name, codes, None, q))
    return cfg, gen, idx, list(io_fastq.batch_reads(iter(recs), cfg))


def _args(name, batch, m=None):
    """The program's arguments for ``batch``; the accumulate program's are
    the rows and PWMs of ``m``'s map program and the batch's tier."""
    if name == "_apply_acc":
        _, rows, nvk, pwm2 = m._device_map_acc_q(*_args("_device_map_acc_q",
                                                       batch))
        return rows, pwm2, tm.acc_tier(int(nvk[1]), rows["valid_h"].shape[0])
    t = torch.from_numpy
    lens = t(np.asarray(batch.lens, np.int32))
    if name.endswith("_q"):
        return t(tm.pack_reads(batch.codes, batch.quals)), lens
    return (t(np.asarray(batch.codes, np.int8)),
            t(np.asarray(batch.pwm_q, np.int32)), lens)


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("banded", [True, False],
                         ids=["banded", "unbanded"])
@pytest.mark.parametrize("kind", KINDS)
def test_device_programs_read_nothing_back(guard, kind, banded, program):
    cfg, gen, idx, batches = _workload(kind, banded)
    m = tm.TorchMapper(gen, idx, cfg, device="cpu", accumulate="device")
    fn = getattr(m, program)
    args = _args(program, batches[0], m)
    want = fn(*args)
    cov = m._cov_dev.clone()
    with guard:
        got = fn(*args)
    assert guard.seen == []
    assert all(torch.equal(a, b) for a, b in zip(pytree.tree_leaves(got),
                                                  pytree.tree_leaves(want)))
    # the workload retains hits: the traceback and its compaction run
    if program == "_apply_acc":
        assert int(got[0][3]) > 0 and int(got[1]) > 0   # n_keep, blocks
        assert not torch.equal(m._cov_dev, cov)         # in place
    elif program.startswith("_device_map_acc"):
        assert int(got[1]["n_keep"]) > 0
    elif program.startswith("_device_map_tb"):
        assert int(got[-3]) > 0                     # blob tail: n_keep
    else:
        assert int(got[:, -1].max()) > 0            # [.. | max_sc]


@pytest.mark.parametrize("bad", ["item", "nonzero", "mask", "repeats"])
def test_guard_sees_a_host_read(guard, bad):
    x = torch.arange(6, dtype=torch.int32)
    fns = {"item": lambda: int(x.sum()),
           "nonzero": lambda: x.nonzero(),
           "mask": lambda: x[x > 2],
           "repeats": lambda: x.repeat_interleave(x)}
    with guard:
        fns[bad]()
    assert guard.seen


# ---------------------------------------------------------------------------
# Programs with a stand-in for torch.cuda.CUDAGraph
# ---------------------------------------------------------------------------

class StandInGraph:
    """In place of torch.cuda.CUDAGraph on the CPU: replay() recomputes the
    program on its static inputs into its static outputs, in place, and
    leaves the launch counters as they were (a replay runs no Python)."""

    def __init__(self, fn, args, outputs):
        self.fn, self.args, self.outputs = fn, args, outputs

    def replay(self):
        before = graphs._counts()
        new = self.fn(*self.args)
        for mod, n in zip(graphs.KERNEL_MODULES, before):
            mod.LAUNCHES = n
        for o, n in zip(pytree.tree_leaves(self.outputs),
                        pytree.tree_leaves(new)):
            o.copy_(n)


class StandInPrograms(graphs.Programs):
    """Programs that capture on the CPU through StandInGraph; ``fail``
    makes every capture raise."""

    def __init__(self, fail=False):
        super().__init__("cpu")
        self.graphed = True
        self.fail = fail
        self.captures = 0

    def _warm_up(self, fn, args):
        return fn(*args)

    def _replay(self, cap):
        return cap.replay()

    def _capture(self, fn, args):
        self.captures += 1
        if self.fail:
            raise RuntimeError("capture refused")
        outputs = fn(*args)
        return StandInGraph(fn, args, outputs), outputs


def double(x, n):
    """A toy program of two 'kernel launches' (B1 and B3 counted)."""
    nw_band.LAUNCHES += 1
    nw_tb.LAUNCHES += 1
    return {"y": x * 2, "s": (n.long().sum() + x.sum())[None]}


def triple(x, n):
    nw_band.LAUNCHES += 1
    return x * 3


@pytest.fixture
def counters():
    saved = graphs._counts()
    for mod in graphs.KERNEL_MODULES:
        mod.LAUNCHES = 0
    yield
    for mod, n in zip(graphs.KERNEL_MODULES, saved):
        mod.LAUNCHES = n


def _batch(rng, B, dtype=np.int32):
    return dict(x=rng.integers(0, 100, B).astype(dtype),
                n=rng.integers(0, 9, B).astype(np.int32))


def test_cpu_programs_run_eagerly(counters):
    p = graphs.Programs("cpu")
    ring = StagingRing("cpu", 2)
    rng = np.random.default_rng(0)
    for _ in range(3):
        b = _batch(rng, 8)
        out = p(double, ring.acquire(), **b)
        assert np.array_equal(out["y"].numpy(), b["x"] * 2)
    assert not p.graphed and p.captured == {}
    assert nw_band.LAUNCHES == nw_tb.LAUNCHES == 3


def test_one_capture_per_program_and_input_shapes(counters):
    p = StandInPrograms()
    ring = StagingRing("cpu", 2)
    rng = np.random.default_rng(1)
    for _ in range(3):
        p(double, ring.acquire(), **_batch(rng, 8))
    assert p.captures == 1
    key = graphs.Programs.key(double, _batch(rng, 8))
    assert key == ("double", ("x", (8,), "<i4"), ("n", (8,), "<i4"))
    assert list(p.captured) == [key] and p.captured[key].replays == 2
    p(double, ring.acquire(), **_batch(rng, 12))            # another shape
    p(double, ring.acquire(), **_batch(rng, 8, np.int64))   # another dtype
    p(triple, ring.acquire(), **_batch(rng, 8))             # another program
    p(double, ring.acquire(), **_batch(rng, 8))
    assert p.captures == 4 and len(p.captured) == 4
    assert p.captured[key].replays == 3


@pytest.mark.parametrize("n_calls", [1, 2, 5])
def test_launches_after_replays_equal_eager_runs(counters, n_calls):
    """The warm-up launches for real; the capture launches nothing and
    puts the counters back; each replay adds one run's launches."""
    p = StandInPrograms()
    ring = StagingRing("cpu", 2)
    rng = np.random.default_rng(2)
    for _ in range(n_calls):
        p(double, ring.acquire(), **_batch(rng, 8))
    assert nw_band.LAUNCHES == nw_tb.LAUNCHES == n_calls
    assert nw_pure.LAUNCHES == nw_full.LAUNCHES == 0
    (cap,) = p.captured.values()
    assert cap.launches == [(nw_band, 1), (nw_tb, 1)]


def test_replay_reads_the_batch_from_the_static_inputs(counters):
    p = StandInPrograms()
    ring = StagingRing("cpu", 2)
    rng = np.random.default_rng(3)
    first = p(double, ring.acquire(), **_batch(rng, 8))
    outs = []
    for _ in range(3):
        b = _batch(rng, 8)
        out = p(double, ring.acquire(), **b)
        (cap,) = p.captured.values()
        assert np.array_equal(cap.inputs["x"].numpy(), b["x"])
        assert np.array_equal(out["y"].numpy(), b["x"] * 2)
        assert out["s"].item() == b["x"].sum() + b["n"].sum()
        outs.append(out)
    # every replay hands out the same static outputs; the warm-up's are the
    # first batch's own
    assert all(o["y"] is outs[0]["y"] for o in outs)
    assert first["y"] is not outs[0]["y"]


def test_failed_capture_raises_and_runs_nothing_else(counters):
    p = StandInPrograms(fail=True)
    ring = StagingRing("cpu", 2)
    rng = np.random.default_rng(4)
    for k in range(2):
        with pytest.raises(RuntimeError, match="capture refused"):
            p(double, ring.acquire(), **_batch(rng, 8))
        # the warm-up's launches only: the capture's are put back and no
        # eager run follows the failure
        assert nw_band.LAUNCHES == k + 1
    assert p.captured == {} and p.captures == 2


# ---------------------------------------------------------------------------
# TorchMapper through the stand-in: batches in flight share the outputs
# ---------------------------------------------------------------------------

def _stream(m, batches):
    res = tm.map_stream(m, iter(batches), collect_sam=True)
    return (res.sam_lines, res.coverage, res.tallies, res.stats.n_mapped,
            res.stats.n_multi)


@pytest.mark.parametrize("path", ["device", "host", "acc", "pwm"])
@pytest.mark.parametrize("kind", ["csr", "fm_bs"])
def test_stand_in_graphs_map_as_eager(counters, kind, path):
    cfg, gen, idx, batches = _workload(kind, True)
    if path == "pwm":
        batches = [dataclasses.replace(b, pwm_arr=b.pwm_q) for b in batches]
    kw = dict(finish_impl="host") if path == "host" else (
        dict(accumulate="device") if path == "acc" else {})
    out, launches = {}, {}
    for graphed in (False, True):
        m = tm.TorchMapper(gen, idx, cfg, device="cpu", **kw)
        if graphed:
            m._programs = StandInPrograms()
        out[graphed] = _stream(m, batches)
        if graphed:
            assert m._programs.captures == 1
            (cap,) = m._programs.captured.values()
            assert cap.replays == len(batches) - 1
    assert len(batches) == 3
    for a, b in zip(out[False], out[True]):
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b)
        else:
            assert a == b
    assert out[True][3] > 0


def test_capacity_overflow_remaps_through_its_own_program(counters):
    """Device-finish batches whose hits overflow the hit capacity (reads
    inside the copies of repeat families, between two batches of plain
    reads) are re-mapped by _remap_packed through the packed program,
    captured beside the tb program, and map as the eager mapper does."""
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=16,
                       max_read_len=40, max_candidates=16, hit_capacity=1,
                       sam_out=True, sgr_out=True)
    g, spots = sim.random_genome_families(6000, seed=33, n_families=4,
                                          copies=8, unit_len=100)
    gen = builder.Genome.from_contigs([("a", g)])
    idx = builder.build_index(gen, cfg)
    inside = (np.concatenate(spots)[:, None] + np.arange(0, 60, 20)).ravel()
    reads = []
    for k in range(3):
        reads += sim.simulate_reads(
            g, 16, 36, seed=40 + k, sub_rate=0.01, contig="a",
            positions=inside if k == 1 else None)
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    out = {}
    for graphed in (False, True):
        m = tm.TorchMapper(gen, idx, cfg, device="cpu")
        if graphed:
            m._programs = StandInPrograms()
        batches = list(io_fastq.batch_reads(iter(recs), cfg))
        out[graphed] = _stream(m, batches)
        if graphed:
            caps = {k[0]: c for k, c in m._programs.captured.items()}
            assert sorted(caps) == ["_device_map_packed", "_device_map_tb_q"]
            assert caps["_device_map_tb_q"].replays == 2
    assert out[False][0] == out[True][0]
    assert np.array_equal(out[False][1], out[True][1])
    assert out[False][3] == out[True][3] > 40


# ---------------------------------------------------------------------------
# AccPrograms with a stand-in graph
# ---------------------------------------------------------------------------

class StandInAccGraph:
    """In place of a captured accumulate program on the CPU: replay() runs
    the program again on the arguments it was captured with (the same
    slot buffers, as a replay reads the same addresses) and keeps its
    outputs in ``last``; the launch counters stay as they were.  It holds
    the buffers that Slot.keep's views are views of, and no view: a graph
    holds addresses, and a live view would keep its slot busy."""

    def __init__(self, fn, args):
        self.fn, self.last = fn, None
        self.args = pytree.tree_map(
            lambda t: t._base if isinstance(t, torch.Tensor)
            and t._base is not None else t, args)

    def replay(self):
        before = graphs._counts()
        self.last = self.fn(*self.args)
        for mod, n in zip(graphs.KERNEL_MODULES, before):
            mod.LAUNCHES = n


class StandInAccPrograms(graphs.AccPrograms):
    def __init__(self):
        super().__init__("cpu")
        self.graphed = True

    def _capture(self, fn, args):
        return StandInAccGraph(fn, args), None

    def _replay(self, cap):
        cap.replay()
        return cap.graph.last


def _tier_batches():
    """Twelve batches of 64 reads (H = 512 slots), every third of them
    reads inside the copies of a 3-copy repeat family, so that n_keep
    falls in two tiers, and each tier on more than one staging slot."""
    cfg = MapperConfig(mer_size=8, seed_jump=3, batch_size=64,
                       max_read_len=40, max_candidates=16, hit_capacity=4,
                       sgr_out=True, snp_mode=True)
    g, spots = sim.random_genome_families(20_000, seed=35, n_families=2,
                                          copies=3, unit_len=120)
    gen = builder.Genome.from_contigs([("a", g)])
    idx = builder.build_index(gen, cfg)
    inside = (np.concatenate(spots)[:, None] + np.arange(0, 80, 10)).ravel()
    reads = []
    for k in range(12):
        reads += sim.simulate_reads(
            g, 64, 36, seed=50 + k, sub_rate=0.01, contig="a",
            positions=inside if k % 3 == 2 else None)
    recs = [io_fastq.ReadRecord(
        r.name, packing.encode(r.seq), None,
        (np.frombuffer(r.qual.encode(), np.uint8) - 33).astype(np.int16))
        for r in reads]
    return cfg, gen, idx, list(io_fastq.batch_reads(iter(recs), cfg))


def test_stand_in_accumulate_graphs_accumulate_as_eager(counters):
    cfg, gen, idx, batches = _tier_batches()
    out = {}
    for graphed in (False, True):
        m = tm.TorchMapper(gen, idx, cfg, device="cpu", accumulate="device")
        if graphed:
            m._acc_programs = StandInAccPrograms()
        c0 = profiling.counters()
        t0 = profiling._now()
        res = tm.map_stream(m, iter(batches), collect_sam=False)
        c1 = profiling.counters()
        tiers = profiling.values("accumulate.tier", t0, profiling._now())
        out[graphed] = (res.coverage, res.tallies, res.stats.n_mapped)
        captures = c1["accumulate.captures"] - c0["accumulate.captures"]
        replays = c1["accumulate.replays"] - c0["accumulate.replays"]
        assert len(tiers) == len(batches) == 12
        assert sorted(set(tiers.tolist())) == [128, 256]
        if not graphed:
            assert captures == replays == 0
            continue
        keys = list(m._acc_programs.captured)
        assert captures == len(keys) and replays == 12 - len(keys)
        # one key a (staging slot, tier); a key is (name, the 9 rows,
        # pwm2, tier, cov, tal), and the ring hands out its slots in turn
        ptrs = {s.kept["pwm2"].data_ptr(): i
                for i, s in enumerate(m._ring.slots)}
        assert len(ptrs) == 4
        got = {(ptrs[k[10][0]], k[11]) for k in keys}
        assert got == {(b % 4, int(t)) for b, t in enumerate(tiers)}
        assert 4 < len(keys) < 12
        assert sum(c.replays for c in m._acc_programs.captured.values()) \
            == replays
    for a, b in zip(out[False], out[True]):
        assert np.array_equal(a, b)
    assert out[True][2] > 700
