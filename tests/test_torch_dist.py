"""The port's reads x index mesh (gnumap_tpu_torch/dist/mesh.py,
dist/collectives.py) held to the JAX package's on the CPU: each workload of
tests/test_dist.py, on the same mesh shapes.

The JAX DistMapper runs in this process on the 8 fake devices that
tests/conftest.py sets up.  The port's runs in gloo worlds of R * S CPU
processes, one rank per mesh position (tests/torch_dist_worker.py), and
returns the global hits on every rank.  Each rank's hits are held to the
JAX DistMapper on the same mesh shape and to the JAX single-device mapper:
strand, pos, score, cigar and ref_len equal, weights within 1e-12
(tests/test_dist.py:56)."""

import numpy as np
import pytest
import torch

from gnumap_tpu.config import MapperConfig
from gnumap_tpu.dist import collectives, mesh as mesh_mod
from gnumap_tpu.index import builder
from gnumap_tpu.io import fastq as io_fastq
from gnumap_tpu.pipeline import mapper as pl
from gnumap_tpu.utils import sim

from conftest import records_from_sim
from test_torch_bridge import to_port
from torch_dist_worker import run_world

torch.set_num_threads(1)

NORMAL = ((2, 1), (1, 2), (2, 2), (4, 2))
INDEL = ((2, 1), (1, 2))
BISULFITE = ((2, 2), (1, 2))
FINISHES = ("device", "host")


def _normal():
    """tests/test_dist.py:26: the phiX-sized genome with 5% repeats."""
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=32,
                       max_read_len=40, align_score_ratio=0.8,
                       max_candidates=32)
    genome = sim.random_genome(sim.PHIX_LEN, seed=0, repeat_frac=0.05,
                               repeat_unit=80)
    gen = builder.Genome.from_contigs([("phiX_sim", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=7, sub_rate=0.03,
                               contig="phiX_sim")
    return cfg, gen, idx, reads


def _indel():
    """tests/test_dist.py:61: indel reads for the device finish."""
    cfg = MapperConfig(mer_size=8, seed_jump=4, batch_size=32,
                       max_read_len=40, align_score_ratio=0.7,
                       max_candidates=32)
    genome = sim.random_genome(30_000, seed=5)
    gen = builder.Genome.from_contigs([("dd", genome)])
    idx = builder.build_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=11, sub_rate=0.02,
                               indel_rate=0.3, contig="dd")
    return cfg, gen, idx, reads


def _bisulfite():
    """tests/test_dist.py:91: both collapsed base-3 tables shard by k-mer
    range (odd 3^m bucket counts exercise the ceil-partition routing)."""
    cfg = MapperConfig(mer_size=9, seed_jump=3, batch_size=32,
                       max_read_len=40, align_score_ratio=0.7,
                       max_candidates=64, bisulfite=True)
    genome = sim.random_genome(20_000, seed=3)
    gen = builder.Genome.from_contigs([("bsd", genome)])
    idx = builder.build_bs_index(gen, cfg)
    reads = sim.simulate_reads(genome, 32, 36, seed=9, sub_rate=0.01,
                               contig="bsd", bisulfite=True)
    return cfg, gen, idx, reads


def _workload(make):
    cfg, gen, idx, reads = make()
    batch = next(io_fastq.batch_reads(
        iter(records_from_sim(reads, cfg)), cfg))
    return cfg, gen, idx, batch


def _hits(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits] for hits in out]


def _task(work, R, S, finish):
    cfg, gen, idx, batch = work
    tcfg, tgen, tidx, tbatch = to_port((cfg, gen, idx, batch))
    return ("dist", dict(R=R, S=S, genome=tgen, index=tidx, cfg=tcfg,
                         batch=tbatch, finish_impl=finish))


@pytest.fixture(scope="module")
def works():
    return dict(normal=_workload(_normal), indel=_workload(_indel),
                bisulfite=_workload(_bisulfite))


def _plan(works, world):
    """The tasks of one world, keyed by (workload, R, S, finish)."""
    keys = [("normal", R, S, f) for R, S in NORMAL for f in FINISHES]
    keys += [("indel", R, S, "device") for R, S in INDEL]
    keys += [("bisulfite", R, S, "device") for R, S in BISULFITE]
    keys = [k for k in keys if k[1] * k[2] == world]
    return keys, [_task(works[k[0]], *k[1:]) for k in keys]


@pytest.fixture(scope="module")
def world2(works, tmp_path_factory):
    keys, tasks = _plan(works, 2)
    res = run_world(2, tasks, tmp_path_factory.mktemp("world2"))
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def world4(works, tmp_path_factory):
    keys, tasks = _plan(works, 4)
    res = run_world(4, tasks, tmp_path_factory.mktemp("world4"))
    return {k: [r[i] for r in res] for i, k in enumerate(keys)}


@pytest.fixture(scope="module")
def world8(works, tmp_path_factory):
    """(4, 2) both finishes, then allreduce_coverage on (4, 2) and
    make_mesh's shapes and refusals, in one world of 8 ranks."""
    keys, tasks = _plan(works, 8)
    stack = np.random.default_rng(0).random((8, 1000))
    res = run_world(8, tasks + [("coverage", dict(R=4, S=2, stack=stack)),
                                ("mesh", {})],
                    tmp_path_factory.mktemp("world8"))
    out = {k: [r[i] for r in res] for i, k in enumerate(keys)}
    out["coverage"] = (stack, [r[len(keys)] for r in res])
    out["mesh"] = [r[len(keys) + 1] for r in res]
    return out


@pytest.fixture(scope="module")
def jax_ref(works):
    """The JAX references, each computed once: ``jax_ref(name)`` the
    single-device mapper's hits, ``jax_ref(name, R, S)`` the JAX
    DistMapper's on that mesh shape (the indel workload with the device
    finish, as tests/test_dist.py:57 runs it)."""
    memo = {}

    def get(name, R=None, S=None):
        if (name, R, S) not in memo:
            cfg, gen, idx, batch = works[name]
            kw = (dict(align_impl="pallas", finish_impl="device")
                  if name == "indel" else {})
            if R is None:
                m = pl.TpuMapper(gen, idx, cfg, **kw)
            else:
                m = collectives.DistMapper(gen, idx, cfg,
                                           mesh_mod.make_mesh(R, S), **kw)
            memo[name, R, S] = _hits(m.map_batch(batch))
        return memo[name, R, S]
    return get


def _port_run(request, key):
    world = request.getfixturevalue(f"world{key[1] * key[2]}")
    return world[key]


def _assert_equal(got, ref):
    assert len(got) == len(ref)
    for g_hits, r_hits in zip(got, ref):
        assert len(g_hits) == len(r_hits)
        for g, r in zip(g_hits, r_hits):
            assert g[:5] == r[:5]
            assert abs(g[5] - r[5]) < 1e-12


def _check_ranks(runs, R, S, refs, n_mapped=None):
    """Every rank of the world returns the same global hits, equal to each
    reference; rank r * S + s sits at mesh position (r, s)."""
    assert [run["coords"] for run in runs] == [
        (r, s) for r in range(R) for s in range(S)]
    for run in runs:
        for ref in refs:
            _assert_equal(run["hits"], ref)
        if n_mapped is not None:
            assert run["n_mapped"] == n_mapped


@pytest.mark.parametrize("finish", FINISHES)
@pytest.mark.parametrize("R,S", NORMAL)
def test_dist_matches_single_device(jax_ref, request, R, S, finish):
    """tests/test_dist.py:42: the port's DistMapper, with the device or the
    host finish, equals the JAX DistMapper on the same mesh shape and the
    JAX single-device mapper."""
    single, jdist = jax_ref("normal"), jax_ref("normal", R, S)
    runs = _port_run(request, ("normal", R, S, finish))
    _check_ranks(runs, R, S, [jdist, single],
                 n_mapped=sum(1 for h in single if h))


@pytest.mark.parametrize("R,S", INDEL)
def test_dist_device_finish_matches_single(jax_ref, request, R, S):
    """tests/test_dist.py:57: the device finish per reads block (retention,
    traceback, blob, gathered and decoded block by block) on indel reads
    equals the JAX device finish, sharded and single-device."""
    single, jdist = jax_ref("indel"), jax_ref("indel", R, S)
    assert any("D" in h[3] or "I" in h[3] for hl in single for h in hl)
    runs = _port_run(request, ("indel", R, S, "device"))
    _check_ranks(runs, R, S, [jdist, single],
                 n_mapped=sum(1 for h in single if h))


@pytest.mark.parametrize("R,S", BISULFITE)
def test_dist_bisulfite_matches_single_device(jax_ref, request, R, S):
    """tests/test_dist.py:89: bisulfite on both collapsed base-3 tables,
    each sharded by k-mer range."""
    single, jdist = jax_ref("bisulfite"), jax_ref("bisulfite", R, S)
    assert sum(1 for h in single if h) >= 28
    runs = _port_run(request, ("bisulfite", R, S, "device"))
    _check_ranks(runs, R, S, [jdist, single])


def test_allreduce_coverage(world8):
    """tests/test_dist.py:119: each rank's row summed over both axes."""
    stack, outs = world8["coverage"]
    for out in outs:
        np.testing.assert_allclose(out, stack.sum(axis=0), rtol=1e-6)


def test_mesh_shapes(world8):
    """tests/test_dist.py:127: make_mesh over a world of 8 ranks refuses
    what the JAX make_mesh refuses, with its messages, and a mesh smaller
    than the world (a rank owns one device); read_shards None takes the
    world / index_shards."""
    for rank, m in enumerate(world8["mesh"]):
        assert m["errors"] == [
            "need 21 devices, have 8",
            "8 devices not divisible by index_shards=3",
            "a 2 x 2 mesh takes 4 ranks, one device each; the world has 8"]
        assert m["shape"] == {"reads": 4, "index": 2}
        assert m["coords"] == (rank // 2, rank % 2)
        assert m["device"] == "cpu"
        r = rank // 2
        assert m["batch_range"] == (3 * r, 3 * r + 3)


def test_dist_mapper_refusals(works):
    """The JAX DistMapper's refusals, in a world of one (no process group):
    a bisulfite config without the collapsed pair, max_candidates not a
    multiple of 8 * index_shards, the FM index; a batch that does not
    divide by the read shards."""
    from gnumap_tpu.index import fm as jfm
    from gnumap_tpu_torch.dist import collectives as tcol, mesh as tmesh
    cfg, gen, idx, batch = to_port(works["normal"])
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == {"reads": 1, "index": 1}
    import dataclasses
    with pytest.raises(ValueError, match="collapsed pair"):
        tcol.DistMapper(gen, idx, dataclasses.replace(cfg, bisulfite=True),
                        mesh)
    with pytest.raises(ValueError, match="8\\*index_shards"):
        tcol.DistMapper(gen, idx, dataclasses.replace(cfg, max_candidates=
                                                      36), mesh)
    jcfg, jgen = works["normal"][:2]
    with pytest.raises(ValueError, match="single-device"):
        tcol.DistMapper(gen, to_port(jfm.build_fm_index(jgen, jcfg)), cfg,
                        mesh)
    two = dataclasses.replace(mesh, shape={"reads": 3, "index": 1})
    with pytest.raises(ValueError, match="divide by read shards 3"):
        tcol.DistMapper(gen, idx, cfg, two).map_batch(batch)
    # a world of one maps like TorchMapper, with no collective
    from gnumap_tpu_torch.pipeline import mapper as tm
    got = _hits(tcol.DistMapper(gen, idx, cfg, mesh).map_batch(batch))
    assert got == _hits(tm.TorchMapper(gen, idx, cfg,
                                       device="cpu").map_batch(batch))

