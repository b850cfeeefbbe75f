"""The port's multi-host layer (gnumap_tpu_torch/dist/multihost.py and the
CLI's --num-hosts, --host-id, --coordinator, -c, --index-shards) without a
cluster: two real torch.distributed CPU processes on localhost (gloo),
mirroring tests/test_multihost.py.  Every merged output is held byte for
byte (SAM body, SGR, SGREX) to the port's single-process run of the same
command; allreduce_f64 is held bit for bit to numpy's host-ordered
reduction."""

import contextlib
import io
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from gnumap_tpu.utils import sim
from gnumap_tpu_torch.cli import main as tcli

from torch_dist_worker import f64_arrays, run_world

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_cli(argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.Popen(
        [sys.executable, "-m", "gnumap_tpu_torch.cli.main", "--device",
         "cpu"] + argv, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _run_hosts(out, common, extra=(), n=2, timeout=300):
    """The CLI on n ranks of one world; [(returncode, stderr), ...].  Every
    rank is killed at the deadline, so a lost rank fails the test."""
    coord = f"localhost:{_free_port()}"
    procs = [_run_cli(["-o", str(out), "--num-hosts", str(n), "--host-id",
                       str(h), "--coordinator", coord, *common, *extra])
             for h in range(n)]
    res = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            res.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return res


def _single(out, common):
    with contextlib.redirect_stdout(io.StringIO()):
        assert tcli.main(["-o", str(out), "--device", "cpu", *common]) == 0


def _body(p):
    with open(p) as f:
        return [line for line in f if not line.startswith("@PG")]


def _assert_same(tmp_path, a, b, sgrex=True):
    assert _body(tmp_path / f"{a}.sam") == _body(tmp_path / f"{b}.sam")
    exts = ("sgr", "sgrex") if sgrex else ("sgr",)
    for ext in exts:
        assert (tmp_path / f"{a}.{ext}").read_bytes() == \
            (tmp_path / f"{b}.{ext}").read_bytes()
    # shard temporaries are cleaned up by the merge
    assert not list(tmp_path.glob(f"{b}.sam.host*"))


def _one_contig(tmp_path, n_reads, seed_g, seed_r, **kw):
    g = sim.random_genome(9000, seed=seed_g, repeat_frac=0.03)
    sim.write_fasta(str(tmp_path / "g.fa"), [("chrM", g)])
    reads = sim.simulate_reads(g, n_reads, 40, seed=seed_r, contig="chrM",
                               **kw)
    sim.write_fastq(str(tmp_path / "r.fq"), reads)
    return ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
            "-m", "9", "-j", "4", "-L", "44", "-B", "16", "--snp"]


def _two_contigs(tmp_path):
    """Two contigs of 6,000 bases and 48 reads from each (cA's with
    indels); the reads, written to r.fq beside the genome g.fa."""
    g = sim.random_genome(12_000, seed=91, repeat_frac=0.04)
    sim.write_fasta(str(tmp_path / "g.fa"),
                    [("cA", g[:6000]), ("cB", g[6000:])])
    reads = (sim.simulate_reads(g[:6000], 48, 40, seed=92, contig="cA",
                                indel_rate=0.05)
             + sim.simulate_reads(g[6000:], 48, 40, seed=93, contig="cB"))
    sim.write_fastq(str(tmp_path / "r.fq"), reads)
    return reads


def test_two_process_matches_single(tmp_path):
    """tests/test_multihost.py:39: --num-hosts 2, each host mapping its
    byte range of the FASTQ; 96 reads / B16 = 6 global batches."""
    common = _one_contig(tmp_path, 96, 71, 72, indel_rate=0.05)
    _single(tmp_path / "single", common)
    for rc, err in _run_hosts(tmp_path / "multi", common):
        assert rc == 0, err[-2000:]
    _assert_same(tmp_path, "single", "multi")


def test_two_process_segmented_matches_single(tmp_path):
    """tests/test_multihost.py:78: the genome-partitioned mode: host h owns
    segment h, reads broadcast, per-read posterior denominators and SAM
    primacy reduce across hosts; the record-level SAM merge and the
    coverage / SNP tracks equal the single-process segmented run."""
    _two_contigs(tmp_path)
    common = ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
              "-m", "9", "-j", "4", "-L", "44", "-B", "16", "--snp",
              "--segments", "2"]
    _single(tmp_path / "single", common)
    for rc, err in _run_hosts(tmp_path / "multi", common):
        assert rc == 0, err[-2000:]
    _assert_same(tmp_path, "single", "multi")
    assert (tmp_path / "single.sgr").read_text().strip()


def test_two_process_segmented_index_complete_after_each_batch(tmp_path):
    """ROADMAP C.3: in the genome-partitioned mode each host appends a
    batch's per-record index rows as the batch completes, also without
    --checkpoint, and holds no rows for the run.  Both hosts are killed
    after 4 of their 6 batches (fault injection): each host's index has a
    row for every line of its shard, and merging the partial shards gives
    exactly the single-process run's records of the first 64 reads."""
    from gnumap_tpu_torch.dist import multihost as tmh
    reads = _two_contigs(tmp_path)
    common = ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
              "-m", "9", "-j", "4", "-L", "44", "-B", "16",
              "--segments", "2"]
    _single(tmp_path / "single", common)
    out = str(tmp_path / "multi")
    rcs = _run_hosts(out, common, ["--fail-after", "4"])
    assert all(rc == 3 for rc, _ in rcs), [rc for rc, _ in rcs]
    for h in (0, 1):
        body, idx = tmh.shard_paths(out, h)
        with open(body) as f, open(idx) as fi:
            n_lines, n_rows = len(f.readlines()), len(fi.readlines())
        assert n_lines == n_rows > 0, (h, n_lines, n_rows)
    tmh.merge_sam_shards_gp(out, 2, "")
    first = {r.name for r in reads[:64]}
    want = [ln for ln in _body(tmp_path / "single.sam")
            if not ln.startswith("@") and ln.split("\t")[0] in first]
    assert _body(out + ".sam") == want and want


def test_two_process_segmented_checkpoint_restart(tmp_path):
    """The genome-partitioned mode killed after 3 of its 6 batches with a
    checkpoint every batch, then resumed: a resumed host keeps the index
    rows of its checkpointed batches only (rewritten line by line), and
    the merged outputs equal the single-process run."""
    _two_contigs(tmp_path)
    common = ["-g", str(tmp_path / "g.fa"), str(tmp_path / "r.fq"),
              "-m", "9", "-j", "4", "-L", "44", "-B", "16", "--snp",
              "--segments", "2"]
    _single(tmp_path / "single", common)
    ck = ["--checkpoint", str(tmp_path / "ck.npz"), "--checkpoint-every",
          "1"]
    rcs = _run_hosts(tmp_path / "out", common, [*ck, "--fail-after", "3"])
    assert all(rc == 3 for rc, _ in rcs), [rc for rc, _ in rcs]
    for rc, err in _run_hosts(tmp_path / "out", common, ck):
        assert rc == 0, err[-2000:]
    _assert_same(tmp_path, "single", "out")


def test_two_process_checkpoint_restart(tmp_path):
    """tests/test_multihost.py:127: both hosts crash after 3 of their 4
    batches (fault injection), then resume from their per-host checkpoints
    (.h0, .h1): the merged outputs equal the single-process run.  A
    checkpoint is written in the background and the next one waits for it,
    so after 3 batches each host has at least batch 1's on disk (the JAX
    test crashes after 2, when a host may have none yet)."""
    common = _one_contig(tmp_path, 128, 81, 82)
    _single(tmp_path / "single", common)
    ck = str(tmp_path / "ck.npz")
    rcs = _run_hosts(tmp_path / "out", common,
                     ["--checkpoint", ck, "--checkpoint-every", "1",
                      "--fail-after", "3"])
    assert all(rc != 0 for rc, _ in rcs), rcs
    assert (tmp_path / "ck.npz.h0").exists() and \
        (tmp_path / "ck.npz.h1").exists()
    for rc, err in _run_hosts(tmp_path / "out", common,
                              ["--checkpoint", ck, "--checkpoint-every",
                               "1"]):
        assert rc == 0, err[-2000:]
    _assert_same(tmp_path, "single", "out")


@pytest.mark.parametrize("flags", [["-c", "2"], ["--index-shards", "2"]])
def test_two_process_mesh_matches_single(flags, tmp_path):
    """-c 2 --num-hosts 2 (a 2 x 1 mesh) and --index-shards 2 --num-hosts 2
    (1 x 2): every rank maps every batch through DistMapper, host 0 writes
    the outputs, equal to the single-process run."""
    common = _one_contig(tmp_path, 96, 61, 62, indel_rate=0.05)
    _single(tmp_path / "single", common)
    res = _run_hosts(tmp_path / "mesh", common, flags)
    for rc, err in res:
        assert rc == 0, err[-2000:]
    _assert_same(tmp_path, "single", "mesh")


@pytest.fixture(scope="module")
def f64_world(tmp_path_factory):
    """allreduce_f64 in a gloo world of 3 ranks: (arrays, chunk, op) ->
    every rank's result."""
    arrays = f64_arrays(3, 50, 11)
    cases = [(7, "sum"), (7, "min"), (8 << 20, "sum"), (50, "sum")]
    res = run_world(3, [("f64", dict(arrays=arrays, chunk_elems=c, op=op))
                        for c, op in cases],
                    tmp_path_factory.mktemp("f64"))
    return arrays, {case: [r[i] for r in res]
                    for i, case in enumerate(cases)}


@pytest.mark.parametrize("chunk,op", [(7, "sum"), (7, "min"),
                                      (8 << 20, "sum"), (50, "sum")])
def test_allreduce_f64_bits(f64_world, chunk, op):
    """Every rank gets the same bits as numpy's host-ordered reduction
    (host 0, then 1, then 2), whatever the chunk: 7 splits 50 elements
    unevenly.  The values are chosen so that another order gives other
    bits."""
    arrays, res = f64_world
    want = arrays[0].copy()
    for r in (1, 2):
        if op == "min":
            np.minimum(want, arrays[r], out=want)
        else:
            want += arrays[r]
    for got in res[chunk, op]:
        assert got.dtype == np.float64 and got.shape == (50,)
        assert np.array_equal(got.view(np.int64), want.view(np.int64))
    if op == "sum":
        other = (arrays[2] + arrays[1]) + arrays[0]
        assert not np.array_equal(other, want)


def test_allreduce_f64_single_rank():
    """Without a process group allreduce_f64 returns its input's values."""
    from gnumap_tpu_torch.dist import multihost
    a = f64_arrays(1, 37, 5)[0]
    assert np.array_equal(multihost.allreduce_f64(a, chunk_elems=5), a)
