"""Worlds of processes for the port's distributed tests: gloo on the CPU,
and on a card gloo (ranks sharing it) or NCCL (a card each).

``run_world(world, tasks, tmp)`` starts ``world`` ranks with
torch.multiprocessing (spawn), joined through a FileStore under ``tmp``;
every rank runs the same task list in order and the results come back per
rank.  A rank imports only the port (never jax or gnumap_tpu), uses one
thread, and the whole world has a deadline: past it every rank is killed
and the test fails, so no test can hang on a lost rank."""

import os
import pickle
import time

import numpy as np
import torch


def _hits(out):
    return [[(h.strand, h.pos, h.score, h.cigar, h.ref_len, h.weight)
             for h in hits] for hits in out]


def _task_dist(R, S, genome, index, cfg, batch, finish_impl, device="cpu"):
    """The port's DistMapper on an R x S mesh of this world: global hits
    (on every rank) and the batch stats."""
    from gnumap_tpu_torch.dist import collectives, mesh as mesh_mod
    from gnumap_tpu_torch.pipeline import mapper as tm
    mesh = mesh_mod.make_mesh(R, S, device=device)
    dm = collectives.DistMapper(genome, index, cfg, mesh,
                                finish_impl=finish_impl)
    stats = tm.BatchStats()
    out = dm.map_batch(batch, stats)
    return dict(hits=_hits(out), n_mapped=stats.n_mapped,
                n_candidates=stats.n_candidates, coords=mesh.coords)


def _task_coverage(R, S, stack):
    from gnumap_tpu_torch.dist import collectives, mesh as mesh_mod
    mesh = mesh_mod.make_mesh(R, S, device="cpu")
    rank = torch.distributed.get_rank()
    return collectives.allreduce_coverage(stack[rank], mesh)


def _task_mesh_shapes():
    """make_mesh's shapes and refusals in this world."""
    from gnumap_tpu_torch.dist import mesh as mesh_mod
    errors = []
    for args in ((7, 3), (None, 3), (2, 2)):
        try:
            mesh_mod.make_mesh(*args, device="cpu")
        except ValueError as e:
            errors.append(str(e))
    m = mesh_mod.make_mesh(None, 2, device="cpu")
    return dict(errors=errors, shape=dict(m.shape), coords=m.coords,
                device=str(m.device),
                batch_range=m.batch_range(m.shape[mesh_mod.READS_AXIS] * 3))


def _task_f64(arrays, chunk_elems, op):
    """multihost.allreduce_f64 of this rank's array."""
    from gnumap_tpu_torch.dist import multihost
    rank = torch.distributed.get_rank()
    return multihost.allreduce_f64(arrays[rank], chunk_elems=chunk_elems,
                                   op=op)


TASKS = {"dist": _task_dist, "coverage": _task_coverage,
         "mesh": _task_mesh_shapes, "f64": _task_f64}


def _rank_main(rank, world, store_path, job_path, out_dir, backend):
    torch.set_num_threads(1)
    import torch.distributed as dist
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world)
    with open(job_path, "rb") as f:
        tasks = pickle.load(f)
    out = [TASKS[kind](**kw) for kind, kw in tasks]
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


def run_world(world, tasks, tmp, timeout=240.0, backend="gloo"):
    """Run ``tasks`` [(kind, kwargs), ...] on every rank of a world of
    ``world`` processes; returns [rank 0's results, rank 1's, ...]."""
    import torch.multiprocessing as mp
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump(tasks, f)
    store = os.path.join(tmp, "store")
    if os.path.exists(store):
        os.remove(store)
    ctx = mp.start_processes(_rank_main,
                             args=(world, store, job, tmp, backend),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise TimeoutError(f"world of {world} ranks ({backend}) did "
                                   f"not finish within {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def f64_arrays(world, n, seed):
    """Per-rank float64 arrays whose sums depend on the order: magnitudes
    from 1e-12 to 1e16, both signs."""
    rng = np.random.default_rng(seed)
    mags = 10.0 ** rng.integers(-12, 16, size=(world, n))
    return rng.choice([-1.0, 1.0], size=(world, n)) * mags * rng.random(
        (world, n))
