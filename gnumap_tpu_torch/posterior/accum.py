"""Ordered span read-modify-write into a device-resident accumulator — the
counterpart of gnumap_tpu/posterior/accum_pallas.py::apply_deltas, the last
step of device accumulation (pipeline/mapper.py device_accumulate).

``apply_deltas`` and ``apply_deltas_pair`` are the wrappers of the
hand-written CUDA kernel csrc/accum_rmw.cu (which replaces the Pallas
``_rmw_kernel``): one accumulator a launch, or the coverage and the tallies
of one batch in a single launch.  For CPU tensors they run the plain
version, ``apply_deltas_plain`` (for the pair: twice, coverage first), the
serial definition.  For CUDA tensors they launch the kernel or raise.  All
update their accumulators in place (the accumulator is the only copy; the
JAX call donates its buffer for the same reason) and return them, with the
same f32 bits: every element receives its deltas one by one in ascending h.

Layouts are the JAX call's, 128 lanes wide, so that flat memory order is
position order:
  coverage  arr f32[Gpad / 128, 128], position p at flat p;
            deltas f32[H, span / 128, 128]; rowmul 1
  tallies   arr f32[Gpad * 4 / 128, 128], (position p, base b) at flat
            4p + b; deltas f32[H, span / 32, 128]; rowmul 4
where rows [rowmul * base_units[h], + nrows) receive delta h.
"""

from __future__ import annotations

import ctypes

import torch

from gnumap_tpu_torch.align.nw_band import check_tensor

# Kernel launches by apply_deltas (the plain version does not count).
LAUNCHES = 0


def apply_deltas_plain(arr, base_units, deltas, n_real, *, rowmul: int):
    """For h < n_real in order: arr[rowmul u(h) : + nrows] += deltas[h]."""
    nrows = deltas.shape[1]
    n = min(int(n_real), base_units.shape[0])
    for h, u in enumerate(base_units[:n].tolist()):
        arr[rowmul * u:rowmul * u + nrows] += deltas[h]
    return arr


# The kernel's order flag, one per (device, stream): [int32[2] zeroed once,
# launches made with it].  A launch uses slot (launches & 1) and clears the
# other one (csrc/accum_rmw.cu), so the wrapper never zeroes it again.  A
# launch captured into a CUDA graph (pipeline/graphs.py AccPrograms) would
# freeze its slot, so it takes a flag of its own, zeroed inside the graph
# before the launch on every replay, and leaves the stream's untouched.
_flags: dict = {}


def _launch(jobs, base_units, n_real):
    """One launch of the kernel for 1 or 2 jobs (arr, deltas, rowmul) that
    share base_units and n_real."""
    dev = base_units.device
    H = base_units.shape[0]
    check_tensor("base_units", base_units, torch.int32, (H,), dev)
    check_tensor("n_real", n_real.reshape(1), torch.int32, (1,), dev)
    for arr, deltas, _ in jobs:
        check_tensor("arr", arr, torch.float32, (arr.shape[0], 128), dev)
        check_tensor("deltas", deltas, torch.float32,
                     (H, deltas.shape[1], 128), dev)
    if H == 0:
        return
    from gnumap_tpu_torch import _build
    fn = _build.load("accum_rmw").accum_rmw_launch
    fn.restype = ctypes.c_int
    job_types = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                 ctypes.c_int, ctypes.c_int]
    fn.argtypes = ([ctypes.c_int] + job_types * 2 + [ctypes.c_void_p] * 2
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    job_args = []
    for arr, deltas, rowmul in (jobs + jobs)[:2]:
        job_args += [arr.data_ptr(), arr.shape[0], deltas.data_ptr(),
                     deltas.shape[1], rowmul]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if torch.cuda.is_current_stream_capturing():
            state = [torch.zeros(2, dtype=torch.int32, device=dev), 0]
        else:
            state = _flags.get((dev.index, stream))
            if state is None:
                state = _flags[(dev.index, stream)] = [
                    torch.zeros(2, dtype=torch.int32, device=dev), 0]
        rc = fn(len(jobs), *job_args, base_units.data_ptr(),
                n_real.data_ptr(), H, state[0].data_ptr(), state[1] & 1,
                stream)
        if rc == 0:     # a refused launch cleared nothing: keep the slot
            state[1] += 1
    if rc != 0:
        raise RuntimeError(f"accum_rmw kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1


def _device_kind(arr, name):
    if arr.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {arr.device} "
                         "(cpu runs the plain version, cuda the kernel)")
    return arr.device.type


def apply_deltas(arr: torch.Tensor, base_units: torch.Tensor,
                 deltas: torch.Tensor, n_real: torch.Tensor, *,
                 rowmul: int) -> torch.Tensor:
    """arr rows [rowmul u(h), + nrows) += deltas[h] for h in [0, n_real),
    serially in h, in place.

    arr        f32[R, 128]          accumulator (updated and returned)
    base_units int32[H]             128-position span starts; any order
                                    (non-decreasing is the fast path)
    deltas     f32[H, nrows, 128]   per-hit delta windows
    n_real     int32[1] or []       number of real hits, a device tensor
    """
    if _device_kind(arr, "apply_deltas") == "cpu":
        return apply_deltas_plain(arr, base_units, deltas, n_real,
                                  rowmul=rowmul)
    _launch([(arr, deltas, rowmul)], base_units, n_real)
    return arr


def apply_deltas_pair_plain(cov, tal, base_units, cov_deltas, tal_deltas,
                            n_real):
    """The two plain calls, coverage (rowmul 1) first, then tallies
    (rowmul 4)."""
    apply_deltas_plain(cov, base_units, cov_deltas, n_real, rowmul=1)
    apply_deltas_plain(tal, base_units, tal_deltas, n_real, rowmul=4)
    return cov, tal


def apply_deltas_pair(cov: torch.Tensor, tal: torch.Tensor,
                      base_units: torch.Tensor, cov_deltas: torch.Tensor,
                      tal_deltas: torch.Tensor, n_real: torch.Tensor):
    """apply_deltas on the coverage (rowmul 1) and the tallies (rowmul 4) of
    one batch, which share base_units and n_real, in one kernel launch: the
    same bits as the two calls, in place; returns (cov, tal)."""
    if _device_kind(cov, "apply_deltas_pair") == "cpu":
        return apply_deltas_pair_plain(cov, tal, base_units, cov_deltas,
                                       tal_deltas, n_real)
    _launch([(cov, cov_deltas, 1), (tal, tal_deltas, 4)], base_units, n_real)
    return cov, tal
