"""Ordered span read-modify-write into a device-resident accumulator — the
counterpart of gnumap_tpu/posterior/accum_pallas.py::apply_deltas, the last
step of device accumulation (pipeline/mapper.py device_accumulate).

``apply_deltas`` is the wrapper of the hand-written CUDA kernel
csrc/accum_rmw.cu (which replaces the Pallas ``_rmw_kernel``).  For CPU
tensors it runs the plain version, ``apply_deltas_plain``, the serial
definition.  For CUDA tensors it launches the kernel or raises.  Both
update ``arr`` in place (the accumulator is the only copy; the JAX call
donates its buffer for the same reason) and return it, with the same f32
bits: every element receives its deltas one by one in ascending h.

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
    if arr.device.type == "cpu":
        return apply_deltas_plain(arr, base_units, deltas, n_real,
                                  rowmul=rowmul)
    if arr.device.type != "cuda":
        raise ValueError(f"apply_deltas: unsupported device {arr.device} "
                         "(cpu runs the plain version, cuda the kernel)")
    dev = arr.device
    H, nrows = base_units.shape[0], deltas.shape[1]
    check_tensor("arr", arr, torch.float32, (arr.shape[0], 128), dev)
    check_tensor("base_units", base_units, torch.int32, (H,), dev)
    check_tensor("deltas", deltas, torch.float32, (H, nrows, 128), dev)
    check_tensor("n_real", n_real.reshape(1), torch.int32, (1,), dev)
    if H == 0:
        return arr
    from gnumap_tpu_torch import _build
    fn = _build.load("accum_rmw").accum_rmw_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    unordered = torch.zeros(1, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(arr.data_ptr(), arr.shape[0], base_units.data_ptr(),
                deltas.data_ptr(), n_real.data_ptr(), H, nrows, rowmul,
                unordered.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"accum_rmw kernel launch failed (code {rc})")
    global LAUNCHES
    LAUNCHES += 1
    return arr
