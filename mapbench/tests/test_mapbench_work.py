"""The benchmark's B1 work formula equals chip_smoke.kernel_bound's on fixed
inputs."""

import sys

import numpy as np
import pytest
import torch

from mapbench import cell as cells, peaks

sys.path.insert(0, cells.ROOT)
import chip_smoke  # noqa: E402


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_b1_formula_equals_kernel_bound(seed):
    rng = np.random.default_rng(seed)
    B2, C, L, W, bw = 64, 32, 104, 128, 42
    SENT = 2 ** 31 - 1
    cands = rng.integers(0, 10 ** 6, (B2, C)).astype(np.int64)
    cands[rng.random((B2, C)) < 0.7] = SENT
    cands[:5] = SENT
    lens = np.full(B2, 100, np.int64)
    a = (None, torch.from_numpy(cands), torch.from_numpy(lens), None)
    want = chip_smoke.kernel_bound("nw_band", a, dict(L=L, W=W, bw=bw))
    live = cands != SENT
    n, rows = int(live.sum()), int(live.any(1).sum())
    work = cells.work_module("nw_band")
    ops, nbytes = work.needs_of(n, rows, n * 100, B2, C, L, W, bw)
    assert (ops, nbytes) == (want["ops"], want["bytes"])
    assert (chip_smoke.INT32_OPS, chip_smoke.HBM_BYTES) == (
        peaks.INT32_OPS, peaks.HBM_BYTES)
    # the stream's form takes rows at their fewest: never a larger bound
    lo_ops, lo_bytes = work.needs_of(n, -(-n // C), n * 100, B2, C, L, W,
                                     bw)
    assert lo_ops == ops and lo_bytes <= nbytes
