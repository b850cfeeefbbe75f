"""The PyTorch port imports without jax: its package, its CLI and the chip
smoke script run with jax blocked from import."""

import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SNIPPET = """
import sys
sys.modules["jax"] = None
import gnumap_tpu_torch.pipeline.mapper, gnumap_tpu_torch.cli.main
import gnumap_tpu_torch.pipeline.checkpoint, gnumap_tpu_torch._build
import gnumap_tpu_torch.align.nw_full, gnumap_tpu_torch.posterior.accum
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax."))
assert bad == ["jax"], bad
print("ok")
"""


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _SNIPPET], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "ok"


def test_chip_smoke_refuses_without_card():
    """Without a CUDA card chip_smoke exits non-zero and prints no result."""
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
