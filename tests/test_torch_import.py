"""The PyTorch port stands alone: every module of its package, its CLI, the
chip smoke script, its scale tools (tools/torch_scale_run.py,
tools/torch_scale3g.py) and its host-memory probe (tools/torch_host_mem.py)
import with jax and the JAX package (gnumap_tpu) both blocked from import,
and none of their sources names either."""

import glob
import os
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SNIPPET = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["gnumap_tpu"] = None
import gnumap_tpu_torch
names = [m.name for m in pkgutil.walk_packages(gnumap_tpu_torch.__path__,
                                               "gnumap_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
import tools.torch_scale_run, tools.torch_scale3g, tools.torch_host_mem
for want in ("config", "core.packing", "core.pwm", "align.scoring",
             "native.lib", "index.builder", "index.store", "io.fastq",
             "io.sam", "io.sgr", "oracle.oracle", "posterior.snp",
             "utils.sim", "pipeline.mapper", "cli.main", "index.fm",
             "dist.segments", "dist.mesh", "dist.collectives",
             "dist.multihost", "utils.profiling", "pipeline.staging",
             "pipeline.graphs"):
    assert "gnumap_tpu_torch." + want in names, want
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "gnumap_tpu", "bench"))
assert bad == ["gnumap_tpu", "jax"], bad
print("ok", len(names))
"""


def test_port_imports_without_jax():
    r = subprocess.run([sys.executable, "-c", _SNIPPET], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split()[0] == "ok" and int(r.stdout.split()[1]) >= 30


def test_port_sources_name_no_jax_package():
    """No source of the port, of chip_smoke.py or of the port's scale and
    host-memory tools imports gnumap_tpu, jax or the JAX package's
    bench.py."""
    files = glob.glob(os.path.join(ROOT, "gnumap_tpu_torch", "**", "*.py"),
                      recursive=True) + [
        os.path.join(ROOT, p) for p in ("chip_smoke.py",
                                        "tools/torch_scale_run.py",
                                        "tools/torch_scale3g.py",
                                        "tools/torch_host_mem.py")]
    assert len(files) > 30
    pat = re.compile(r"^\s*(?:import|from)\s+(?:gnumap_tpu|jax|jaxlib|bench)"
                     r"(?:[.\s]|$)", re.M)
    bad = {}
    for path in files:
        with open(path) as f:
            hits = pat.findall(f.read())
        if hits:
            bad[os.path.relpath(path, ROOT)] = hits
    assert not bad, bad


_CLI = """
import sys
sys.modules["jax"] = None
sys.modules["gnumap_tpu"] = None
from gnumap_tpu_torch.cli.main import main
sys.exit(main(sys.argv[1:]))
"""


def test_cli_reproduces_golden_outputs_without_the_jax_package(tmp_path):
    """python -m gnumap_tpu_torch.cli.main --device cpu, in a process where
    neither jax nor gnumap_tpu can be imported, writes the golden phiX SAM
    body and SGR / SGREX files byte for byte."""
    import hashlib
    golden_dir = os.path.join(ROOT, "tests", "golden")
    r = subprocess.run(
        [sys.executable, "-c", _CLI,
         "-g", os.path.join(ROOT, "testdata", "phix_sim.fa"),
         "-o", str(tmp_path / "phix"), "-m", "8", "-j", "4", "-B", "128",
         "-L", "40", "--snp", "--device", "cpu",
         os.path.join(ROOT, "testdata", "phix_sim_200.fastq")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    golden = {}
    with open(os.path.join(golden_dir, "SHA256SUMS")) as f:
        for line in f:
            h, p = line.split()
            golden[os.path.basename(p)] = h

    def body(path):
        with open(path) as f:
            return "".join(x for x in f if not x.startswith("@PG"))

    assert body(tmp_path / "phix.sam") == body(os.path.join(golden_dir,
                                                            "phix.sam"))
    for ext in ("sgr", "sgrex"):
        with open(tmp_path / f"phix.{ext}", "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == \
                golden[f"phix.{ext}"]


def test_chip_smoke_refuses_without_card():
    """Without a CUDA card chip_smoke exits non-zero and prints no result."""
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
