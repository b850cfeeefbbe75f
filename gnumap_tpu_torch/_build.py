"""Loader of the package's native code, built into ``_build/`` at first use.

Kernels: ``csrc/<name>.cu`` -> ``_build/lib<name>.so`` -> ctypes.  Each source
has a plain C interface (pointers and the CUDA stream passed as ``void*``),
so ``nvcc`` compiles it in seconds without PyTorch's headers.  A library is
built on first use and rebuilt when a source in ``csrc/`` is newer than it;
nothing is built at import time.  A missing ``nvcc`` or a failed build
raises: there is no fallback.

Host library: ``native/*.cpp`` -> ``_build/libgnumap_host.so`` with the host
C++ compiler (``build_host``).  It is host code with a Python fallback in
``native/lib.py``, so a missing compiler returns None there, not an error.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_DIR, "csrc")
NATIVE = os.path.join(_DIR, "native")
BUILD_DIR = os.path.join(_DIR, "_build")
HOST_SO = os.path.join(BUILD_DIR, "libgnumap_host.so")
# -ffp-contract=off: the float64 scatters must round as the NumPy paths do
CXX_FLAGS = ("-O3", "-march=native", "-ffp-contract=off", "-fPIC", "-shared",
             "-std=c++17", "-Wall")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, spills, shared memory) of each build, by name
BUILD_LOG: Dict[str, str] = {}


def nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        cand = os.path.join(home, "bin", "nvcc")
        path = cand if os.path.exists(cand) else None
    if path is None:
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the "
                           "CUDA kernels of gnumap_tpu_torch cannot be built")
    return path


def _paths(name: str):
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    if not os.path.exists(so):
        return True
    deps = [src] + [os.path.join(CSRC, f) for f in os.listdir(CSRC)
                    if f.endswith(".cuh")]
    return max(os.path.getmtime(d) for d in deps) > os.path.getmtime(so)


def build(names: Iterable[str]) -> None:
    """Compile every stale library in ``names``, one ``nvcc`` per source,
    all started together.  Raises with the compiler's output on failure."""
    todo = [n for n in names if _stale(n)]
    if not todo:
        return
    exe = nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        src, so = _paths(name)
        tmp = f"{so}.{os.getpid()}.tmp"
        procs.append((name, so, tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    errors = []
    for name, so, tmp, p in procs:
        out, _ = p.communicate()
        BUILD_LOG[name] = out
        if p.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu "
                          f"(rc {p.returncode}):\n{out}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def _host_sources() -> list:
    return sorted(os.path.join(NATIVE, f) for f in os.listdir(NATIVE)
                  if f.endswith(".cpp"))


def build_host():
    """Path of the host library, compiled from ``native/*.cpp`` when it is
    missing or older than a source; None without a C++ compiler or when the
    build fails (``BUILD_LOG["gnumap_host"]`` keeps the compiler's output)."""
    srcs = _host_sources()
    if (os.path.exists(HOST_SO) and os.path.getmtime(HOST_SO)
            >= max(os.path.getmtime(s) for s in srcs)):
        return HOST_SO
    exe = (shutil.which(os.environ.get("CXX", "g++")) or shutil.which("c++"))
    if exe is None:
        BUILD_LOG["gnumap_host"] = "no C++ compiler ($CXX, g++, c++)"
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{HOST_SO}.{os.getpid()}.tmp"
    try:
        r = subprocess.run([exe, *CXX_FLAGS, "-o", tmp, *srcs, "-lpthread"],
                           capture_output=True, text=True, timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        BUILD_LOG["gnumap_host"] = repr(e)
        return None
    BUILD_LOG["gnumap_host"] = r.stdout + r.stderr
    if r.returncode != 0:
        return None
    os.replace(tmp, HOST_SO)
    return HOST_SO


def sources() -> list:
    """Names of every kernel source in ``csrc/``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))
