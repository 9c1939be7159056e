"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled on first use by ``nvcc`` for Hopper
(``-gencode arch=compute_90a,code=sm_90a``) into a shared library with a
plain C interface under ``build/pnp_svrg_tpu_torch/`` at the repository root,
named by a hash of the source and the flags, and loaded with ``ctypes``. The
sources include no PyTorch header, so a build takes seconds. Pointers and the
stream are passed as ``c_void_p`` and every entry point returns the launch's
``cudaError_t``, which :func:`check` turns into an exception.

Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "pnp_svrg_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("bm3d_match", "bm3d_aggregate", "nlm")

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}  # source name -> nvcc/ptxas output of its build


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names=SOURCES) -> dict[str, Path]:
    """Compile every named source that has no current library, one ``nvcc``
    per source, all started together. Returns name -> library path."""
    paths = {n: library_path(n) for n in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(SRC_DIR / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (nvcc exit {proc.returncode}):\n{log}")
            os.unlink(tmp)
        else:
            os.replace(tmp, paths[n])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
