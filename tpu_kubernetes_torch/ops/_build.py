"""Build and load the port's CUDA kernels.

Each source under ``tpu_kubernetes_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded
with ``ctypes``. The library lands in ``build/tpu_kubernetes_torch/`` at
the root of the checkout, named by a hash of its source, so the first
call after a source change rebuilds it and later calls (and processes)
reuse it. Nothing here runs at import time: the CPU tests import every
module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_kubernetes_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# every kernel source of the port, by library name (also its C symbol)
SOURCES = {"flash_fwd": CSRC / "flash_fwd.cu"}

_lock = threading.Lock()
_fns: dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(home) / "bin" / "nvcc") if home else None,
                 shutil.which("nvcc"),
                 Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built "
        "from tpu_kubernetes_torch/csrc at first use"
    )


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _compile(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name].name}:\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)    # atomic: a concurrent build sees all or none


def load(name: str, argtypes: list) -> ctypes._CFuncPtr:
    """The C function ``name`` of library ``name``, compiled first if its
    library is missing, bound to ``argtypes`` (returning ``int``) once."""
    fn = _fns.get(name)
    if fn is not None:
        return fn
    with _lock:
        if name not in _fns:
            out = library_path(name)
            if not out.exists():
                _compile(name, out)
            fn = getattr(ctypes.CDLL(str(out)), name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]
