"""Build and load the port's CUDA kernels.

Each source under ``tpu_kubernetes_torch/csrc/`` is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded
with ``ctypes``. The library lands in ``build/tpu_kubernetes_torch/`` at
the root of the checkout, named by a hash of its source and of every
header under ``csrc/`` (``hopper.cuh``), so the first call after a change
to either rebuilds it and later calls (and processes) reuse it.
:func:`build` compiles every missing library at once, one ``nvcc`` per
source started together. Nothing here runs at import time:
the CPU tests import every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "tpu_kubernetes_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
# every kernel source of the port under CSRC, by library name
SOURCES = {
    "flash_fwd": "flash_fwd.cu",
    "flash_bwd": "flash_bwd.cu",
    "grouped_matmul": "grouped_matmul.cu",
    "adamw": "adamw.cu",
    "decode_attention": "decode_attention.cu",
    "decode_attention_tc": "decode_attention_tc.cu",
    "w8_matmul": "w8_matmul.cu",
    "w8_matmul_tc": "w8_matmul_tc.cu",
}

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
    """Where library ``name`` lands: named by a hash of its source and of
    every ``csrc/*.cuh`` (an edit to a shared header rebuilds each library;
    one that includes none of them rebuilds too, in parallel, for nothing)."""
    digest = hashlib.sha256()
    for path in [CSRC / SOURCES[name], *sorted(CSRC.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def _build_locked(names) -> dict[str, float]:
    missing = [n for n in names if not library_path(n).exists()]
    if not missing:
        return {n: 0.0 for n in names}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {}
    for n in missing:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    seconds, failed = {n: 0.0 for n in names}, []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[n] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {SOURCES[n]}:\n{out}")
        else:
            os.replace(tmp, library_path(n))   # atomic: all or none
    if failed:
        raise RuntimeError("\n".join(failed))
    return seconds


def build() -> dict[str, float]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. → seconds from the start until each finished (0.0 for a
    library already built)."""
    with _lock:
        return _build_locked(list(SOURCES))


def load(symbol: str, argtypes: list, library: str | None = None
         ) -> ctypes._CFuncPtr:
    """The C function ``symbol`` of library ``library`` (default: the
    library of the same name), compiled first if it is missing, bound to
    ``argtypes`` (returning ``int``) once."""
    fn = _fns.get(symbol)
    if fn is not None:
        return fn
    library = library or symbol
    with _lock:
        if symbol not in _fns:
            _build_locked([library])
            fn = getattr(ctypes.CDLL(str(library_path(library))), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _fns[symbol] = fn
        return _fns[symbol]
