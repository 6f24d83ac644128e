#!/usr/bin/env python3
"""Where one launch of the tensor-core decode-attention kernel spends its
time, on one CUDA card.

    python3 decode_attention_trace.py

Builds ``tpu_kubernetes_torch/csrc/decode_attention_tc.cu`` with
``-DDECODE_ATTENTION_TRACE`` into a library of its own under
``build/tpu_kubernetes_torch/``: the kernel then stamps ``%globaltimer``
(nanoseconds, advancing in steps of about a quarter microsecond) at each
of its phases, one stamp a block and phase. The wrapper's tc entry is
pointed at that build, and the kernel runs once, after three warm-up
calls, at each tensor-core shape of ``chip_smoke.py``'s decode-attention
phase (``decode_cases``). For each phase it prints the earliest, median
and latest block, in microseconds from the first block's first stamp,
and the span from that stamp to the last block's exit. The stamps cost a
global store each; the times of record are chip_smoke.py's.
"""

from __future__ import annotations

import ctypes
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
# the kernel's TRACE(k, ...) stamps, in order
PHASES = ("row planned", "ring ready", "first TMA issued",
          "first tile landed", "tiles done", "block partial written",
          "cluster partials visible", "o written", "exit")
TRACE_BLOCKS = 8192          # the kernel's stamps hold this many blocks


def build_traced(_build) -> ctypes.CDLL:
    """The traced library, built by nvcc (seconds) into the build dir."""
    src = _build.CSRC / _build.SOURCES["decode_attention_tc"]
    out = _build.library_path("decode_attention_tc").with_name(
        _build.library_path("decode_attention_tc").stem + "-trace.so")
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DDECODE_ATTENTION_TRACE", "-o", str(out),
                        str(src)], check=True)
    return ctypes.CDLL(str(out))


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_attention_trace: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from tpu_kubernetes_torch.ops import _build

    tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    lib = build_traced(_build)
    entry = lib.decode_attention_tc
    entry.argtypes = tda.load_kernel("tc").argtypes
    entry.restype = ctypes.c_int
    _build._fns["decode_attention_tc"] = entry   # the wrapper's tc entry
    read = lib.decode_attention_tc_trace
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    n = TRACE_BLOCKS * len(PHASES)
    stamps = np.zeros(n, dtype=np.uint64)
    card = smoke.card_line()
    for case in smoke.decode_cases(torch):
        q, lim, pl, ps, table = (case[k] for k in ("q", "limits", "pl", "ps",
                                                   "table"))
        kv = case["dense"][0][0].shape[1]
        if tda._route(q.dtype, q.shape[3], q.shape[1] // kv) != "tc":
            continue
        k, v = case["calls"][0]
        for _ in range(3):
            tda.decode_attention_cuda(q, k, v, lim, pl, ps, table=table)
        torch.cuda.synchronize()
        smoke.check(read(stamps.ctypes.data, n) == 0, "trace read failed")
        tda.decode_attention_cuda(q, k, v, lim, pl, ps, table=table)
        torch.cuda.synchronize()
        smoke.check(read(stamps.ctypes.data, n) == 0, "trace read failed")
        blocks = 4 * kv * q.shape[0]           # CLUSTER x kv x b
        t = stamps.reshape(TRACE_BLOCKS, len(PHASES))[:blocks]
        t = t.astype(np.float64)
        t0 = t[:, 0][t[:, 0] > 0].min()
        cells = []
        for i, name in enumerate(PHASES):
            col = t[:, i][t[:, i] > 0] - t0
            if len(col):
                cells.append(f"{name} {col.min() / 1e3:.2f} / "
                             f"{np.median(col) / 1e3:.2f} / "
                             f"{col.max() / 1e3:.2f}")
        smoke.say(f"trace {case['label']} ({blocks} blocks; us from the "
                  f"first stamp, earliest / median / latest block): "
                  + "; ".join(cells) + f" [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
