#!/usr/bin/env python3
"""Decode attention of this checkout against another checkout's (the
commit before a change to it), on one CUDA card, in one call.

    python3 decode_attention_ab.py OTHER_CHECKOUT
    python3 decode_attention_ab.py --side CHECKOUT   # one side alone

Each side runs in a fresh process that imports ``tpu_kubernetes_torch``
from its checkout, so each builds its own kernels into its own
``build/``; the sides run in turns (other, this, this, other). A side
times the decode-attention wrapper's default route at the shapes of
``chip_smoke.py``'s decode-attention phase (``decode_cases``), each a
CUDA graph of back-to-back calls, with its error against the plain
version, and then runs ``chip_smoke.py``'s long-context engine turn
(``phase_long_context``: ms a segment and tokens/s of the dense and
paged engines on the kernel and on the plain decode attention, and the
decode-attention kernel's share of a profiled turn). The helpers are
this checkout's ``chip_smoke.py``; the port they drive is the side's.

Prints, for every shape and engine, both checkouts' numbers in turn
order, then one JSON line of everything with the card's name and power
limit. Exits non-zero if a side fails or finds no card.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TAG = "decode_attention_ab: "


def load_smoke():
    """This checkout's chip_smoke.py as a module of helpers (its main is
    not run), whatever checkout sits first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def side(root: Path) -> dict:
    """One side's numbers, from the port of ``root``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("decode_attention_ab: no CUDA device")
    sys.path.insert(0, str(root))
    smoke = load_smoke()
    tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    fa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
    if not Path(tda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {tda.__file__}, not the port of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    shapes = {}
    for case in smoke.decode_cases(torch):
        q, lim, pl, ps, table = (case[k] for k in ("q", "limits", "pl", "ps",
                                                   "table"))

        def kernel(i, case=case):
            k, v = case["calls"][i % smoke.DECODE_COPIES]
            return tda.decode_attention_cuda(q, k, v, lim, pl, ps,
                                             table=table)

        k, v = case["calls"][0]
        ref = tda.decode_attention_reference(q, k, v, lim, pl, ps,
                                             table=table)
        err = (kernel(0).float() - ref.float()).abs().max().item()
        smoke.check(err <= smoke.decode_tol(torch, ref),
                    f"{case['label']}: max abs err {err}")
        counter = iter(range(10 ** 9))
        ms = smoke.graph_ms(torch, lambda: kernel(next(counter)), 40)
        b_ms, _ = smoke.bound(0, case["nbytes"], str(case["dtype"])[6:])
        shapes[case["label"]] = {"ms": ms, "bound_ms": b_ms,
                                 "max_abs_err": err}
        smoke.say(f"{TAG}{root.name}: {case['label']}: {ms:.4f} ms (bound "
                  f"{b_ms:.4f}, err {err:.3e}) [{card}]")
    torch.cuda.empty_cache()
    long = smoke.phase_long_context(torch, fa, card, check_counts=False)
    return {"card": card, "shapes": shapes, "long_context": {
        "variants": long["variants"],
        "profile": [r for r in long["profile"]
                    if "decode_attention" in r[0]]}}


def main(argv: list[str]) -> int:
    if len(argv) == 2 and argv[0] == "--side":
        out = side(Path(argv[1]).resolve())
        print(TAG + "RESULT " + json.dumps(out), flush=True)
        return 0
    if len(argv) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    sides = {"other": Path(argv[0]).resolve(), "this": HERE}
    runs = []
    for name in ("other", "this", "this", "other"):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--side",
             str(sides[name])], capture_output=True, text=True, timeout=1500)
        sys.stdout.write(proc.stdout)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode != 0:
            print(f"{TAG}{name} side failed ({proc.returncode})",
                  file=sys.stderr)
            return 1
        line = next(x for x in proc.stdout.splitlines()
                    if x.startswith(TAG + "RESULT "))
        runs.append((name, json.loads(line[len(TAG + "RESULT "):])))
        print(f"{TAG}{name} side took {time.perf_counter() - t0:.1f} s",
              flush=True)
    for label in runs[0][1]["shapes"]:
        print(f"{TAG}{label}: " + ", ".join(
            f"{n} {r['shapes'][label]['ms']:.4f}" for n, r in runs)
            + f" ms (bound {runs[0][1]['shapes'][label]['bound_ms']:.4f})")
    for v in runs[0][1]["long_context"]["variants"]:
        print(f"{TAG}long context {v}: " + ", ".join(
            f"{n} {r['long_context']['variants'][v]['ms_segment']:.3f} ms a "
            f"segment / {r['long_context']['variants'][v]['tokens_s']:.1f} "
            f"tokens/s" for n, r in runs))
    for n, r in runs:
        print(f"{TAG}{n}: decode attention in a profiled long-context turn "
              f"{r['long_context']['profile']}")
    print(json.dumps({"card": runs[0][1]["card"], "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
