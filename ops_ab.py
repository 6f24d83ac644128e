#!/usr/bin/env python3
"""The llama-1b engine turn of this checkout against another checkout's
(the commit before a change), on one CUDA card, in one call: the cost of
the serving operations layer (metrics, goodput ledger, profiler, tracing,
fault sites) on the paged slot engine.

    python3 ops_ab.py OTHER_CHECKOUT
    python3 ops_ab.py --side CHECKOUT   # one side alone

Each side runs in a fresh process that imports ``tpu_kubernetes_torch``
from its checkout (building its kernels into its own ``build/``, all at
once) and runs this checkout's ``chip_smoke.py`` ``ops_engine_turns``: the
llama-1b paged engine (8 slots, segments of 8, bf16, weights from seed 0)
over 16 requests, a first turn that captures, then counted turns, each
with its wall tokens/s and its median ms a segment. The sides run in
turns (other, this, this, other); each side's tokens must equal the
others'.

Prints both checkouts' numbers in turn order, then one JSON line of
everything with the card's name and power limit. Exits non-zero if a side
fails, the tokens differ, or there is no card.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TAG = "ops_ab: "
TURNS = 5


def load_smoke():
    """This checkout's chip_smoke.py as a module of helpers (its main is
    not run), whatever checkout sits first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def side(root: Path) -> dict:
    """One side's engine turns, on the port of ``root``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("ops_ab: no CUDA device")
    sys.path.insert(0, str(root))
    smoke = load_smoke()
    build = importlib.import_module("tpu_kubernetes_torch.ops._build")
    if not Path(build.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {build.__file__}, not the port of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    build.build()
    eng, _, _, out = smoke.ops_engine_turns(torch, card, TURNS)
    eng.close()
    smoke.say(f"{TAG}{root.name}: {out['tokens_s']} tokens/s, ms a segment "
              f"{out['seg_ms']} [{card}]")
    return {"card": card, "tokens_s": out["tokens_s"],
            "seg_ms": out["seg_ms"], "walls": out["walls"],
            "tokens": out["tokens"]}


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
             str(sides[name])], capture_output=True, text=True, timeout=900)
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
    if any(r["tokens"] != runs[0][1]["tokens"] for _, r in runs):
        print(f"{TAG}the sides' tokens differ", file=sys.stderr)
        return 1
    for n, r in runs:
        print(f"{TAG}{n}: tokens/s {r['tokens_s']}, ms a segment "
              f"{r['seg_ms']}")
    for name in ("other", "this"):
        mine = [r for n, r in runs if n == name]
        print(f"{TAG}{name}: median tokens/s "
              f"{statistics.median(t for r in mine for t in r['tokens_s'])}"
              f", median ms a segment "
              f"{statistics.median(m for r in mine for m in r['seg_ms'])}")
    for _, r in runs:
        del r["tokens"]
    print(json.dumps({"card": runs[0][1]["card"], "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
