#!/usr/bin/env python3
"""The llama-1b engine turn of this checkout against another checkout's
(the commit before a change), on one CUDA card, in one call: the cost of
the serving operations layer (metrics, goodput ledger, profiler, tracing,
fault sites) and of the engine's black box (the flight recorder's record
a segment, the tripwires' tick on the scheduler thread) on the paged slot
engine.

    python3 ops_ab.py OTHER_CHECKOUT
    python3 ops_ab.py --side CHECKOUT   # one side alone

Each side runs in a fresh process that imports ``tpu_kubernetes_torch``
from its checkout (building its kernels into its own ``build/``, all at
once) and runs this checkout's ``chip_smoke.py`` ``ops_engine_turns``: the
llama-1b paged engine (8 slots, segments of 8, bf16, weights from seed 0)
over 16 requests, a first turn that captures, then counted turns, each
with its wall tokens/s and its median ms a segment; a side whose server
has ``build_black_box`` runs with the black box wired, as its server
wires it, and times the black box's host work on the scheduler thread
over its counted turns: the flight recorder's record a segment (with the
registry's render and parse every 2 s) and the alert manager's
evaluations (the tick, at most one a second). The sides run in turns
(other, this, this, other); each side's tokens must equal the others'.

Prints both checkouts' numbers in turn order, then one JSON line of
everything with the card's name and power limit. Exits non-zero if a side
fails, the tokens differ, or there is no card.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import shutil
import statistics
import subprocess
import sys
import threading
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


class BlackBoxTimers:
    """Host timers around the black box's scheduler-thread work:
    ``FlightRecorder.record_segment`` and ``AlertManager.evaluate``, each
    wrapped in place; their ms and calls since the last :meth:`zero`."""

    KEYS = ("record_ms", "records", "tick_ms", "ticks")

    def __init__(self, flightrec, alerts):
        self._lock = threading.Lock()    # the scheduler adds, we zero
        self.totals = dict.fromkeys(self.KEYS, 0)
        self._wrap(flightrec.FlightRecorder, "record_segment", "record")
        self._wrap(alerts.AlertManager, "evaluate", "tick")

    def _wrap(self, cls, attr: str, key: str) -> None:
        inner = getattr(cls, attr)

        def wrapper(obj, *args, **kwargs):
            t0 = time.perf_counter()
            try:
                return inner(obj, *args, **kwargs)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                with self._lock:
                    self.totals[f"{key}_ms"] += ms
                    self.totals[f"{key}s"] += 1
        setattr(cls, attr, wrapper)

    def zero(self) -> None:
        with self._lock:
            self.totals = dict.fromkeys(self.KEYS, 0)

    def report(self, walls: list) -> dict:
        """The totals and their share of the turns' wall: they run over
        the counted turns and their quiet gaps, so an upper bound."""
        with self._lock:
            t = dict(self.totals)
        t["share_of_turn_wall"] = ((t["record_ms"] + t["tick_ms"])
                                   / (1e3 * sum(walls)))
        return t


def black_box_timers() -> BlackBoxTimers | None:
    """Timers on the imported port's black box, or None for a port
    without one."""
    server = importlib.import_module("tpu_kubernetes_torch.serve.server")
    if not hasattr(server, "build_black_box"):
        return None
    return BlackBoxTimers(
        importlib.import_module("tpu_kubernetes_torch.obs.flightrec"),
        importlib.import_module("tpu_kubernetes_torch.obs.alerts"))


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
    timers = black_box_timers()
    eng, _, _, out = smoke.ops_engine_turns(
        torch, card, TURNS, before_counted=timers and timers.zero)
    eng.close()
    host = timers.report(out["walls"]) if timers is not None else None
    box = out["black_box"]
    if box is not None:
        box["alerts"].close()
        shutil.rmtree(box["dir"], ignore_errors=True)
    smoke.say(f"{TAG}{root.name}: {out['tokens_s']} tokens/s, ms a segment "
              f"{out['seg_ms']}, black box {box is not None}, its host "
              f"work {host} [{card}]")
    return {"card": card, "tokens_s": out["tokens_s"],
            "seg_ms": out["seg_ms"], "walls": out["walls"],
            "black_box": box is not None, "black_box_host": host,
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
              f"{r['seg_ms']}, black box {r['black_box']}, its host work "
              f"{r['black_box_host']}")
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
