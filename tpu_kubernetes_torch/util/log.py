"""One leveled logger for the CLI's human-facing channel (SURVEY §5.5:
the reference has no log levels at all — bare fmt.Println everywhere).

The port's copy of ``tpu_kubernetes/util/log.py`` (the port imports nothing of
the JAX package): the same names, families and behaviour.

Three levels, set once by the CLI entry point:

  quiet (-q)        — warnings and errors only
  normal (default)  — + progress (phase markers, dry-run notices)
  verbose (--verbose) — + debug detail (rendered paths, API calls)

Everything here goes to STDERR: stdout belongs to command RESULTS
(kubeconfig text, `get` JSON) so they stay pipeable. The machine-readable
channel is the per-run report (util/runlog.py), not this."""

from __future__ import annotations

import sys

QUIET, NORMAL, VERBOSE = 0, 1, 2
_level = NORMAL


def set_level(level: int) -> None:
    global _level
    _level = level


def set_verbosity(quiet: bool = False, verbose: bool = False) -> None:
    """CLI flag mapping; --verbose wins when both are passed."""
    set_level(VERBOSE if verbose else QUIET if quiet else NORMAL)


def level() -> int:
    return _level


def debug(msg: str) -> None:
    if _level >= VERBOSE:
        print(f"[tpu-k8s] {msg}", file=sys.stderr)


def info(msg: str) -> None:
    if _level >= NORMAL:
        print(f"[tpu-k8s] {msg}", file=sys.stderr)


def warn(msg: str) -> None:
    """Warnings always print — quiet mode is for progress chatter, not for
    hiding that a best-effort step failed."""
    print(f"[tpu-k8s] WARNING: {msg}", file=sys.stderr)


def error(msg: str) -> None:
    print(f"error: {msg}", file=sys.stderr)
