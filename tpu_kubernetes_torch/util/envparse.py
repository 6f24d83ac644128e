"""Env-var parsing for the port's serve path.

A copy of the reference's ``tpu_kubernetes/util/envparse.py`` helpers
(the port shares nothing with the JAX package by import), same rules:

* **Bad values fall back, loudly.** ``SERVE_MAX_NEW=eight`` serves with
  the default and one stderr warning instead of failing at startup.
* **Empty string means unset.**
* **One falsy-string rule.** :func:`env_bool` treats "", "0", "false",
  "no", "off" (case/space-insensitive) as False.

Every helper takes the mapping explicitly or defaults to ``os.environ``.
"""

from __future__ import annotations

import os
import sys
from typing import Mapping

FALSY = ("", "0", "false", "no", "off")


def _resolve(env: Mapping[str, str] | None) -> Mapping[str, str]:
    return os.environ if env is None else env


def _warn(name: str, raw: str, default) -> None:
    print(
        f"warning: env {name}={raw!r} is not a valid value; using default "
        f"{default!r}",
        file=sys.stderr, flush=True,
    )


def env_str(name: str, default: str = "", *,
            env: Mapping[str, str] | None = None) -> str:
    """The raw value, or ``default`` when unset/empty."""
    return _resolve(env).get(name, "") or default


def env_int(name: str, default: int, *,
            env: Mapping[str, str] | None = None) -> int:
    raw = _resolve(env).get(name, "")
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return int(str(raw).strip())
    except (ValueError, TypeError):
        _warn(name, raw, default)
        return default


def env_float(name: str, default: float, *,
              env: Mapping[str, str] | None = None) -> float:
    raw = _resolve(env).get(name, "")
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return float(str(raw).strip())
    except (ValueError, TypeError):
        _warn(name, raw, default)
        return default


def env_bool(name: str, default: bool = False, *,
             env: Mapping[str, str] | None = None) -> bool:
    """Unset → ``default``; set → anything outside :data:`FALSY` is True."""
    raw = _resolve(env).get(name)
    if raw is None:
        return default
    return str(raw).strip().lower() not in FALSY
