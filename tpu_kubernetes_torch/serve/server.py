"""HTTP completions server (port of the solo path of
``tpu_kubernetes/serve/server.py``).

A stdlib server exposing:

  GET  /healthz         → {"status": "ok", "model": ..., ...}; 503
                          {"status": "warming"} until the default programs
                          have run once
  GET  /v1/models       → the one resident model, OpenAI-list shaped
  POST /v1/completions  → {"prompt": str, "max_new_tokens"?: int,
                           "temperature"?: float, "top_k"?: int,
                           "top_p"?: float, "seed"?: int}
                          ("max_tokens" aliases max_new_tokens)
                          ⇒ {"text": str, "tokens": int,
                           "prompt_tokens": int, "finish_reason":
                           "stop"|"length", "model": str}

Model bring-up is ``serve/job.py``'s ``load_serving_stack`` (SERVE_MODEL,
SERVE_TOKENIZER, SERVE_DTYPE, SERVE_DEVICE — ``cuda`` unless set), plus
SERVER_HOST/SERVER_PORT, SERVE_MAX_NEW (the per-request max_new_tokens
cap, default 64), SERVE_EOS_ID (tokens from it on are cut from
responses) and SERVE_EARLY_EXIT_STEPS (the greedy decode loop checks
between segments of this many steps whether any row is still live,
default 8; <= 0 runs one segment).

Request handling follows the reference's solo path exactly, so a greedy
response is token-identical to it: the prompt is byte-encoded (empty →
``[0]``), right-padded to a power-of-two width, prefilled raggedly into a
cache spanning ``width + run_max_new`` (``run_max_new`` is the requested
budget rounded up to a power of two, capped), decoded greedily in
segments until the budget or EOS, then cut to the requested budget and
at EOS. The greedy lane (:class:`GreedyLane`) runs its prefill and
decode segments as CUDA graphs on the card, one per static signature,
the counterpart of the reference's cached jitted programs; ``warm()``
captures the default bucket's. Sampled requests run ``generate``
eagerly, with a ``torch.Generator`` seeded from the request (its draws
differ from ``jax.random``'s).

Later slices of the port bring streaming (SSE), chat completions,
batching, the continuous slot engine, paged KV, the prefix cache, int8
KV and weights, speculation, the mesh, /metrics and tracing, and the
resilience and drain machinery (ROADMAP.md).
"""

from __future__ import annotations

import json
import os
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from tpu_kubernetes_torch.models.decode import (
    KVCache,
    decode_segment,
    generate,
    init_cache,
    prefill,
)
from tpu_kubernetes_torch.serve.job import load_serving_stack, log
from tpu_kubernetes_torch.util.envparse import env_int, env_str
from tpu_kubernetes_torch.util.graphs import Programs


def _bucket(n: int, lo: int = 16) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _is_greedy(temperature, top_k, top_p) -> bool:
    """Default sampling: greedy argmax, no filters."""
    return (
        float(temperature) == 0.0 and int(top_k) == 0
        and float(top_p) == 0.0
    )


def _bucket_max_new(n: int, cap: int) -> int:
    """Round a requested max_new up to a power-of-two bucket (≤ cap).
    Responses still truncate to the REQUESTED budget."""
    return min(_bucket(n, lo=8), cap)


class _Slots:
    """The buffers one (batch, width, span) shares between its prefill and
    decode programs: the static inputs (tokens, lengths, the decode's
    first slot), the cache and the carry (token, done). They live outside
    the graphs' pool."""

    def __init__(self, cfg, b: int, width: int, span: int, device):
        self.tokens = torch.zeros((b, width), dtype=torch.int32,
                                  device=device)
        self.lengths = torch.zeros((b,), dtype=torch.int32, device=device)
        cache = init_cache(cfg, b, span, device=device)
        self.cache = KVCache(cache.k, cache.v, length=width,
                             prompt_lengths=self.lengths, prompt_slots=width)
        self.start = torch.zeros((), dtype=torch.int64, device=device)
        self.token = torch.zeros((b,), dtype=torch.int32, device=device)
        self.done = torch.zeros((b,), dtype=torch.bool, device=device)
        self.length = width            # the host's count of filled slots


class GreedyLane:
    """The greedy serving programs, cached by key in one
    :class:`~tpu_kubernetes_torch.util.graphs.Programs` (the reference's
    ``_cached_program``): a ragged ``prefill`` per ("prefill", batch,
    width, span) and a ``decode_segment`` per ("decode", batch, width,
    span, steps); the EOS id is the lane's. On the card each program is a
    CUDA graph captured at its key's first call; ``graphs=False`` runs the
    same bodies eagerly (comparisons only)."""

    def __init__(self, params: dict, cfg, eos_id: int | None = None, *,
                 graphs: bool = True):
        self.params, self.cfg, self.eos_id = params, cfg, eos_id
        self.device = params["embed"].device
        self.programs = Programs(self.device, graphs=graphs)
        self._slots: dict[tuple, _Slots] = {}

    def slots(self, b: int, width: int, span: int) -> _Slots:
        key = (b, width, span)
        if key not in self._slots:
            self._slots[key] = _Slots(self.cfg, b, width, span, self.device)
        return self._slots[key]

    def prefill(self, rows: torch.Tensor, lengths: torch.Tensor,
                span: int) -> _Slots:
        """Copy the right-padded ``rows`` (b, width) and their ``lengths``
        in, run the prefill program → its slots, whose ``token`` holds
        each row's first greedy token and ``done`` whether it is EOS."""
        b, width = rows.shape
        st = self.slots(b, width, span)
        # the body closes over the lane's parts, never the lane, so a
        # dropped lane frees its graphs by reference count
        params, cfg, eos_id = self.params, self.cfg, self.eos_id

        def build():
            def body():
                logits, _ = prefill(params, st.tokens, cfg, max_seq=span,
                                    lengths=st.lengths, cache=st.cache)
                st.token.copy_(torch.argmax(logits, dim=-1))
                if eos_id is None:
                    st.done.zero_()
                else:
                    st.done.copy_(st.token == eos_id)
            return body

        program = self.programs.get(("prefill", b, width, span), build)
        st.tokens.copy_(rows, non_blocking=True)
        st.lengths.copy_(lengths, non_blocking=True)
        program()
        st.length = width
        return st

    def decode(self, st: _Slots, steps: int) -> torch.Tensor:
        """``steps`` greedy decode steps from the slots' carry, in place →
        the emitted tokens (b, steps) int32 (a copy: the program's own
        output is overwritten by its next replay)."""
        b, width = st.tokens.shape
        span = st.cache.k.shape[3]
        if st.length + steps > span:
            raise ValueError(f"cache span {span} cannot take {steps} more "
                             f"steps after {st.length}")

        params, cfg, eos_id = self.params, self.cfg, self.eos_id

        def build():
            out = torch.zeros((b, steps), dtype=torch.int32,
                              device=st.token.device)

            def body():
                # st.cache's host length is the prompt's; the slot the
                # segment starts at is read from st.start at every replay
                toks, tok, done, _ = decode_segment(
                    params, st.cache, st.token, st.done, cfg, steps,
                    eos_id=eos_id, pad_id=0, start=st.start)
                out.copy_(toks)
                st.token.copy_(tok)
                st.done.copy_(done)
            body.out = out
            return body

        program = self.programs.get(("decode", b, width, span, steps), build)
        st.start.fill_(st.length)
        program()
        st.length += steps
        return program.body.out.clone()

    def run(self, rows: torch.Tensor, lengths: torch.Tensor, budgets: list,
            run_max_new: int, k_steps: int) -> tuple[list, int]:
        """Prefill, then greedy decode in segments of ``k_steps`` steps
        (the last one shorter, its own key) with a host-side liveness
        check between them: a row is live until its EOS appears or its own
        budget is emitted; once none is, the rest of the run is skipped.
        → (tokens (b, 1+steps_run) list of lists, steps_run)."""
        b, width = rows.shape
        st = self.prefill(rows, lengths, width + run_max_new)
        total = run_max_new - 1       # steps left after the first token
        k_steps = k_steps if k_steps > 0 else total
        pieces = [st.token[:, None].clone()]
        emitted = 1
        steps_run = 0
        while steps_run < total:
            done_h = st.done.tolist()
            if not any(budgets[i] > emitted and not done_h[i]
                       for i in range(b)):
                break
            steps = min(k_steps, total - steps_run)
            pieces.append(self.decode(st, steps))
            emitted += steps
            steps_run += steps
        return torch.cat(pieces, dim=1).tolist(), steps_run


class ServingState:
    """The resident model, its device and the generation lock."""

    def __init__(self, env: dict):
        self.env = env
        params, cfg, encode, decode_text = load_serving_stack(env)
        self.params, self.cfg = params, cfg
        self.device = params["embed"].device
        self.encode, self.decode_text = encode, decode_text
        self.max_new_cap = env_int("SERVE_MAX_NEW", 64, env=env)
        eos_env = env.get("SERVE_EOS_ID", "")
        self.eos_id = int(eos_env) if eos_env else None
        self.model_name = env.get("SERVE_MODEL", "llama-test")
        self.early_exit_steps = env_int("SERVE_EARLY_EXIT_STEPS", 8, env=env)
        self.greedy = GreedyLane(params, cfg, self.eos_id)
        self._lock = threading.Lock()
        self.ready = False

    def warm(self) -> None:
        """Run the default request's path once before going ready: the
        kernel libraries are built, and the default bucket's greedy
        programs captured, on this first call."""
        self.complete("")
        self.ready = True
        log("server: warm — serving")

    def _validate(self, prompt: str, max_new_tokens: int | None):
        """→ (prompt ids, requested max_new, run_max_new, width)."""
        max_new = (
            self.max_new_cap if max_new_tokens is None
            else int(max_new_tokens)   # 0 is a VALUE (and rejected), not unset
        )
        max_new = min(max_new, self.max_new_cap)
        if max_new < 1:
            raise ValueError("max_new_tokens must be >= 1")
        ids = self.encode(prompt) or [0]      # empty prompt → one pad row
        width = _bucket(len(ids))
        if width + max_new > self.cfg.max_seq:
            raise ValueError(
                f"prompt ({len(ids)} tokens, bucket {width}) + "
                f"max_new_tokens ({max_new}) exceeds max_seq "
                f"{self.cfg.max_seq}"
            )
        run_max_new = min(
            _bucket_max_new(max_new, self.max_new_cap),
            self.cfg.max_seq - width,
        )
        return ids, max_new, run_max_new, width

    def _pad_rows(self, rows: list, width: int) -> torch.Tensor:
        padded = torch.zeros((len(rows), width), dtype=torch.int32)
        for i, r in enumerate(rows):
            padded[i, :len(r)] = torch.tensor(r, dtype=torch.int32)
        return padded

    def complete(self, prompt: str, max_new_tokens: int | None = None,
                 temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 0.0, seed: int = 0) -> dict:
        ids, max_new, run_max_new, width = self._validate(
            prompt, max_new_tokens
        )
        rows = self._pad_rows([ids], width)
        lengths = torch.tensor([len(ids)], dtype=torch.int32)
        with self._lock:
            if _is_greedy(temperature, top_k, top_p):
                out, _ = self.greedy.run(rows, lengths, [max_new],
                                         run_max_new, self.early_exit_steps)
                tokens = out[0]
            else:
                gen = torch.Generator(device=self.device).manual_seed(
                    int(seed))
                out = generate(
                    self.params, rows.to(self.device), self.cfg, run_max_new,
                    temperature=float(temperature), top_k=int(top_k),
                    top_p=float(top_p), generator=gen,
                    prompt_lengths=lengths.to(self.device),
                    eos_id=self.eos_id,
                )
                tokens = out[0].tolist()
        tokens = tokens[:max_new]              # bucketed run → requested budget
        if self.eos_id is not None and self.eos_id in tokens:
            tokens = tokens[:tokens.index(self.eos_id)]
        return {
            "text": self.decode_text(tokens),
            "tokens": len(tokens),
            "prompt_tokens": len(ids),
            # a full budget means truncation, anything shorter means EOS
            "finish_reason": "length" if len(tokens) >= max_new else "stop",
            "model": self.model_name,
        }


class _Handler(BaseHTTPRequestHandler):
    state: ServingState  # set by make_server
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):
        pass  # no per-request access lines

    def _json(self, code: int, obj: dict) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler contract
        st = self.state
        if self.path == "/v1/models":
            return self._json(200, {
                "object": "list",
                "data": [{"id": st.model_name, "object": "model"}],
            })
        if self.path != "/healthz":
            return self._json(404, {"error": "unknown path"})
        if not st.ready:
            return self._json(503, {"status": "warming"})
        return self._json(200, {
            "status": "ok",
            "model": st.model_name,
            "max_new_tokens_cap": st.max_new_cap,
            "device": str(st.device),
        })

    def do_POST(self):  # noqa: N802
        st = self.state
        if self.path != "/v1/completions":
            return self._json(404, {"error": "unknown path"})
        if not st.ready:
            return self._json(503, {"error": "warming"})
        try:
            length = int(self.headers.get("Content-Length", "0"))
            body = json.loads(self.rfile.read(length) or b"{}")
            if not isinstance(body, dict) or "prompt" not in body:
                raise ValueError('body must be a JSON object with "prompt"')
            if body.get("stream"):
                raise ValueError(
                    '"stream" is not supported by the PyTorch port yet '
                    "(streaming arrives with a later slice)"
                )
            result = st.complete(
                str(body["prompt"]),
                max_new_tokens=body.get("max_new_tokens",
                                        body.get("max_tokens")),
                temperature=body.get("temperature", 0.0),
                top_k=body.get("top_k", 0),
                top_p=body.get("top_p", 0.0),
                seed=body.get("seed", 0),
            )
        except (ValueError, TypeError, json.JSONDecodeError) as e:
            return self._json(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — a generation failure must
            # be a JSON 500 the client can parse, not a dropped socket
            log(f"request failed: {type(e).__name__}: {e}")
            return self._json(500, {"error": f"{type(e).__name__}: {e}"})
        return self._json(200, result)


def make_server(env: dict | None = None) -> ThreadingHTTPServer:
    """Build (but don't run) the server; the model is loaded and warmed
    before this returns."""
    env = dict(os.environ if env is None else env)
    state = ServingState(env)
    state.warm()
    handler = type("Handler", (_Handler,), {"state": state})
    host = env_str("SERVER_HOST", "127.0.0.1", env=env)
    port = env_int("SERVER_PORT", 8000, env=env)
    return ThreadingHTTPServer((host, port), handler)


def main(argv: list[str] | None = None) -> int:
    import argparse

    argparse.ArgumentParser(
        prog="tpu-kubernetes-torch-server",
        description="OpenAI-style completions over the PyTorch port "
                    "(configured by SERVE_* / SERVER_* env vars)",
    ).parse_args(argv)
    try:
        server = make_server()
    except ValueError as e:
        raise SystemExit(f"config error: {e}") from e
    host, port = server.server_address[:2]
    log(f"server: listening on {host}:{port}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
