#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and hold its kernels to their
plain versions.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. Card: the card's name and power limit (``nvidia-smi``), then the
   port's CUDA kernel built from ``tpu_kubernetes_torch/csrc``, with the
   build seconds.
2. Kernel against plain: the flash-attention forward against
   ``attention_reference`` on the same tensors (O, and LSE against
   ``logsumexp``) over the listed shapes, bf16 and f32, causal (square
   and ``seq_q < seq_k``) and not. At the main path's prefill shape: the
   kernel's time, the plain version's, the bound, and one
   ``scaled_dot_product_attention`` call as a yardstick only (the port
   never calls it).
3. llama-1b at full width (16 layers, bf16, random weights from a
   seeded ``torch.Generator``): with every launch count set to 0, a
   ragged ``prefill`` of 4 rows at width 1024 (16 kernel launches) and a
   greedy ``generate`` of 64 new tokens; then the kernel's logits
   against the plain lane's.
4. HTTP: ``make_server`` at llama-test on the card, on an ephemeral
   port; ``/healthz`` and three ``/v1/completions`` (two greedy, one
   sampled), with the launch count set to 0 before them.
5. One JSON line of the kernels, then the result line
   ``{"ok": true, "device": {...}}``.

Phase 2 includes the HTTP phase's own shapes; phase 4 also replays its
greedy requests on an f32 server and holds their token ids to a
ServingState whose prefill takes the plain lane.
"""

from __future__ import annotations

import contextlib
import copy
import http.client
import importlib
import json
import math
import subprocess
import sys
import threading
import time
import traceback
from dataclasses import replace
from pathlib import Path

HERE = Path(__file__).resolve().parent
BF16_TFLOPS = 989e12      # H100 SXM dense bf16 tensor-core peak
F32_TFLOPS = 67e12        # H100 SXM f32 outside the tensor cores
HBM_BYTES_S = 3.35e12     # H100 SXM HBM3

# |kernel − plain| <= atol + rtol·|plain|, elementwise. f32: both sides
# compute in f32 and differ by summation order and exp ulps. bf16: the
# plain version rounds P to bf16 before P·V and the kernel keeps it in
# f32, and O is rounded to bf16 on both sides, so the two may land one
# bf16 ulp apart (2^-8 relative, 0.0156 at |O| in [2, 4)).
O_TOL = {"bfloat16": (1e-2, 1e-2), "float32": (1e-4, 1e-4)}
LSE_TOL = 1e-3            # f32 scores from the same inputs on both sides
# llama-1b bf16 logits, kernel lane vs plain lane: the attention outputs
# differ by the bf16 P rounding above and the difference rides 16 layers
# of bf16 residual stream. The logits leave a bf16 matmul, so they move in
# bf16 ulps: 2^-5 = 0.031 for a largest logit in [4, 8), where this seed
# lands (measured: 0.078 of 4.625, 1.7 %, 2.5 ulps). 3 % of the largest
# logit allows about 4 ulps there; the greedy argmax must agree on every row.
LOGIT_REL_TOL = 3e-2

MAIN_SHAPE = (4, 16, 1024, 128)   # llama-1b prefill: 4 rows × width 1024


class SmokeError(RuntimeError):
    pass


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise SmokeError(msg)


def say(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(bool(out), "nvidia-smi printed no card")
    return out[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean device milliseconds of ``fn`` over ``iters`` back-to-back
    calls, after one warm-up call (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_work(b, h, sq, sk, d, causal, itemsize):
    """(operations, bytes) this call needs: the unmasked score pairs × 2
    products × 2 ops × d, and q/k/v read once, O and LSE written once."""
    if causal:
        off = sk - sq
        pairs = sum(min(sk, r + off + 1) for r in range(sq))
    else:
        pairs = sq * sk
    ops = 4 * b * h * pairs * d
    nbytes = (2 * b * h * sq * d + 2 * b * h * sk * d) * itemsize + b * h * sq * 4
    return ops, nbytes


def bound(ops, nbytes, dtype_name):
    peak = BF16_TFLOPS if dtype_name == "bfloat16" else F32_TFLOPS
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_kernel(torch, fa) -> dict:
    """Kernel vs plain over the listed cases; timings at MAIN_SHAPE."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1234)
    cases = [
        # (b, h, seq_q, seq_k, d, dtype, causal)
        (1, 16, 2048, 2048, 128, torch.bfloat16, True),
        (4, 16, 512, 512, 128, torch.bfloat16, True),
        (1, 16, 2048, 2048, 128, torch.float32, True),
        (4, 16, 512, 512, 128, torch.float32, True),
        (2, 4, 64, 64, 16, torch.bfloat16, True),
        (2, 4, 64, 64, 16, torch.float32, True),
        (1, 16, 256, 512, 128, torch.bfloat16, True),
        (1, 16, 256, 512, 128, torch.float32, True),
        (2, 16, 512, 512, 128, torch.bfloat16, False),
        (2, 8, 256, 384, 64, torch.float32, False),
        (1, 4, 200, 328, 32, torch.float32, True),
        # the HTTP phase's shapes (llama-test, one row bucketed to 16 or 32
        # tokens: a q tile mostly of padding), and one with an offset
        (1, 4, 16, 16, 16, torch.bfloat16, True),
        (1, 4, 32, 32, 16, torch.bfloat16, True),
        (1, 4, 16, 16, 16, torch.float32, True),
        (1, 4, 32, 32, 16, torch.float32, True),
        (1, 4, 16, 48, 16, torch.bfloat16, True),
        (*MAIN_SHAPE[:3], MAIN_SHAPE[2], MAIN_SHAPE[3], torch.bfloat16, True),
    ]
    main = None
    for b, h, sq, sk, d, dtype, causal in cases:
        q = torch.randn((b, h, sq, d), generator=g, device=dev).to(dtype)
        k = torch.randn((b, h, sk, d), generator=g, device=dev).to(dtype)
        v = torch.randn((b, h, sk, d), generator=g, device=dev).to(dtype)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_fwd_cuda(q, k, v, causal, scale)
        torch.cuda.synchronize()
        ref = fa.attention_reference(q, k, v, causal=causal, sm_scale=scale)
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
        if causal:
            keep = torch.ones(sq, sk, dtype=torch.bool, device=dev).tril(sk - sq)
            s = s.masked_fill(~keep, fa.NEG_INF)
        lse_ref = torch.logsumexp(s, dim=-1)
        del s
        name = str(dtype).split(".")[-1]
        atol, rtol = O_TOL[name]
        diff = (o.float() - ref.float()).abs()
        err = diff.max().item()
        within = bool((diff <= atol + rtol * ref.float().abs()).all())
        lse_err = (lse - lse_ref).abs().max().item()
        ok = within and math.isfinite(err) and lse_err <= LSE_TOL
        say(f"kernel flash_fwd {name} b={b} h={h} sq={sq} sk={sk} d={d} "
            f"causal={causal}: max_abs_err O {err:.3e} (tol {atol:.0e} + "
            f"{rtol:.0e}*|O|) LSE {lse_err:.3e} (tol {LSE_TOL:.0e}) "
            f"{'ok' if ok else 'FAIL'}")
        check(ok, f"flash_fwd disagrees with attention_reference at "
                  f"{(b, h, sq, sk, d, name, causal)}")
        if (b, h, sq, d) == MAIN_SHAPE and sk == sq and dtype == torch.bfloat16:
            main = (q, k, v, scale, err)

    q, k, v, scale, err = main
    b, h, sq, d = MAIN_SHAPE
    sdpa = torch.nn.functional.scaled_dot_product_attention
    ms = cuda_ms(lambda: fa.flash_fwd_cuda(q, k, v, True, scale), 20)
    plain_ms = cuda_ms(
        lambda: fa.attention_reference(q, k, v, causal=True, sm_scale=scale), 5)
    library_ms = cuda_ms(lambda: sdpa(q, k, v, is_causal=True, scale=scale), 20)
    ops, nbytes = attention_work(b, h, sq, sq, d, True, q.element_size())
    bound_ms, bound_by = bound(ops, nbytes, "bfloat16")
    say(f"kernel flash_fwd bf16 {MAIN_SHAPE} causal: {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, sdpa (yardstick) {library_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms by {bound_by} ({ops:.4e} ops, {nbytes} bytes)")
    return {
        "name": "flash_fwd",
        "route": "cuda",
        "source": "tpu_kubernetes_torch/csrc/flash_fwd.cu",
        "replaces": "tpu_kubernetes/ops/flash_attention.py:96",
        "launches": None,            # filled from the main path's run
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }


def profile_window(torch, label: str, fn, card: str) -> None:
    """Kernel time by name and the device's busy share over one call of
    ``fn`` under torch.profiler (one stream, so the kernel times add)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernels only: the CPU ops that launched them carry their time too
    rows = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count)
         for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if busy <= 0:
        say(f"profile {label}: device time not measured (the profiler "
            f"saw no kernels) [{card}]")
        return
    say(f"profile {label}: wall {wall * 1e3:.3f} ms under the profiler, "
        f"kernels {busy:.3f} ms, device busy {busy / (wall * 1e3):.3f} "
        f"[{card}]")
    for name, ms, count in rows[:6]:
        say(f"  {ms:9.3f} ms {ms / busy:6.3f} x{count:<5d} {name[:110]}")


def phase_llama_1b(torch, fa, card: str) -> int:
    """llama-1b prefill + generate through the kernel; → launches."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.models.decode import (
        decode_segment,
        generate,
        prefill,
    )

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    b, width, new = 4, 1024, 64
    tokens = torch.randint(0, cfg.vocab_size, (b, width), generator=gen,
                           device=dev, dtype=torch.int32)
    lengths = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                           device=dev)
    span = width + new

    prefill(params, tokens, cfg, max_seq=span, lengths=lengths)   # warm-up
    torch.cuda.synchronize()

    # -- the main path: every count at 0 just before, read just after ----
    fa.flash_fwd_cuda.launches = 0
    t0 = time.perf_counter()
    logits, _ = prefill(params, tokens, cfg, max_seq=span, lengths=lengths)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    after_prefill = fa.flash_fwd_cuda.launches
    t0 = time.perf_counter()
    out = generate(params, tokens, cfg, new, prompt_lengths=lengths)
    torch.cuda.synchronize()
    t_generate = time.perf_counter() - t0
    launches = fa.flash_fwd_cuda.launches
    # -----------------------------------------------------------------------

    check(after_prefill == cfg.n_layers,
          f"prefill launched the kernel {after_prefill} times, not "
          f"{cfg.n_layers}")
    check(launches == 2 * cfg.n_layers,
          f"prefill + generate launched the kernel {launches} times, not "
          f"{2 * cfg.n_layers}")
    check(tuple(out.shape) == (b, new), f"generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
          "generated token out of [0, vocab)")
    check(bool(torch.isfinite(logits).all()), "non-finite prefill logits")

    plain = replace(cfg, use_kernel=False)
    ref, _ = prefill(params, tokens, plain, max_seq=span, lengths=lengths)
    torch.cuda.synchronize()
    check(fa.flash_fwd_cuda.launches == launches,
          "the plain lane launched the kernel")
    err = (logits - ref).abs().max().item()
    scale = ref.abs().max().item()
    agree = (logits.argmax(-1) == ref.argmax(-1)).float().mean().item()
    say(f"llama-1b prefill logits kernel vs plain: max_abs_err {err:.4e}, "
        f"max |logit| {scale:.4e}, rel {err / scale:.3e} (tol "
        f"{LOGIT_REL_TOL:.0e}), argmax agreement {agree:.2f}")
    check(err <= LOGIT_REL_TOL * scale,
          "llama-1b kernel logits disagree with the plain lane")
    check(agree == 1.0, "llama-1b greedy argmax differs between the kernel "
                        "and the plain lane")

    real = int(lengths.sum())
    decode_ms = (t_generate - t_prefill) / (new - 1) * 1e3
    say(f"llama-1b prefill: {b}x{width} padded ({real} real tokens) in "
        f"{t_prefill * 1e3:.2f} ms = {b * width / t_prefill:.1f} padded "
        f"tokens/s, {real / t_prefill:.1f} real tokens/s [{card}]")
    say(f"llama-1b decode: generate {new} tokens x {b} rows in "
        f"{t_generate * 1e3:.2f} ms; (generate - prefill) / {new - 1} = "
        f"{decode_ms:.3f} ms/step [{card}]")

    def decode8():
        logits, cache = prefill(params, tokens, cfg, max_seq=span,
                                lengths=lengths)
        torch.cuda.synchronize()
        first = logits.argmax(-1).to(torch.int32)
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        return lambda: decode_segment(params, cache, first, done, cfg, 8)

    profile_window(torch, "llama-1b prefill 4x1024", lambda: prefill(
        params, tokens, cfg, max_seq=span, lengths=lengths), card)
    profile_window(torch, "llama-1b decode_segment 8 steps x 4 rows",
                   decode8(), card)
    del params
    torch.cuda.empty_cache()
    return launches


def _request(port: int, method: str, path: str, body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


HTTP_ENV = {"SERVE_MODEL": "llama-test", "SERVER_HOST": "127.0.0.1",
            "SERVER_PORT": "0", "SERVE_MAX_NEW": "32"}
# prompts of 19 and 0 bytes: widths 32 and 16 (an empty prompt is [0])
GREEDY = [{"prompt": "hello from the card", "max_tokens": 8},
          {"prompt": "", "max_tokens": 20}]
SAMPLED = {"prompt": "sample me", "max_tokens": 12, "temperature": 0.8,
           "top_p": 0.9, "seed": 7}


@contextlib.contextmanager
def serving(env: dict):
    """A warmed server on an ephemeral port, answering in a thread
    → (its ServingState, port); shut down on exit."""
    from tpu_kubernetes_torch.serve.server import make_server

    server = make_server(env)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        state = server.RequestHandlerClass.state
        check(state.device.type == "cuda", "the server is not on the card")
        yield state, server.server_address[1]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)


def record_ids(state) -> list:
    """Keep the token ids of each completion ``state`` renders."""
    seen, inner = [], state.decode_text

    def decode_text(ids):
        seen.append(list(ids))
        return inner(ids)

    state.decode_text = decode_text
    return seen


def phase_http(torch, fa) -> int:
    """Three completions over HTTP at the default bf16 (the main path);
    then the greedy ones again at f32, where kernel and plain differ by
    summation order only, held token for token against a ServingState
    on the same weights whose prefill takes the plain lane."""
    with serving(HTTP_ENV) as (state, port):
        # -- the main path: the count at 0 just before, read just after --
        fa.flash_fwd_cuda.launches = 0
        code, health = _request(port, "GET", "/healthz")
        check(code == 200 and health.get("status") == "ok",
              f"/healthz {code} {health}")
        for body in [*GREEDY, SAMPLED]:
            code, out = _request(port, "POST", "/v1/completions", body)
            say(f"http /v1/completions {json.dumps(body)} -> {code} "
                f"tokens={out.get('tokens')} "
                f"finish={out.get('finish_reason')}")
            check(code == 200, f"/v1/completions {code}: {out}")
            check(out["tokens"] == body["max_tokens"],
                  f"tokens {out['tokens']} != max_tokens {body['max_tokens']}")
        launches = fa.flash_fwd_cuda.launches
        # -------------------------------------------------------------------
    check(launches > 0, "the HTTP requests never launched the kernel")
    say(f"http: 3 completions on the card, {launches} kernel launches")

    with serving({**HTTP_ENV, "SERVE_DTYPE": "float32"}) as (state, port):
        plain = copy.copy(state)
        plain.cfg = replace(state.cfg, use_kernel=False)
        plain._lock = threading.Lock()
        served, ref = record_ids(state), record_ids(plain)
        mark = fa.flash_fwd_cuda.launches
        for body in GREEDY:
            code, out = _request(port, "POST", "/v1/completions", body)
            check(code == 200, f"/v1/completions f32 {code}: {out}")
        check(fa.flash_fwd_cuda.launches > mark,
              "the f32 server never launched the kernel")
        mark = fa.flash_fwd_cuda.launches
        for body in GREEDY:
            plain.complete(body["prompt"], body["max_tokens"])
        check(fa.flash_fwd_cuda.launches == mark,
              "the plain lane launched the kernel")
    say(f"http f32 greedy token ids, kernel lane {served} vs plain lane "
        f"{ref}: {'identical' if served == ref else 'DIFFER'}")
    check(served == ref, "greedy HTTP completions through the kernel differ "
                         "from the plain lane's")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (HERE / "tpu_kubernetes_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout that holds "
              "tpu_kubernetes_torch/", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from tpu_kubernetes_torch.ops import _build

    # the module, not the dispatcher that ops/__init__ re-exports by its name
    fa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")

    check(Path(fa.__file__).resolve().is_relative_to(HERE),
          f"imported the port from {fa.__file__}, not from this checkout")
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say(f"card: {card}")
    say(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # one kernel source so far: its build is the first load of the process
    cached = _build.library_path("flash_fwd").exists()
    t0 = time.perf_counter()
    fa.load_kernel()
    say(f"build: flash_fwd {time.perf_counter() - t0:.2f} s"
        f"{' (library already built)' if cached else ''}")

    entry = phase_kernel(torch, fa)
    entry["launches"] = phase_llama_1b(torch, fa, card)
    phase_http(torch, fa)

    say(json.dumps({"kernels": [entry]}))
    say(card)                        # name, power limit as nvidia-smi says
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # noqa: BLE001 — any failed phase fails the run
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        sys.exit(1)
