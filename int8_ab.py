#!/usr/bin/env python3
"""Int8 serving of this checkout against another checkout's (the commit
before a change to it), on one CUDA card, in one call.

    python3 int8_ab.py OTHER_CHECKOUT
    python3 int8_ab.py --side CHECKOUT   # one side alone

Each side runs in a fresh process that imports ``tpu_kubernetes_torch``
from its checkout, so each builds its own kernels into its own
``build/``; the sides run in turns (other, this, this, other). A side
times, each a CUDA graph of back-to-back calls on its port's default
routes:

* the weight-only int8 matmul at llama-1b's five weight shapes, 8 rows
  (and 4, the solo lane's), beside a bf16 ``torch.matmul`` of the shape,
  with its error against the plain version;
* decode attention over an int8 cache at ``chip_smoke.py``'s
  ``q8_cases`` shapes, beside ``decode_attention_tc`` on the same cache
  in bf16 (same layout), with its error against the plain version;
* the int8 KV cache's quantize on write alone (``_quantize_pair``, once a
  layer, at the solo lane's 4 rows), 16 layers a step;
* llama-1b's solo lane, 4 ragged rows x 1,024 + 63 greedy steps, int8
  (weights and cache) and bf16 in turns: prefill ms, decode ms/step;
* the engine traffic (16 requests) through the int8 paged engine and the
  bf16 paged engine: tokens/s (best turn), ms a segment.

Besides, each side writes a digest of the bf16 routes' outputs
(``decode_attention_tc`` at the bf16 shapes above, ``flash_fwd_tc`` and
``gmm_forward_tc`` at one shape each) and of the CUDA-core int8 decode
attention's (``q8``, forced where the port takes a route argument): equal
digests on both sides mean the same bits. The helpers are this checkout's
``chip_smoke.py``; the port they drive is the side's.

Prints each number of both checkouts in turn order, then one JSON line of
everything with the card's name and power limit. Exits non-zero if a
side fails or finds no card.
"""

from __future__ import annotations

import hashlib
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TAG = "int8_ab: "
W8_SHAPES = ((2048, 2048), (2048, 1024), (2048, 5632), (5632, 2048),
             (2048, 32000))
W8_ROWS = (8, 4)


def load_smoke():
    """This checkout's chip_smoke.py as a module of helpers (its main is
    not run), whatever checkout sits first on sys.path."""
    spec = importlib.util.spec_from_file_location("chip_smoke_helpers",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def digest(torch, *ts) -> str:
    """A digest of tensors' bytes: equal digests, equal bits."""
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def w8_side(torch, smoke, card) -> dict:
    from tpu_kubernetes_torch.models.quant import _quantize_leaf

    tw8 = importlib.import_module("tpu_kubernetes_torch.ops.w8_matmul")
    dev = torch.device("cuda")
    out = {}
    for K, N in W8_SHAPES:
        g = torch.Generator(device=dev).manual_seed(K + N)
        ws = [torch.randn((K, N), generator=g, device=dev) * 0.02
              for _ in range(smoke.DECODE_COPIES)]
        leaves = [_quantize_leaf(w) for w in ws]
        wide = [w.to(torch.bfloat16) for w in ws]
        del ws
        for m in W8_ROWS:
            x = torch.randn((m, K), generator=g, device=dev).to(torch.bfloat16)
            ref = tw8.w8_matmul_reference(x, leaves[0]["q"], leaves[0]["s"])
            got = tw8.w8_matmul_cuda(x, leaves[0]["q"], leaves[0]["s"])
            diff = (got.float() - ref.float()).abs()
            smoke.check(bool((diff <= smoke.w8_tol(torch, ref)).all()),
                        f"w8_matmul {K}x{N} {m} rows: beyond one ulp")
            counter = iter(range(10 ** 9))

            def kernel():
                leaf = leaves[next(counter) % smoke.DECODE_COPIES]
                return tw8.w8_matmul_cuda(x, leaf["q"], leaf["s"])

            def yard():
                return x @ wide[next(counter) % smoke.DECODE_COPIES]

            ms = smoke.graph_ms(torch, kernel, 40)
            yard_ms = smoke.graph_ms(torch, yard, 40)
            b_ms, _ = smoke.bound(2 * m * K * N, K * N + 4 * N
                                  + m * (K + N) * 2, "bfloat16")
            label = f"w8 {K}x{N}, {m} rows"
            out[label] = {"ms": ms, "matmul_ms": yard_ms, "bound_ms": b_ms,
                          "max_abs_err": diff.max().item()}
            smoke.say(f"{TAG}{label}: {ms:.4f} ms (bf16 matmul "
                      f"{yard_ms:.4f}, bound {b_ms:.4f}) [{card}]")
        del leaves, wide
        torch.cuda.empty_cache()
    return out


def q8_side(torch, smoke, card) -> tuple[dict, dict]:
    tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    forceable = "route" in inspect.signature(
        tda.decode_attention_cuda).parameters
    out, digests = {}, {}
    for case in smoke.q8_cases(torch):
        q, lim, pl, ps, table = (case[k] for k in ("q", "limits", "pl", "ps",
                                                   "table"))
        counter = iter(range(10 ** 9))

        def kernel(i, case=case, route=None):
            k8, v8, ks, vs = case["calls"][i % smoke.DECODE_COPIES]
            kw = {"route": route} if route else {}
            return tda.decode_attention_cuda(q, k8, v8, lim, pl, ps,
                                             table=table, k_scale=ks,
                                             v_scale=vs, **kw)

        k8, v8, ks, vs = case["calls"][0]
        ref = tda.decode_attention_reference(q, k8, v8, lim, pl, ps, table,
                                             ks, vs)
        err = (kernel(0).float() - ref.float()).abs().max().item()
        smoke.check(err <= smoke.decode_tol(torch, ref),
                    f"{case['label']}: max abs err {err}")
        ms = smoke.graph_ms(torch, lambda: kernel(next(counter)), 40)
        digests[f"q8 {case['label']}"] = digest(
            torch, kernel(0, route="q8" if forceable else None))
        tc_ms = None
        rep = q.shape[1] // case["dense"][0][0].shape[1]
        if tda._route(q.dtype, q.shape[3], rep) == "tc":
            def tc(i, case=case):
                k, v = case["wide"][i % smoke.DECODE_COPIES]
                return tda.decode_attention_cuda(q, k, v, lim, pl, ps,
                                                 table=table)
            tc_ms = smoke.graph_ms(torch, lambda: tc(next(counter)), 40)
            digests[f"tc {case['label']}"] = digest(torch, tc(0))
        b_ms, _ = smoke.bound(0, case["nbytes"], str(q.dtype)[6:])
        out[case["label"]] = {"ms": ms, "tc_bf16_ms": tc_ms,
                              "bound_ms": b_ms, "max_abs_err": err}
        yard = f", tc on bf16 {tc_ms:.4f}" if tc_ms is not None else ""
        smoke.say(f"{TAG}decode attention int8 {case['label']}: {ms:.4f} ms"
                  f"{yard} (bound {b_ms:.4f}) [{card}]")
        torch.cuda.empty_cache()
    return out, digests


def bf16_digests(torch) -> dict:
    """The bf16 flash forward and grouped forward at one shape each."""
    fa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
    gm = importlib.import_module("tpu_kubernetes_torch.ops.grouped_matmul")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn((2, 4, 512, 128), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    o, lse = fa.flash_fwd_cuda(q, k, v, True, 128 ** -0.5)
    lhs = torch.randn((1024, 1024), generator=g, device=dev).to(torch.bfloat16)
    rhs = torch.randn((4, 1024, 512), generator=g, device=dev).to(
        torch.bfloat16)
    sizes = torch.tensor([300, 0, 500, 224], dtype=torch.int32, device=dev)
    y = gm.gmm_cuda(lhs, rhs, sizes)
    return {"flash_fwd_tc": digest(torch, o, lse),
            "gmm_forward_tc": digest(torch, y)}


def quantize_on_write_ms(torch, smoke, cfg) -> float:
    """The int8 cache's quantize on write alone, a decode step's worth:
    16 layers of _quantize_pair at the solo lane's 4 rows, one position."""
    from tpu_kubernetes_torch.models.decode import _quantize_pair

    dev = torch.device("cuda")
    shape = (4, cfg.n_kv_heads, 1, cfg.head_dim)
    kv = [(torch.randn(shape, device=dev).to(cfg.dtype),
           torch.randn(shape, device=dev).to(cfg.dtype))
          for _ in range(cfg.n_layers)]

    def step():
        for k, v in kv:
            _quantize_pair(k, v)

    return smoke.graph_ms(torch, step, 10)


def serving_side(torch, smoke, card) -> dict:
    """llama-1b int8 beside bf16: the solo lane in turns, the quantize on
    write, the paged engines in turns."""
    from tpu_kubernetes_torch.models import CONFIGS, init_params
    from tpu_kubernetes_torch.models.decode import page_bytes
    from tpu_kubernetes_torch.models.quant import quantize_for_decode
    from tpu_kubernetes_torch.serve.server import ContinuousEngine, GreedyLane

    dev = torch.device("cuda")
    cfg = CONFIGS["llama-1b"]
    gen = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, gen, dev)
    qparams = quantize_for_decode(params, cfg)
    b, width, new = 4, 1024, 64
    rows = torch.randint(0, cfg.vocab_size, (b, width), generator=gen,
                         device=dev, dtype=torch.int32)
    lengths = torch.tensor([1024, 1000, 777, 333], dtype=torch.int32,
                           device=dev)
    lanes = {"bf16": GreedyLane(params, cfg),
             "int8": GreedyLane(qparams, cfg, kv_quant=True)}
    for lane in lanes.values():
        smoke.serve_run(torch, lane, rows, lengths, new)        # captures
    times = {v: [] for v in lanes}
    for rep in range(smoke.REPEATS):
        for v in (list(lanes) if rep % 2 == 0 else list(reversed(lanes))):
            _, pf, dec = smoke.serve_run(torch, lanes[v], rows, lengths, new)
            times[v].append({"prefill_ms": pf, "decode_ms_step": dec})
    del lanes
    torch.cuda.empty_cache()
    out = {"solo": times,
           "quantize_on_write_ms_step": quantize_on_write_ms(torch, smoke,
                                                             cfg)}
    for v in ("bf16", "int8"):
        smoke.say(f"{TAG}solo lane {v}: prefill ms "
                  f"{smoke.spread([t['prefill_ms'] for t in times[v]])}; "
                  f"decode ms/step "
                  f"{smoke.spread([t['decode_ms_step'] for t in times[v]])} "
                  f"[{card}]")
    smoke.say(f"{TAG}quantize on write, 16 layers at 4 rows: "
              f"{out['quantize_on_write_ms_step']:.4f} ms a step [{card}]")

    requests = smoke.engine_requests(torch, cfg, 16, seed=1)
    pages = smoke.INT8_POOL_PAGES
    engines = {
        "int8 paged": ContinuousEngine(
            GreedyLane(qparams, cfg, kv_quant=True), slots=smoke.ENGINE_SLOTS,
            seg_steps=smoke.ENGINE_STEPS,
            pool_mb=pages * page_bytes(cfg, smoke.DECODE_PAGE, True) / 2 ** 20,
            page_size=smoke.DECODE_PAGE),
        "bf16 paged": ContinuousEngine(
            GreedyLane(params, cfg), slots=smoke.ENGINE_SLOTS,
            seg_steps=smoke.ENGINE_STEPS,
            pool_mb=pages * page_bytes(cfg, smoke.DECODE_PAGE) / 2 ** 20,
            page_size=smoke.DECODE_PAGE)}
    seg_ms = {v: [] for v in engines}
    for v, eng in engines.items():
        eng.warm()
        inner = eng._run_segment

        def run(eng=eng, v=v, inner=inner):
            before = eng.segments
            t0 = time.perf_counter()
            inner()
            if eng.segments > before:
                seg_ms[v].append((time.perf_counter() - t0) * 1e3)
        eng._run_segment = run
        smoke.engine_turn(eng, requests)                        # warm turn
        smoke.wait_idle(eng)
        seg_ms[v].clear()
    walls, tokens = {v: [] for v in engines}, {}
    for v in (*engines, *reversed(engines)):
        got, wall = smoke.engine_turn(engines[v], requests)
        smoke.wait_idle(engines[v])
        walls[v].append(wall)
        tokens[v] = sum(len(t) for t in got)
    for eng in engines.values():
        eng.close()
    out["engines"] = {}
    for v in engines:
        med = sorted(seg_ms[v])[len(seg_ms[v]) // 2]
        out["engines"][v] = {"tokens": tokens[v], "walls_s": walls[v],
                             "tokens_s": tokens[v] / min(walls[v]),
                             "ms_segment": med}
        smoke.say(f"{TAG}engine {v}: {tokens[v] / min(walls[v]):.1f} tokens/s "
                  f"(best turn), {med:.3f} ms a segment [{card}]")
    return out


def side(root: Path) -> dict:
    """One side's numbers, from the port of ``root``."""
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("int8_ab: no CUDA device")
    sys.path.insert(0, str(root))
    smoke = load_smoke()
    tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")
    if not Path(tda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {tda.__file__}, not the port of {root}")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.card_line()
    importlib.import_module("tpu_kubernetes_torch.ops._build").build()
    w8 = w8_side(torch, smoke, card)
    q8, digests = q8_side(torch, smoke, card)
    digests.update(bf16_digests(torch))
    return {"card": card, "w8": w8, "q8": q8, "digests": digests,
            "serving": serving_side(torch, smoke, card)}


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
    first = runs[0][1]
    for label in first["w8"]:
        print(f"{TAG}{label}: " + ", ".join(
            f"{n} {r['w8'][label]['ms']:.4f}" for n, r in runs)
            + f" ms (bf16 matmul {first['w8'][label]['matmul_ms']:.4f}, "
              f"bound {first['w8'][label]['bound_ms']:.4f})")
    for label in first["q8"]:
        print(f"{TAG}decode attention int8 {label}: " + ", ".join(
            f"{n} {r['q8'][label]['ms']:.4f}" for n, r in runs) + " ms")
    for v in ("bf16", "int8"):
        print(f"{TAG}solo lane {v} decode ms/step: " + ", ".join(
            f"{n} " + "/".join(f"{t['decode_ms_step']:.3f}"
                               for t in r["serving"]["solo"][v])
            for n, r in runs))
    print(f"{TAG}quantize on write ms a step: " + ", ".join(
        f"{n} {r['serving']['quantize_on_write_ms_step']:.4f}"
        for n, r in runs))
    for v in first["serving"]["engines"]:
        print(f"{TAG}engine {v} tokens/s: " + ", ".join(
            f"{n} {r['serving']['engines'][v]['tokens_s']:.1f}"
            for n, r in runs))
    differ = sorted(k for k in first["digests"]
                    if len({r["digests"].get(k) for _, r in runs}) != 1)
    print(f"{TAG}digests equal on both sides: "
          f"{len(first['digests']) - len(differ)} of {len(first['digests'])}"
          f"{'; differ: ' + ', '.join(differ) if differ else ''}")
    print(json.dumps({"card": first["card"], "runs": runs,
                      "digests_differ": differ}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
