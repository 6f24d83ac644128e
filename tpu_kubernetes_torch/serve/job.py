"""The batch inference job and the model bring-up for serving (port of
``tpu_kubernetes/serve/job.py``): prompts file in, completions out.

    python -m tpu_kubernetes_torch.serve.job

The serving counterpart of ``train/job.py``, what a serving pod runs. The
prompts are tokenized, right-padded to one static width (ragged: each row
generates from its own last real token), batched to a fixed row count,
and generated through ONE compiled program for the whole file (the
sampled lane's ``("generate", ...)`` program of ``serve/server.py``: on
the card a CUDA graph captured by the first batch and replayed by the
rest), greedy or sampled. The env contract, with the reference's
defaults and errors:

  SERVE_HF_CHECKPOINT  LOCAL transformers checkpoint (Llama or Mixtral)
                       to serve, through ``models/convert_hf.load_hf``
                       (bf16; needs the ``transformers`` package)
  SERVE_MODEL          preset name, dense or MoE (default llama-test),
                       random init from a fixed seed — smoke/bring-up mode
  SERVE_TOKENIZER      'byte' (default) or 'hf:<local path>'
  SERVE_DTYPE          'float32' | 'bfloat16': override the compute dtype
                       (f32 makes greedy responses comparable bitwise)
  SERVE_DEVICE         torch device to serve on (default 'cuda'; 'cpu'
                       only when asked)
  SERVE_QUANT          'int8': weight-only int8 export of the matmul
                       weights after the dtype cast (models/quant.py;
                       the weight-only int8 matmul kernel on the card)
  SERVE_KV_QUANT       =1: int8 KV cache for the generate program (half
                       the cache bytes a decode step reads; refused in
                       the speculative modes, whose verification runs a
                       full-precision cache)
  SERVE_PROMPTS        path to a UTF-8 text file, one prompt per line
  SERVE_OUT            output path ('-' = stdout, default); one completion
                       per line, same order (newlines inside a completion
                       escaped as \\n so line i always pairs with prompt i)
  SERVE_BATCH          rows per program call (default 8; the last batch
                       pads with repeats, extras dropped)
  SERVE_MAX_NEW        tokens to generate per prompt (default 64)
  SERVE_CACHE_SPAN     pin the KV-cache span (default: the longest prompt
                       + SERVE_MAX_NEW); the span changes the attention
                       reduction order, so pinning it makes runs
                       comparable bitwise across pipelines
  SERVE_TEMPERATURE / SERVE_TOP_K / SERVE_TOP_P / SERVE_SEED
                       sampling; the program's generator is seeded once
                       from SERVE_SEED and its draws carry on from batch
                       to batch (they differ from ``jax.random``'s)
  SERVE_EOS_ID         stop rows at this token (emitted tokens after it
                       are dropped from the text)
  SERVE_PROMPT_LOOKUP  speculative decoding without a draft model: each
                       prompt alone (batch 1, greedy) through
                       ``models/speculative.py``'s prompt_lookup_generate
  SERVE_DRAFT_MODEL    speculative decoding with a draft preset (random
                       init from seed 1, smoke mode): speculative_generate;
                       it wins when both are set
  SERVE_DRAFT_HF_CHECKPOINT
                       the draft from a LOCAL transformers checkpoint
                       instead (it wins over SERVE_DRAFT_MODEL); either
                       draft runs in the target's dtype
  SERVE_DRAFT_K        proposals a round (default 8 for lookup, 4 for a
                       draft; at most 15, the verify window's chunk route)
  SERVE_NGRAM          the lookup's n-gram length (default 2)
  SERVE_DRAFT_KV_QUANT =1: int8 KV cache for the DRAFT model only
                       (proposals only: the output is unchanged); needs
                       SERVE_DRAFT_MODEL
  SERVE_MESH           e.g. 'tensor=4' or 'data=2,tensor=2' (default:
                       tensor over every card of every host; on the CPU
                       one rank a host). A mesh of more than one device
                       serves through ``parallel/serving.py``
                       ``make_sharded_generate``: the job spawns one
                       worker a rank (NCCL on the cards, the generate
                       program one CUDA graph; gloo on SERVE_DEVICE=cpu,
                       one rank a core), every worker builds the whole
                       serving stack from the one seed (SERVE_QUANT
                       included), keeps its shards and runs the batches;
                       only rank 0 logs and writes SERVE_OUT. On one host
                       a mesh smaller than the host takes its first
                       devices; on several the mesh covers every card.
                       A mesh that wants more devices than exist fails
                       ("SERVE_MESH {...} wants N devices, have M") before
                       any worker starts.
  JAX_NUM_PROCESSES / JAX_PROCESS_ID / JAX_COORDINATOR_ADDRESS
                       the provisioner's multi-host contract
                       (``parallel/distributed.py``): the hosts' workers
                       join one world; only process 0 writes

Speculation is greedy and token-exact: the completions are the plain
greedy job's at the span of each prompt + SERVE_MAX_NEW + SERVE_DRAFT_K;
each round is one compiled program, kept across the prompts. The
speculative modes stay single-device, as in the reference: SERVE_MESH is
checked, then each process serves every prompt alone.
"""

from __future__ import annotations

import math
import os
import sys
import time
from dataclasses import replace
from pathlib import Path

import torch

from tpu_kubernetes_torch.models import CONFIGS, init_params
from tpu_kubernetes_torch.models.quant import quantize_for_decode
from tpu_kubernetes_torch.train.corpus import resolve_tokenizer
from tpu_kubernetes_torch.util.envparse import (
    env_bool,
    env_float,
    env_int,
)

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def log(*args) -> None:
    """Print a job line; in a sharded job, on rank 0 alone."""
    from tpu_kubernetes_torch.parallel.mesh import this_rank

    if this_rank() == 0:
        print("[serve]", *args, file=sys.stderr, flush=True)


def truthy_env(env: dict, name: str) -> bool:
    """The SERVE_* falsy-string rule ("", "0", "false", "no", "off")."""
    return env_bool(name, env=env)


def refuse_knobs(env: dict, knobs: dict) -> None:
    """Raise ValueError for a knob of ``knobs`` (name → (how the reference
    reads it, its default there, the ROADMAP.md item that brings it)) set
    to anything but the reference's default, so a deployment never gets
    a different program than it asked for."""
    for name, (read, default, item) in knobs.items():
        if read(name, default, env=env) != default:
            raise ValueError(
                f"{name}={env.get(name)!r} is not supported by the PyTorch "
                f"port yet: it arrives with ROADMAP.md {item}")


def _detokenizer(spec: str):
    """Inverse of train/corpus.py's tokenizers: ids → text."""
    if spec == "byte":
        return lambda ids: bytes(ids).decode("utf-8", errors="replace")
    if spec.startswith("hf:"):
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(
            spec[3:], local_files_only=True
        )
        return lambda ids: tok.decode(list(ids), skip_special_tokens=True)
    raise ValueError(f"unknown tokenizer {spec!r}")


def _cast(tree: dict, dtype: torch.dtype) -> dict:
    return {
        k: _cast(v, dtype) if isinstance(v, dict) else v.to(dtype)
        for k, v in tree.items()
    }


def load_hf_checkpoint(knob: str, path: str, device: torch.device):
    """``load_hf`` of the checkpoint a knob names → (params, cfg); a
    checkpoint that cannot be read raises SystemExit naming the knob."""
    from tpu_kubernetes_torch.models.convert_hf import ConvertError, load_hf

    try:
        return load_hf(path, device=device)
    except (ConvertError, OSError) as e:
        raise SystemExit(f"{knob}={path!r}: {e}") from e


def load_serving_stack(env: dict):
    """SERVE_MODEL / SERVE_HF_CHECKPOINT / SERVE_TOKENIZER / SERVE_DTYPE /
    SERVE_DEVICE / SERVE_QUANT → (params, cfg, encode, decode_text),
    params on the serving device (SERVE_QUANT=int8: the matmul weights
    int8-quantized after the dtype cast)."""
    quant = env.get("SERVE_QUANT", "")
    if quant not in ("", "int8"):
        raise SystemExit(f"SERVE_QUANT must be 'int8' or unset, got "
                         f"{quant!r}")
    device = torch.device(env.get("SERVE_DEVICE", "") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"SERVE_DEVICE={device} but torch sees no CUDA device "
            "(SERVE_DEVICE=cpu serves on the CPU)"
        )
    tok_spec = env.get("SERVE_TOKENIZER", "byte")
    encode, vocab = resolve_tokenizer(tok_spec)
    decode_text = _detokenizer(tok_spec)

    hf_path = env.get("SERVE_HF_CHECKPOINT", "")
    t0 = time.perf_counter()
    if hf_path:
        params, cfg = load_hf_checkpoint("SERVE_HF_CHECKPOINT", hf_path,
                                         device)
        log(f"loaded HF checkpoint {hf_path} on {device} in "
            f"{time.perf_counter() - t0:.1f}s")
    else:
        name = env.get("SERVE_MODEL", "llama-test")
        if name not in CONFIGS:
            raise SystemExit(
                f"unknown SERVE_MODEL {name!r} (the port serves the dense "
                f"and MoE presets {sorted(CONFIGS)})"
            )
        cfg = CONFIGS[name]
        generator = torch.Generator(device=device).manual_seed(0)
        params = init_params(cfg, generator, device)
        log(f"random-init {name} on {device} in "
            f"{time.perf_counter() - t0:.1f}s (smoke mode — set "
            "SERVE_HF_CHECKPOINT for real weights)")
    dtype_env = env.get("SERVE_DTYPE", "")
    if dtype_env:
        # serve above (or below) the preset's storage precision: the
        # weights are drawn in the preset's dtype, then cast
        if dtype_env not in DTYPES:
            raise SystemExit(
                f"SERVE_DTYPE must be one of {sorted(DTYPES)}, "
                f"got {dtype_env!r}"
            )
        cfg = replace(cfg, dtype=DTYPES[dtype_env])
        params = _cast(params, cfg.dtype)
    if vocab > cfg.vocab_size:
        raise SystemExit(
            f"tokenizer vocab {vocab} exceeds model vocab {cfg.vocab_size}"
        )
    if vocab < cfg.vocab_size:
        raise SystemExit(
            f"tokenizer vocab {vocab} cannot render model vocab "
            f"{cfg.vocab_size} — pass the model's own tokenizer "
            "(SERVE_TOKENIZER=hf:<path>)"
        )
    if quant == "int8":
        params = quantize_for_decode(params, cfg)
        log("int8 weight-only export")
    return params, cfg, encode, decode_text


def _read_prompts(env: dict) -> list[str]:
    prompts_path = env.get("SERVE_PROMPTS", "")
    if not prompts_path:
        raise SystemExit("SERVE_PROMPTS must point at a prompts file")
    prompts = Path(prompts_path).read_text(encoding="utf-8").splitlines()
    if not prompts:
        raise SystemExit(f"{prompts_path} holds no prompts")
    return prompts


def _mesh_plan(env: dict, device: torch.device) -> tuple[dict, int]:
    """SERVE_MESH as the reference reads it → (mesh shape, its devices).
    The devices are every card of every host on ``cuda``; on ``cpu`` one
    gloo rank a core on one host, one a host over several, and the
    default mesh one rank a host. On one host a smaller mesh takes a
    prefix of the devices; over several it covers them all. A mesh that
    does not fit raises SystemExit with the reference's message."""
    from tpu_kubernetes_torch.parallel import (
        device_prefix_for,
        parse_mesh_shape,
        read_env,
    )
    from tpu_kubernetes_torch.train.job import cores_here

    hosts = read_env(env).num_processes
    spec = env.get("SERVE_MESH", "")
    if device.type == "cuda":
        n = default = hosts * torch.cuda.device_count()
    else:
        n, default = (cores_here() if hosts == 1 else hosts), hosts
    try:
        shape = parse_mesh_shape(spec) if spec else {"tensor": default}
        device_prefix_for(shape, list(range(n)), allow_partial=hosts == 1,
                          label="SERVE_MESH")
    except ValueError as e:
        raise SystemExit(str(e)) from e
    total = math.prod(v for v in shape.values() if v)
    if hosts > 1 and total != n:
        raise SystemExit(f"SERVE_MESH {dict(shape)} wants {total} devices, "
                         f"have {n} (a mesh over several hosts covers "
                         f"every device)")
    if total < n and total > 1:
        log(f"partial-host mesh: {total} of {n} devices")
    return shape, total


def _speculative(env: dict) -> bool:
    """A speculative mode is asked for (SERVE_DRAFT_* or
    SERVE_PROMPT_LOOKUP)."""
    return bool(env.get("SERVE_DRAFT_HF_CHECKPOINT", "")
                or env.get("SERVE_DRAFT_MODEL", "")
                or truthy_env(env, "SERVE_PROMPT_LOOKUP"))


def run_serving(env: dict | None = None) -> list[str]:
    """The whole job; ``env`` defaults to os.environ (injectable for
    tests). → the completions, also written to SERVE_OUT (by process 0
    alone); a sharded job's other hosts return []. Logs the generate
    program's captures and replays (1 and the batches − 1) and the
    tokens/s line. A mesh of more than one device (SERVE_MESH,
    JAX_NUM_PROCESSES) spawns one worker a rank (:func:`_serve_worker`),
    except in the speculative modes, which are single-device."""
    env = dict(os.environ if env is None else env)
    _read_prompts(env)
    device = torch.device(env.get("SERVE_DEVICE", "") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"SERVE_DEVICE={device} but torch sees no CUDA device "
            "(SERVE_DEVICE=cpu serves on the CPU)"
        )
    shape, total = _mesh_plan(env, device)
    if total == 1 or _speculative(env):
        if total > 1:
            log(f"SERVE_MESH={dict(shape)} unused: the speculative modes "
                "serve on one device")
        return _serve(env)
    from tpu_kubernetes_torch.train.job import _spawn

    log(f"mesh={dict(shape)}: {total} ranks")
    result = _spawn(env, time.time(), shape, {}, total,
                    torch.device(device.type), target=_serve_worker)
    return result if isinstance(result, list) else []


def _serve_worker(env: dict, t_start: float, shape: dict, dcn: dict,
                  device: torch.device) -> list[str]:
    """One rank of a sharded job (the train job's ``_spawn`` target): the
    mesh over the world, then :func:`_serve` on this rank's device."""
    del t_start, dcn
    from tpu_kubernetes_torch.parallel import create_mesh

    return _serve(dict(env, SERVE_DEVICE=str(device)), create_mesh(shape))


def _serve(env: dict, mesh=None) -> list[str]:
    """The job on this process: one device, or (``mesh``) this rank of
    the sharded job."""
    from tpu_kubernetes_torch.parallel import read_env
    from tpu_kubernetes_torch.parallel.mesh import this_rank

    prompts = _read_prompts(env)
    params, cfg, encode, decode_text = load_serving_stack(env)
    # the lanes live with the server, which imports this module
    from tpu_kubernetes_torch.serve.server import (
        GreedyLane,
        SampledLane,
        _pad_rows,
    )

    max_new = env_int("SERVE_MAX_NEW", 64, env=env)
    batch_rows = env_int("SERVE_BATCH", 8, env=env)
    eos_env = env.get("SERVE_EOS_ID", "")
    eos_id = int(eos_env) if eos_env else None

    token_rows = [encode(p) for p in prompts]
    if any(not r for r in token_rows):
        raise SystemExit("empty prompt line — every line must tokenize "
                         "to at least one token")
    width = max(len(r) for r in token_rows)
    if width + max_new > cfg.max_seq:
        raise SystemExit(
            f"longest prompt ({width}) + SERVE_MAX_NEW ({max_new}) "
            f"exceeds the model's max_seq {cfg.max_seq}"
        )
    completions: list[str] = []
    n_tokens = 0

    def finish(ids: list) -> None:
        nonlocal n_tokens
        if eos_id is not None and eos_id in ids:
            ids = ids[:ids.index(eos_id)]
        n_tokens += len(ids)
        completions.append(decode_text(ids))

    t0 = time.perf_counter()
    kv_quant = truthy_env(env, "SERVE_KV_QUANT")
    spec = _speculative_runner(env, params, cfg, width, max_new, kv_quant)
    if spec is not None:
        run_one, programs, k = spec
        drafted = accepted = 0
        for row in token_rows:
            out, stats = run_one(torch.tensor([row], dtype=torch.int32,
                                              device=params["embed"].device))
            drafted += stats.drafted
            accepted += stats.accepted
            finish(out[0].tolist())
        log(f"speculative: k={k}, accepted {accepted}/{drafted} "
            f"({accepted / max(1, drafted):.0%})")
    else:
        span_env = env.get("SERVE_CACHE_SPAN", "")
        span = int(span_env) if span_env else width + max_new
        knobs = dict(temperature=env_float("SERVE_TEMPERATURE", 0.0,
                                           env=env),
                     top_k=env_int("SERVE_TOP_K", 0, env=env),
                     top_p=env_float("SERVE_TOP_P", 0.0, env=env))
        if mesh is None:
            lane = SampledLane(GreedyLane(params, cfg, eos_id,
                                          kv_quant=kv_quant))
            programs = lane.programs
            generate = lane.generate
        else:
            generate = _sharded_lane(params, cfg, mesh, max_new, span,
                                     eos_id, kv_quant, knobs, batch_rows)
        # seeded once: every later batch's draws carry on from the last
        seed = env_int("SERVE_SEED", 0, env=env)
        for start in range(0, len(token_rows), batch_rows):
            rows = token_rows[start:start + batch_rows]
            n_real = len(rows)
            rows = rows + [rows[-1]] * (batch_rows - n_real)   # pad
            lengths = torch.tensor([len(r) for r in rows], dtype=torch.int32)
            out = generate(_pad_rows(rows, width), lengths, max_new,
                           span, seed=seed if start == 0 else None,
                           **knobs)
            for ids in out[:n_real].tolist():
                finish(ids)
        if mesh is not None:
            programs = generate.programs
    dt = time.perf_counter() - t0
    log(f"{'speculative programs' if spec else 'generate program'}: "
        f"captures {programs.captures}, replays {programs.replays}")
    log(f"{len(prompts)} prompts, {n_tokens} tokens "
        f"in {dt:.1f}s ({n_tokens / dt:.0f} tok/s)")

    out_path = env.get("SERVE_OUT", "-")
    # keep the line↔prompt pairing exact no matter what the model emits
    escaped = [
        c.replace("\\", "\\\\").replace("\n", "\\n").replace("\r", "\\r")
        for c in completions
    ]
    text = "\n".join(escaped) + "\n"
    if this_rank() == 0 and read_env(env).process_id == 0:
        # every rank and process holds the same completions; one writes
        if out_path == "-":
            sys.stdout.write(text)
        else:
            Path(out_path).write_text(text, encoding="utf-8")
            log(f"wrote {out_path}")
    return completions


def _sharded_lane(params: dict, cfg, mesh, max_new: int, span: int,
                  eos_id: int | None, kv_quant: bool, knobs: dict,
                  batch_rows: int):
    """The job's batches through ``make_sharded_generate`` on this rank:
    the whole params cut to the rank's shards, each batch's rows to the
    rank's block → (generate(padded rows, lengths, max_new, span, seed,
    **knobs) → the whole batch's tokens, the program cache's view)."""
    from tpu_kubernetes_torch.parallel import (
        check_serving_mesh,
        make_sharded_generate,
    )
    from tpu_kubernetes_torch.parallel.mesh import (
        shard_tensor,
        this_rank,
        tree_map_shardings,
    )

    try:
        check_serving_mesh(cfg, mesh, batch_rows)
    except ValueError as e:
        raise SystemExit(f"SERVE_MESH={dict(mesh.shape)}, SERVE_BATCH="
                         f"{batch_rows}: {e}") from e
    run, p_sh, b_sh = make_sharded_generate(
        cfg, mesh, params, max_new_tokens=max_new, eos_id=eos_id,
        cache_span=span, kv_quant=kv_quant, **knobs)
    rank = this_rank()
    local = tree_map_shardings(lambda t, sh: shard_tensor(t, sh, rank),
                               params, p_sh)
    device = local["embed"].device

    def generate(rows, lengths, max_new, span, seed=None, **_):
        mine = shard_tensor(rows.to(device), b_sh, rank)
        out = run(local, mine, seed, prompt_lengths=lengths.to(device))
        generate.programs = run.programs
        return out

    return generate


def load_draft(draft_hf: str, draft_name: str, dtype: torch.dtype,
               device: torch.device, error: type[Exception],
               check=lambda cfg: None):
    """The draft model of SERVE_DRAFT_HF_CHECKPOINT (which wins) or of the
    SERVE_DRAFT_MODEL preset (random init from seed 1, smoke mode), cast
    to the target's ``dtype`` → (params, cfg). ``check(cfg)`` raises for a
    draft the caller cannot use, before a preset's weights are made; an
    unknown preset raises ``error``."""
    if draft_hf:
        params, cfg = load_hf_checkpoint("SERVE_DRAFT_HF_CHECKPOINT",
                                         draft_hf, device)
        cfg = replace(cfg, dtype=dtype)
        check(cfg)
        log(f"draft: HF checkpoint {draft_hf}")
        return _cast(params, dtype), cfg
    if draft_name not in CONFIGS:
        raise error(f"unknown SERVE_DRAFT_MODEL {draft_name!r} (the port's "
                    f"presets: {sorted(CONFIGS)})")
    cfg = replace(CONFIGS[draft_name], dtype=dtype)
    check(cfg)
    params = init_params(CONFIGS[draft_name], torch.Generator(device=device)
                         .manual_seed(1), device)
    log(f"draft: random-init {draft_name} (smoke mode)")
    return _cast(params, dtype), cfg


def _speculative_runner(env: dict, params: dict, cfg, width: int,
                        max_new: int, kv_quant: bool = False):
    """The speculative modes (the reference's, with its ``SystemExit``
    checks, SERVE_KV_QUANT and SERVE_DRAFT_KV_QUANT among them): None
    without SERVE_PROMPT_LOOKUP or SERVE_DRAFT_MODEL, else
    (run_one(prompt (1, len) int32 → (out, SpecStats)), the Programs all
    prompts share, draft_k)."""
    draft_hf = env.get("SERVE_DRAFT_HF_CHECKPOINT", "")
    draft_name = env.get("SERVE_DRAFT_MODEL", "")
    lookup = truthy_env(env, "SERVE_PROMPT_LOOKUP")
    if truthy_env(env, "SERVE_DRAFT_KV_QUANT") and not (draft_hf
                                                         or draft_name):
        # with no draft model there is no draft cache to quantize
        raise SystemExit(
            "SERVE_DRAFT_KV_QUANT needs a draft model "
            "(SERVE_DRAFT_MODEL / SERVE_DRAFT_HF_CHECKPOINT)")
    if not _speculative(env):
        return None
    if kv_quant:
        # the speculative paths verify on their own full-precision caches
        raise SystemExit(
            "SERVE_KV_QUANT is not supported in speculative/"
            "prompt-lookup modes (exact verification uses a "
            "full-precision cache) — drop one of the knobs")
    from tpu_kubernetes_torch.models import MoEConfig
    from tpu_kubernetes_torch.models.speculative import (
        check_draft_k,
        prompt_lookup_generate,
        speculative_generate,
    )
    from tpu_kubernetes_torch.util.graphs import Programs

    # cheap config rejections first, before any draft weights are made
    if env_float("SERVE_TEMPERATURE", 0.0, env=env) != 0.0:
        raise SystemExit(
            "speculative decoding is greedy: unset SERVE_TEMPERATURE or "
            "drop the SERVE_DRAFT_*/SERVE_PROMPT_LOOKUP config")
    if isinstance(cfg, MoEConfig):
        raise SystemExit(
            "speculative decoding needs a dense TARGET model (MoE chunk "
            "verification is not token-exact); MoE drafts are fine")
    draft_k = env_int("SERVE_DRAFT_K", 8 if lookup else 4, env=env)
    ngram = env_int("SERVE_NGRAM", 2, env=env)
    if draft_k < 1 or ngram < 1:
        raise SystemExit(f"SERVE_DRAFT_K ({draft_k}) and SERVE_NGRAM "
                         f"({ngram}) must be >= 1")
    try:
        check_draft_k(draft_k)
    except ValueError as e:
        raise SystemExit(f"SERVE_DRAFT_K: {e}") from e
    if width + max_new + draft_k > cfg.max_seq:
        raise SystemExit(
            f"longest prompt ({width}) + SERVE_MAX_NEW ({max_new}) + "
            f"SERVE_DRAFT_K ({draft_k}) exceeds the target model's max_seq "
            f"{cfg.max_seq}")
    programs = Programs(params["embed"].device)
    if lookup and (draft_hf or draft_name):
        # drafts only propose, so the choice moves the acceptance rate,
        # never the output (the server's precedence too)
        log("draft: SERVE_PROMPT_LOOKUP and SERVE_DRAFT_* both set — the "
            "draft model proposes (lookup ignored)")
    if not (draft_hf or draft_name):
        log(f"draft: prompt-lookup (ngram={ngram}, no draft model)")
        return (lambda prompt: prompt_lookup_generate(
            params, prompt, cfg, max_new, draft_k=draft_k, ngram=ngram,
            programs=programs)), programs, draft_k

    def check(draft_cfg):
        if draft_cfg.vocab_size != cfg.vocab_size:
            raise SystemExit(
                f"draft vocab {draft_cfg.vocab_size} != target vocab "
                f"{cfg.vocab_size} — the models must share a tokenizer")
        if width + max_new + draft_k > draft_cfg.max_seq:
            raise SystemExit(
                f"longest prompt ({width}) + SERVE_MAX_NEW ({max_new}) + "
                f"SERVE_DRAFT_K ({draft_k}) exceeds the draft model's "
                f"max_seq {draft_cfg.max_seq}")

    draft_params, draft_cfg = load_draft(
        draft_hf, draft_name, cfg.dtype, params["embed"].device, SystemExit,
        check)
    draft_kv = truthy_env(env, "SERVE_DRAFT_KV_QUANT")
    if draft_kv:
        log("draft: int8 KV cache (proposals only — exactness unaffected)")
    return (lambda prompt: speculative_generate(
        params, draft_params, prompt, cfg, draft_cfg, max_new,
        draft_k=draft_k, draft_kv_quant=draft_kv,
        programs=programs)), programs, draft_k


def main() -> int:
    run_serving()
    return 0


if __name__ == "__main__":
    sys.exit(main())
