"""Model and tokenizer bring-up for serving (port of
``load_serving_stack`` and its helpers in ``tpu_kubernetes/serve/job.py``).

The env contract this slice reads:

  SERVE_MODEL          preset name, dense or MoE (default llama-test),
                       random init from a fixed seed — smoke/bring-up mode
  SERVE_TOKENIZER      'byte' (default) or 'hf:<local path>'
  SERVE_DTYPE          'float32' | 'bfloat16': override the compute dtype
                       (f32 makes greedy responses comparable bitwise)
  SERVE_DEVICE         torch device to serve on (default 'cuda'; 'cpu'
                       only when asked)

SERVE_HF_CHECKPOINT (local checkpoints) and SERVE_QUANT (int8 weights)
are refused with a one-line error until their slices of the port land.
The batch-inference entry point of the reference is not ported yet.
"""

from __future__ import annotations

import sys
import time
from dataclasses import replace

import torch

from tpu_kubernetes_torch.models import CONFIGS, init_params
from tpu_kubernetes_torch.train.corpus import resolve_tokenizer
from tpu_kubernetes_torch.util.envparse import env_bool

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def log(*args) -> None:
    print("[serve]", *args, file=sys.stderr, flush=True)


def truthy_env(env: dict, name: str) -> bool:
    """The SERVE_* falsy-string rule ("", "0", "false", "no", "off")."""
    return env_bool(name, env=env)


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


def load_serving_stack(env: dict):
    """SERVE_MODEL / SERVE_TOKENIZER / SERVE_DTYPE / SERVE_DEVICE →
    (params, cfg, encode, decode_text), params on the serving device."""
    if env.get("SERVE_HF_CHECKPOINT", ""):
        raise SystemExit(
            "SERVE_HF_CHECKPOINT is not supported by the PyTorch port yet: "
            "checkpoint loading arrives with the tooling slice (ROADMAP.md)"
        )
    if env.get("SERVE_QUANT", ""):
        raise SystemExit(
            "SERVE_QUANT is not supported by the PyTorch port yet: int8 "
            "weights arrive with the int8 slice (ROADMAP.md)"
        )
    device = torch.device(env.get("SERVE_DEVICE", "") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"SERVE_DEVICE={device} but torch sees no CUDA device "
            "(SERVE_DEVICE=cpu serves on the CPU)"
        )
    tok_spec = env.get("SERVE_TOKENIZER", "byte")
    encode, vocab = resolve_tokenizer(tok_spec)
    decode_text = _detokenizer(tok_spec)

    name = env.get("SERVE_MODEL", "llama-test")
    if name not in CONFIGS:
        raise SystemExit(
            f"unknown SERVE_MODEL {name!r} (the port serves the dense and "
            f"MoE presets {sorted(CONFIGS)})"
        )
    cfg = CONFIGS[name]
    t0 = time.perf_counter()
    generator = torch.Generator(device=device).manual_seed(0)
    params = init_params(cfg, generator, device)
    log(f"random-init {name} on {device} in {time.perf_counter() - t0:.1f}s "
        "(smoke mode — random weights)")
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
    return params, cfg, encode, decode_text
