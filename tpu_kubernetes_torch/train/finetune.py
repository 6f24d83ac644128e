"""The LoRA finetuning job on one card (port of
``tpu_kubernetes/train/finetune.py``): a base in, merged (and optionally
HF-exported) weights out.

    python -m tpu_kubernetes_torch.train.finetune

The env contract, with the reference's defaults:

  FT_HF_CHECKPOINT  LOCAL transformers checkpoint to adapt
                    (``models/convert_hf.load_hf``; llama or mixtral)
  FT_MODEL          a preset instead (random init from seed 0 — smoke
                    mode; default llama-test)
  FT_DATA_PATH      token shards (``train/corpus.py`` format); synthetic
                    tokens when unset (smoke mode)
  FT_STEPS          optimizer steps (default 100)
  FT_BATCH / FT_SEQ batch rows / sequence length (defaults 4 / the model's
                    max_seq)
  FT_RANK / FT_ALPHA / FT_TARGETS   LoRA shape (defaults 8 / 16 /
                    wq,wk,wv,wo — comma-separated layer leaves)
  FT_LR             adapter learning rate (default 1e-4)
  FT_OUT            directory for the MERGED weights, a port checkpoint
                    (``train/checkpoint.py``, ``{"params": …}`` at step
                    FT_STEPS); required unless FT_STEPS=0
  FT_EXPORT_HF      optional directory: also export the merged model as a
                    transformers checkpoint (dense only; refused for MoE
                    before training)
  FT_DEVICE         torch device (default ``cuda``; ``cpu`` only when
                    asked)
  FT_MESH           a mesh of more than one device is refused until the
                    sharded LoRA step (ROADMAP.md queue 1 item 7b)

The adapters start from seed 1 and train through ``make_lora_step``
(one CUDA graph on the card, the base read in place); only adapter
moments exist (``train/lora.py``).
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

import torch


def log(*args) -> None:
    print("[finetune]", *args, file=sys.stderr, flush=True)


def run_finetune(env: dict | None = None) -> dict:
    """The whole job; ``env`` defaults to os.environ (injectable for
    tests). → {"losses": every step's loss, "step_s": the steps' mean wall
    after the first (None below 2 steps)}."""
    env = dict(os.environ if env is None else env)

    from tpu_kubernetes_torch.models import CONFIGS, MoEConfig, init_params
    from tpu_kubernetes_torch.train import (
        input_pipeline,
        prefetch,
        synthetic_batches,
    )
    from tpu_kubernetes_torch.train.checkpoint import save
    from tpu_kubernetes_torch.train.job import _sync, _trivial_mesh
    from tpu_kubernetes_torch.train.lora import (
        LoraConfig,
        init_lora_state,
        make_lora_step,
        merge_lora,
    )

    if not _trivial_mesh(env.get("FT_MESH", "")):
        raise SystemExit(
            f"FT_MESH={env['FT_MESH']!r} is not supported by the PyTorch "
            "port yet: the sharded LoRA step arrives with ROADMAP.md "
            "queue 1 item 7b (parallel: pipeline, ring attention, sharded "
            "LoRA)")
    out_dir = env.get("FT_OUT", "")
    steps = int(env.get("FT_STEPS", "100"))
    if not out_dir and steps > 0:
        raise SystemExit("FT_OUT must name the merged-weights directory "
                         "(FT_STEPS=0 for a no-output smoke run)")
    device = torch.device(env.get("FT_DEVICE", "") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"FT_DEVICE={device} but torch sees no CUDA device "
            "(FT_DEVICE=cpu finetunes on the CPU)")

    t_start = time.time()
    hf_path = env.get("FT_HF_CHECKPOINT", "")
    if hf_path:
        from tpu_kubernetes_torch.models import load_hf

        params, cfg = load_hf(hf_path, device=device)
        log(f"base: HF checkpoint {hf_path}")
    else:
        name = env.get("FT_MODEL", "llama-test")
        if name not in CONFIGS:
            raise SystemExit(f"unknown FT_MODEL {name!r} (presets: "
                             f"{sorted(CONFIGS)})")
        cfg = CONFIGS[name]
        params = init_params(cfg, torch.Generator(device=device)
                             .manual_seed(0), device)
        log(f"base: random-init {name} (smoke mode)")
    if env.get("FT_EXPORT_HF", "") and isinstance(cfg, MoEConfig):
        # fail in seconds, not after the whole finetune
        raise SystemExit("FT_EXPORT_HF supports the dense family only")

    batch = int(env.get("FT_BATCH", "4"))
    seq = int(env.get("FT_SEQ", str(cfg.max_seq)))
    lc = LoraConfig(
        rank=int(env.get("FT_RANK", "8")),
        alpha=float(env.get("FT_ALPHA", "16")),
        targets=tuple(
            t for t in env.get("FT_TARGETS", "wq,wk,wv,wo").split(",") if t
        ),
    )
    lr = float(env.get("FT_LR", "1e-4"))
    log(f"device={device} rank={lc.rank} targets={','.join(lc.targets)} "
        f"batch={batch} seq={seq}")

    state = init_lora_state(torch.Generator(device=device).manual_seed(1),
                            params, cfg, lc, learning_rate=lr)
    step = make_lora_step(cfg, lc, state, params, (batch, seq + 1),
                          learning_rate=lr)
    data_path = env.get("FT_DATA_PATH", "")
    if data_path:
        batches = input_pipeline(data_path, batch, seq, cfg.vocab_size,
                                 device)
        log(f"data: {data_path}")
    else:
        batches = prefetch(synthetic_batches(cfg.vocab_size, batch, seq,
                                             device=device))
        log("data: synthetic")

    losses = []                 # device copies, read once at the end
    t_first = None
    try:
        for i in range(steps):
            loss = step(next(batches))
            losses.append(loss.clone())
            if t_first is None:
                _sync(device)
                t_first = time.time()
                log(f"FIRST FINETUNE STEP at +{t_first - t_start:.1f}s "
                    f"loss={float(loss):.4f}")
            if (i + 1) % 25 == 0 or i + 1 == steps:
                log(f"step {i + 1}/{steps} loss={float(loss):.4f}")
    finally:
        batches.close()
    _sync(device)
    step_s = ((time.time() - t_first) / (steps - 1) if steps > 1 else None)

    merged = merge_lora(params, state["adapters"], lc)
    if out_dir:
        save(out_dir, {"params": merged}, step=steps)
        log(f"merged weights → {out_dir}")
    export_dir = env.get("FT_EXPORT_HF", "")
    if export_dir:
        from tpu_kubernetes_torch.models import export_hf_llama

        export_hf_llama(merged, cfg, Path(export_dir))
        log(f"HF export → {export_dir}")
    return {"losses": [float(x) for x in losses], "step_s": step_s}


def main() -> int:
    run_finetune()
    return 0


if __name__ == "__main__":
    sys.exit(main())
