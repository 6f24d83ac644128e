"""The training job on one card (port of ``tpu_kubernetes/train/job.py``):

    python -m tpu_kubernetes_torch.train.job

It trains the configured preset (dense LLaMA or MoE, at the preset's own
dispatch mode) from random weights (seeded) on
synthetic tokens or a token file, and logs in the reference's form: the
``FIRST TRAIN STEP at +…s loss=…`` marker, then ``step=… loss=…
tokens/s=…`` every 10 steps, timed after the device has finished. The
step is ``make_train_step``'s: the state updated in place, and on the
card one CUDA graph that the first step captures; the held-out loss is
``make_eval_step``'s program, a graph of its own.

Env knobs, as the reference reads them: JOB_MODEL (default llama-7b),
JOB_BATCH, JOB_SEQ, JOB_STEPS, JOB_ACCUM_STEPS, JOB_OPTIMIZER ("adamw" |
"adafactor"), JOB_DATA_PATH (token shards; synthetic data when unset),
JOB_EVAL_DATA_PATH + JOB_EVAL_EVERY / JOB_EVAL_BATCHES (held-out loss),
JOB_CHECKPOINT_DIR + JOB_CHECKPOINT_EVERY (default 50): the state is
saved every that many steps (``train/checkpoint.py``, a local directory),
and a job that finds a checkpoint there restores it into its state (the
step program is built first, and the restore copies in place) and
carries on from its step, through the token file from that step on
(synthetic batches start again from their seed, as in the reference).
JOB_DEVICE picks the torch device (default ``cuda``; ``cpu`` only when
asked). A JOB_MESH / JOB_DCN_MESH of more than one device is refused
until the parallel slice (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Mapping

import torch


def log(*args) -> None:
    print("[job]", *args, file=sys.stderr, flush=True)


def _trivial_mesh(spec: str) -> bool:
    """True for "" or a mesh whose every axis has size 1 ("data=1,…")."""
    for part in filter(None, (p.strip() for p in spec.split(","))):
        name, _, size = part.partition("=")
        if not name.strip() or not size.strip().isdigit():
            raise SystemExit(f"bad mesh axis {part!r} in {spec!r} "
                             "(want name=size,…)")
        if int(size) != 1:
            return False
    return True


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(env: Mapping[str, str] | None = None) -> dict:
    """Run the job. → {"loss": last loss, "losses": every step's loss this
    run, "start_step": the step it resumed from (0 for a fresh run),
    "tokens_per_s": the last logged rate or None, "first_step_s": start →
    first step done}."""
    env = os.environ if env is None else env
    t_start = time.time()

    from tpu_kubernetes_torch.models import CONFIGS, param_count
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        input_pipeline,
        make_eval_step,
        make_train_step,
        prefetch,
        synthetic_batches,
    )
    from tpu_kubernetes_torch.train.checkpoint import (
        CheckpointError,
        latest_step,
        restore,
        save,
    )

    for knob in ("JOB_MESH", "JOB_DCN_MESH"):
        if not _trivial_mesh(env.get(knob, "")):
            raise SystemExit(
                f"{knob}={env[knob]!r} is not supported by the PyTorch port "
                "yet: meshes wait for the parallel slice (ROADMAP.md queue "
                "1 item 7, parallel)"
            )
    ckpt_dir = env.get("JOB_CHECKPOINT_DIR", "")
    ckpt_every = int(env.get("JOB_CHECKPOINT_EVERY", "50"))
    if "://" in ckpt_dir:
        # fail in seconds, not at the first save
        raise SystemExit(
            f"JOB_CHECKPOINT_DIR={ckpt_dir!r}: the PyTorch port checkpoints "
            "to a local directory only (no remote store)")
    device = torch.device(env.get("JOB_DEVICE", "") or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"JOB_DEVICE={device} but torch sees no CUDA device "
            "(JOB_DEVICE=cpu trains on the CPU)"
        )

    model = env.get("JOB_MODEL", "llama-7b")
    if model not in CONFIGS:
        raise SystemExit(f"unknown JOB_MODEL {model!r} (the port trains the "
                         f"dense and MoE presets {sorted(CONFIGS)})")
    cfg = CONFIGS[model]
    batch = int(env.get("JOB_BATCH", "4"))
    seq = int(env.get("JOB_SEQ", str(cfg.max_seq)))
    steps = int(env.get("JOB_STEPS", "100"))
    data_path = env.get("JOB_DATA_PATH", "")
    eval_path = env.get("JOB_EVAL_DATA_PATH", "")
    eval_every = int(env.get("JOB_EVAL_EVERY", "50"))
    eval_batches = int(env.get("JOB_EVAL_BATCHES", "8"))
    log(f"device={device} model={model} batch={batch} seq={seq}")

    tc = TrainConfig(
        accum_steps=int(env.get("JOB_ACCUM_STEPS", "1")),
        optimizer=env.get("JOB_OPTIMIZER", "adamw"),
    )
    if tc.accum_steps < 1 or batch % tc.accum_steps:
        raise SystemExit(
            f"JOB_BATCH={batch} not divisible by "
            f"JOB_ACCUM_STEPS={tc.accum_steps} (or accum < 1)"
        )
    state = init_state(torch.Generator(device=device).manual_seed(0), cfg,
                       tc, device)
    log(f"params={param_count(state['params']) / 1e9:.2f}B")

    # in place, one CUDA graph on the card (captured by the first step);
    # built before the restore, which copies into the state it reads
    step = make_train_step(cfg, tc, state, (batch, seq + 1))
    start_step = 0
    if ckpt_dir:
        try:
            if latest_step(ckpt_dir) is not None:
                t0 = time.perf_counter()
                restore(ckpt_dir, like=state)
                start_step = state["step"]
                log(f"resumed from step {start_step} "
                    f"({time.perf_counter() - t0:.2f}s)")
        except CheckpointError as e:
            log(f"no resume: {e}")

    if data_path:
        # start_step skips the batches a resumed run already took
        batches = input_pipeline(data_path, batch, seq, cfg.vocab_size,
                                 device, start_step=start_step)
        log(f"data: {data_path} (from step {start_step})")
    else:
        batches = prefetch(synthetic_batches(cfg.vocab_size, batch, seq,
                                             device=device))
        log("data: synthetic")
    eval_step, eval_data = None, []
    if eval_path:
        # built once: the same seed-pinned batches for every eval, through
        # one program (a CUDA graph on the card) over the trained params
        eval_step = make_eval_step(cfg, state["params"], (batch, seq + 1))
        eval_it = input_pipeline(eval_path, batch, seq, cfg.vocab_size,
                                 device, seed=1, prefetch_depth=1)
        eval_data = [next(eval_it) for _ in range(eval_batches)]
        eval_it.close()

    loss, tps, first_step_s = None, None, None
    losses = []                 # device copies, read once at the end
    t_last, window = time.time(), 0
    try:
        for i in range(start_step, steps):
            loss = step(next(batches))
            losses.append(loss.clone())
            window += 1
            if first_step_s is None:
                _sync(device)
                first_step_s = time.time() - t_start
                if device.type == "cuda":
                    log(f"device memory peak="
                        f"{torch.cuda.max_memory_allocated(device) / 2**30:.2f}"
                        "GiB")
                log(f"FIRST TRAIN STEP at +{first_step_s:.1f}s "
                    f"loss={float(loss):.4f}")   # the first-step marker
            if (i + 1) % 10 == 0:
                _sync(device)
                now = time.time()
                tps = window * batch * seq / (now - t_last)
                log(f"step={i + 1} loss={float(loss):.4f} tokens/s={tps:.0f}")
                t_last, window = now, 0
            if eval_step is not None and (i + 1) % eval_every == 0:
                mean = sum(float(eval_step(eb))
                           for eb in eval_data) / eval_batches
                log(f"eval step={i + 1} loss={mean:.4f} "
                    f"ppl={math.exp(min(mean, 30)):.2f}")
            if ckpt_dir and (i + 1) % ckpt_every == 0:
                t0 = time.perf_counter()
                save(ckpt_dir, state, step=i + 1)
                log(f"checkpointed step {i + 1} "
                    f"({time.perf_counter() - t0:.2f}s)")
    finally:
        batches.close()
    log("done")
    return {"loss": None if loss is None else float(loss),
            "losses": [float(x) for x in losses], "start_step": start_step,
            "tokens_per_s": tps, "first_step_s": first_step_s}


if __name__ == "__main__":
    main()
