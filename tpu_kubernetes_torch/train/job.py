"""The training job (port of ``tpu_kubernetes/train/job.py``):

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
asked).

JOB_MESH ("data=2,fsdp=2,tensor=2") and JOB_DCN_MESH (multislice: the
cross-host axes, JOB_MESH then the axes within a host) are read as the
reference reads them; the default mesh is ``mesh_shape_for_devices(n)``
over the n cards (one card: today's one-device step). A mesh of more
than one device runs one process per device: the job spawns a worker per
local card on ``cuda`` (the mesh must cover every card of every host,
the reference's rule), or as many gloo workers as the mesh asks on
``cpu`` (at most one per core). Every worker initialises the whole model
from the one seed, keeps its shards and trains them with
``make_sharded_train_step`` (NCCL, one CUDA graph, on the cards; gloo on
the CPU); only rank 0 logs. On several hosts the provisioner's env
contract (``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES``,
``JAX_PROCESS_ID``) joins the hosts' workers into one world
(``parallel/distributed.py``). A mesh that wants more devices than exist
fails with the reference's "wants N devices".
"""

from __future__ import annotations

import math
import os
import sys
import time
from typing import Mapping

import torch


# this process's rank in a sharded job: only rank 0 logs
_RANK = [0]


def log(*args) -> None:
    if _RANK[0] == 0:
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


def _mesh_plan(env: Mapping[str, str], device: torch.device
               ) -> tuple[dict, dict, int]:
    """→ (ici shape, dcn shape, devices) as the reference reads JOB_MESH
    and JOB_DCN_MESH. The devices are the cards of every host on
    ``cuda``; on ``cpu`` one per host, or as many as the mesh asks up to
    the cores. Raises ValueError ("wants N devices") where the mesh does
    not fit them."""
    from tpu_kubernetes_torch.parallel import (
        mesh_shape_for_devices,
        parse_mesh_shape,
        read_env,
    )

    hosts = read_env(dict(env)).num_processes
    mesh_spec, dcn_spec = env.get("JOB_MESH", ""), env.get("JOB_DCN_MESH", "")
    for spec in (mesh_spec, dcn_spec):
        _trivial_mesh(spec)             # the syntax check
    if device.type == "cuda":
        n = hosts * torch.cuda.device_count()
    else:
        n = hosts
    dcn = parse_mesh_shape(dcn_spec) if dcn_spec else {}
    n_slices = math.prod(v for v in dcn.values() if v) if dcn else 1
    ici = (parse_mesh_shape(mesh_spec) if mesh_spec
           else mesh_shape_for_devices(max(n // n_slices, 1)))
    total = n_slices * math.prod(v for v in ici.values() if v)
    shape = {**dcn, **ici} if dcn else ici
    if device.type == "cuda":
        if total != n:
            raise ValueError(f"mesh {shape} wants {total} devices, have {n}")
    else:
        cores = hosts * (len(os.sched_getaffinity(0))
                         if hasattr(os, "sched_getaffinity")
                         else os.cpu_count() or 1)
        if total > cores:
            raise ValueError(f"mesh {shape} wants {total} devices, have "
                             f"{cores} (JOB_DEVICE=cpu: one gloo rank a "
                             "core)")
    return ici, dcn, total


def main(env: Mapping[str, str] | None = None) -> dict:
    """Run the job. → {"loss": last loss, "losses": every step's loss this
    run, "start_step": the step it resumed from (0 for a fresh run),
    "tokens_per_s": the last logged rate or None, "first_step_s": start →
    first step done}. Under a mesh of more than one device it spawns the
    local workers and returns rank 0's result."""
    env = dict(os.environ if env is None else env)
    t_start = time.time()
    ckpt_dir = env.get("JOB_CHECKPOINT_DIR", "")
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
    ici, dcn, total = _mesh_plan(env, device)
    if total == 1:
        return _train(env, t_start, ici, dcn, device)
    return _spawn(env, t_start, ici, dcn, total, device)


def _spawn(env: dict, t_start: float, ici: dict, dcn: dict, total: int,
           device: torch.device, target=None) -> dict:
    """One worker per local device, joined into one world (gloo on the
    CPU, NCCL on the cards), each running ``target(env, t_start, ici,
    dcn, device)`` (a module-level function: the job's ``_train``, or the
    finetune job's); → rank 0's result."""
    import json
    import tempfile

    import torch.multiprocessing as mp

    from tpu_kubernetes_torch.parallel import read_env

    hosts = read_env(env).num_processes
    local = total // hosts
    with tempfile.TemporaryDirectory(prefix="tpu-job-") as tmp:
        # one host: a file rendezvous; several: the coordinator's address
        init = None if hosts > 1 else f"file://{tmp}/rendezvous"
        out = os.path.join(tmp, "result.json")
        mp.start_processes(_worker, args=(env, t_start, ici, dcn, local,
                                          init, str(device), out,
                                          target or _train),
                           nprocs=local, join=True, start_method="spawn")
        if not os.path.exists(out):     # rank 0 lives on host 0
            return {}
        with open(out) as f:
            return json.load(f)


def _worker(local_rank: int, env: dict, t_start: float, ici: dict,
            dcn: dict, local: int, init: str | None, device: str,
            out: str, target) -> None:
    import json

    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel import initialize

    if device == "cuda":
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
    else:
        # the host's cores shared out between its ranks
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local))
        dev = torch.device("cpu")
    initialize(env, device=device, local_rank=local_rank, local_size=local,
               init_method=init)
    _RANK[0] = dist.get_rank()
    result = target(env, t_start, ici, dcn, dev)
    # every rank done before any tears its connections down (gloo aborts
    # a rank whose peer closes first)
    dist.barrier()
    dist.destroy_process_group()
    if _RANK[0] == 0:
        with open(out, "w") as f:
            json.dump(result, f)


def _train(env: Mapping[str, str], t_start: float, ici: dict, dcn: dict,
           device: torch.device) -> dict:
    """The job on this process: one device, or this rank of the mesh."""
    from tpu_kubernetes_torch.models import CONFIGS, param_count
    from tpu_kubernetes_torch.parallel import (
        create_hybrid_mesh,
        create_mesh,
        read_env,
    )
    from tpu_kubernetes_torch.train import (
        TrainConfig,
        init_state,
        input_pipeline,
        make_eval_step,
        make_sharded_eval_step,
        make_sharded_train_step,
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
    from tpu_kubernetes_torch.train.trainer import local_rows

    ckpt_dir = env.get("JOB_CHECKPOINT_DIR", "")
    ckpt_every = int(env.get("JOB_CHECKPOINT_EVERY", "50"))
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
    denv = read_env(dict(env))
    mesh = (create_hybrid_mesh(ici, dcn) if dcn else create_mesh(ici))
    sharded = mesh.size > 1
    if sharded:
        log(f"process {denv.process_id}/{denv.num_processes} "
            f"ranks={mesh.size} accelerator={denv.accelerator_type} "
            f"topology={denv.slice_topology}")
    log(f"device={device} devices={mesh.size} mesh={dict(mesh.shape)} "
        f"model={model} batch={batch} seq={seq}")

    tc = TrainConfig(
        accum_steps=int(env.get("JOB_ACCUM_STEPS", "1")),
        optimizer=env.get("JOB_OPTIMIZER", "adamw"),
    )
    if tc.accum_steps < 1 or batch % tc.accum_steps:
        raise SystemExit(
            f"JOB_BATCH={batch} not divisible by "
            f"JOB_ACCUM_STEPS={tc.accum_steps} (or accum < 1)"
        )
    # every rank draws the whole state (params and moments) on its device
    # from the one seed and keeps its blocks (make_sharded_train_step):
    # the device holds the whole state once, at the start
    state = init_state(torch.Generator(device=device).manual_seed(0), cfg,
                       tc, device)
    log(f"params={param_count(state['params']) / 1e9:.2f}B")

    # in place, one CUDA graph on the card (captured by the first step);
    # built before the restore, which copies into the state it reads
    shardings, b_sh = None, None
    if sharded:
        step, shardings, b_sh = make_sharded_train_step(
            cfg, tc, mesh, state, (batch, seq + 1))
    else:
        step = make_train_step(cfg, tc, state, (batch, seq + 1))
    start_step = 0
    if ckpt_dir:
        try:
            if latest_step(ckpt_dir) is not None:
                t0 = time.perf_counter()
                restore(ckpt_dir, like=state, shardings=shardings)
                start_step = state["step"]
                log(f"resumed from step {start_step} "
                    f"({time.perf_counter() - t0:.2f}s)")
        except CheckpointError as e:
            log(f"no resume: {e}")

    rows = {} if b_sh is None else {
        "sharding": b_sh, "process_index": denv.process_id,
        "process_count": denv.num_processes}
    if data_path:
        # start_step skips the batches a resumed run already took
        batches = input_pipeline(data_path, batch, seq, cfg.vocab_size,
                                 device, start_step=start_step,
                                 accum_steps=tc.accum_steps, **rows)
        log(f"data: {data_path} (from step {start_step})")
    else:
        # every rank draws the global batch and keeps its rows
        batches = synthetic_batches(cfg.vocab_size, batch, seq,
                                    device=device)
        if b_sh is not None:
            # the rank's rows, found here (not on the prefetch thread)
            rows = torch.as_tensor(local_rows(b_sh, batch, tc.accum_steps),
                                   device=device)
            batches = (b.index_select(0, rows) for b in batches)
        batches = prefetch(batches)
        log("data: synthetic")
    eval_step, eval_data = None, []
    if eval_path:
        # built once: the same seed-pinned batches for every eval, through
        # one program (a CUDA graph on the card) over the trained params
        if sharded:
            eval_step, _ = make_sharded_eval_step(cfg, mesh, state["params"],
                                                  (batch, seq + 1))
        else:
            eval_step = make_eval_step(cfg, state["params"], (batch, seq + 1))
        eval_it = input_pipeline(eval_path, batch, seq, cfg.vocab_size,
                                 device, seed=1, prefetch_depth=1, **rows)
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
                # under a mesh every rank enters it (the leaves are
                # gathered whole and rank 0 writes)
                save(ckpt_dir, state, step=i + 1, shardings=shardings)
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
