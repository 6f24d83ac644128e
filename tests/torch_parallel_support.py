"""A pool of gloo ranks for the port's parallel tests: spawned once per
test module (spawning costs seconds), then every case runs on the first
``k`` ranks of it, each rank in its own process on the CPU, with the
world's rendezvous in a temporary directory (``file://``).

``pool.submit(fn, *args)`` runs ``fn(*args)`` on every rank (``fn`` a
module-level function, so it pickles by name); ``pool.collect()`` returns
the ranks' results in rank order and raises with the failing rank's
traceback. A case that hangs fails after ``timeout`` seconds and the pool
is torn down.
"""

from __future__ import annotations

import os
import queue
import shutil
import tempfile
import traceback

import torch.multiprocessing as mp


def _worker(rank: int, world: int, path: str, inbox, outbox,
            timeout: float) -> None:
    import faulthandler

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{path}",
                            rank=rank, world_size=world)
    while True:
        task = inbox.get()
        if task is None:
            break
        fn, args = task
        # a hung case prints every rank's stack before the parent gives up
        faulthandler.dump_traceback_later(timeout - 5)
        try:
            outbox.put((rank, True, fn(*args)))
        except BaseException:  # noqa: BLE001 — reported to the parent
            outbox.put((rank, False, traceback.format_exc()))
        faulthandler.cancel_dump_traceback_later()
    dist.barrier()              # no rank tears down under a peer
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int = 8, timeout: float = 240.0):
        ctx = mp.get_context("spawn")
        self.world, self.timeout = world, timeout
        self.tmp = tempfile.mkdtemp(prefix="rankpool-")
        path = os.path.join(self.tmp, "rendezvous")
        self.inboxes = [ctx.Queue() for _ in range(world)]
        self.outbox = ctx.Queue()
        self.procs = [ctx.Process(target=_worker, daemon=True,
                                  args=(r, world, path, self.inboxes[r],
                                        self.outbox, timeout))
                      for r in range(world)]
        for p in self.procs:
            p.start()
        self.pending = False

    def submit(self, fn, *args) -> None:
        assert not self.pending, "collect the last case first"
        for box in self.inboxes:
            box.put((fn, args))
        self.pending = True

    def collect(self) -> list:
        results, errors = [None] * self.world, []
        try:
            for _ in range(self.world):
                rank, ok, value = self.outbox.get(timeout=self.timeout)
                if ok:
                    results[rank] = value
                else:
                    errors.append(f"rank {rank}:\n{value}")
        except queue.Empty:
            self.close(kill=True)
            raise TimeoutError(f"a case took over {self.timeout} s")
        finally:
            self.pending = False
        if errors:
            raise RuntimeError("\n".join(errors))
        return results

    def run(self, fn, *args) -> list:
        self.submit(fn, *args)
        return self.collect()

    def close(self, kill: bool = False) -> None:
        for p, box in zip(self.procs, self.inboxes):
            if kill:
                p.kill()
            else:
                box.put(None)
        for p in self.procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
        shutil.rmtree(self.tmp, ignore_errors=True)


# -- cases (run on every rank of the pool) ------------------------------------

def _to_numpy(tree):
    import torch

    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return tree.detach().float().cpu().numpy() if isinstance(
        tree, torch.Tensor) else tree


def make_mesh(mesh_shape: dict, dcn_shape: dict | None = None):
    """The case's mesh over the first ranks of the world, or None on a
    rank past it."""
    import math

    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel import create_hybrid_mesh, create_mesh

    n = math.prod(mesh_shape.values()) * math.prod(
        (dcn_shape or {}).values())
    devices = list(range(n))
    # every rank of the world builds the mesh (its groups are collective
    # over the world); the ranks past it sit the case out
    if dcn_shape:
        mesh = create_hybrid_mesh(mesh_shape, dcn_shape, devices=devices)
    else:
        mesh = create_mesh(mesh_shape, devices=devices)
    return mesh if dist.get_rank() < n else None


def train_case(model: str, overrides: dict, mesh_shape: dict,
               dcn_shape: dict | None, tc_kwargs: dict, params_np: dict,
               batches: list, eval_batch=None):
    """``len(batches)`` sharded steps from the whole ``params_np`` (zero
    moments) → on rank 0 {"losses", "params", "eval"}: each step's loss,
    the whole params after the last step, and (given ``eval_batch``) the
    sharded eval step's loss on it after training."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.models.from_jax import params_from_numpy
    from tpu_kubernetes_torch.train.trainer import (
        TrainConfig,
        gather_state,
        make_optimizer,
        make_sharded_eval_step,
        make_sharded_train_step,
        shard_batch,
    )

    mesh = make_mesh(mesh_shape, dcn_shape)
    if mesh is None:
        return None
    cfg = replace(CONFIGS[model], **overrides)
    tc = TrainConfig(**tc_kwargs)
    params = params_from_numpy(params_np, "cpu", dtype=None)
    state = {"params": params, "opt_state": make_optimizer(tc).init(params),
             "step": 0}
    step, sh, b_sh = make_sharded_train_step(cfg, tc, mesh, state,
                                             batches[0].shape)
    losses = [float(step(shard_batch(torch.from_numpy(b), b_sh,
                                     tc.accum_steps))) for b in batches]
    out = {"losses": losses, "step": state["step"],
           "local_numel": {k: int(v.numel()) for k, v in
                           state["params"]["layers"].items()},
           "opt_state": _to_numpy(gather_state(state["opt_state"],
                                               sh["opt_state"]))}
    whole = gather_state(state["params"], sh["params"])
    if eval_batch is not None:
        ev, eb_sh = make_sharded_eval_step(cfg, mesh, state["params"],
                                           eval_batch.shape)
        out["eval"] = float(ev(shard_batch(torch.from_numpy(eval_batch),
                                           eb_sh)))
    out["params"] = _to_numpy(whole)
    return out if dist.get_rank() == 0 else None


def _sharded_params(model: str, overrides: dict, mesh, params_np: dict):
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.models.from_jax import params_from_numpy
    from tpu_kubernetes_torch.train.trainer import (
        TrainConfig,
        make_optimizer,
        shard_state,
        state_shardings,
    )

    cfg = replace(CONFIGS[model], **overrides)
    params = params_from_numpy(params_np, "cpu", dtype=None)
    state = {"params": params,
             "opt_state": make_optimizer(TrainConfig()).init(params),
             "step": 0}
    sh = state_shardings(state, cfg, mesh)
    shard_state(state, sh)
    return cfg, state["params"], sh["params"]


def forward_case(model: str, overrides: dict, mesh_shape: dict,
                 params_np: dict, tokens):
    """``forward`` under the mesh on this rank's rows and shards → on rank
    0 the whole batch's logits (the ranks' rows gathered)."""
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.models import forward
    from tpu_kubernetes_torch.parallel import batch_sharding, mesh_context
    from tpu_kubernetes_torch.parallel.mesh import gather_tensor
    from tpu_kubernetes_torch.train.trainer import shard_batch

    mesh = make_mesh(mesh_shape)
    if mesh is None:
        return None
    cfg, params, _ = _sharded_params(model, overrides, mesh, params_np)
    b_sh = batch_sharding(mesh)
    rows = shard_batch(torch.from_numpy(tokens), b_sh)
    with torch.no_grad(), mesh_context(mesh):
        logits = forward(params, rows, cfg)
    whole = gather_tensor(logits, b_sh)
    return whole.numpy() if dist.get_rank() == 0 else None


def loss_grad_case(model: str, overrides: dict, mesh_shape: dict,
                   params_np: dict, tokens):
    """The batch's loss and every whole gradient leaf, computed under the
    mesh as the sharded step computes them → on rank 0 (loss, grads)."""
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.models.moe_ep import expert_parallel_context
    from tpu_kubernetes_torch.parallel import batch_sharding
    from tpu_kubernetes_torch.train.trainer import (
        Shards,
        _unflatten,
        _value_and_grad,
        gather_state,
        shard_batch,
    )

    mesh = make_mesh(mesh_shape)
    if mesh is None:
        return None
    cfg, params, p_sh = _sharded_params(model, overrides, mesh, params_np)
    rows = shard_batch(torch.from_numpy(tokens), batch_sharding(mesh))
    with expert_parallel_context(mesh):
        loss, grads = _value_and_grad(params, rows, cfg)
    shards = Shards(mesh, p_sh, params)
    grads = _unflatten(params, iter(shards.reduce_grads(grads)))
    loss = float(shards.mean_loss(loss))
    whole = _to_numpy(gather_state(grads, p_sh))
    return (loss, whole) if dist.get_rank() == 0 else None


def collectives_case(seed: int):
    """Every differentiable collective on a 4-rank ``data=2,tensor=2``
    mesh, forward and backward, and the vocab-parallel loss → on every
    rank a dict of results (checked by the test against their plain
    definitions)."""
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.ops.losses import (
        next_token_nll,
        next_token_nll_vocab_parallel,
    )
    from tpu_kubernetes_torch.parallel import collectives as C

    mesh = make_mesh({"data": 2, "tensor": 2})
    if mesh is None:
        return None
    rank = dist.get_rank()
    dg, tg = mesh.group("data"), mesh.group("tensor")
    gen = torch.Generator().manual_seed(seed)
    # every rank draws all ranks' inputs, so each can check the others'
    xs = torch.randn(4, 3, 4, generator=gen)
    x = xs[rank].clone().requires_grad_(True)
    out = {}

    def run(name, fn, weight):
        y = fn(x)
        (y * weight).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy().copy())
        x.grad = None

    w = torch.arange(1.0, 25.0).reshape(3, 8) / 10   # a fixed cotangent
    run("all_gather_data_dim1", lambda t: C.all_gather(t, 1, dg), w)
    run("reduce_scatter_data_dim1",
        lambda t: C.reduce_scatter(t, 1, dg), w[:, :2])
    run("all_reduce_data", lambda t: C.all_reduce(t, dg), w[:, :4])
    run("copy_to_tensor", lambda t: C.copy_to(t, tg), w[:, :4])
    run("reduce_from_tensor", lambda t: C.reduce_from(t, tg), w[:, :4])
    run("gather_from_tensor", lambda t: C.gather_from(t, -1, tg), w)
    run("all_to_all_data",
        lambda t: C.all_to_all(t.reshape(2, 6), dg).reshape(3, 4), w[:, :4])
    # the vocab-parallel loss on tensor ranks' halves of one set of logits
    logits = torch.randn(2, 5, 16, generator=gen)
    targets = torch.randint(0, 16, (2, 5), generator=gen)
    t = mesh.my_coords()["tensor"]
    part = logits[..., t * 8:(t + 1) * 8].clone().requires_grad_(True)
    loss = next_token_nll_vocab_parallel(part, targets, t * 8, tg)
    loss.backward()
    whole = logits.clone().requires_grad_(True)
    plain = next_token_nll(whole, targets)
    plain.backward()
    out["vocab_parallel"] = (float(loss), float(plain), part.grad.numpy(),
                             whole.grad[..., t * 8:(t + 1) * 8].numpy())
    out["xs"] = xs.numpy()
    return out


# -- item 7b: ring attention, the pipeline, the sharded LoRA step ---------------

def ring_case(mesh_shape: dict, q, k, v, g, causal: bool):
    """``ring_attention_sharded`` on this rank's sequence block of (q, k,
    v), and the gradients of ⟨out, g⟩ → on every rank its blocks (out,
    dq, dk, dv), as numpy."""
    import torch

    from tpu_kubernetes_torch.parallel import ring_attention_sharded
    from tpu_kubernetes_torch.parallel.mesh import shard_tensor, this_rank
    from tpu_kubernetes_torch.parallel.ring_attention import seq_sharding

    mesh = make_mesh(mesh_shape)
    if mesh is None:
        return None
    sh = seq_sharding(mesh)
    rank = this_rank()
    q, k, v = (shard_tensor(torch.from_numpy(x), sh, rank)
               .requires_grad_(True) for x in (q, k, v))
    out = ring_attention_sharded(q, k, v, mesh, causal=causal)
    (out * shard_tensor(torch.from_numpy(g), sh, rank)).sum().backward()
    return tuple(t.detach().numpy() for t in (out, q.grad, k.grad, v.grad))


def _pipeline_setup(model: str, overrides: dict, mesh_shape: dict,
                    params_np: dict):
    """The mesh, the config and this rank's blocks of the params under
    the pipeline's shardings (None on a rank past the mesh)."""
    from dataclasses import replace

    from tpu_kubernetes_torch.models import CONFIGS, logical_axes
    from tpu_kubernetes_torch.models.from_jax import params_from_numpy
    from tpu_kubernetes_torch.parallel import pipeline_param_shardings
    from tpu_kubernetes_torch.train.trainer import shard_state

    mesh = make_mesh(mesh_shape)
    if mesh is None:
        return None
    cfg = replace(CONFIGS[model], **overrides)
    params = params_from_numpy(params_np, "cpu", dtype=None)
    p_sh = pipeline_param_shardings(logical_axes(cfg), mesh)
    shard_state({"params": params}, {"params": p_sh})
    return mesh, cfg, params, p_sh


def pipeline_forward_case(model: str, overrides: dict, mesh_shape: dict,
                          params_np: dict, tokens, n_microbatches: int):
    """``pipeline_forward`` on this rank's rows → on rank 0 the whole
    batch's logits, the ranks' rows put back in global order."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel import (
        batch_sharding,
        pipeline_forward,
    )
    from tpu_kubernetes_torch.parallel.collectives import all_gather_raw
    from tpu_kubernetes_torch.train.trainer import local_rows, shard_batch

    setup = _pipeline_setup(model, overrides, mesh_shape, params_np)
    if setup is None:
        return None
    mesh, cfg, params, _ = setup
    b_sh = batch_sharding(mesh)
    rows = shard_batch(torch.from_numpy(tokens), b_sh, n_microbatches)
    with torch.no_grad():
        logits = pipeline_forward(params, rows, cfg, mesh, n_microbatches)
    # every rank's rows, and which global rows they are
    idx = torch.as_tensor(local_rows(b_sh, tokens.shape[0], n_microbatches))
    allx = all_gather_raw(logits, 0, mesh.group(mesh.axis_names))
    alli = all_gather_raw(idx, 0, mesh.group(mesh.axis_names))
    if dist.get_rank() != 0:
        return None
    out = np.zeros((tokens.shape[0], *logits.shape[1:]), np.float32)
    out[alli.numpy()] = allx.numpy()
    return out


def pipeline_grad_case(model: str, overrides: dict, mesh_shape: dict,
                       params_np: dict, tokens, n_microbatches: int):
    """The pipelined loss and every whole gradient leaf, reduced as the
    pipelined step reduces them → on rank 0 (loss, grads)."""
    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.parallel import batch_sharding, pipeline_loss_fn
    from tpu_kubernetes_torch.train.trainer import (
        Shards,
        _unflatten,
        gather_state,
        shard_batch,
        value_and_grad,
    )

    setup = _pipeline_setup(model, overrides, mesh_shape, params_np)
    if setup is None:
        return None
    mesh, cfg, params, p_sh = setup
    rows = shard_batch(torch.from_numpy(tokens), batch_sharding(mesh),
                       n_microbatches)
    loss, grads = value_and_grad(lambda p: pipeline_loss_fn(
        p, rows, cfg, mesh, n_microbatches), params)
    shards = Shards(mesh, p_sh, params)
    grads = _unflatten(params, iter(shards.reduce_grads(grads)))
    loss = float(shards.mean_loss(loss))
    whole = _to_numpy(gather_state(grads, p_sh))
    return (loss, whole) if dist.get_rank() == 0 else None


def pipeline_train_case(model: str, overrides: dict, mesh_shape: dict,
                        tc_kwargs: dict, params_np: dict, batches: list,
                        n_microbatches: int):
    """``make_pipeline_train_step`` for ``len(batches)`` steps from the
    whole ``params_np`` (zero moments) → on rank 0 {"losses", "params",
    "opt_state"}; on every rank the step count, wq's local size and each
    leaf's sum in the whole params it gathered (equal on every rank when
    the stage replicas of the embedding and head agree)."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.models.from_jax import params_from_numpy
    from tpu_kubernetes_torch.train.trainer import (
        TrainConfig,
        gather_state,
        make_optimizer,
        make_pipeline_train_step,
        shard_batch,
        tree_leaves,
    )

    mesh = make_mesh(mesh_shape)
    if mesh is None:
        return None
    cfg = replace(CONFIGS[model], **overrides)
    tc = TrainConfig(**tc_kwargs)
    params = params_from_numpy(params_np, "cpu", dtype=None)
    state = {"params": params, "opt_state": make_optimizer(tc).init(params),
             "step": 0}
    step, sh, b_sh = make_pipeline_train_step(cfg, tc, mesh, state,
                                              n_microbatches,
                                              batches[0].shape)
    losses = [float(step(shard_batch(torch.from_numpy(b), b_sh,
                                     step.row_blocks))) for b in batches]
    whole = gather_state(state["params"], sh["params"])
    out = {"losses": losses, "step": state["step"],
           "wq_numel": int(state["params"]["layers"]["wq"].numel()),
           "sums": [float(x.double().sum()) for x in tree_leaves(whole)],
           "opt_state": _to_numpy(gather_state(state["opt_state"],
                                               sh["opt_state"])),
           "params": _to_numpy(whole)}
    if dist.get_rank() == 0:
        return out
    return {k: out[k] for k in ("step", "wq_numel", "losses", "sums")}


def lora_case(model: str, overrides: dict, mesh_shape: dict, lc_kwargs: dict,
              params_np: dict, adapters_np: dict, batches: list,
              learning_rate: float):
    """``make_sharded_lora_step`` for ``len(batches)`` steps from the whole
    base and adapters → on rank 0 {"losses", "adapters", "opt_state",
    "base_unchanged"}; on every rank the step count and B of wq's local
    and whole sizes."""
    from dataclasses import replace

    import torch
    import torch.distributed as dist

    from tpu_kubernetes_torch.models import CONFIGS
    from tpu_kubernetes_torch.models.from_jax import params_from_numpy
    from tpu_kubernetes_torch.train.lora import (
        LoraConfig,
        make_lora_optimizer,
        make_sharded_lora_step,
    )
    from tpu_kubernetes_torch.train.trainer import (
        gather_state,
        shard_batch,
        tree_leaves,
        tree_map,
    )

    mesh = make_mesh(mesh_shape)
    if mesh is None:
        return None
    cfg = replace(CONFIGS[model], **overrides)
    lc = LoraConfig(**lc_kwargs)
    params = params_from_numpy(params_np, "cpu", dtype=None)
    adapters = params_from_numpy(adapters_np, "cpu", dtype=None)
    state = {"adapters": adapters,
             "opt_state": make_lora_optimizer(lc, learning_rate).init(
                 adapters),
             "step": 0}
    step, s_sh, p_sh, b_sh = make_sharded_lora_step(
        cfg, lc, mesh, state, params, batches[0].shape,
        learning_rate=learning_rate)
    before = tree_map(torch.clone, params)
    losses = [float(step(shard_batch(torch.from_numpy(b), b_sh)))
              for b in batches]
    base_unchanged = all(torch.equal(a, b) for a, b in zip(
        tree_leaves(before), tree_leaves(params)))
    b_wq = state["adapters"]["wq"]["b"]
    out = {"losses": losses, "step": state["step"],
           "base_unchanged": base_unchanged,
           "b_wq_numel": int(b_wq.numel()),
           "adapters": _to_numpy(gather_state(state["adapters"],
                                              s_sh["adapters"])),
           "opt_state": _to_numpy(gather_state(state["opt_state"],
                                               s_sh["opt_state"]))}
    if dist.get_rank() == 0:
        return out
    return {k: out[k] for k in ("step", "b_wq_numel", "base_unchanged")}
