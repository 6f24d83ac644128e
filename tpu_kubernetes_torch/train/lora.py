"""LoRA finetuning: low-rank adapters over frozen base weights (port of
the one-device part of ``tpu_kubernetes/train/lora.py``).

Only the adapters train: ``W_eff = W + (α/r)·A@B`` with A ``(…, in, r)``
and B ``(…, r, out)`` on each target leaf of ``params["layers"]``, the
leading (layer, expert) axes kept, so the optimizer holds moments of the
adapters alone and the base stays bit for bit as it was.

* **Merge form**, as in the reference: each step merges ``W + (A@B)·s``
  for the adapted leaves (``s`` cast to the weight's dtype before the
  multiply, so the product rounds where the reference's does) and runs
  the unmodified ``models.loss_fn``; the gradient reaches A and B through
  the merge, and nothing else is differentiated. On the card the forward
  and backward run the flash kernels as the train step does.
* B starts at zero, so step 0 is exactly the base model.
* The optimizer is optax ``adamw(learning_rate, weight_decay=0)``: a
  constant rate, b1 0.9, b2 0.999, eps 1e-8, no clip — the port's
  :class:`~tpu_kubernetes_torch.train.trainer.AdamW` in its constant-rate,
  clip-free form (on the card the fused ``adamw_update`` kernel alone).
* :func:`lora_train_step` is the out-of-place step (the parity tests');
  :func:`make_lora_step` the one-device counterpart of the reference's
  ``make_sharded_lora_step``: one program (``util/graphs.py``), a CUDA
  graph on the card, reading the base in place and updating the adapters
  in place. :func:`make_sharded_lora_step` is the same over a mesh, the
  adapters laid out by :func:`lora_shardings`.
* :func:`merge_lora` gives plain params for serving, quantizing and export.

Over a mesh each adapter keeps its base leaf's split of the input (A)
and output (B) axis and replicates the rank, so a rank's ``A_block @
B_block`` is its block of the whole product: the merge needs no
collective. Its backward sums: A's gradient over the axes that split the
base's output dimension, B's over those that split its input dimension,
except a data-like axis (fsdp), whose sum is the step's own data-like
gradient sum (``Shards.reduce_grads``), which must not count it twice.
So the merge passes A and B through ``copy_to`` over their ``tensor``
lines (identity forward, all-reduce backward).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_kubernetes_torch.models import ModelConfig, logical_axes, loss_fn
from tpu_kubernetes_torch.parallel.collectives import copy_to
from tpu_kubernetes_torch.parallel.mesh import (
    DATA_AXES,
    Mesh,
    NamedSharding,
    batch_sharding,
    logical_to_spec,
    mesh_context,
    param_shardings,
)
from tpu_kubernetes_torch.train.trainer import (
    AdamW,
    Shards,
    _check_mesh,
    _graphs_for,
    _opt_leaf_shardings,
    _unflatten,
    shard_state,
    tree_leaves,
    value_and_grad,
)
from tpu_kubernetes_torch.util.graphs import Program


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    # layer-stack leaves to adapt (the attention projections by default)
    targets: tuple[str, ...] = ("wq", "wk", "wv", "wo")

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def init_lora(generator: torch.Generator, params: dict, cfg: ModelConfig,
              lc: LoraConfig) -> dict:
    """→ {leaf: {"a": (…, in, r), "b": (…, r, out)}} for every target, in
    the weight's dtype and on its device (``generator`` lives there): A ~
    N(0, 1)/√in, drawn target by target in ``lc.targets`` order, B = 0.
    The draws differ from ``jax.random``'s; the tests carry the
    reference's adapters over with ``models.from_jax``."""
    del cfg
    adapters: dict[str, dict] = {}
    for name in lc.targets:
        if name not in params["layers"]:
            raise ValueError(f"LoRA target {name!r} not in params.layers")
        w = params["layers"][name]
        if w.ndim < 3:
            # a 2-D leaf (a norm's gain) would couple the layer stack as
            # if it were a feature axis
            raise ValueError(
                f"LoRA target {name!r} has shape {tuple(w.shape)} — only "
                "stacked matmul weights can carry adapters"
            )
        *lead, d_in, d_out = w.shape
        root = torch.full((), float(d_in), dtype=torch.float32,
                          device=w.device).sqrt().to(w.dtype)
        a = torch.randn((*lead, d_in, lc.rank), generator=generator,
                        dtype=torch.float32, device=w.device).to(w.dtype)
        adapters[name] = {
            "a": a / root,
            "b": torch.zeros((*lead, lc.rank, d_out), dtype=w.dtype,
                             device=w.device),
        }
    return adapters


def merge_lora(params: dict, adapters: dict, lc: LoraConfig,
               groups: dict | None = None) -> dict:
    """Base params + ``(A@B)·s`` on every adapted leaf → a plain param
    tree (the base's structure; the other leaves are the base's own
    tensors). Over a mesh, params and adapters are this rank's blocks and
    ``groups`` (:func:`merge_groups`) the lines the merge's backward sums
    A and B over."""
    layers = dict(params["layers"])
    for name, ab in adapters.items():
        w = layers[name]
        a, b = ab["a"], ab["b"]
        if groups is not None:
            a = copy_to(a, groups[name]["a"])
            b = copy_to(b, groups[name]["b"])
        # a fill, not a host copy: the merge runs inside a captured step
        scale = torch.full((), lc.scale, dtype=torch.float32,
                           device=w.device).to(w.dtype)
        layers[name] = w + torch.matmul(a, b) * scale
    return {**params, "layers": layers}


def lora_loss_fn(adapters: dict, params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig, lc: LoraConfig,
                 groups: dict | None = None) -> torch.Tensor:
    """``loss_fn`` of the merged model."""
    return loss_fn(merge_lora(params, adapters, lc, groups), tokens, cfg)


def make_lora_optimizer(lc: LoraConfig, learning_rate: float = 1e-4
                        ) -> AdamW:
    """optax ``adamw(learning_rate, weight_decay=0.0)`` over the adapters:
    a constant rate (no warm-up: a linear schedule over 0 steps would be
    a rate of 0), no weight decay on B, no clip."""
    del lc
    return AdamW(learning_rate=learning_rate, warmup_steps=None, b1=0.9,
                 b2=0.999, weight_decay=0.0, grad_clip=None)


def init_lora_state(generator: torch.Generator, params: dict,
                    cfg: ModelConfig, lc: LoraConfig,
                    learning_rate: float = 1e-4) -> dict:
    adapters = init_lora(generator, params, cfg, lc)
    return {"adapters": adapters,
            "opt_state": make_lora_optimizer(lc, learning_rate).init(
                adapters),
            "step": 0}


def _value_and_grad(adapters: dict, params: dict, batch: torch.Tensor,
                    cfg: ModelConfig, lc: LoraConfig
                    ) -> tuple[torch.Tensor, list]:
    return value_and_grad(
        lambda a: lora_loss_fn(a, params, batch, cfg, lc), adapters)


def lora_train_step(state: dict, params: dict, batch: torch.Tensor,
                    cfg: ModelConfig, lc: LoraConfig,
                    learning_rate: float = 1e-4) -> tuple[dict, torch.Tensor]:
    """One finetuning step, out of place → (new state, f32 loss): the
    gradients of the adapters alone; the base and the argument state stay
    as they were."""
    loss, grads = _value_and_grad(state["adapters"], params, batch, cfg, lc)
    adapters, opt_state = make_lora_optimizer(lc, learning_rate).update(
        _unflatten(state["adapters"], iter(grads)), state["opt_state"],
        state["adapters"])
    return ({"adapters": adapters, "opt_state": opt_state,
             "step": state["step"] + 1}, loss)


def make_lora_step(cfg: ModelConfig, lc: LoraConfig, state: dict,
                   params: dict, batch_shape: tuple[int, int], *,
                   learning_rate: float = 1e-4, graphs: bool = True
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """→ ``step(batch) → loss``, the one-device counterpart of the
    reference's ``make_sharded_lora_step``: each call copies ``batch``
    ((batch, seq+1) int, of ``batch_shape``) into the step's own input
    buffer, then runs the merge, forward, backward and the adapters'
    AdamW update as one program (``util/graphs.py``: on the card a CUDA
    graph captured at the first call). ``params`` (the base) is read in
    place and never written; ``state``'s adapters, moments and count are
    updated in place, ``state["step"]`` counts on the host, and the loss
    comes back in one f32 buffer that the next call overwrites.
    ``graphs=False`` runs the same body eagerly; ``step.program`` holds
    the program."""
    batch_shape = tuple(batch_shape)
    device = tree_leaves(params)[0].device
    opt = make_lora_optimizer(lc, learning_rate)
    batch_in = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    loss_out = torch.zeros((), dtype=torch.float32, device=device)

    def body():
        loss, grads = _value_and_grad(state["adapters"], params, batch_in,
                                      cfg, lc)
        opt.update_(grads, state["opt_state"], state["adapters"])
        loss_out.copy_(loss)

    program = Program(body, device, graphs=graphs)

    def step(batch: torch.Tensor) -> torch.Tensor:
        if tuple(batch.shape) != batch_shape:
            raise ValueError(f"batch {tuple(batch.shape)} is not the step's "
                             f"{batch_shape}")
        batch_in.copy_(batch, non_blocking=True)
        program()
        state["step"] += 1
        return loss_out

    step.program = program
    return step


# -- over a mesh --------------------------------------------------------------

def lora_shardings(cfg: ModelConfig, lc: LoraConfig, mesh: Mesh) -> dict:
    """Adapter shardings from each base leaf's logical axes: A keeps the
    leading and input axes and replicates the rank; B keeps the leading
    axes, replicates the rank and keeps the output axis."""
    layer_axes = logical_axes(cfg)["layers"]
    out: dict[str, dict] = {}
    for name in lc.targets:
        axes = layer_axes[name]          # e.g. ("layer", "embed", "heads")
        lead, ax_in, ax_out = axes[:-2], axes[-2], axes[-1]
        out[name] = {
            "a": NamedSharding(mesh, logical_to_spec((*lead, ax_in, None),
                                                     mesh=mesh)),
            "b": NamedSharding(mesh, logical_to_spec((*lead, None, ax_out),
                                                     mesh=mesh)),
        }
    return out


def merge_groups(cfg: ModelConfig, lc: LoraConfig, mesh: Mesh) -> dict:
    """{target: {"a": group, "b": group}}: the lines over which the
    merge's backward sums A's gradient (the axes splitting the base's
    output dimension) and B's (its input dimension), data-like axes left
    to the step's gradient sum; None where there is nothing to sum."""
    w_sh = param_shardings(logical_axes(cfg), mesh)["layers"]

    def line(sh, dim):
        return mesh.group(tuple(a for a in sh.axes(dim)
                                if a not in DATA_AXES))

    out = {}
    for name in lc.targets:
        sh = w_sh[name]
        nd = len(sh.spec)
        out[name] = {"a": line(sh, nd - 1), "b": line(sh, nd - 2)}
    return out


def make_sharded_lora_step(cfg: ModelConfig, lc: LoraConfig, mesh: Mesh,
                           state: dict, params: dict,
                           batch_shape: tuple[int, int], *,
                           learning_rate: float = 1e-4
                           ) -> tuple[Callable, dict, dict, NamedSharding]:
    """→ (step, state shardings, param shardings, batch sharding): the
    reference's ``make_sharded_lora_step`` on one rank, the finetuning
    counterpart of ``make_sharded_train_step``. ``state`` and ``params``
    are whole, as every rank made them from the one seed; both are
    sharded in place (the base by the model's own logical axes, the
    adapters by :func:`lora_shardings`, their moments after them), so the
    caller's trees hold this rank's blocks after the call.
    ``step(batch)`` takes this rank's rows of a global ``batch_shape``
    batch (``trainer.shard_batch``) and returns the batch's mean loss (an
    f32 buffer that the next call overwrites): the merge on this rank's
    blocks, the loss under ``parallel.mesh_context``, the adapters'
    gradients reduced over the data-like ranks, the AdamW update of the
    adapters and their moments in place; the base is read in place and
    never written. One CUDA graph under NCCL, eager over gloo; a trivial
    mesh gives :func:`make_lora_step`'s step."""
    batch_shape = tuple(batch_shape)
    a_sh = lora_shardings(cfg, lc, mesh)
    state_sh = {"adapters": a_sh,
                "opt_state": _opt_leaf_shardings(
                    state["opt_state"], state["adapters"], a_sh, mesh),
                "step": None}
    p_sh = param_shardings(logical_axes(cfg), mesh)
    b_sh = batch_sharding(mesh)
    if mesh.size == 1:
        return (make_lora_step(cfg, lc, state, params, batch_shape,
                               learning_rate=learning_rate),
                state_sh, p_sh, b_sh)
    _check_mesh(cfg, mesh, batch_shape[0])
    shard_state({"params": params}, {"params": p_sh})
    shard_state(state, state_sh)
    adapters = state["adapters"]
    device = tree_leaves(params)[0].device
    shards = Shards(mesh, a_sh, adapters)
    groups = merge_groups(cfg, lc, mesh)
    local_shape = (batch_shape[0] // shards.n_dp, batch_shape[1])
    opt = make_lora_optimizer(lc, learning_rate)
    batch_in = torch.zeros(local_shape, dtype=torch.int32, device=device)
    loss_out = torch.zeros((), dtype=torch.float32, device=device)

    def body():
        with mesh_context(mesh):
            value, grads = value_and_grad(
                lambda a: lora_loss_fn(a, params, batch_in, cfg, lc, groups),
                adapters)
        grads = shards.reduce_grads(grads)
        opt.update_(grads, state["opt_state"], adapters, shards=shards)
        loss_out.copy_(shards.mean_loss(value))

    program = Program(body, device, graphs=_graphs_for(device))

    def step(batch: torch.Tensor) -> torch.Tensor:
        if tuple(batch.shape) != local_shape:
            raise ValueError(f"batch {tuple(batch.shape)} is not this "
                             f"rank's rows {local_shape} of {batch_shape}")
        batch_in.copy_(batch, non_blocking=True)
        program()
        state["step"] += 1
        return loss_out

    step.program = program
    step.local_shape = local_shape
    return step, state_sh, p_sh, b_sh
