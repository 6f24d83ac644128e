"""Pipeline parallelism: GPipe microbatch pipelining over a mesh ``stage``
axis (port of ``tpu_kubernetes/parallel/pipeline.py``).

The decoder's layer stack is split into S contiguous stages: every layer
leaf is split over ``stage`` on its leading (layer) axis and over nothing
else (:func:`pipeline_param_shardings`), so each stage's ranks hold
n_layers/S whole layers. The batch is split into M microbatches, which
flow stage to stage over M + S − 1 ticks: on every tick each stage runs
its layers on the microbatch it holds and hands the activation on to the
next (:func:`~tpu_kubernetes_torch.parallel.collectives.ppermute`,
non-cyclic ``i → i+1``). Autograd through the shift sends the cotangents
back the other way, so one backward of :func:`pipeline_loss_fn` is a
whole pipelined step. Inside the pipeline the blocks run whole on every
``tensor`` and ``fsdp`` rank (outside ``mesh_context``'s Megatron and
fsdp splits, as the reference's ``shard_map`` runs the plain block); each
rank holds its data-like block of each microbatch
(``train/trainer.py`` ``local_rows`` with ``accum_steps = M``).

The embedding, final norm and head run outside the pipeline under the
default rules (the vocab-parallel head and loss over ``tensor``, the
embedding gathered over ``fsdp``). Three places decide the numbers:

* the microbatches enter replicated over ``stage`` and only stage 0 reads
  them, so they pass through ``copy_to`` over the stage line (identity
  forward, all-reduce backward): every stage's replica of the embedding
  gets stage 0's gradient;
* the output buffer, the last stage's, is summed over ``stage`` forward
  and passed through backward (``reduce_from``): every stage's head sees
  the same activations and the last stage alone takes a cotangent in;
* a stage skips its layers on a bubble tick (a microbatch index outside
  0..M−1 for it): a static choice by stage and tick whose output the
  reference computes and never uses. The shift still runs on every tick
  on every rank, carrying zeros, and a token threads all of them
  (``collectives.ppermute``), so every rank runs the same shifts in the
  same order in its backward.

Dense LLaMA only, as in the reference, whose body runs the dense block.
"""

from __future__ import annotations

import math
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from tpu_kubernetes_torch.parallel.collectives import (
    chain_token,
    copy_to,
    ppermute,
    reduce_from,
)
from tpu_kubernetes_torch.parallel.mesh import (
    DEFAULT_RULES,
    Mesh,
    NamedSharding,
    PartitionSpec,
    data_axes_in,
    logical_to_spec,
    mesh_context,
)

# models/ imports this package (its blocks' collectives), so the model
# functions are imported where they run


def _pipeline_body(layers: dict, x_mb: torch.Tensor, cfg, n_stages: int,
                   stage: int, stage_group) -> torch.Tensor:
    """One rank's part of the pipeline. layers: this stage's
    (n_layers/S, …) leaves, whole; x_mb: (M, mb, s, d) this rank's rows
    of every microbatch. → the last stage's outputs (M, mb, s, d), on
    every stage."""
    from tpu_kubernetes_torch.models.llama import _block, remat_policy_kwargs
    from tpu_kubernetes_torch.ops import rope_tables

    M = x_mb.shape[0]
    cos, sin = rope_tables(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                           x_mb.device)
    remat = cfg.remat and torch.is_grad_enabled()
    kwargs = remat_policy_kwargs(cfg) if remat else {}
    stacked = {k: v.unbind(0) for k, v in layers.items()}
    n_local = layers["wq"].shape[0]

    def block(cfg, cos, sin, x, layer):
        # whole on every rank, in the forward and in remat's recompute
        # (the backward runs under the step's mesh)
        with mesh_context(None):
            return _block(cfg, cos, sin, x, layer)

    def run_stage(act):
        for li in range(n_local):
            layer = {k: v[li] for k, v in stacked.items()}
            if remat:
                act = checkpoint(block, cfg, cos, sin, act, layer, **kwargs)
            else:
                act = block(cfg, cos, sin, act, layer)
        return act

    fwd = [(i, i + 1) for i in range(n_stages - 1)]     # non-cyclic
    act = torch.zeros_like(x_mb[0])
    token = chain_token(x_mb)
    outs = []
    for t in range(M + n_stages - 1):
        if stage == 0 and t < M:
            act = x_mb[t]                   # stage 0 ingests microbatch t
        if 0 <= t - stage < M:
            out = run_stage(act)
        else:                               # a bubble tick: nothing to run
            out = torch.zeros_like(act)
        if stage == n_stages - 1 and t >= n_stages - 1:
            outs.append(out)    # the last stage finishes microbatch t-(S-1)
        # hand the activation to the next stage (stage 0 receives zeros)
        act, token = ppermute((out, token), fwd, stage_group)
    buf = (torch.stack(outs) if stage == n_stages - 1
           else torch.zeros_like(x_mb))
    # replicate the last stage's buffer over the stage line
    return reduce_from(buf, stage_group) + token.to(buf.dtype)


def _check(cfg, mesh: Mesh, rows: int, n_microbatches: int,
           stage_axis: str) -> None:
    """The reference's two "not divisible" errors (the layers over the
    stages, the global batch over the microbatches), and the family."""
    if hasattr(cfg, "n_experts"):
        raise ValueError("the pipeline runs the dense LLaMA block only, as "
                         "the reference's does: a MoE config is not "
                         "pipelined")
    S = mesh.axis_size(stage_axis)
    if cfg.n_layers % S:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by {S} "
                         "stages")
    batch = rows * math.prod(mesh.shape[a] for a in data_axes_in(mesh))
    if batch % n_microbatches:
        raise ValueError(f"batch {batch} not divisible by {n_microbatches} "
                         "microbatches")


def _pipelined_logits(params: dict, tokens: torch.Tensor, cfg, mesh: Mesh,
                      n_microbatches: int, stage_axis: str) -> torch.Tensor:
    """The embedding, the pipeline and the head of this rank's rows → its
    columns of the f32 logits (vocab-split under ``tensor``)."""
    from tpu_kubernetes_torch.models.llama import embed_tokens, head_logits

    _check(cfg, mesh, tokens.shape[0], n_microbatches, stage_axis)
    stage_group = mesh.group(stage_axis)
    with mesh_context(mesh):
        x = embed_tokens(params, tokens, cfg)             # (rows, s, d)
    x = copy_to(x, stage_group)
    x_mb = x.reshape(n_microbatches, x.shape[0] // n_microbatches,
                     *x.shape[1:])
    x = _pipeline_body(params["layers"], x_mb, cfg,
                       mesh.axis_size(stage_axis),
                       mesh.my_coords().get(stage_axis, 0), stage_group)
    with mesh_context(mesh):
        return head_logits(params, x.reshape(-1, *x.shape[2:]), cfg)


def pipeline_forward(params: dict, tokens: torch.Tensor, cfg, mesh: Mesh,
                     n_microbatches: int, stage_axis: str = "stage"
                     ) -> torch.Tensor:
    """tokens: this rank's rows, (rows, seq) int: its data-like block of
    each microbatch (``train/trainer.py`` ``shard_batch`` with
    ``accum_steps = n_microbatches``) → the f32 logits (rows, seq, vocab)
    of those rows, the layer stack pipelined over ``stage_axis``; params:
    this rank's blocks under :func:`pipeline_param_shardings`. Collective
    over the mesh."""
    from tpu_kubernetes_torch.models.llama import full_logits

    logits = _pipelined_logits(params, tokens, cfg, mesh, n_microbatches,
                               stage_axis)
    with mesh_context(mesh):
        return full_logits(logits)


def pipeline_loss_fn(params: dict, tokens: torch.Tensor, cfg, mesh: Mesh,
                     n_microbatches: int) -> torch.Tensor:
    """The next-token loss of this rank's rows (rows, seq+1) through the
    pipeline: their mean (the sharded step averages it over the data-like
    ranks); vocab-parallel under ``tensor``."""
    from tpu_kubernetes_torch.models.llama import nll

    logits = _pipelined_logits(params, tokens[:, :-1], cfg, mesh,
                               n_microbatches, "stage")
    with mesh_context(mesh):
        return nll(logits, tokens[:, 1:])


def pipeline_param_shardings(logical_tree: Any, mesh: Mesh) -> Any:
    """Shardings for pipelined training: every layer-stacked leaf splits
    its leading axis over ``stage`` and nothing else; the boundary leaves
    (embedding, final norm, head) follow the default logical rules."""
    if isinstance(logical_tree, dict):
        return {k: pipeline_param_shardings(v, mesh)
                for k, v in logical_tree.items()}
    if "layer" in logical_tree:
        return NamedSharding(mesh, PartitionSpec(
            *("stage" if name == "layer" else None for name in logical_tree)))
    return NamedSharding(mesh, logical_to_spec(logical_tree, DEFAULT_RULES,
                                               mesh))
