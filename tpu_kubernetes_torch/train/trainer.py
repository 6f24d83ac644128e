"""Training step and state for one device (port of the single-device
part of ``tpu_kubernetes/train/trainer.py``).

The state is ``{"params", "opt_state", "step"}``: params a nested dict of
tensors as the model family lays them out, ``step`` a Python int (the
optimizer's own count is a device tensor in ``opt_state``).
:func:`make_train_step` (the job's step: in place, a CUDA graph on the
card) and :func:`train_step` (out of place, the parity tests') take the
gradients of the family's ``loss_fn``
(``models.loss_fn`` dispatches on the config: dense LLaMA or MoE) with
``torch.autograd`` (on the card the attention gradient runs the two
backward flash kernels, and MoE's grouped expert products the grouped
kernels) and apply the optimizer ``TrainConfig.optimizer`` names:
:class:`AdamW` (the reference's optax chain ``clip_by_global_norm`` →
``adamw`` term for term) or :class:`Adafactor` (``clip_by_global_norm`` →
``adafactor``, likewise). :func:`make_sharded_train_step` and
:func:`make_sharded_eval_step` are the reference's steps over a mesh
(``parallel/``): one process per card, each on its shards of the state
(:func:`state_shardings`, :func:`shard_state`, :func:`gather_state`) and
its rows of the batch; :func:`make_pipeline_train_step` is the step with
the layer stack pipelined over ``stage`` (``parallel/pipeline.py``). The
LoRA steps, one device and sharded, are ``train/lora.py``'s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from tpu_kubernetes_torch.models import (
    ModelConfig,
    init_params,
    logical_axes,
    loss_fn,
)
from tpu_kubernetes_torch.ops.adamw import (
    Hyper,
    adamw_,
    clip_factors,
    global_norm,
)
from tpu_kubernetes_torch.parallel.collectives import all_reduce_raw
from tpu_kubernetes_torch.parallel.mesh import (
    Mesh,
    NamedSharding,
    PartitionSpec,
    batch_sharding,
    data_axes_in,
    gather_tensor,
    mesh_context,
    param_shardings,
    shard_tensor,
    this_rank,
    tree_map_shardings,
)
from tpu_kubernetes_torch.util.graphs import Program


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    warmup_steps: int = 100
    # gradient accumulation: the (batch, seq+1) step batch is split into
    # accum_steps microbatches run one after another, gradients summed in
    # float32, ONE optimizer update — numerically the full-batch step
    accum_steps: int = 1
    # "adamw" (default) or "adafactor": a factored second moment and a bf16
    # first moment, for less optimizer state (see :class:`Adafactor`)
    optimizer: str = "adamw"


# -- tree helpers (params are nested dicts of tensors) ------------------------

def tree_leaves(tree: dict) -> list:
    out = []
    for v in tree.values():
        out.extend(tree_leaves(v) if isinstance(v, dict) else (v,))
    return out


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    return {
        k: (tree_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)))
        for k, v in tree.items()
    }


def _unflatten(tree: dict, leaves: Iterator) -> dict:
    return tree_map(lambda _: next(leaves), tree)


# -- the optimizer -----------------------------------------------------------

@dataclass(frozen=True)
class AdamW:
    """optax ``chain(clip_by_global_norm(grad_clip), adamw(
    linear_schedule(0, lr, warmup_steps), b1, b2, eps=1e-8, weight_decay))``
    written out, because ``torch.optim.AdamW`` differs from it: torch
    decays as ``p·(1 − lr·wd)`` before the Adam step and reads its
    learning rate after counting the step, where optax adds ``wd·p`` to
    the Adam direction, scales the sum by the learning rate read at the
    count *before* it increments (so the first update runs at lr 0), and
    clips by one global norm over every gradient leaf first. Term for
    term, per leaf, as optax computes it:

    * clip: ``norm = √Σ g²`` over all leaves in f32; ``g ← g / div · mul``
      with ``div`` the norm cast to the leaf dtype and ``mul = grad_clip``
      when ``norm ≥ grad_clip``, and both 1 below it (optax's select,
      made on the device, so the update never waits for it);
    * ``mu ← (1−b1)·g + b1·mu``, ``nu ← (1−b2)·g² + b2·nu``, kept in the
      parameter dtype (optax's default ``mu_dtype``), so bf16 at llama-1b
      and f32 for MoE's f32 router in a bf16 model;
    * ``u = (mu / (1−b1^t)) / (√(nu / (1−b2^t)) + eps)`` with t the count
      after incrementing, bias corrections in f32;
    * ``u ← u + wd·p`` on every leaf, norms included (no mask);
    * ``p ← p − lr_t·u`` with ``lr_t`` cast to the leaf dtype first.

    The count is an int32 tensor on the parameters' device, and the
    schedule and both bias corrections are computed from it there, in
    f32, as optax computes them inside the reference's jitted step: a
    captured step reads them at every replay. The elementwise terms run
    in f32 and round where optax stores a value (mu, nu and p in the
    parameter dtype): in f32 that is optax number for number up to
    summation order and the ulp of the bias corrections' ``pow``; in bf16
    XLA's fusions round at places of their own, so the two agree within a
    bf16 ulp of each value. On the card the update is the fused kernel of
    ``ops/adamw.py`` (``csrc/adamw.cu``), on the CPU its plain version."""

    learning_rate: float
    # None: a constant learning rate (optax's float ``learning_rate``), the
    # LoRA optimizer's; an int: the linear warm-up from 0
    warmup_steps: int | None
    b1: float
    b2: float
    weight_decay: float
    # None: no clip (the LoRA optimizer's); the norm kernel does not run
    grad_clip: float | None
    eps = 1e-8                      # optax.adamw's default

    def schedule(self, count) -> torch.Tensor:
        """The learning rate at ``count`` (see :func:`learning_rate_at`)."""
        return learning_rate_at(self.learning_rate, self.warmup_steps, count)

    def scalars(self, count: torch.Tensor) -> torch.Tensor:
        """(step size, 1 − b1^t, 1 − b2^t) as one f32 (3,) tensor on the
        count's device: the step size reads the count before it moves, the
        bias corrections t = count + 1."""
        t = (count + 1).float()
        bc = [1 - torch.pow(torch.full((), b, dtype=torch.float32,
                                       device=count.device), t)
              for b in (self.b1, self.b2)]
        return torch.stack([-self.schedule(count), *bc])

    def hyper(self) -> Hyper:
        return Hyper(b1=self.b1, b2=self.b2, eps=self.eps,
                     weight_decay=self.weight_decay,
                     grad_clip=(math.inf if self.grad_clip is None
                                else self.grad_clip))

    def init(self, params: dict) -> dict:
        device = tree_leaves(params)[0].device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update_(self, grads: list, opt_state: dict, params: dict,
                shards: "Shards | None" = None) -> None:
        """One step in place: ``params``, ``opt_state``'s mu, nu and count
        are written where they lie, as the reference's step donates its
        state. ``grads`` are the leaves in ``tree_leaves(params)`` order.
        With ``shards`` the leaves are this rank's blocks and the clip
        reads the whole model's norm (:meth:`Shards.global_norm`)."""
        norm = None
        if shards is not None and self.grad_clip is not None:
            norm = shards.global_norm(grads)
        adamw_(grads, tree_leaves(params), tree_leaves(opt_state["mu"]),
               tree_leaves(opt_state["nu"]),
               self.scalars(opt_state["count"]), self.hyper(), norm=norm)
        opt_state["count"].add_(1)

    def update(self, grads: dict, opt_state: dict, params: dict
               ) -> tuple[dict, dict]:
        """One step → (new params, new optimizer state), :meth:`update_` on
        copies: the arguments stay valid."""
        params = tree_map(torch.clone, params)
        opt_state = tree_map(torch.clone, opt_state)
        self.update_(tree_leaves(grads), opt_state, params)
        return params, opt_state


def learning_rate_at(learning_rate: float, warmup_steps: int | None,
                     count) -> torch.Tensor:
    """optax's learning rate at ``count`` in f32, on ``count``'s device (a
    0-d tensor, or an int for the CPU): ``linear_schedule(0, lr,
    warmup_steps)(count)``, or ``lr`` itself when ``warmup_steps`` is
    None (a float ``learning_rate``)."""
    count = torch.as_tensor(count)
    dev = count.device

    def f32(x):                 # a divisor from a fill, not a host copy
        return torch.full((), x, dtype=torch.float32, device=dev)

    if warmup_steps is None:
        return f32(learning_rate)
    if warmup_steps <= 0:           # optax: the constant init value
        return f32(0.0)
    c = count.clamp(0, warmup_steps).float()
    frac = 1 - c / f32(float(warmup_steps))
    return f32(0.0 - learning_rate) * frac + f32(learning_rate)


MIN_DIM_SIZE_TO_FACTOR = 128        # optax.adafactor's default


def factored_dims(shape: tuple[int, ...]) -> tuple[int, int] | None:
    """optax's ``_factored_dims`` (``factored=True``, ``min_dim_size_to_
    factor`` 128): the (second-largest, largest) axes by ``np.argsort`` of
    the shape, ties as it orders them, or None when the leaf has fewer
    than two axes or its second-largest is under 128 (then its second
    moment is kept whole)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < MIN_DIM_SIZE_TO_FACTOR:
        return None
    return int(order[-2]), int(order[-1])


@dataclass(frozen=True)
class Adafactor:
    """optax ``chain(clip_by_global_norm(grad_clip), adafactor(
    linear_schedule(0, lr, warmup_steps), momentum=b1,
    dtype_momentum=bfloat16, weight_decay_rate=wd or None,
    multiply_by_parameter_scale=False))`` (the reference's
    ``make_optimizer``; optax 0.2.6 ``_src/alias.py`` ``adafactor``,
    ``_src/factorized.py``) written out term for term, per leaf:

    * clip: one global norm over every gradient leaf, as :class:`AdamW`'s
      (on the card the ``adamw_sumsq`` kernel);
    * ``scale_by_factored_rms``: ``g² + 1e-30``; the decay ``β = 1 −
      (t+1)^-0.8`` with t the count before it moves, in f32 on the
      count's device (a captured step reads it at every replay). A leaf
      :func:`factored_dims` factors over axes (d1, d0) keeps ``v_row`` =
      ``β·v_row + (1−β)·mean(g², d0)`` and ``v_col`` = ``β·v_col +
      (1−β)·mean(g², d1)``, each stored in the **parameter's dtype**, and
      takes ``u = g · (v_row / mean(v_row))^-½ · v_col^-½`` from the stored
      values; any other leaf keeps a whole ``v`` = ``β·v + (1−β)·g²`` and
      takes ``u = g · v^-½``. The unused statistics are (1,) zeros, as
      optax keeps them;
    * ``clip_by_block_rms(1)``: ``u ← u / max(1, rms(u))`` per leaf;
    * the learning rate of the count before it moves (0 at the first
      step), cast to the leaf's dtype, times u;
    * ``ema(b1, debias=False)``: ``mu ← (1−b1)·u + b1·mu``, stored in
      bf16 whatever the leaf's dtype, and u is that sum in the leaf's dtype
      before the bf16 rounding;
    * ``add_decayed_weights(wd)``: ``u ← u + wd·p``, **after** the learning
      rate (each step takes ``wd·p`` off p whatever the rate: the
      reference's behaviour, matched, ``ROADMAP.md`` "Found in the
      reference"); no term when wd is 0;
    * ``scale(-1)`` and ``p ← p + (−u)`` in the leaf's dtype.

    The terms run in f32 and round where optax stores a value (v_row,
    v_col, v and p in the parameter's dtype, mu in bf16): in f32 that is
    optax number for number up to summation order and the ulps of
    ``pow``; in bf16 XLA rounds its fused terms at places of its own.
    Plain tensor ops, as XLA fuses optax's update in the reference (no
    Pallas kernel there), updated in place with no host read."""

    learning_rate: float
    warmup_steps: int
    momentum: float
    weight_decay: float
    grad_clip: float
    decay_rate = 0.8                # optax.adafactor's defaults
    eps = 1e-30
    clipping_threshold = 1.0
    momentum_dtype = torch.bfloat16

    def schedule(self, count) -> torch.Tensor:
        return learning_rate_at(self.learning_rate, self.warmup_steps, count)

    def decay(self, count: torch.Tensor) -> torch.Tensor:
        """optax's ``_decay_rate_pow``: ``1 − (count+1)^-0.8`` in f32 on the
        count's device."""
        t = (count + 1).float()
        return 1.0 - torch.pow(t, -self.decay_rate)

    def init(self, params: dict) -> dict:
        device = tree_leaves(params)[0].device

        def stat(p, which):
            dims = factored_dims(tuple(p.shape))
            if which == "v":
                shape = (1,) if dims else p.shape
            elif dims is None:
                shape = (1,)
            else:   # v_row drops the largest axis, v_col the second
                drop = dims[1] if which == "v_row" else dims[0]
                shape = p.shape[:drop] + p.shape[drop + 1:]
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                **{k: tree_map(lambda p, k=k: stat(p, k), params)
                   for k in ("v_row", "v_col", "v")},
                "mu": tree_map(lambda p: torch.zeros_like(
                    p, dtype=self.momentum_dtype), params)}

    def update_(self, grads: list, opt_state: dict, params: dict,
                shards: "Shards | None" = None) -> None:
        """One step in place: ``params`` and every statistic of
        ``opt_state`` written where they lie; ``grads`` are the leaves in
        ``tree_leaves(params)`` order. With ``shards`` the leaves are this
        rank's blocks: the factoring rule reads each whole leaf's shape,
        and the clip's norm, the row and column means and the update's RMS
        are all-reduced over the mesh axes that split what they reduce."""
        count = opt_state["count"]
        if shards is None:
            norm = global_norm(grads)
            layouts = [None] * len(grads)
        else:
            norm = shards.global_norm(grads)
            layouts = shards.leaves
        beta = self.decay(count)
        rate = self.schedule(count)
        per_dtype = {}
        for g, p, v_row, v_col, v, mu, sh in zip(
                grads, tree_leaves(params),
                *(tree_leaves(opt_state[k])
                  for k in ("v_row", "v_col", "v", "mu")), layouts):
            if p.dtype not in per_dtype:
                per_dtype[p.dtype] = (*clip_factors(norm, self.grad_clip,
                                                    p.dtype),
                                      rate.to(p.dtype).float())
            div, mul, lr = per_dtype[p.dtype]
            g = g.float() / div * mul
            g2 = g * g + self.eps
            dims = factored_dims(_whole_shape(p, sh))
            if dims is not None:
                d1, d0 = dims
                v_row.copy_(beta * v_row.float()
                            + (1 - beta) * _mean(g2, d0, sh))
                v_col.copy_(beta * v_col.float()
                            + (1 - beta) * _mean(g2, d1, sh))
                row = v_row.float()     # d1's axis once d0 is gone:
                row = torch.rsqrt(row / _mean(
                    row, d1 - 1 if d1 > d0 else d1, sh, keepdim=True,
                    split=d1))
                u = (g * row.unsqueeze(d0)
                     * torch.rsqrt(v_col.float()).unsqueeze(d1))
            else:
                v.copy_(beta * v.float() + (1 - beta) * g2)
                u = g * torch.rsqrt(v.float())
            rms = torch.sqrt(_mean_all(u * u, sh))
            u = u / torch.clamp(rms / self.clipping_threshold, min=1.0)
            m = (1 - self.momentum) * (lr * u) + self.momentum * mu.float()
            mu.copy_(m)
            u = m.to(p.dtype).float()
            if self.weight_decay:
                u = u + self.weight_decay * p.float()
            p.copy_(p.float() + (-u))
        count.add_(1)

    def update(self, grads: dict, opt_state: dict, params: dict
               ) -> tuple[dict, dict]:
        """One step → (new params, new optimizer state), :meth:`update_` on
        copies: the arguments stay valid."""
        params = tree_map(torch.clone, params)
        opt_state = tree_map(torch.clone, opt_state)
        self.update_(tree_leaves(grads), opt_state, params)
        return params, opt_state


def _whole_shape(p: torch.Tensor, sh: NamedSharding | None
                 ) -> tuple[int, ...]:
    """The whole leaf's shape of this rank's block ``p``."""
    if sh is None:
        return tuple(p.shape)
    return tuple(n * sh.parts(d) for d, n in enumerate(p.shape))


def _mean(x: torch.Tensor, dim: int, sh: NamedSharding | None,
          keepdim: bool = False, split: int | None = None) -> torch.Tensor:
    """``x.mean(dim)`` over the whole leaf: this rank's block mean,
    averaged over the ranks that split that dimension (``split``: its
    index in the leaf's sharding, when ``x`` has lost a dimension)."""
    out = x.mean(dim, keepdim=keepdim)
    if sh is None:
        return out
    axes = sh.axes(dim if split is None else split)
    if not axes:
        return out
    return all_reduce_raw(out, sh.mesh.group(axes)) / sh.parts(
        dim if split is None else split)


def _mean_all(x: torch.Tensor, sh: NamedSharding | None) -> torch.Tensor:
    """``x.mean()`` over the whole leaf (equal blocks: the mean of the
    ranks' means over every axis that splits it)."""
    out = torch.mean(x)
    if sh is None or not sh.split_axes():
        return out
    axes = sh.split_axes()
    n = math.prod(sh.mesh.shape[a] for a in axes)
    return all_reduce_raw(out, sh.mesh.group(axes)) / n


def make_optimizer(tc: TrainConfig) -> AdamW | Adafactor:
    if tc.optimizer == "adafactor":
        return Adafactor(learning_rate=tc.learning_rate,
                         warmup_steps=tc.warmup_steps, momentum=tc.beta1,
                         weight_decay=tc.weight_decay,
                         grad_clip=tc.grad_clip)
    if tc.optimizer != "adamw":
        raise ValueError(
            f"unknown optimizer {tc.optimizer!r} (adamw | adafactor)"
        )
    return AdamW(learning_rate=tc.learning_rate,
                 warmup_steps=tc.warmup_steps, b1=tc.beta1, b2=tc.beta2,
                 weight_decay=tc.weight_decay, grad_clip=tc.grad_clip)


def init_state(generator: torch.Generator, cfg: ModelConfig, tc: TrainConfig,
               device: torch.device | str = "cuda") -> dict[str, Any]:
    """Random params from ``generator`` (on ``device``), zero moments."""
    params = init_params(cfg, generator, device)
    return {"params": params, "opt_state": make_optimizer(tc).init(params),
            "step": 0}


def value_and_grad(fn: Callable[[dict], torch.Tensor], tree: dict
                   ) -> tuple[torch.Tensor, list]:
    """``fn(tree)`` and its gradient leaves, in ``tree_leaves(tree)`` order
    and contiguous (as the fused update takes them); nothing but ``tree``
    is differentiated."""
    leaves = [t.detach().requires_grad_(True) for t in tree_leaves(tree)]
    with torch.enable_grad():
        loss = fn(_unflatten(tree, iter(leaves)))
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), [g.contiguous() for g in grads]


def _value_and_grad(params: dict, batch: torch.Tensor, cfg: ModelConfig,
                    loss: Callable | None = None
                    ) -> tuple[torch.Tensor, list]:
    lossf = loss or loss_fn
    return value_and_grad(lambda p: lossf(p, batch, cfg), params)


def _check_accum(rows: int, tc: TrainConfig) -> None:
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
    if rows % tc.accum_steps:
        raise ValueError(
            f"batch rows {rows} not divisible by accum_steps "
            f"{tc.accum_steps}"
        )


def _loss_and_grads(params: dict, batch: torch.Tensor, cfg: ModelConfig,
                    tc: TrainConfig, loss: Callable | None = None
                    ) -> tuple[torch.Tensor, list]:
    """The step's loss (``loss(params, batch, cfg)``, by default the
    family's ``loss_fn``) and gradient leaves. ``tc.accum_steps > 1`` runs
    that many microbatches one after another, sums their gradients in
    float32 and casts ``Σg / accum_steps`` to each parameter's dtype; the
    loss is then the microbatch mean, as the reference computes it."""
    if tc.accum_steps == 1:
        return _value_and_grad(params, batch, cfg, loss)
    rows = batch.shape[0]
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)]
    lsum = torch.zeros((), dtype=torch.float32, device=batch.device)
    for mb in batch.reshape(tc.accum_steps, rows // tc.accum_steps, -1):
        lv, g = _value_and_grad(params, mb, cfg, loss)
        gsum = [a + b.float() for a, b in zip(gsum, g)]
        lsum = lsum + lv
    scale = 1.0 / tc.accum_steps
    grads = [(g * scale).to(p.dtype)
             for g, p in zip(gsum, tree_leaves(params))]
    return lsum * scale, grads


def train_step(
    state: dict[str, Any], batch: torch.Tensor, cfg: ModelConfig,
    tc: TrainConfig,
) -> tuple[dict[str, Any], torch.Tensor]:
    """One optimizer step, out of place. batch: (batch, seq+1) int tokens
    on the params' device. → (new state, f32 loss scalar on the device);
    the argument state stays valid (see :func:`_loss_and_grads` for
    ``tc.accum_steps``).

    The CPU parity tests call this form. The training job runs
    :func:`make_train_step`: the same loss, gradients and update, in
    place, captured as one CUDA graph on the card."""
    _check_accum(batch.shape[0], tc)
    params = state["params"]
    loss_value, grads = _loss_and_grads(params, batch, cfg, tc)
    new_params, new_opt = make_optimizer(tc).update(
        _unflatten(params, iter(grads)), state["opt_state"], params)
    return ({"params": new_params, "opt_state": new_opt,
             "step": state["step"] + 1}, loss_value)


def make_train_step(cfg: ModelConfig, tc: TrainConfig, state: dict[str, Any],
                    batch_shape: tuple[int, int], *, graphs: bool = True,
                    loss: Callable | None = None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """→ ``step(batch) → loss``: the one-device counterpart of the
    reference's ``make_sharded_train_step`` (``jax.jit`` of the step with
    the state donated). Each call copies ``batch`` ((batch, seq+1) int, of
    ``batch_shape``) into the step's own input buffer, then runs forward,
    backward (remat included), accumulation and the fused AdamW update as
    one program (``util/graphs.py``): on the card a CUDA graph captured at
    the first call and replayed after. ``state``'s params, mu, nu and
    count are updated in place, ``state["step"]`` counts on the host, and
    the loss comes back in one f32 buffer that the next call overwrites.
    ``graphs=False`` runs the same body eagerly (for comparisons);
    ``loss`` replaces the family's ``loss_fn``; ``step.program`` holds the
    program and its counts."""
    batch_shape = tuple(batch_shape)
    _check_accum(batch_shape[0], tc)
    params = state["params"]
    device = tree_leaves(params)[0].device
    opt = make_optimizer(tc)
    batch_in = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    loss_out = torch.zeros((), dtype=torch.float32, device=device)

    def body():
        value, grads = _loss_and_grads(params, batch_in, cfg, tc, loss)
        opt.update_(grads, state["opt_state"], params)
        loss_out.copy_(value)

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


def make_eval_step(cfg: ModelConfig, params: dict,
                   batch_shape: tuple[int, int], *, graphs: bool = True
                   ) -> Callable[[torch.Tensor], torch.Tensor]:
    """→ ``step(batch) → loss``: the loss-only forward, no gradient,
    nothing changed (the reference's jitted eval step on one device), as
    one program (``util/graphs.py``) over ``params``, read in place (the
    train job's, which its step updates in place). Each call copies
    ``batch`` ((batch, seq+1) int, of ``batch_shape``) into the step's own
    input buffer and writes the f32 loss into one buffer that the next
    call overwrites. On the card the first call captures a CUDA graph in
    a pool of its own, which writes nothing of the train step's.
    ``graphs=False`` runs the same body eagerly; ``step.program`` holds
    the program and its counts."""
    batch_shape = tuple(batch_shape)
    device = tree_leaves(params)[0].device
    batch_in = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    loss_out = torch.zeros((), dtype=torch.float32, device=device)

    @torch.no_grad()
    def body():
        loss_out.copy_(loss_fn(params, batch_in, cfg))

    program = Program(body, device, graphs=graphs)

    def step(batch: torch.Tensor) -> torch.Tensor:
        if tuple(batch.shape) != batch_shape:
            raise ValueError(f"batch {tuple(batch.shape)} is not the eval "
                             f"step's {batch_shape}")
        batch_in.copy_(batch, non_blocking=True)
        program()
        return loss_out

    step.program = program
    return step


def synthetic_batches(
    vocab_size: int, batch: int, seq: int, seed: int = 0,
    device: torch.device | str = "cuda",
) -> Iterator[torch.Tensor]:
    """Deterministic synthetic token stream from a seeded
    ``torch.Generator`` on ``device``; batches are (batch, seq+1) int32 so
    the next-token loss sees exactly ``seq`` positions. The draws differ
    from the reference's ``jax.random`` ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield torch.randint(0, vocab_size, (batch, seq + 1), generator=gen,
                            device=device, dtype=torch.int32)


# -- over a mesh -------------------------------------------------------------

def _check_mesh(cfg: ModelConfig, mesh: Mesh, rows: int,
                accum_steps: int = 1) -> None:
    """Raise ValueError, naming the axis and the dimension, where the
    reference would pad a split under GSPMD and the port does not.
    ``stage`` and ``sequence`` split nothing of the plain step: their
    ranks are replicas, as under GSPMD in the reference (no rule maps a
    leaf or the batch to them)."""
    t, f, ep = (mesh.axis_size(a) for a in ("tensor", "fsdp", "expert"))
    dims = [("tensor", t, "n_heads", cfg.n_heads),
            ("tensor", t, "n_kv_heads", cfg.n_kv_heads),
            ("tensor", t, "d_ff", cfg.d_ff),
            ("tensor", t, "vocab_size", cfg.vocab_size),
            ("fsdp", f, "d_model", cfg.d_model)]
    if hasattr(cfg, "n_experts"):
        dims.append(("expert", ep, "n_experts", cfg.n_experts))
    n_dp = math.prod(mesh.shape[a] for a in data_axes_in(mesh))
    dims.append(("data-like (" + ",".join(data_axes_in(mesh)) + ")", n_dp,
                 "batch rows / accum_steps", rows // max(accum_steps, 1)))
    for axis, size, name, n in dims:
        if size > 1 and n % size:
            raise ValueError(
                f"mesh axis {axis} of size {size} does not divide {name} "
                f"{n}: the port splits evenly (the reference would pad)")


def _opt_leaf_shardings(opt_state: dict, params: dict, p_sh: dict,
                        mesh: Mesh) -> dict:
    """Shardings of the optimizer state: moments and a whole Adafactor
    ``v`` follow their parameter; a factored row (column) statistic its
    parameter's with the reduced dimension taken out; the (1,)
    placeholders and the count are whole on every rank."""
    whole = NamedSharding(mesh, PartitionSpec())

    def stat(leaf, p, sh, key):
        if key in ("v_row", "v_col"):
            dims = factored_dims(tuple(p.shape))
            if dims is None:
                return whole                # a (1,) placeholder
            drop = dims[1] if key == "v_row" else dims[0]
            spec = list(sh.spec) + [None] * (p.dim() - len(sh.spec))
            return NamedSharding(mesh, PartitionSpec(
                *(spec[:drop] + spec[drop + 1:])))
        # mu, nu, and a whole v; a factored leaf's v is a (1,) placeholder
        return sh if tuple(leaf.shape) == tuple(p.shape) else whole

    out = {}
    for key, tree in opt_state.items():
        if not isinstance(tree, dict):
            out[key] = whole
        else:
            out[key] = _map3(
                lambda leaf, p, sh, key=key: stat(leaf, p, sh, key),
                tree, params, p_sh)
    return out


def _map3(fn, a: dict, b: dict, c: dict) -> dict:
    return {k: (_map3(fn, v, b[k], c[k]) if isinstance(v, dict)
                else fn(v, b[k], c[k])) for k, v in a.items()}


def state_shardings(state: dict[str, Any], cfg: ModelConfig, mesh: Mesh,
                    p_shardings: Any = None) -> dict[str, Any]:
    """Shardings for the whole train state: params by logical axes (or
    ``p_shardings``, e.g. the pipeline's), the optimizer's moments and
    statistics after their parameters, the count whole on every rank;
    ``step`` (a host int) None."""
    p_sh = (param_shardings(logical_axes(cfg), mesh) if p_shardings is None
            else p_shardings)
    return {"params": p_sh,
            "opt_state": _opt_leaf_shardings(state["opt_state"],
                                             state["params"], p_sh, mesh),
            "step": None}


def shard_state(state: dict[str, Any], shardings: dict[str, Any]) -> None:
    """Replace every tensor of the whole ``state`` by this rank's block of
    it, in place (the dicts stay the same objects, the leaves are new):
    the reference's ``jax.device_put(state, shardings)``."""
    rank = this_rank()

    def walk(tree, sh):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, sh[k])
            elif isinstance(v, torch.Tensor):
                tree[k] = shard_tensor(v, sh[k], rank)

    walk({k: v for k, v in state.items() if k != "step"},
         {k: v for k, v in shardings.items() if k != "step"})


def gather_state(tree: Any, shardings: Any) -> Any:
    """The whole tensors of a sharded tree (a state, its params, ...):
    all-gathers, so every rank of the mesh calls it; host values pass
    through."""
    def one(leaf, sh):
        if isinstance(leaf, torch.Tensor) and sh is not None:
            return gather_tensor(leaf, sh)
        return leaf

    return tree_map_shardings(one, tree, shardings)


def local_rows(sharding: NamedSharding, rows: int,
               accum_steps: int = 1) -> np.ndarray:
    """The global batch rows this rank holds under the batch sharding, in
    the order its step reads them: its block of each of the
    ``accum_steps`` microbatches (the reference's microbatch ``i`` is
    global rows ``[i·rows/a, (i+1)·rows/a)``, split over the data-like
    axes), so a rank holds exactly the rows its microbatches need."""
    mesh = sharding.mesh
    parts = sharding.parts(0)
    c = sharding.index(0, mesh.my_coords())
    micro = rows // accum_steps
    if micro % parts:
        raise ValueError(f"microbatch of {micro} rows does not split over "
                         f"{parts} data-like ranks")
    per = micro // parts
    return np.concatenate([np.arange(i * micro + c * per,
                                     i * micro + (c + 1) * per)
                           for i in range(accum_steps)])


def shard_batch(batch: torch.Tensor, sharding: NamedSharding,
                accum_steps: int = 1) -> torch.Tensor:
    """This rank's rows of a global (rows, seq+1) batch (see
    :func:`local_rows`); ranks that differ only in ``tensor`` get the same
    rows."""
    idx = torch.as_tensor(local_rows(sharding, batch.shape[0], accum_steps),
                          device=batch.device)
    return batch.index_select(0, idx)


class Shards:
    """One rank's view of a sharded step: the mesh, the shardings of the
    param leaves (in ``tree_leaves(params)`` order: matched by key, since
    a params tree may order its keys otherwise than the logical axes),
    the data-like axes and their rank count."""

    def __init__(self, mesh: Mesh, p_shardings: dict, params: dict):
        self.mesh = mesh
        self.leaves: list[NamedSharding] = tree_leaves(
            tree_map(lambda _, sh: sh, params, p_shardings))
        self.dp_axes = data_axes_in(mesh)
        self.n_dp = math.prod(mesh.shape[a] for a in self.dp_axes)

    def reduce_grads(self, grads: list) -> list:
        """This rank's gradient leaves → the step's: summed over the
        data-like axes that do not split the leaf (those that do summed
        already, in the backward of their all-gather or all-to-all), then
        divided by the data-like ranks, the gradient of the batch mean.
        Tensor ranks hold the same rows and are not counted again."""
        out = []
        for g, sh in zip(grads, self.leaves):
            split = sh.split_axes()
            axes = tuple(a for a in self.dp_axes if a not in split)
            g = all_reduce_raw(g, self.mesh.group(axes))
            out.append(g / self.n_dp if self.n_dp > 1 else g)
        return out

    def global_norm(self, grads: list) -> torch.Tensor:
        """The whole model's √Σ g²: one ``global_norm`` (the
        ``adamw_sumsq`` kernel on the card) over the leaves split over the
        same axes, its square all-reduced over those axes, so each block
        counts once and a leaf replicated over an axis counts once."""
        by_axes: dict[tuple, list] = {}
        for g, sh in zip(grads, self.leaves):
            by_axes.setdefault(tuple(sorted(sh.split_axes())), []).append(g)
        total = None
        for axes, leaves in by_axes.items():
            sq = global_norm(leaves) ** 2
            sq = all_reduce_raw(sq, self.mesh.group(axes))
            total = sq if total is None else total + sq
        return torch.sqrt(total)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The batch mean of the ranks' row means (equal rows each)."""
        loss = all_reduce_raw(loss, self.mesh.group(self.dp_axes))
        return loss / self.n_dp if self.n_dp > 1 else loss


def _graphs_for(device: torch.device) -> bool:
    """A sharded step is one CUDA graph under NCCL; gloo's collectives
    cannot be captured, so over gloo it runs eagerly."""
    import torch.distributed as dist

    return (device.type == "cuda" and dist.is_initialized()
            and dist.get_backend() == "nccl")


def make_sharded_train_step(
    cfg: ModelConfig, tc: TrainConfig, mesh: Mesh, state: dict[str, Any],
    batch_shape: tuple[int, int], loss: Callable | None = None,
    p_shardings: Any = None, row_blocks: int = 1,
) -> tuple[Callable[[torch.Tensor], torch.Tensor], dict, NamedSharding]:
    """→ (step, state shardings, batch sharding): the reference's
    ``make_sharded_train_step`` on one rank. ``state`` is the whole state
    as :func:`init_state` made it on every rank from the one seed; it is
    sharded in place (:func:`shard_state`), so the caller's ``state``
    holds this rank's blocks after the call. ``batch_shape`` is the global
    (rows, seq+1); ``step(batch)`` takes this rank's rows of it
    (:func:`shard_batch` with ``step.row_blocks`` as its ``accum_steps``,
    ``train/data.py`` ``global_batches``) and returns the batch's mean
    loss (an f32 buffer that the next call overwrites), updating the state
    in place: the loss of this rank's rows under ``parallel.mesh_context``
    (``loss(params, rows, cfg)``, by default the family's ``loss_fn``),
    its gradients reduced over the data-like ranks
    (:meth:`Shards.reduce_grads`), the optimizer on this rank's blocks
    with the whole model's clip norm. ``p_shardings`` replaces the params'
    logical shardings (the pipeline's); ``row_blocks`` is the number of
    blocks of rows a rank holds within each accumulation step (the
    pipeline's microbatches). Under NCCL the step is one CUDA graph, as
    :func:`make_train_step` is; over gloo (several ranks on one card, or
    the CPU) it runs eagerly. A trivial mesh gives exactly
    :func:`make_train_step`'s step, with no process group."""
    batch_shape = tuple(batch_shape)
    _check_accum(batch_shape[0], tc)
    shardings = state_shardings(state, cfg, mesh, p_shardings)
    b_sharding = batch_sharding(mesh)
    if mesh.size == 1:
        step = make_train_step(cfg, tc, state, batch_shape, loss=loss)
        step.row_blocks = tc.accum_steps * row_blocks
        return step, shardings, b_sharding
    _check_mesh(cfg, mesh, batch_shape[0], tc.accum_steps * row_blocks)
    shard_state(state, shardings)
    params = state["params"]
    device = tree_leaves(params)[0].device
    shards = Shards(mesh, shardings["params"], params)
    rows = batch_shape[0] // shards.n_dp
    local_shape = (rows, batch_shape[1])
    opt = make_optimizer(tc)
    batch_in = torch.zeros(local_shape, dtype=torch.int32, device=device)
    loss_out = torch.zeros((), dtype=torch.float32, device=device)

    def body():
        with mesh_context(mesh):
            value, grads = _loss_and_grads(params, batch_in, cfg, tc, loss)
        grads = shards.reduce_grads(grads)
        opt.update_(grads, state["opt_state"], params, shards=shards)
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
    step.row_blocks = tc.accum_steps * row_blocks
    return step, shardings, b_sharding


def make_pipeline_train_step(
    cfg: ModelConfig, tc: TrainConfig, mesh: Mesh, state: dict[str, Any],
    n_microbatches: int, batch_shape: tuple[int, int],
) -> tuple[Callable[[torch.Tensor], torch.Tensor], dict, NamedSharding]:
    """→ (pipelined step, state shardings, batch sharding): the layer
    leaves split over the ``stage`` axis, the batch over the data-like
    axes (PP × DP in one step), ``n_microbatches`` microbatches through
    ``parallel/pipeline.py``. The reference's thin specialisation of
    :func:`make_sharded_train_step`: the same optimizer and update, the
    pipelined loss; one CUDA graph under NCCL, eager over gloo. A rank
    takes its rows with ``shard_batch(batch, b_sharding,
    step.row_blocks)``: its data-like block of each microbatch."""
    from tpu_kubernetes_torch.parallel.pipeline import (
        pipeline_loss_fn,
        pipeline_param_shardings,
    )

    def loss(params, tokens, cfg):
        return pipeline_loss_fn(params, tokens, cfg, mesh, n_microbatches)

    return make_sharded_train_step(
        cfg, tc, mesh, state, batch_shape, loss=loss,
        p_shardings=pipeline_param_shardings(logical_axes(cfg), mesh),
        row_blocks=n_microbatches)


def make_sharded_eval_step(
    cfg: ModelConfig, mesh: Mesh, params: dict, batch_shape: tuple[int, int],
) -> tuple[Callable[[torch.Tensor], torch.Tensor], NamedSharding]:
    """→ (eval step, batch sharding): the reference's ``make_eval_step``
    over a mesh, on one rank. ``params`` are this rank's blocks (the
    sharded train state's, read in place); ``step(batch)`` takes this
    rank's rows of a global ``batch_shape`` batch and returns the batch's
    mean loss, nothing changed. A trivial mesh gives
    :func:`make_eval_step`'s step."""
    b_sharding = batch_sharding(mesh)
    if mesh.size == 1:
        return make_eval_step(cfg, params, batch_shape), b_sharding
    _check_mesh(cfg, mesh, batch_shape[0])
    shards = Shards(mesh, param_shardings(logical_axes(cfg), mesh), params)
    device = tree_leaves(params)[0].device
    local_shape = (batch_shape[0] // shards.n_dp, batch_shape[1])
    batch_in = torch.zeros(local_shape, dtype=torch.int32, device=device)
    loss_out = torch.zeros((), dtype=torch.float32, device=device)

    @torch.no_grad()
    def body():
        with mesh_context(mesh):
            loss = loss_fn(params, batch_in, cfg)
        loss_out.copy_(shards.mean_loss(loss))

    program = Program(body, device, graphs=_graphs_for(device))

    def step(batch: torch.Tensor) -> torch.Tensor:
        if tuple(batch.shape) != local_shape:
            raise ValueError(f"batch {tuple(batch.shape)} is not this "
                             f"rank's rows {local_shape} of {batch_shape}")
        batch_in.copy_(batch, non_blocking=True)
        program()
        return loss_out

    step.program = program
    step.local_shape = local_shape
    return step, b_sharding
