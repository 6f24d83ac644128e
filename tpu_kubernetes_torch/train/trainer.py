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
``adafactor``, likewise). The sharded and pipelined steps wait for the
port's parallel slice (ROADMAP.md queue 1 item 7); the LoRA step is
``train/lora.py``'s.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from tpu_kubernetes_torch.models import ModelConfig, init_params, loss_fn
from tpu_kubernetes_torch.ops.adamw import (
    Hyper,
    adamw_,
    clip_factors,
    global_norm,
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

    def update_(self, grads: list, opt_state: dict, params: dict) -> None:
        """One step in place: ``params``, ``opt_state``'s mu, nu and count
        are written where they lie, as the reference's step donates its
        state. ``grads`` are the leaves in ``tree_leaves(params)`` order."""
        adamw_(grads, tree_leaves(params), tree_leaves(opt_state["mu"]),
               tree_leaves(opt_state["nu"]),
               self.scalars(opt_state["count"]), self.hyper())
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

    def update_(self, grads: list, opt_state: dict, params: dict) -> None:
        """One step in place: ``params`` and every statistic of
        ``opt_state`` written where they lie; ``grads`` are the leaves in
        ``tree_leaves(params)`` order."""
        count = opt_state["count"]
        norm = global_norm(grads)
        beta = self.decay(count)
        rate = self.schedule(count)
        per_dtype = {}
        for g, p, v_row, v_col, v, mu in zip(
                grads, tree_leaves(params),
                *(tree_leaves(opt_state[k])
                  for k in ("v_row", "v_col", "v", "mu"))):
            if p.dtype not in per_dtype:
                per_dtype[p.dtype] = (*clip_factors(norm, self.grad_clip,
                                                    p.dtype),
                                      rate.to(p.dtype).float())
            div, mul, lr = per_dtype[p.dtype]
            g = g.float() / div * mul
            g2 = g * g + self.eps
            dims = factored_dims(tuple(p.shape))
            if dims is not None:
                d1, d0 = dims
                v_row.copy_(beta * v_row.float()
                            + (1 - beta) * g2.mean(d0))
                v_col.copy_(beta * v_col.float()
                            + (1 - beta) * g2.mean(d1))
                row = v_row.float()     # d1's axis once d0 is gone:
                row = torch.rsqrt(row / row.mean(
                    d1 - 1 if d1 > d0 else d1, keepdim=True))
                u = (g * row.unsqueeze(d0)
                     * torch.rsqrt(v_col.float()).unsqueeze(d1))
            else:
                v.copy_(beta * v.float() + (1 - beta) * g2)
                u = g * torch.rsqrt(v.float())
            rms = torch.sqrt(torch.mean(u * u))
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


def _value_and_grad(params: dict, batch: torch.Tensor,
                    cfg: ModelConfig) -> tuple[torch.Tensor, list]:
    return value_and_grad(lambda p: loss_fn(p, batch, cfg), params)


def _check_accum(rows: int, tc: TrainConfig) -> None:
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
    if rows % tc.accum_steps:
        raise ValueError(
            f"batch rows {rows} not divisible by accum_steps "
            f"{tc.accum_steps}"
        )


def _loss_and_grads(params: dict, batch: torch.Tensor, cfg: ModelConfig,
                    tc: TrainConfig) -> tuple[torch.Tensor, list]:
    """The step's loss and gradient leaves. ``tc.accum_steps > 1`` runs
    that many microbatches one after another, sums their gradients in
    float32 and casts ``Σg / accum_steps`` to each parameter's dtype; the
    loss is then the microbatch mean, as the reference computes it."""
    if tc.accum_steps == 1:
        return _value_and_grad(params, batch, cfg)
    rows = batch.shape[0]
    gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for p in tree_leaves(params)]
    lsum = torch.zeros((), dtype=torch.float32, device=batch.device)
    for mb in batch.reshape(tc.accum_steps, rows // tc.accum_steps, -1):
        lv, g = _value_and_grad(params, mb, cfg)
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
                    batch_shape: tuple[int, int], *, graphs: bool = True
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
    ``step.program`` holds the program and its counts."""
    batch_shape = tuple(batch_shape)
    _check_accum(batch_shape[0], tc)
    params = state["params"]
    device = tree_leaves(params)[0].device
    opt = make_optimizer(tc)
    batch_in = torch.zeros(batch_shape, dtype=torch.int32, device=device)
    loss_out = torch.zeros((), dtype=torch.float32, device=device)

    def body():
        loss, grads = _loss_and_grads(params, batch_in, cfg, tc)
        opt.update_(grads, state["opt_state"], params)
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
