"""Training step and state for one device (port of the single-device
part of ``tpu_kubernetes/train/trainer.py``).

The state is ``{"params", "opt_state", "step"}``: params a nested dict of
tensors as the model family lays them out, ``step`` a Python int.
:func:`train_step` takes the gradients of the family's ``loss_fn``
(``models.loss_fn`` dispatches on the config: dense LLaMA or MoE) with
``torch.autograd`` (on the card the attention gradient runs the two
backward flash kernels, and MoE's grouped expert products the grouped
kernels) and applies :class:`AdamW`, which is the
reference's optax chain ``clip_by_global_norm`` → ``adamw`` term for
term. The sharded, pipelined and LoRA steps wait for the port's parallel
slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import numpy as np
import torch

from tpu_kubernetes_torch.models import ModelConfig, init_params, loss_fn


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
    # "adamw" (default) or "adafactor" (refused until ported)
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

    * clip: ``norm = √Σ g²`` over all leaves; when ``norm ≥ grad_clip``,
      ``g ← g / norm·grad_clip`` with the norm cast to the leaf dtype,
      picked on the device (``torch.where``, optax's ``select``), so the
      update never waits for the device;
    * ``mu ← (1−b1)·g + b1·mu``, ``nu ← (1−b2)·g² + b2·nu``, kept in the
      parameter dtype (optax's default ``mu_dtype``), so bf16 at llama-1b
      and f32 for MoE's f32 router in a bf16 model;
    * ``u = (mu / (1−b1^t)) / (√(nu / (1−b2^t)) + eps)`` with t the count
      after incrementing, bias corrections in f32;
    * ``u ← u + wd·p`` on every leaf, norms included (no mask);
    * ``p ← p − lr_t·u`` with ``lr_t`` cast to the leaf dtype first.

    The elementwise terms run in f32 and round where optax stores a value
    (mu, nu and p in the parameter dtype): in f32 that is optax number for
    number up to summation order; in bf16 XLA's fusions round at places of
    their own, so the two agree within a bf16 ulp of each value."""

    learning_rate: float
    warmup_steps: int
    b1: float
    b2: float
    weight_decay: float
    grad_clip: float
    eps = 1e-8                      # optax.adamw's default

    def schedule(self, count: int) -> np.float32:
        """``linear_schedule(0, lr, warmup)(count)`` in f32, as optax."""
        f32 = np.float32
        if self.warmup_steps <= 0:          # optax: the constant init value
            return f32(0.0)
        c = min(max(count, 0), self.warmup_steps)
        frac = f32(1) - f32(c) / f32(self.warmup_steps)
        return f32(0.0 - self.learning_rate) * frac + f32(self.learning_rate)

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(self, grads: dict, opt_state: dict, params: dict
               ) -> tuple[dict, dict]:
        """One step → (new params, new optimizer state). Nothing is
        updated in place: the arguments stay valid."""
        g_leaves = tree_leaves(grads)
        norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                              for g in g_leaves))
        # optax's select (its `<`) on the device, as a divisor and a factor
        # per leaf dtype: below the clip a leaf is divided and multiplied by
        # 1, so it stays exactly itself, and no pass is added to the clip's
        # two; the host never reads the norm
        keep = norm < self.grad_clip
        clip_by = {}
        count = opt_state["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(count))
        step_size = -self.schedule(opt_state["count"])

        new_p, new_mu, new_nu = [], [], []
        for g, mu, nu, p in zip(g_leaves, tree_leaves(opt_state["mu"]),
                                tree_leaves(opt_state["nu"]),
                                tree_leaves(params)):
            if p.dtype not in clip_by:
                clip_by[p.dtype] = (
                    torch.where(keep, 1.0, norm.to(p.dtype).float()),
                    torch.where(keep, 1.0, self.grad_clip))
            div, mul = clip_by[p.dtype]
            g = g.float() / div * mul
            mu32 = (1 - self.b1) * g + self.b1 * mu.float()
            nu32 = (1 - self.b2) * (g * g) + self.b2 * nu.float()
            mu, nu = mu32.to(mu.dtype), nu32.to(nu.dtype)
            u = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + self.eps)
            u = u + self.weight_decay * p.float()
            lr = torch.tensor(step_size, dtype=p.dtype).item()
            new_p.append((p.float() + lr * u).to(p.dtype))
            new_mu.append(mu)
            new_nu.append(nu)
        return (_unflatten(params, iter(new_p)),
                {"count": count, "mu": _unflatten(params, iter(new_mu)),
                 "nu": _unflatten(params, iter(new_nu))})


def make_optimizer(tc: TrainConfig) -> AdamW:
    if tc.optimizer == "adafactor":
        raise NotImplementedError(
            "optimizer 'adafactor' is not ported yet: it waits in "
            "ROADMAP.md queue 1 (training, still to port)"
        )
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


def _value_and_grad(params: dict, batch: torch.Tensor,
                    cfg: ModelConfig) -> tuple[torch.Tensor, list]:
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss = loss_fn(_unflatten(params, iter(leaves)), batch, cfg)
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def train_step(
    state: dict[str, Any], batch: torch.Tensor, cfg: ModelConfig,
    tc: TrainConfig,
) -> tuple[dict[str, Any], torch.Tensor]:
    """One optimizer step. batch: (batch, seq+1) int tokens on the
    params' device. → (new state, f32 loss scalar on the device).

    ``tc.accum_steps > 1`` runs that many microbatches (batch rows must
    divide evenly), summing their gradients in float32 and applying ONE
    update with ``(Σg / accum_steps)`` cast to each parameter's dtype; the
    returned loss is the microbatch mean, as the reference computes it."""
    if tc.accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {tc.accum_steps}")
    params = state["params"]
    if tc.accum_steps > 1:
        rows = batch.shape[0]
        if rows % tc.accum_steps:
            raise ValueError(
                f"batch rows {rows} not divisible by accum_steps "
                f"{tc.accum_steps}"
            )
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
        loss_value = lsum * scale
    else:
        loss_value, grads = _value_and_grad(params, batch, cfg)
    new_params, new_opt = make_optimizer(tc).update(
        _unflatten(params, iter(grads)), state["opt_state"], params)
    return ({"params": new_params, "opt_state": new_opt,
             "step": state["step"] + 1}, loss_value)


def make_eval_step(cfg: ModelConfig) -> Callable:
    """→ eval step ``(params, batch) → loss``: the loss-only forward, no
    gradient, nothing changed (the reference's eval step on one device)."""

    @torch.no_grad()
    def eval_step(params: dict, batch: torch.Tensor) -> torch.Tensor:
        return loss_fn(params, batch, cfg)

    return eval_step


def synthetic_batches(
    vocab_size: int, batch: int, seq: int, seed: int = 0,
    device: torch.device | str = "cpu",
) -> Iterator[torch.Tensor]:
    """Deterministic synthetic token stream from a seeded
    ``torch.Generator`` on ``device``; batches are (batch, seq+1) int32 so
    the next-token loss sees exactly ``seq`` positions. The draws differ
    from the reference's ``jax.random`` ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    while True:
        yield torch.randint(0, vocab_size, (batch, seq + 1), generator=gen,
                            device=device, dtype=torch.int32)
