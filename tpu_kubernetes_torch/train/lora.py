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
  in place. The sharded step and ``lora_shardings`` wait for ROADMAP.md
  queue 1 item 7b.
* :func:`merge_lora` gives plain params for serving, quantizing and export.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from tpu_kubernetes_torch.models import ModelConfig, loss_fn
from tpu_kubernetes_torch.train.trainer import (
    AdamW,
    _unflatten,
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


def merge_lora(params: dict, adapters: dict, lc: LoraConfig) -> dict:
    """Base params + ``(A@B)·s`` on every adapted leaf → a plain param
    tree (the base's structure; the other leaves are the base's own
    tensors)."""
    layers = dict(params["layers"])
    for name, ab in adapters.items():
        w = layers[name]
        # a fill, not a host copy: the merge runs inside a captured step
        scale = torch.full((), lc.scale, dtype=torch.float32,
                           device=w.device).to(w.dtype)
        layers[name] = w + torch.matmul(ab["a"], ab["b"]) * scale
    return {**params, "layers": layers}


def lora_loss_fn(adapters: dict, params: dict, tokens: torch.Tensor,
                 cfg: ModelConfig, lc: LoraConfig) -> torch.Tensor:
    """``loss_fn`` of the merged model."""
    return loss_fn(merge_lora(params, adapters, lc), tokens, cfg)


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

