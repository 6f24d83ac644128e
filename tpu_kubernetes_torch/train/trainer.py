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
kernels) and applies :class:`AdamW`, which is the
reference's optax chain ``clip_by_global_norm`` → ``adamw`` term for
term. The sharded, pipelined and LoRA steps wait for the port's parallel
slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Iterator

import torch

from tpu_kubernetes_torch.models import ModelConfig, init_params, loss_fn
from tpu_kubernetes_torch.ops.adamw import Hyper, adamw_
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
    warmup_steps: int
    b1: float
    b2: float
    weight_decay: float
    grad_clip: float
    eps = 1e-8                      # optax.adamw's default

    def schedule(self, count) -> torch.Tensor:
        """``linear_schedule(0, lr, warmup)(count)`` in f32, as optax, on
        ``count``'s device (a 0-d tensor, or an int for the CPU)."""
        count = torch.as_tensor(count)
        dev = count.device

        def f32(x):                 # a divisor from a fill, not a host copy
            return torch.full((), x, dtype=torch.float32, device=dev)

        if self.warmup_steps <= 0:          # optax: the constant init value
            return f32(0.0)
        c = count.clamp(0, self.warmup_steps).float()
        frac = 1 - c / f32(float(self.warmup_steps))
        return f32(0.0 - self.learning_rate) * frac + f32(self.learning_rate)

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
                     weight_decay=self.weight_decay, grad_clip=self.grad_clip)

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
        opt_state = {"count": opt_state["count"].clone(),
                     "mu": tree_map(torch.clone, opt_state["mu"]),
                     "nu": tree_map(torch.clone, opt_state["nu"])}
        self.update_(tree_leaves(grads), opt_state, params)
        return params, opt_state


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
