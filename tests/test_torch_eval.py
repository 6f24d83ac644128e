"""The port's eval step as a program (``train/trainer.py``
``make_eval_step``) against the JAX package's ``loss_fn`` on the CPU,
from the same weights (``models.from_jax``) and the same numpy tokens.

The step is one program over a static (batch, seq + 1) buffer that
writes a device loss (on the card one CUDA graph; here its body runs
eagerly under the same keys and counts): its loss equals JAX's
``loss_fn`` in float32 within 1e-5 relative (summation order and
transcendental ulps, as ``tests/test_torch_train.py``'s losses), and the
eager forward's bit for bit. It reads the params in place and writes
nothing of theirs."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import moe as jmoe
from tpu_kubernetes_torch import models as tmodels
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.train import trainer as ttr

LOSS_REL = 1e-5
MODELS = {
    "llama-test": (jllama, replace(jllama.CONFIGS["llama-test"],
                                   dtype=jnp.float32)),
    "moe-test": (jmoe, replace(jmoe.MOE_CONFIGS["moe-test"],
                               dtype=jnp.float32)),
}


def _pair(name):
    family, jc = MODELS[name]
    jp = family.init_params(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return family, jc, jp, tp, replace(tmodels.CONFIGS[name],
                                       dtype=torch.float32)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_eval_step_loss_equals_jax_and_the_eager_forward(name):
    family, jc, jp, tp, tc = _pair(name)
    step = ttr.make_eval_step(tc, tp, (2, 17))
    for seed in (1, 2):
        tokens = _tokens(seed, (2, 17), tc.vocab_size)
        got = step(torch.from_numpy(tokens))
        want = float(family.loss_fn(jp, jnp.asarray(tokens), jc))
        assert got.dtype == torch.float32 and got.shape == ()
        assert got.item() == pytest.approx(want, rel=LOSS_REL)
        with torch.no_grad():
            eager = tmodels.loss_fn(tp, torch.from_numpy(tokens), tc)
        assert torch.equal(got, eager)
    assert step.program.captures == 1 and step.program.replays == 1


def _tensors(state):
    return [x for x in ttr.tree_leaves({"params": state["params"],
                                        "opt": state["opt_state"]})
            if isinstance(x, torch.Tensor)]


def test_eval_step_reads_the_trained_params_in_place_and_changes_none():
    """Between evals the train step updates the params in place; the eval
    program, built once, reads the new values, and neither its calls nor
    their loss buffer touch the params or the optimizer state."""
    _, _, _, tp, tc = _pair("llama-test")
    tc_train = ttr.TrainConfig(warmup_steps=1)
    state = {"params": tp, "opt_state": ttr.make_optimizer(tc_train).init(tp),
             "step": 0}
    train = ttr.make_train_step(tc, tc_train, state, (2, 17))
    evaluate = ttr.make_eval_step(tc, tp, (2, 17))
    held_out = torch.from_numpy(_tokens(3, (2, 17), tc.vocab_size))
    losses = []
    for seed in (4, 5):
        train(torch.from_numpy(_tokens(seed, (2, 17), tc.vocab_size)))
        before = [p.clone() for p in _tensors(state)]
        losses.append(evaluate(held_out).item())
        assert all(torch.equal(a, b) for a, b in
                   zip(before, _tensors(state)))
        with torch.no_grad():
            assert losses[-1] == tmodels.loss_fn(tp, held_out, tc).item()
    assert losses[0] != losses[1]


def test_eval_step_refuses_another_batch_shape():
    _, _, _, tp, tc = _pair("llama-test")
    step = ttr.make_eval_step(tc, tp, (2, 17))
    with pytest.raises(ValueError, match=r"not the eval step's \(2, 17\)"):
        step(torch.zeros((2, 9), dtype=torch.int32))
