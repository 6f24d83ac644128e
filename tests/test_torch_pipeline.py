"""The port's pipeline (``parallel/pipeline.py``, ``make_pipeline_train_step``)
against the reference's ``tests/test_pipeline.py`` on eight gloo ranks:
the forward against the plain model (PP × DP × TP and PP × FSDP), the
gradients against the plain model's and the JAX ``pipeline_loss_fn``'s,
the stage-sharded train state, the two "not divisible" errors, and two
f32 steps of the pipelined train step against the JAX
``make_pipeline_train_step`` on the same mesh."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_parity import LOSS_RTOL, PARAM_TOL, leaves
from torch_parallel_support import (
    RankPool,
    pipeline_forward_case,
    pipeline_grad_case,
    pipeline_train_case,
)
from tpu_kubernetes import models as jmodels
from tpu_kubernetes.parallel import create_mesh as jcreate_mesh
from tpu_kubernetes.parallel import pipeline_loss_fn as jpipeline_loss_fn
from tpu_kubernetes.train import trainer as jtr
from tpu_kubernetes_torch.models import CONFIGS
from tpu_kubernetes_torch.parallel import create_mesh, pipeline_forward

CFG32 = replace(jmodels.CONFIGS["llama-test"], dtype=jnp.float32)
F32 = {"dtype": torch.float32}
PP_DP = {"data": 2, "stage": 2, "tensor": 2}


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    try:
        yield p
    finally:
        p.close()


@pytest.fixture(scope="module")
def params32():
    return jmodels.init_params(jax.random.PRNGKey(0), CFG32)


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _tokens(seed, shape):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(seed), shape, 0,
                                         CFG32.vocab_size), np.int32)


def test_forward_matches_plain(pool, params32):
    tokens = _tokens(1, (8, 32))
    got = pool.run(pipeline_forward_case, "llama-test", F32, PP_DP,
                   _np(params32), tokens, 4)[0]
    ref = jmodels.forward(params32, jnp.asarray(tokens), CFG32)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)


def test_forward_matches_plain_4_stages(pool, params32):
    """The reference's pure-PP mesh: stage=2 (llama-test has 2 layers, one
    a stage) with the microbatch rows over fsdp=4."""
    tokens = _tokens(2, (8, 16))
    got = pool.run(pipeline_forward_case, "llama-test", F32,
                   {"stage": 2, "fsdp": 4}, _np(params32), tokens, 2)[0]
    ref = jmodels.forward(params32, jnp.asarray(tokens), CFG32)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-4)


def test_gradients_match_plain(pool, params32):
    """The backward through the shift's adjoint equals the unpipelined
    gradient, and the JAX pipelined gradient more tightly."""
    tokens = _tokens(3, (4, 33))
    loss, got = pool.run(pipeline_grad_case, "llama-test", F32, PP_DP,
                         _np(params32), tokens, 2)[0]
    jt = jnp.asarray(tokens)
    l_ref, g_ref = jax.value_and_grad(jmodels.loss_fn)(params32, jt, CFG32)
    jmesh = jcreate_mesh(PP_DP)
    g_pp = jax.jit(jax.grad(lambda p, t: jpipeline_loss_fn(
        p, t, CFG32, jmesh, n_microbatches=2)))(params32, jt)
    np.testing.assert_allclose(loss, float(l_ref), rtol=1e-6)
    have = dict(leaves(got))
    for path, want in leaves(_np(g_ref)):
        np.testing.assert_allclose(have[path], want, atol=2e-4, rtol=2e-3,
                                   err_msg=f"{path} against the plain model")
    for path, want in leaves(_np(g_pp)):
        np.testing.assert_allclose(have[path], want, atol=1e-6, rtol=1e-5,
                                   err_msg=f"{path} against JAX's pipeline")


def test_pipelined_train_step_shards_stages(pool):
    """Two bf16 steps of llama-test at the reference's mesh and sizes:
    finite losses, the step count, and the layer axis (2 layers) split
    over the 2 stages on every rank."""
    from tpu_kubernetes.train import synthetic_batches

    cfg = CONFIGS["llama-test"]
    jp = jmodels.init_params(jax.random.PRNGKey(0),
                             jmodels.CONFIGS["llama-test"])
    batch = np.asarray(next(synthetic_batches(cfg.vocab_size, 8, 64)))
    res = pool.run(pipeline_train_case, "llama-test", {}, PP_DP,
                   {"warmup_steps": 2}, _np(jp), [batch, batch], 4)
    whole = int(np.prod(_np(jp)["layers"]["wq"].shape))
    for r in res:
        assert r["step"] == 2 and np.all(np.isfinite(r["losses"]))
        assert r["wq_numel"] == whole // 2
        # every rank gathers the same state: the stage replicas of the
        # embedding (its gradient all-reduced over stage) and of the head
        # agree bit for bit
        assert r["sums"] == res[0]["sums"]


def test_rejects_indivisible_layers_or_batch(params32):
    cfg = replace(CONFIGS["llama-test"], dtype=torch.float32)
    tokens = torch.zeros((4, 16), dtype=torch.int32)
    mesh = create_mesh({"stage": 8}, list(range(8)))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_forward({}, tokens, cfg, mesh, n_microbatches=2)
    # a rank of stage=2,data=4 holds one row of the global 4
    mesh2 = create_mesh({"stage": 2, "data": 4}, list(range(8)))
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_forward({}, tokens[:1], cfg, mesh2, n_microbatches=3)


def test_moe_is_not_pipelined():
    cfg = CONFIGS["moe-test"]
    mesh = create_mesh({"stage": 2}, [0, 1])
    with pytest.raises(ValueError, match="dense LLaMA block only"):
        pipeline_forward({}, torch.zeros((2, 8), dtype=torch.int32), cfg,
                         mesh, n_microbatches=2)


@pytest.mark.parametrize("mesh_shape,m,opt", [
    (PP_DP, 4, "adamw"), ({"stage": 2, "fsdp": 4}, 2, "adamw"),
    # the clip's norm and the update's RMS count a stage-split leaf once
    (PP_DP, 2, "adafactor")])
def test_two_f32_steps_equal_the_jax_pipelined_step(pool, mesh_shape, m, opt):
    """The port's make_pipeline_train_step against the JAX one on the
    same mesh, from the same f32 weights and batches: each step's loss,
    every parameter after the second step, and the AdamW moments."""
    tc_kwargs = {"warmup_steps": 1, "optimizer": opt}
    jp = jmodels.init_params(jax.random.PRNGKey(4), CFG32)
    rng = np.random.default_rng(5)
    batches = [rng.integers(0, CFG32.vocab_size, (8, 33)).astype(np.int32)
               for _ in range(2)]
    # remat on (the presets' default past llama-test): a block's
    # recompute in the backward runs whole, as its forward did
    pool.submit(pipeline_train_case, "llama-test", {**F32, "remat": True},
                mesh_shape, tc_kwargs, _np(jp), batches, m)
    tc = jtr.TrainConfig(**tc_kwargs)
    jmesh = jcreate_mesh(mesh_shape)
    state = jtr.init_state(jax.random.PRNGKey(4), CFG32, tc)
    state["params"] = jp
    step, sh, b_sh = jtr.make_pipeline_train_step(CFG32, tc, jmesh, state,
                                                  n_microbatches=m)
    state = jax.device_put(state, sh)
    jl = []
    for b in batches:
        state, loss = step(state, jax.device_put(jnp.asarray(b), b_sh))
        jl.append(float(loss))
    res = pool.collect()
    got = res[0]
    assert all(r["sums"] == got["sums"] for r in res if r is not None)
    np.testing.assert_allclose(got["losses"], jl, rtol=LOSS_RTOL)
    have = dict(leaves(got["params"]))
    for path, want in leaves(_np(state["params"])):
        np.testing.assert_allclose(have[path], want, **PARAM_TOL,
                                   err_msg=path)
    if opt != "adamw":
        return
    mu = dict(leaves(got["opt_state"]["mu"]))
    for path, want in leaves(_np(state["opt_state"][1][0].mu)):
        np.testing.assert_allclose(mu[path], want, atol=1e-6, rtol=1e-5,
                                   err_msg=f"mu/{path}")
