"""The reference's expert-parallel cases against the port on gloo ranks,
in f32: ``TestExpertParallel`` (``tests/test_moe.py``: the sharded step
partitions the experts, the batch sharding spans ``expert``, the sharded
forward equals one device) and the expert-parallel grouped cases of
``tests/test_grouped_matmul.py`` (loss and every gradient against the JAX
package on one device, dropless under the worst imbalance, the sharded
train step under remat "moe" and the sharded eval step), plus the
capacity ("gather") dispatch over ``expert=2,tensor=2``. One pool of
eight ranks serves the module."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_parity import assert_three_agree, leaves, run_three
from torch_parallel_support import RankPool, forward_case, loss_grad_case
from tpu_kubernetes.models import CONFIGS as JCONFIGS
from tpu_kubernetes.models import forward as jforward
from tpu_kubernetes.models import init_params as jinit
from tpu_kubernetes.models import loss_fn as jloss
from tpu_kubernetes_torch.parallel import batch_sharding, create_mesh

MODEL = "moe-test-grouped"


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


def test_gather_dispatch_over_expert_and_tensor(pool):
    """The capacity ("gather") dispatch, whose expert stacks are
    all-gathered over ``expert`` (only the grouped mode exchanges rows)."""
    res = run_three(pool, "moe-test", {"expert": 2, "tensor": 2}, None,
                    {"warmup_steps": 2})
    assert_three_agree(res)


# -- tests/test_moe.py TestExpertParallel -------------------------------------

def test_sharded_train_step_partitions_experts(pool):
    res = run_three(pool, "moe-test", {"data": 2, "expert": 2, "tensor": 2},
                    None, {"warmup_steps": 2}, steps=1, rows=8, seq=64)
    port = res["port"]
    assert np.isfinite(port["losses"][0]) and port["step"] == 1
    whole = res["params_np"]["layers"]["w_gate"].size
    # over expert (×2) and tensor (×2)
    assert port["local_numel"]["w_gate"] <= whole // 4


def test_batch_sharding_includes_expert_axis():
    mesh = create_mesh({"expert": 4, "tensor": 2}, devices=list(range(8)))
    spec = batch_sharding(mesh).spec
    assert "expert" in (spec[0] if isinstance(spec[0], tuple)
                        else (spec[0],))


def test_expert_parallel_matches_single_device(pool):
    """The sharded forward agrees with the unsharded one (f32)."""
    cfg = replace(JCONFIGS["moe-test"], dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(0), cfg)
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(5), (4, 32), 0, cfg.vocab_size), np.int32)
    ref = np.asarray(jforward(params, jnp.asarray(tokens), cfg))
    out = pool.run(forward_case, "moe-test", {"dtype": torch.float32},
                   {"expert": 4, "tensor": 2},
                   jax.tree.map(np.asarray, params), tokens)[0]
    np.testing.assert_allclose(out, ref, atol=2e-4, rtol=2e-4)


# -- tests/test_grouped_matmul.py's expert-parallel cases ---------------------

def _ep_inputs(seed_tokens: int, router=None):
    cfg = replace(JCONFIGS["moe-test"], dispatch_mode="grouped",
                  dtype=jnp.float32)
    params = jinit(jax.random.PRNGKey(0), cfg)
    if router is not None:
        params["layers"]["w_router"] = router(params["layers"]["w_router"])
    tokens = np.asarray(jax.random.randint(
        jax.random.PRNGKey(seed_tokens), (8, 65), 0, cfg.vocab_size,
        jnp.int32))
    return cfg, params, tokens


def test_grouped_ep_matches_single_device(pool):
    """The expert-parallel grouped path (4-way expert × 2-way data)
    reproduces the single-device grouped loss and gradients (the JAX
    package's, one device)."""
    cfg, params, tokens = _ep_inputs(7)
    ref_loss, ref_grads = jax.value_and_grad(jloss)(params,
                                                    jnp.asarray(tokens), cfg)
    loss, grads = pool.run(loss_grad_case, MODEL, {"dtype": torch.float32},
                           {"expert": 4, "data": 2},
                           jax.tree.map(np.asarray, params), tokens)[0]
    np.testing.assert_allclose(loss, float(ref_loss), atol=1e-5, rtol=1e-5)
    want = dict(leaves(jax.tree.map(np.asarray, ref_grads)))
    for path, g in leaves(grads):
        np.testing.assert_allclose(g, want[path], atol=1e-6, rtol=1e-5,
                                   err_msg=path)


def test_grouped_ep_dropless_under_max_imbalance(pool):
    """Every token routed to expert 0: one rank receives every row (the
    worst-case bin is exactly full), the others none — the loss still
    equals the single-device grouped loss."""
    cfg, params, tokens = _ep_inputs(
        3, router=lambda r: jnp.zeros_like(r).at[:, :, 0].set(5.0))
    ref = float(jloss(params, jnp.asarray(tokens), cfg))
    loss, _ = pool.run(loss_grad_case, MODEL, {"dtype": torch.float32},
                       {"expert": 4, "data": 2},
                       jax.tree.map(np.asarray, params), tokens)[0]
    np.testing.assert_allclose(loss, ref, atol=1e-5, rtol=1e-5)


def test_grouped_ep_train_step_and_eval_step(pool):
    """The sharded step over expert × data with remat ("moe" policy), and
    the sharded eval step after it equal to the one-device loss of the
    trained params."""
    from tpu_kubernetes_torch.models import loss_fn
    from tpu_kubernetes_torch.models.from_jax import params_from_numpy

    res = run_three(pool, MODEL, {"expert": 4, "data": 2}, None,
                    {"warmup_steps": 2}, eval_batch=True,
                    widths={"remat": True})
    assert_three_agree(res)
    trained = params_from_numpy(res["port"]["params"], "cpu")
    want = loss_fn(trained, torch.from_numpy(res["eval_batch"]),
                   res["cfg"]).item()
    np.testing.assert_allclose(res["port"]["eval"], want, rtol=1e-5)
