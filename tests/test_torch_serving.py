"""Sharded serving (``tpu_kubernetes_torch/parallel/serving.py``
``make_sharded_generate``) against the JAX package's single-device
``generate``: the reference's ``tests/test_serving.py``, its six cases
re-run against the port on gloo ranks on the CPU, in float32, from the
same numpy weights and prompts. Tensor-parallel, int8-weight, int8-cache,
expert-parallel and ragged generation are token-identical to JAX's; the
sampled draw follows its seed. The ranks really hold blocks: a rank's
``wq``, its int8 ``q`` and its expert ``w_gate`` are smaller than the
whole, and an int8 scale keeps its size-1 contraction dimension with its
output dimension split. The prefill logits under the mesh agree with
JAX's within 1e-4 absolute (the partial sums over tensor add in another
order; the largest difference measured here is 1.5e-6). The mesh
context is this thread's alone. One pool of eight ranks serves the
module."""

import threading
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_support import RankPool
from torch_serving_support import generate_case, remat_thread_case
from tpu_kubernetes.models import CONFIGS as JCONFIGS
from tpu_kubernetes.models import init_params as jinit
from tpu_kubernetes.models.decode import generate as jgenerate
from tpu_kubernetes.models.decode import prefill as jprefill
from tpu_kubernetes.models.quant import quantize_for_decode as jquantize
from tpu_kubernetes_torch.models import CONFIGS
from tpu_kubernetes_torch.parallel import (
    active_mesh,
    check_serving_mesh,
    create_mesh,
    make_sharded_generate,
    mesh_context,
)
from tpu_kubernetes_torch.parallel.mesh import shard_tensor

CFG = replace(JCONFIGS["llama-test"], dtype=jnp.float32)
MOE_CFG = replace(JCONFIGS["moe-test"], dtype=jnp.float32)
F32 = {"dtype": torch.float32}
TP = {"data": 2, "tensor": 4}
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(8)
    yield p
    p.close()


def _params(cfg):
    return jinit(jax.random.PRNGKey(0), cfg)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _prompt(key, shape, cfg=CFG):
    return np.asarray(jax.random.randint(jax.random.PRNGKey(key), shape, 0,
                                         cfg.vocab_size), np.int32)


def _run(pool, model, cfg, params, prompt, mesh, quant=False, logits=False,
         **gen):
    res = [r for r in pool.run(generate_case, model, F32, mesh, _np(params),
                               prompt, gen, quant, None, (None,), logits)
           if r is not None]
    for r in res[1:]:                   # every rank: the whole batch, alike
        np.testing.assert_array_equal(r["tokens"][0], res[0]["tokens"][0])
    return res


def test_tensor_parallel_generate_matches_single_device(pool):
    params = _params(CFG)
    prompt = _prompt(1, (4, 8))
    ref = np.asarray(jgenerate(params, jnp.asarray(prompt), CFG,
                               max_new_tokens=6))
    res = _run(pool, "llama-test", CFG, params, prompt, TP, logits=True,
               max_new_tokens=6)
    np.testing.assert_array_equal(res[0]["tokens"][0], ref)
    # attention weights really partitioned over tensor
    wq = params["layers"]["wq"]
    assert res[0]["shapes"]["layers/wq"][0] < wq.size
    want, _ = jprefill(params, jnp.asarray(prompt), CFG)
    np.testing.assert_allclose(res[0]["logits"], np.asarray(want),
                               atol=LOGIT_ATOL, rtol=0)


def test_quantized_sharded_generate_matches_quantized_single_device(pool):
    params = _params(CFG)
    qparams = jquantize(params, CFG)
    prompt = _prompt(1, (4, 8))
    ref = np.asarray(jgenerate(qparams, jnp.asarray(prompt), CFG,
                               max_new_tokens=6))
    # the port quantizes the same f32 weights: the same bits
    res = _run(pool, "llama-test", CFG, params, prompt, TP, quant=True,
               max_new_tokens=6)
    np.testing.assert_array_equal(res[0]["tokens"][0], ref)
    q = qparams["layers"]["wq"]["q"]
    assert res[0]["shapes"]["layers/wq/q"][0] < q.size
    # the scale shards with the output channel it scales (not replicated,
    # not split on its size-1 contraction dimension)
    s = qparams["layers"]["wq"]["s"]
    shape = res[0]["shapes"]["layers/wq/s"][1]
    assert shape[-2] == 1
    assert shape[-1] < s.shape[-1]


def test_kv_quant_sharded_generate_matches_single_device(pool):
    """The int8 KV cache composes with tensor-parallel serving."""
    params = _params(CFG)
    prompt = _prompt(1, (4, 8))
    ref = np.asarray(jgenerate(params, jnp.asarray(prompt), CFG,
                               max_new_tokens=6, kv_quant=True))
    res = _run(pool, "llama-test", CFG, params, prompt, TP,
               max_new_tokens=6, kv_quant=True)
    np.testing.assert_array_equal(res[0]["tokens"][0], ref)


def test_moe_expert_parallel_generate_matches_single_device(pool):
    params = _params(MOE_CFG)
    prompt = _prompt(1, (4, 8), MOE_CFG)
    ref = np.asarray(jgenerate(params, jnp.asarray(prompt), MOE_CFG,
                               max_new_tokens=6))
    res = _run(pool, "moe-test", MOE_CFG, params, prompt,
               {"expert": 4, "tensor": 2}, max_new_tokens=6)
    np.testing.assert_array_equal(res[0]["tokens"][0], ref)
    wg = params["layers"]["w_gate"]
    assert res[0]["shapes"]["layers/w_gate"][0] < wg.size


def test_sampled_generation_uses_the_supplied_seed(pool):
    params = _params(CFG)
    prompt = _prompt(2, (2, 4))
    res = [r for r in pool.run(generate_case, "llama-test", F32, TP,
                               _np(params), prompt,
                               {"max_new_tokens": 12, "temperature": 1.0},
                               False, None, (10, 11, 10)) if r is not None]
    for r in res:
        a, b, c = r["tokens"]
        np.testing.assert_array_equal(a, c)
        assert not np.array_equal(a, b)
        # ranks along tensor draw alike: every rank returns the same batch
        for x, y in zip(r["tokens"], res[0]["tokens"]):
            np.testing.assert_array_equal(x, y)


def test_ragged_sharded_generate_matches_unsharded(pool):
    params = _params(CFG)
    lengths = np.asarray([3, 7, 5, 7], np.int32)
    prompt = _prompt(8, (4, 7))
    ref = np.asarray(jgenerate(params, jnp.asarray(prompt), CFG,
                               max_new_tokens=5,
                               prompt_lengths=jnp.asarray(lengths)))
    res = [r for r in pool.run(generate_case, "llama-test", F32, TP,
                               _np(params), prompt, {"max_new_tokens": 5},
                               False, lengths) if r is not None]
    for r in res:
        np.testing.assert_array_equal(r["tokens"][0], ref)


# -- the port's own checks ----------------------------------------------------

def test_grouped_moe_over_expert_and_tensor(pool):
    """The grouped (dropless) dispatch exchanges the decode rows over
    ``expert`` (``models/moe_ep.py``) on each rank's expert slab."""
    cfg = replace(MOE_CFG, dispatch_mode="grouped")
    params = _params(cfg)
    prompt = _prompt(4, (4, 8), cfg)
    ref = np.asarray(jgenerate(params, jnp.asarray(prompt), cfg,
                               max_new_tokens=6))
    res = _run(pool, "moe-test-grouped", cfg, params, prompt,
               {"expert": 2, "tensor": 2}, max_new_tokens=6)
    np.testing.assert_array_equal(res[0]["tokens"][0], ref)


def test_int8_weights_over_fsdp_and_tensor(pool):
    """An int8 tree over fsdp: each layer's ``q`` and ``s`` gathered as
    the block uses them (``llama.gather_fsdp``), the head's too."""
    params = _params(CFG)
    prompt = _prompt(3, (4, 8))
    ref = np.asarray(jgenerate(jquantize(params, CFG), jnp.asarray(prompt),
                               CFG, max_new_tokens=6))
    res = _run(pool, "llama-test", CFG, params, prompt,
               {"fsdp": 2, "tensor": 2}, quant=True, max_new_tokens=6)
    np.testing.assert_array_equal(res[0]["tokens"][0], ref)
    # w_down's q is split over mlp (tensor) and embed (fsdp); its scale
    # over embed alone
    assert res[0]["shapes"]["layers/w_down/q"][0] * 4 == \
        params["layers"]["w_down"].size
    assert res[0]["shapes"]["layers/w_down/s"][1][-2:] == (1, CFG.d_model // 2)


def test_mesh_context_is_per_thread():
    """A mesh entered on one thread is not active on another, and nested
    contexts unwind in order."""
    outer = create_mesh({"data": 2, "tensor": 4}, devices=list(range(8)))
    inner = create_mesh({"tensor": 2}, devices=[0, 1])
    seen = {}
    entered, release = threading.Event(), threading.Event()

    def hold():
        with mesh_context(outer):
            seen["holder"] = active_mesh()
            entered.set()
            release.wait(10)

    t = threading.Thread(target=hold)
    t.start()
    entered.wait(10)
    seen["other"] = active_mesh()
    release.set()
    t.join()
    assert seen == {"holder": outer, "other": None}
    with mesh_context(outer):
        with mesh_context(inner):
            assert active_mesh() is inner
        assert active_mesh() is outer
    assert active_mesh() is None


@pytest.mark.parametrize("model", ["llama-test", "moe-test"])
def test_remat_recompute_on_another_thread_keeps_the_mesh(pool, model):
    """A per-thread mesh context must still reach remat's recompute,
    which the autograd engine runs on a thread of its own for CUDA
    tensors: the checkpointed blocks carry the mesh they ran under
    (``parallel.mesh.in_context_mesh``), so a backward taken on another
    thread gives the same gradients."""
    cfg = replace(JCONFIGS[model], dtype=jnp.float32)
    tokens = _prompt(6, (4, 17), cfg)
    res = pool.run(remat_thread_case, model, _np(_params(cfg)), tokens)
    assert res[0] == 0.0


def test_uneven_batch_and_mesh_are_refused_by_axis():
    cfg = replace(CONFIGS["llama-test"], dtype=torch.float32)
    mesh = create_mesh({"data": 2, "tensor": 4}, devices=list(range(8)))
    _, _, b_sh = make_sharded_generate(cfg, mesh, {}, max_new_tokens=2)
    assert b_sh.spec == (("data",),)
    with pytest.raises(ValueError, match=r"data-like \(data\) of size 2 "
                                         r"does not divide batch rows 3"):
        check_serving_mesh(cfg, mesh, 3)
    # the caller's cut of a whole batch names the dimension and the axes
    with pytest.raises(ValueError, match=r"dimension 0 of size 3 .*"
                                         r"\('data',\) of size 2"):
        shard_tensor(torch.zeros((3, 4)), b_sh, 0)
    # a tensor split wider than the KV heads must be a multiple of them
    with pytest.raises(ValueError, match="n_kv_heads 2"):
        make_sharded_generate(cfg, create_mesh({"tensor": 3}, devices=[0, 1,
                                                                       2]),
                              {}, max_new_tokens=2)
