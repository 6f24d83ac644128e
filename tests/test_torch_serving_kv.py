"""The slot engine's half of ``tpu_kubernetes_torch/parallel/serving.py``:
the KV rule and the programs on head-sharded caches, at tensor=2 on gloo
ranks on the CPU, in float32. The data-movement bodies
(``cache_insert_row``, ``cache_clear_row``, ``paged_insert_row``,
``paged_clear_pages``, ``gather_pages``) run as they are on a rank's head
slice (``kv_movement``): gathered back, the caches are bit for bit the
one-device bodies' on the same rows. The model programs
(``prefill``, ``decode_segment_slots``, ``decode_segment_paged``,
``prefill_resume``) run under the mesh (``kv_model_program``): their
tokens equal the JAX package's single-device programs', dense, paged and
on an int8 cache. ``kv_tree_shardings`` splits exactly the KV storage (4
dimensions or more) on axis 2. One pool of two ranks serves the module."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_support import RankPool
from torch_serving_support import kv_case, kv_widths, resume_case
from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.parallel import (
    create_mesh,
    kv_partition_spec,
    kv_tree_shardings,
    mesh_context,
    shard_kv,
)

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
TP = {"tensor": 2}
STEPS = 6
LOGIT_ATOL = 1e-4


@pytest.fixture(scope="module")
def pool():
    p = RankPool(2)
    yield p
    p.close()


@pytest.fixture(scope="module")
def params():
    return jllama.init_params(jax.random.PRNGKey(0), JCFG)


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, JCFG.vocab_size, n).astype(np.int32)
            for n in (5, 11, 8)]


def _jax_slots(params, prompts, kv_quant, paged):
    """The JAX package's single-device engine on the same rows → (each
    row's first token, the segment's tokens)."""
    width, span, ps, row_ws = kv_widths(prompts, STEPS, paged)
    n = len(prompts)
    first, rows = [], []
    for p, row_w in zip(prompts, row_ws):
        pad = np.zeros((1, row_w), np.int32)
        pad[0, :len(p)] = p
        logits, row = jdec.prefill(
            params, jnp.asarray(pad), JCFG, max_seq=row_w,
            lengths=jnp.asarray([len(p)], jnp.int32), kv_quant=kv_quant)
        first.append(int(jnp.argmax(logits[0])))
        rows.append(row)
    z = np.zeros((n,), np.int32)
    st = jdec.SlotState(
        tok=jnp.asarray(first, jnp.int32), pos=jnp.asarray(row_ws, jnp.int32),
        remaining=jnp.asarray(z + STEPS),
        prompt_lengths=jnp.asarray([len(p) for p in prompts], jnp.int32),
        prompt_slots=jnp.asarray(row_ws, jnp.int32))
    if not paged:
        cache = jdec.init_cache(JCFG, n, span, kv_quant=kv_quant)
        for i, row in enumerate(rows):
            cache = jdec.cache_insert_row(cache, row, i)
        out, _, _ = jdec.decode_segment_slots(params, cache, st, JCFG, STEPS)
    else:
        n_pages = span // ps
        pool = jdec.init_paged_pool(JCFG, n * n_pages, ps, kv_quant=kv_quant)
        table = np.zeros((n, n_pages), np.int32)
        for i, row in enumerate(rows):
            table[i] = np.arange(1 + i * n_pages, 1 + (i + 1) * n_pages)
            pool = jdec.paged_insert_row(
                pool, row, jnp.asarray(table[i, :row_ws[i] // ps]))
        out, _, _ = jdec.decode_segment_paged(params, pool,
                                              jnp.asarray(table), st, JCFG,
                                              STEPS)
    return first, np.asarray(out)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("kv_quant", [False, True], ids=["f32", "int8"])
def test_slot_programs_on_head_sharded_caches(pool, params, kv_quant, paged):
    prompts = _prompts()
    first, want = _jax_slots(params, prompts, kv_quant, paged)
    res = pool.run(kv_case, TP, jax.tree.map(np.asarray, params), prompts,
                   first, STEPS, kv_quant, paged)
    for r in res:
        assert all(r["moved_equal"]), r["moved_equal"]
        np.testing.assert_array_equal(r["tokens"], want)
        # each rank holds one of llama-test's two KV heads
        assert r["shapes"][0][2] == JCFG.n_kv_heads // 2
    # the rows the sharded prefill wrote: the one-device prefill's K up to
    # the reduction order (int8: the same codes)
    assert res[0]["rows_diff"] <= (0 if kv_quant else 1e-5)


def test_prefill_resume_on_head_sharded_caches(pool, params):
    rng = np.random.default_rng(9)
    prefix = rng.integers(0, JCFG.vocab_size, (2, 8)).astype(np.int32)
    suffix = rng.integers(0, JCFG.vocab_size, (2, 5)).astype(np.int32)
    span = 8 + 5 + 4
    _, jcache = jdec.prefill(params, jnp.asarray(prefix), JCFG, max_seq=span)
    jlogits, jcache = jdec.prefill_resume(params, jnp.asarray(suffix), JCFG,
                                          jcache)
    tok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    out, *_ = jdec.decode_segment(params, jcache, tok,
                                  jnp.zeros_like(tok, bool), JCFG, 4)
    want = np.concatenate([np.asarray(tok)[:, None], np.asarray(out)], 1)
    res = pool.run(resume_case, TP, jax.tree.map(np.asarray, params),
                   prefix, suffix)
    for r in res:
        assert r["kv_heads"] == 1
        np.testing.assert_array_equal(r["tokens"], want)
        np.testing.assert_allclose(r["logits"], np.asarray(jlogits),
                                   atol=LOGIT_ATOL, rtol=0)


def test_kv_tree_shardings_split_exactly_the_kv_storage():
    mesh = create_mesh({"data": 2, "tensor": 2}, devices=[0, 1, 2, 3])
    assert kv_partition_spec(mesh) == (None, None, "tensor")
    assert kv_partition_spec(create_mesh({"data": 4},
                                         devices=[0, 1, 2, 3])) == \
        (None, None, None)
    cache = tdec.init_cache(TCFG, 3, 16, kv_quant=True, device="cpu")
    st = tdec.init_slot_state(3, device="cpu")
    table = torch.zeros((3, 2), dtype=torch.int32)
    sh = kv_tree_shardings((cache, st, table), mesh)
    c_sh, st_sh, t_sh = sh
    assert c_sh.k.spec == c_sh.v.spec == (None, None, "tensor")
    assert c_sh.k_scale.spec == (None, None, "tensor")       # 4-D scales
    assert c_sh.length == 0 and c_sh.prompt_lengths is None
    assert all(getattr(st_sh, f).spec == () for f in
               ("tok", "pos", "remaining", "prompt_lengths",
                "prompt_slots"))
    assert t_sh.spec == ()
    # the cut keeps a rank's heads, the rest as it is
    cut = shard_kv((cache, table), mesh, rank=3)
    assert tuple(cut[0].k.shape) == (2, 3, 1, 16, 16)
    assert tuple(cut[0].k_scale.shape) == (2, 3, 1, 16)
    assert cut[1] is table
    # a cache, a pool and a page made under the mesh hold the rank's heads
    whole = tdec.page_bytes(TCFG, 8)
    with mesh_context(mesh):
        assert tdec.init_cache(TCFG, 3, 16, device="cpu").k.shape[2] == 1
        assert tdec.init_paged_pool(TCFG, 4, 8, device="cpu").k.shape[2] == 1
        assert tdec.page_bytes(TCFG, 8) * 2 == whole
