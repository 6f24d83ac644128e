"""The port's LoRA (``train/lora.py``) against the JAX package's and the
reference's ``tests/test_lora.py`` cases (all but the sharded step, which
waits for the parallel slice): the adapters' shapes and guards, the
zero-init identity, the merge's rounding, three ``lora_train_step``s
against the JAX package's from bridged params and adapters (f32: the
adapters and losses within a stated tolerance, the base bit for bit
untouched), and ``make_lora_step`` equal to ``lora_train_step``."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import moe as jmoe
from tpu_kubernetes.train import lora as jlora
from tpu_kubernetes_torch.models import forward, init_params, loss_fn
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models import moe as tmoe
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.train import lora as tlora
from tpu_kubernetes_torch.train.trainer import synthetic_batches, tree_leaves

CFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
MOE_CFG = replace(tmoe.MOE_CONFIGS["moe-test"], dtype=torch.float32)
JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
JMOE_CFG = replace(jmoe.MOE_CONFIGS["moe-test"], dtype=jnp.float32)
LC = tlora.LoraConfig(rank=4)
JLC = jlora.LoraConfig(rank=4)
# f32 adapters after three AdamW steps at lr 5e-3 from gradients that agree
# to ~1e-7: each element moves by about lr·sign(g) a step, and the two
# sides round the moments by a few f32 ulps (measured 2.3e-8 abs)
ADAPTER_TOL = dict(atol=1e-6, rtol=1e-5)


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.fixture(scope="module")
def params():
    return init_params(CFG, _gen(0), "cpu")


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def test_zero_init_is_identity(params):
    """B = 0 ⇒ the merged model is bit for bit the base model."""
    adapters = tlora.init_lora(_gen(1), params, CFG, LC)
    merged = tlora.merge_lora(params, adapters, LC)
    tokens = torch.randint(0, CFG.vocab_size, (2, 16), generator=_gen(2))
    with torch.no_grad():
        assert torch.equal(forward(merged, tokens, CFG),
                           forward(params, tokens, CFG))


def test_adapter_shapes_preserve_stacking(params):
    lc = tlora.LoraConfig(rank=4, targets=("wq", "w_gate"))
    adapters = tlora.init_lora(_gen(1), params, CFG, lc)
    L, d, hout = params["layers"]["wq"].shape
    assert adapters["wq"]["a"].shape == (L, d, 4)
    assert adapters["wq"]["b"].shape == (L, 4, hout)
    assert adapters["w_gate"]["a"].dtype == params["layers"]["w_gate"].dtype
    assert not adapters["wq"]["b"].any()
    # A ~ N(0, 1)/√in
    std = adapters["w_gate"]["a"].std().item()
    assert abs(std * d ** 0.5 - 1) < 0.2


def test_moe_expert_adapters():
    """Expert stacks adapt too: the (layer, expert) axes ride along."""
    moe_params = init_params(MOE_CFG, _gen(0), "cpu")
    lc = tlora.LoraConfig(rank=2, targets=("w_gate", "w_up", "w_down"))
    adapters = tlora.init_lora(_gen(1), moe_params, MOE_CFG, lc)
    L, E, d, ff = moe_params["layers"]["w_gate"].shape
    assert adapters["w_gate"]["a"].shape == (L, E, d, 2)
    merged = tlora.merge_lora(moe_params, adapters, lc)
    tokens = torch.randint(0, MOE_CFG.vocab_size, (2, 17), generator=_gen(3))
    with torch.no_grad():
        assert np.isfinite(loss_fn(merged, tokens, MOE_CFG).item())


@pytest.mark.parametrize("targets,match", [
    (("w_nonexistent",), "not in params"), (("attn_norm",), "stacked")])
def test_bad_targets_rejected(params, targets, match):
    with pytest.raises(ValueError, match=match):
        tlora.init_lora(_gen(1), params, CFG,
                        tlora.LoraConfig(targets=targets))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_merge_is_the_jax_packages(dtype):
    """w + (a @ b)·s with s cast to the weight's dtype before the multiply:
    the JAX package's merge of the same numbers. bf16 bit for bit (the
    product and the sum each rounded to bf16); f32 within the order of the
    rank's 4-term sums (XLA's and ATen's: measured 1.2e-7 at |w| < 0.6)."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jp = jllama.init_params(jax.random.PRNGKey(0),
                            replace(JCFG, dtype=jdt))
    lc = jlora.LoraConfig(rank=4, alpha=5.0)
    ja = jlora.init_lora(jax.random.PRNGKey(1), jp, JCFG, lc)
    # a nonzero B, so the product is not all zeros
    ja = {k: {"a": v["a"], "b": jax.random.normal(
        jax.random.PRNGKey(2), v["b"].shape, jdt)} for k, v in ja.items()}
    want = jlora.merge_lora(jp, ja, lc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    ta = params_from_numpy(jax.tree.map(np.asarray, ja), device="cpu")
    got = tlora.merge_lora(tp, ta, tlora.LoraConfig(rank=4, alpha=5.0))
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        g = _leaf(got, path)
        assert g.dtype == dtype
        tol = (dict(rtol=1e-6, atol=2e-7) if dtype == torch.float32
               else dict(rtol=0, atol=0))
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(leaf).astype(np.float32), **tol,
            err_msg=jax.tree_util.keystr(path))


def test_lora_optimizer_is_optax_adamw_at_a_constant_rate():
    """optax.adamw(lr, weight_decay=0): the rate from the first count on
    (no warm-up), b2 0.999, no clip: one step on a large gradient, which
    a clip at 1 would shrink, against optax's."""
    opt = tlora.make_lora_optimizer(LC, learning_rate=5e-3)
    for count in (0, 1, 1000):
        assert opt.schedule(torch.tensor(count)).item() == np.float32(5e-3)
    w = np.random.default_rng(0).normal(size=(3, 4)).astype(np.float32)
    g = 100 * np.random.default_rng(1).normal(size=(3, 4)).astype(np.float32)
    ref = optax.adamw(5e-3, weight_decay=0.0)
    jstate = ref.init(jnp.asarray(w))
    params = {"w": torch.from_numpy(w.copy())}
    state = opt.init(params)
    for _ in range(2):
        upd, jstate = ref.update(jnp.asarray(g), jstate, jnp.asarray(w))
        w = np.asarray(optax.apply_updates(jnp.asarray(w), upd))
        opt.update_([torch.from_numpy(g)], state, params)
    np.testing.assert_allclose(params["w"].numpy(), w, rtol=1e-6, atol=1e-7)


def _bridged(jcfg, tcfg, lc_kw, lr=5e-3):
    jlc, tlc = jlora.LoraConfig(**lc_kw), tlora.LoraConfig(**lc_kw)
    jp = (jmoe if hasattr(jcfg, "n_experts") else jllama).init_params(
        jax.random.PRNGKey(0), jcfg)
    jstate = jlora.init_lora_state(jax.random.PRNGKey(1), jp, jcfg, jlc,
                                   learning_rate=lr)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    adapters = params_from_numpy(
        jax.tree.map(np.asarray, jstate["adapters"]), device="cpu")
    tstate = {"adapters": adapters,
              "opt_state": tlora.make_lora_optimizer(tlc, lr).init(adapters),
              "step": 0}
    return jp, jstate, jlc, tp, tstate, tlc


@pytest.mark.parametrize("family", ["dense", "moe"])
def test_three_steps_match_the_jax_package_f32(family):
    """Three lora_train_steps on both sides from bridged params and
    adapters: losses and adapters within the f32 tolerance, the base bit
    for bit untouched."""
    jcfg, tcfg = ((JCFG, CFG) if family == "dense" else (JMOE_CFG, MOE_CFG))
    lc_kw = dict(rank=4) if family == "dense" else dict(
        rank=2, targets=("wq", "wo", "w_gate", "w_down"))
    jp, js, jlc, tp, ts, tlc = _bridged(jcfg, tcfg, lc_kw)
    base = [t.clone() for t in tree_leaves(tp)]
    jstep = jax.jit(lambda s, p, b: jlora.lora_train_step(
        s, p, b, jcfg, jlc, learning_rate=5e-3))
    rng = np.random.default_rng(4)
    for _ in range(3):
        b = rng.integers(0, tcfg.vocab_size, (4, 33)).astype(np.int32)
        js, lj = jstep(js, jp, jnp.asarray(b))
        ts, lt = tlora.lora_train_step(ts, tp, torch.from_numpy(b), tcfg,
                                       tlc, learning_rate=5e-3)
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    assert ts["step"] == 3 == int(js["step"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(js["adapters"]):
        np.testing.assert_allclose(
            _leaf(ts["adapters"], path).numpy(), np.asarray(leaf),
            **ADAPTER_TOL, err_msg=jax.tree_util.keystr(path))
    assert any(bool(t["b"].abs().sum() > 0) for t in ts["adapters"].values())
    for a, b in zip(base, tree_leaves(tp)):
        assert torch.equal(a, b)


def test_graphless_step_equals_lora_train_step():
    """make_lora_step(graphs=False), in place, against lora_train_step
    from the same state and batches: bit for bit on the CPU."""
    _, _, _, tp, a, tlc = _bridged(JCFG, CFG, dict(rank=4))
    _, _, _, _, b, _ = _bridged(JCFG, CFG, dict(rank=4))
    step = tlora.make_lora_step(CFG, tlc, b, tp, (4, 33),
                                learning_rate=5e-3, graphs=False)
    ptrs = [t.data_ptr() for t in tree_leaves(b["adapters"])]
    gen = _gen(6)
    for _ in range(3):
        batch = torch.randint(0, CFG.vocab_size, (4, 33), generator=gen,
                              dtype=torch.int32)
        a, la = tlora.lora_train_step(a, tp, batch, CFG, tlc,
                                      learning_rate=5e-3)
        assert step(batch).item() == la.item()
    assert b["step"] == a["step"] == 3
    assert [t.data_ptr() for t in tree_leaves(b["adapters"])] == ptrs
    for key in ("adapters", "opt_state"):
        for x, y in zip(tree_leaves(a[key]), tree_leaves(b[key])):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="is not the step's"):
        step(torch.zeros((2, 33), dtype=torch.int32))


def test_training_decreases_loss_and_freezes_base(params):
    """The reference's test: nine steps overfit one batch; only the
    adapters move, and they change the model."""
    state = tlora.init_lora_state(_gen(1), params, CFG, LC,
                                  learning_rate=5e-3)
    base = [t.clone() for t in tree_leaves(params)]
    batch = next(synthetic_batches(CFG.vocab_size, 4, 32, device="cpu"))
    step = tlora.make_lora_step(CFG, LC, state, params, tuple(batch.shape),
                                learning_rate=5e-3)
    first = step(batch).item()
    for _ in range(8):
        loss = step(batch).item()
    assert loss < first
    assert state["step"] == 9
    for a, b in zip(base, tree_leaves(params)):
        assert torch.equal(a, b)
    merged = tlora.merge_lora(params, state["adapters"], LC)
    tokens = batch[:, :-1]
    with torch.no_grad():
        assert not torch.allclose(forward(merged, tokens, CFG),
                                  forward(params, tokens, CFG))
    # the merge leaves the other leaves as the base's own tensors
    assert merged["layers"]["w_gate"] is params["layers"]["w_gate"]
