"""The port's Adafactor (``train/trainer.py`` ``Adafactor``) against the JAX
package's optax chain ``clip_by_global_norm`` → ``adafactor``, from the
same weights (``models.from_jax``) and the same numpy batches: three f32
steps, the losses, every parameter leaf and every optimizer statistic.

The configs: ``llama-test`` widths (d_model 64: nothing factors, as in the
reference's own ``TestAdafactor``), a dense config at d_model 128 and d_ff
256 (``wq``, ``w_gate``, ``w_up``, ``embed`` and ``lm_head`` factor, on
both orders of their axes and on a tie; ``wk``, ``wv`` and the norms do
not), and MoE at those widths (the 4-D expert stacks factor). Then the
reference's ``TestAdafactor`` cases against the port, and the in-place
step against the out-of-place one."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from optax._src import factorized

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import moe as jmoe
from tpu_kubernetes.train import trainer as jtr
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models import moe as tmoe
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.train import trainer as ttr

TC = jtr.TrainConfig(warmup_steps=2, optimizer="adafactor")
WIDE = dict(d_model=128, d_ff=256)
CASES = {
    "llama-test": (replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32),
                   replace(tllama.CONFIGS["llama-test"],
                           dtype=torch.float32)),
    "dense-factored": (
        replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32, **WIDE),
        replace(tllama.CONFIGS["llama-test"], dtype=torch.float32, **WIDE)),
    "moe-factored": (
        replace(jmoe.MOE_CONFIGS["moe-test"], dtype=jnp.float32, **WIDE),
        replace(tmoe.MOE_CONFIGS["moe-test"], dtype=torch.float32, **WIDE)),
}
# f32 parameters after three steps from gradients that agree to ~1e-7: the
# second-moment statistics differ by summation order and the ulps of
# pow/rsqrt, the update by a few f32 ulps of |u| ≤ lr·rms-clip (measured
# 2.7e-7 abs at |p| ≤ 2.9)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
# the statistics themselves, relative (measured 1.2e-6 at a norm's v)
STAT_RTOL = 1e-5


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _states(jcfg, tc):
    js = jtr.init_state(jax.random.PRNGKey(0), jcfg, tc)
    tp = params_from_numpy(jax.tree.map(np.asarray, js["params"]),
                           device="cpu")
    return js, {"params": tp, "opt_state": ttr.make_optimizer(tc).init(tp),
                "step": 0}


def _run_both(jcfg, tcfg, tc, steps=3, rows=4):
    js, ts = _states(jcfg, tc)
    step = jax.jit(functools.partial(jtr.train_step, cfg=jcfg, tc=tc))
    rng = np.random.default_rng(3)
    jl, tl = [], []
    for _ in range(steps):
        b = rng.integers(0, tcfg.vocab_size, (rows, 33)).astype(np.int32)
        js, lj = step(js, jnp.asarray(b))
        ts, lt = ttr.train_step(ts, torch.from_numpy(b), tcfg, tc)
        jl.append(float(lj))
        tl.append(lt.item())
    return js, ts, jl, tl


@pytest.mark.parametrize("case,accum", [
    ("llama-test", 1), ("dense-factored", 1), ("moe-factored", 1),
    ("dense-factored", 2)])
def test_three_steps_match_optax_f32(case, accum):
    """Losses, every parameter and every statistic (v_row, v_col, v, the
    bf16 momentum) after three steps; the first at lr 0, so its update is
    the weight decay alone."""
    jcfg, tcfg = CASES[case]
    tc = replace(TC, accum_steps=accum)
    js, ts, jl, tl = _run_both(jcfg, tcfg, tc)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for path, leaf in jax.tree_util.tree_leaves_with_path(js["params"]):
        np.testing.assert_allclose(
            _leaf(ts["params"], path).numpy(), np.asarray(leaf), **PARAM_TOL,
            err_msg=jax.tree_util.keystr(path))
    factored, _, _, ema, _, _ = js["opt_state"][1]
    stats = {"v_row": factored.v_row, "v_col": factored.v_col,
             "v": factored.v, "mu": ema.ema}
    for name, tree in stats.items():
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            got = _leaf(ts["opt_state"][name], path)
            ref = np.asarray(leaf).astype(np.float32)
            assert tuple(got.shape) == ref.shape, (name, path)
            assert got.dtype == (torch.bfloat16 if name == "mu"
                                 else torch.float32)
            scale = max(np.abs(ref).max(), 1e-30)
            err = np.abs(got.float().numpy() - ref).max() / scale
            # the bf16 momentum: values within STAT_RTOL on either side of
            # a rounding boundary land one bf16 ulp apart (2^-7 relative)
            assert err <= (2 ** -7 if name == "mu" else STAT_RTOL), (
                name, jax.tree_util.keystr(path), err)
    assert int(ts["opt_state"]["count"]) == 3 == int(factored.count)


def test_factored_leaves_are_the_ones_optax_factors():
    """Which leaves factor, over which axes, at the three configs."""
    seen = set()
    for case, (_, tcfg) in CASES.items():
        params = ttr.init_state(torch.Generator().manual_seed(0), tcfg, TC,
                                "cpu")["params"]
        for p in ttr.tree_leaves(params):
            ours = ttr.factored_dims(tuple(p.shape))
            assert ours == factorized._factored_dims(tuple(p.shape), True,
                                                     128)
            seen.add((case, ours is not None))
    assert ("llama-test", True) not in seen
    assert {("dense-factored", True), ("dense-factored", False),
            ("moe-factored", True)} <= seen


@pytest.mark.parametrize("shape", [
    (5,), (128, 128), (2, 128, 128), (2, 256, 128), (256, 128), (128, 256),
    (2, 4, 128, 256), (4, 127, 300), (130, 129, 131), (16, 2048, 5632),
    (16, 5632, 2048), (32000, 2048), (16, 2048)])
def test_factored_dims_equal_optax(shape):
    assert ttr.factored_dims(shape) == factorized._factored_dims(
        shape, True, 128)


def test_decay_rate_from_the_count_tensor():
    """``1 − (t+1)^-0.8`` read from the count tensor, as optax's
    ``_decay_rate_pow`` of the same count (within one f32 ulp of pow)."""
    opt = ttr.make_optimizer(TC)
    for count in (0, 1, 2, 9, 99, 12_345):
        got = opt.decay(torch.tensor(count, dtype=torch.int32))
        assert got.dtype == torch.float32 and got.dim() == 0
        ref = np.float32(factorized._decay_rate_pow(count))
        assert abs(got.item() - ref) <= np.spacing(np.float32(1.0)), count


def test_weight_decay_is_added_after_the_learning_rate():
    """The first step runs at lr 0, and still takes wd·p off every
    parameter: the decay is not scaled by the rate (the reference's
    behaviour, kept), bit for bit optax's in f32."""
    jcfg, tcfg = CASES["dense-factored"]
    js0, ts0 = _states(jcfg, TC)
    js, ts, _, _ = _run_both(jcfg, tcfg, TC, steps=1)
    for path, leaf in jax.tree_util.tree_leaves_with_path(js0["params"]):
        p0 = np.asarray(leaf)
        want = p0 + -(np.float32(TC.weight_decay) * p0)
        np.testing.assert_array_equal(_leaf(ts["params"], path).numpy(),
                                      want)
        np.testing.assert_array_equal(
            np.asarray(_leaf(js["params"], path)), want)


def test_in_place_step_equals_out_of_place():
    """make_train_step(graphs=False), in place, against train_step from
    the same state and batches: bit for bit on the CPU, at the factoring
    config."""
    _, tcfg = CASES["dense-factored"]
    a = ttr.init_state(torch.Generator().manual_seed(0), tcfg, TC, "cpu")
    b = ttr.init_state(torch.Generator().manual_seed(0), tcfg, TC, "cpu")
    step = ttr.make_train_step(tcfg, TC, b, (4, 33), graphs=False)
    gen = torch.Generator().manual_seed(5)
    for _ in range(3):
        batch = torch.randint(0, tcfg.vocab_size, (4, 33), generator=gen,
                              dtype=torch.int32)
        a, la = ttr.train_step(a, batch, tcfg, TC)
        lb = step(batch)
        assert la.item() == lb.item()
    assert b["step"] == a["step"] == 3
    for key in ("params", "opt_state"):
        for x, y in zip(ttr.tree_leaves(a[key]), ttr.tree_leaves(b[key])):
            assert torch.equal(x, y)


def test_update_leaves_its_arguments_as_they_were():
    _, tcfg = CASES["dense-factored"]
    state = ttr.init_state(torch.Generator().manual_seed(0), tcfg, TC, "cpu")
    leaves = [*ttr.tree_leaves(state["params"]),
              *ttr.tree_leaves(state["opt_state"])]
    before = [t.clone() for t in leaves]
    batch = torch.zeros((2, 9), dtype=torch.int32)
    new, _ = ttr.train_step(state, batch, tcfg, TC)
    for x, y in zip(before, leaves):
        assert torch.equal(x, y)
    assert int(new["opt_state"]["count"]) == 1
    assert int(state["opt_state"]["count"]) == 0


# -- the reference's TestAdafactor (tests/test_train.py), on the port ---------

CFG = tllama.CONFIGS["llama-test"]


def test_loss_decreases():
    state = ttr.init_state(torch.Generator().manual_seed(0), CFG, TC, "cpu")
    batch = next(ttr.synthetic_batches(CFG.vocab_size, 2, 64, seed=7,
                                       device="cpu"))
    losses = []
    for _ in range(5):
        state, loss = ttr.train_step(state, batch, CFG, TC)
        losses.append(loss.item())
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("cfg", [CFG, replace(CFG, **WIDE)],
                         ids=["llama-test", "dense-factored"])
def test_moments_are_smaller_and_bf16(cfg):
    """bf16 params: the momentum and the statistics are bf16, and the state
    is under AdamW's f32 m + v (8 bytes a parameter); at the factoring
    config also under 0.6 of the port's AdamW state (whose moments keep
    the parameters' dtype: at llama-test, where nothing factors, the two
    are the same size)."""
    state = ttr.init_state(torch.Generator().manual_seed(0), cfg, TC, "cpu")
    leaves = ttr.tree_leaves(state["opt_state"])
    n_params = sum(p.numel() for p in ttr.tree_leaves(state["params"]))
    opt_bytes = sum(x.numel() * x.element_size() for x in leaves)
    assert opt_bytes < 0.8 * 8 * n_params
    assert any(x.dtype == torch.bfloat16 for x in leaves)
    for name in ("v_row", "v_col", "v", "mu"):
        assert all(x.dtype == torch.bfloat16
                   for x in ttr.tree_leaves(state["opt_state"][name]))
    if cfg.d_model >= 128:      # the second moment is factored
        adamw = ttr.make_optimizer(replace(TC, optimizer="adamw")).init(
            state["params"])
        adamw_bytes = sum(x.numel() * x.element_size()
                          for x in ttr.tree_leaves(adamw))
        assert opt_bytes < 0.6 * adamw_bytes


def test_unknown_optimizer_rejected():
    with pytest.raises(ValueError, match="unknown optimizer"):
        ttr.init_state(torch.Generator().manual_seed(0), CFG,
                       replace(TC, optimizer="sgd"), "cpu")


def test_optax_chain_is_the_reference_one():
    """The reference builds the chain these tests compare against (a guard
    that the JAX side under test is optax's adafactor)."""
    opt = jtr.make_optimizer(TC)
    state = opt.init({"w": jnp.zeros((128, 256))})
    assert isinstance(state[1][0], factorized.FactoredState)
    assert isinstance(state[1][3], optax.EmaState)
    assert state[1][3].ema["w"].dtype == jnp.bfloat16
