"""The port's MoE family against the JAX package on ``moe-test`` (and its
grouped twin), from the same weights (carried over by ``models.from_jax``
without a dtype override, so the router stays float32) and the same numpy
inputs:

* routing, exactly: every plan from the same gates array, with a
  capacity-overflow case and gates that underflow to exactly 0;
* ``moe_sublayer`` and ``forward_with_aux`` in all three dispatch modes
  (f32 logits within 1e-5, aux within 1e-6), ``loss_fn`` gradients under
  remat off, "dots" and "moe", and remat changing no gradient;
* the reference's grouped oracles re-run against the port (grouped equals
  the drop-free einsum path; grouped stays dropless under a router biased
  to one expert);
* serving (greedy ``generate`` token-identical, prefill/decode logits),
  three optimizer steps, the server's ``complete()`` and the job;
* the kernel lane's launch counts under remat "moe" and in serving, with
  the CUDA kernels stood in for by their plain versions (the CPU has no
  card): the grouped kernel 8 times a layer a step, drhs 3 times, and
  decode attention once a layer a decode step.

Routing is discrete, so an end-to-end comparison could flip on a near-tie
of two gates; every end-to-end test asserts that the smallest margin
between the top-k gates and the next one is above 1e-4 on its inputs."""

import functools
import importlib
import math
from dataclasses import fields, replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import moe as jmoe
from tpu_kubernetes.serve.server import ServingState as JState
from tpu_kubernetes.train import trainer as jtr
from tpu_kubernetes_torch import models as tmodels
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import moe as tmoe
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tsjob
from tpu_kubernetes_torch.serve import server as tserver
from tpu_kubernetes_torch.train import job as tjob
from tpu_kubernetes_torch.train import trainer as ttr
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

tfa = importlib.import_module("tpu_kubernetes_torch.ops.flash_attention")
tgmm = importlib.import_module("tpu_kubernetes_torch.ops.grouped_matmul")
tda = importlib.import_module("tpu_kubernetes_torch.ops.decode_attention")

MODES = ["einsum", "gather", "grouped"]
JCFG = replace(jmoe.MOE_CONFIGS["moe-test"], dtype=jnp.float32)
TCFG = replace(tmoe.MOE_CONFIGS["moe-test"], dtype=torch.float32)
# float32 through two layers: summation order (XLA vs ATen) and
# transcendental ulps only, with every routing decision equal
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)
AUX_TOL = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)      # measured 5e-8 abs
# float32 parameters after three AdamW steps (as tests/test_torch_train.py)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
MARGIN = 1e-4


def _cfgs(mode, **kw):
    return (replace(JCFG, dispatch_mode=mode, **kw),
            replace(TCFG, dispatch_mode=mode, **kw))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TCFG.vocab_size, shape).astype(np.int32)


def _j(a):
    return jnp.asarray(a)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _bridge(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same weights as port tensors on the CPU)."""
    jp = jmoe.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, _bridge(jp)


@pytest.fixture()
def gate_log(monkeypatch):
    """Every gates tensor the port routes, recorded for the near-tie
    check."""
    seen, inner = [], tmoe._topk_selection

    def record(gates, k):
        seen.append(gates.detach())
        return inner(gates, k)

    monkeypatch.setattr(tmoe, "_topk_selection", record)
    return seen


def _assert_no_near_ties(seen, k=TCFG.experts_per_token):
    """The top-k gates of every token are more than MARGIN apart from each
    other and from the next gate, so rounding cannot change a decision."""
    assert seen, "nothing was routed"
    margin = min(
        (lambda top: (top[..., :k] - top[..., 1:k + 1]).min().item())(
            torch.sort(g, dim=-1, descending=True).values)
        for g in seen)
    assert margin > MARGIN, f"near-tie: top-{k} gate margin {margin:.3e}"


# -- config and parameters ----------------------------------------------------

@pytest.mark.parametrize("name", sorted(jmoe.MOE_CONFIGS))
def test_presets_match_the_reference(name):
    jc, tc = jmoe.MOE_CONFIGS[name], tmodels.CONFIGS[name]
    assert isinstance(tc, tmodels.MoEConfig)
    for f in fields(tc):
        if f.name not in ("dtype", "use_kernel"):
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
    assert tmodels.expert_capacity(tc, 1000) == jmoe.expert_capacity(jc, 1000)


def test_init_params_layout_and_router_dtype():
    """The port's init draws its own numbers in the reference's layout:
    every leaf's shape equal, the router f32 in a bf16 model."""
    cfg = tmoe.MOE_CONFIGS["moe-test"]
    tp = tmodels.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    jp = jmoe.init_params(jax.random.PRNGKey(0), jmoe.MOE_CONFIGS["moe-test"])
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        assert tuple(_leaf(tp, path).shape) == leaf.shape
    assert tp["layers"]["w_router"].dtype == torch.float32
    assert tp["layers"]["w_gate"].dtype == torch.bfloat16
    assert _bridge(jp)["layers"]["w_router"].dtype == torch.float32


# -- routing, exactly -----------------------------------------------------------

def _gates(kind):
    rng = np.random.default_rng({"random": 0, "overflow": 1, "underflow": 2}[kind])
    logits = rng.standard_normal((2, 16, 4)).astype(np.float32)
    if kind == "overflow":
        logits[..., 0] += 3.0                  # most tokens pick expert 0
    if kind == "underflow":
        logits *= 200.0                        # most gates exactly 0.0
    z = np.exp(logits - logits.max(-1, keepdims=True))
    gates = (z / z.sum(-1, keepdims=True)).astype(np.float32)
    # XLA on the CPU flushes subnormals to zero where torch keeps them:
    # the gates hold none, so that both compare the same numbers
    gates[np.abs(gates) < np.finfo(np.float32).tiny] = 0.0
    if kind == "underflow":
        assert (gates == 0).any()
    return gates


ROUTING = [("random", 10), ("overflow", 3), ("underflow", 10)]


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("kind,capacity", ROUTING)
def test_routing_plans_equal_the_reference(kind, capacity):
    g = _gates(kind)
    jg, tg = _j(g), _t(g)
    k, E = 2, 4
    ji, jmk = jmoe._topk_selection(jg, k)
    ti, tmk = tmoe._topk_selection(tg, k)
    for a, b in zip(ti + tmk, ji + jmk):
        _eq(a, b)

    jd, jc, jf = jmoe._route(jg, k, capacity)
    td, tc, tf = tmoe._route(tg, k, capacity)
    _eq(td, jd)
    _eq(tf, jf)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    if kind == "overflow":
        assert float(jnp.sum(jd)) < k * 2 * 16, "no claim was dropped"

    jplan = jmoe._grouped_sort_plan(jg, k, E)
    tplan = tmoe._grouped_sort_plan(tg, k, E)
    for name, a, b in zip(("perm", "sizes", "token_of", "inv", "weight",
                           "first"), tplan, jplan):
        if name == "weight":
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        else:
            _eq(a, b)
    assert tplan[1].dtype == torch.int32

    jdst, jkeep, jw, jfirst = jmoe._route_plan(jg, k, capacity)
    tdst, tkeep, tw, tfirst = tmoe._route_plan(tg, k, capacity)
    _eq(tdst, jdst)
    _eq(tkeep, jkeep)
    _eq(tfirst, jfirst)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    jsrc, jvalid = jmoe._slot_sources(jdst, jkeep, E * capacity)
    tsrc, tvalid = tmoe._slot_sources(tdst, tkeep, E * capacity)
    _eq(tsrc, jsrc)
    _eq(tvalid, jvalid)


def test_underflowed_gates_never_repick_an_expert():
    """Every gate but one exactly 0: the second round takes the first of
    the zero gates, never the expert already chosen."""
    g = np.zeros((1, 3, 4), np.float32)
    g[0, :, 2] = 1.0
    idxs, _ = tmoe._topk_selection(_t(g), 2)
    assert idxs[0].tolist() == [[2, 2, 2]]
    assert idxs[1].tolist() == [[0, 0, 0]]


# -- the layer and the model against JAX ----------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_moe_sublayer_matches_jax(params, gate_log, mode):
    jp, tp = params
    jc, tc = _cfgs(mode)
    x = np.random.default_rng(3).standard_normal((2, 16, 64)).astype(np.float32)
    jl = jax.tree.map(lambda a: a[0], jp["layers"])
    tl = {k: v[0] for k, v in tp["layers"].items()}
    jo, ja = jmoe.moe_sublayer(jc, _j(x), jl)
    to, ta = tmoe.moe_sublayer(tc, _t(x), tl)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **LOGIT_TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **AUX_TOL)
    _assert_no_near_ties(gate_log)


@pytest.mark.parametrize("mode", MODES)
def test_forward_with_aux_matches_jax(params, gate_log, mode):
    jp, tp = params
    jc, tc = _cfgs(mode)
    tokens = _tokens(0, (2, 17))
    jl, ja = jmoe.forward_with_aux(jp, _j(tokens), jc)
    tl, ta = tmoe.forward_with_aux(tp, _t(tokens), tc)
    assert tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    np.testing.assert_allclose(ta.item(), float(ja), **AUX_TOL)
    np.testing.assert_allclose(tmodels.forward(tp, _t(tokens), tc).numpy(),
                               tl.numpy(), rtol=0, atol=0)
    _assert_no_near_ties(gate_log)


def _port_loss_and_grads(tp, tokens, cfg):
    leaves = [p.detach().requires_grad_(True) for p in ttr.tree_leaves(tp)]
    tree = ttr._unflatten(tp, iter(leaves))
    loss = tmodels.loss_fn(tree, _t(tokens), cfg)
    return loss, dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves))), tree


@pytest.mark.parametrize("remat", [None, "dots", "moe"])
@pytest.mark.parametrize("mode", MODES)
def test_loss_and_every_gradient_leaf_match_jax(params, gate_log, mode, remat):
    jp, _ = params
    jc, tc = _cfgs(mode)
    if remat is not None:
        jc, tc = _cfgs(mode, remat=True, remat_policy=remat)
    tokens = _tokens(1, (2, 17))
    lj, gj = jax.value_and_grad(jmoe.loss_fn)(jp, _j(tokens), jc)
    loss, grads, tree = _port_loss_and_grads(_bridge(jp), tokens, tc)
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-6)
    for path, g in jax.tree_util.tree_leaves_with_path(gj):
        got = grads[id(_leaf(tree, path))]
        assert got.dtype == _leaf(tree, path).dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    _assert_no_near_ties(gate_log)


@pytest.mark.parametrize("policy", ["moe", "dots"])
@pytest.mark.parametrize("mode", ["gather", "grouped"])
def test_remat_changes_no_gradient(params, mode, policy):
    """The port's own invariant, as tests/test_grouped_matmul.py holds
    JAX: remat "moe" and "dots" give the gradients of no remat."""
    _, tp = params
    tokens = _tokens(2, (2, 33))
    _, g0, _ = _port_loss_and_grads(tp, tokens, _cfgs(mode)[1])
    _, g1, _ = _port_loss_and_grads(
        tp, tokens, _cfgs(mode, remat=True, remat_policy=policy)[1])
    for a, b in zip(g0.values(), g1.values()):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, rtol=1e-6)


# -- the reference's grouped oracles, re-run against the port (bf16 moe-test) -

BF16 = tmoe.MOE_CONFIGS["moe-test"]


@pytest.fixture(scope="module")
def bf16_params():
    return _bridge(jmoe.init_params(jax.random.PRNGKey(0),
                                    jmoe.MOE_CONFIGS["moe-test"]))


def _oracle_tokens():
    """The reference test's own tokens."""
    return _t(np.array(jax.random.randint(jax.random.PRNGKey(7), (2, 33), 0,
                                          BF16.vocab_size)))


def test_grouped_matches_the_dropfree_einsum_oracle(bf16_params):
    oracle = replace(BF16, dispatch_mode="einsum",
                     capacity_factor=float(BF16.n_experts))
    grouped = replace(BF16, dispatch_mode="grouped")
    lo, ao = tmoe.forward_with_aux(bf16_params, _oracle_tokens(), oracle)
    lg, ag = tmoe.forward_with_aux(bf16_params, _oracle_tokens(), grouped)
    np.testing.assert_allclose(lg.numpy(), lo.numpy(), atol=3e-2, rtol=3e-2)
    np.testing.assert_allclose(ag.item(), ao.item(), atol=1e-5)
    _, go, _ = _port_loss_and_grads(bf16_params, _oracle_tokens(), oracle)
    _, gg, _ = _port_loss_and_grads(bf16_params, _oracle_tokens(), grouped)
    for a, b in zip(go.values(), gg.values()):
        np.testing.assert_allclose(b.float().numpy(), a.float().numpy(),
                                   atol=2e-3, rtol=2e-2)


def test_grouped_is_dropless(bf16_params):
    """Every token routed to expert 0 overflows any capacity: grouped still
    equals the no-drop oracle, while the capacity path visibly drops."""
    biased = {**bf16_params, "layers": dict(bf16_params["layers"])}
    router = torch.zeros_like(bf16_params["layers"]["w_router"])
    router[:, :, 0] = 5.0
    biased["layers"]["w_router"] = router
    tokens = _oracle_tokens()
    lg, _ = tmoe.forward_with_aux(biased, tokens,
                                  replace(BF16, dispatch_mode="grouped"))
    lo, _ = tmoe.forward_with_aux(biased, tokens, replace(
        BF16, dispatch_mode="einsum", capacity_factor=float(BF16.n_experts)))
    lc, _ = tmoe.forward_with_aux(biased, tokens, replace(
        BF16, dispatch_mode="gather", capacity_factor=1.0))
    np.testing.assert_allclose(lg.numpy(), lo.numpy(), atol=3e-2, rtol=3e-2)
    assert float((lc - lo).abs().max()) > 1e-3


# -- serving ----------------------------------------------------------------------

SERVE = ["moe-test", "moe-test-grouped"]


def _serve_cfgs(name):
    """f32 and capacity_factor 4.0 (no token dropped), as
    tests/test_decode.py serves MoE."""
    return (replace(jmoe.MOE_CONFIGS[name], dtype=jnp.float32,
                    capacity_factor=4.0),
            replace(tmoe.MOE_CONFIGS[name], dtype=torch.float32,
                    capacity_factor=4.0))


@pytest.mark.parametrize("lengths", [None, [5, 8]])
@pytest.mark.parametrize("name", SERVE)
def test_greedy_generate_token_identical_to_jax(params, gate_log, name,
                                                lengths):
    jp, tp = params
    jc, tc = _serve_cfgs(name)
    prompt = _tokens(5, (2, 8))
    lj = None if lengths is None else _j(np.array(lengths, np.int32))
    lt = None if lengths is None else _t(np.array(lengths, np.int32))
    ref = jdec.generate(jp, _j(prompt), jc, max_new_tokens=10,
                        prompt_lengths=lj)
    got = tdec.generate(tp, _t(prompt), tc, max_new_tokens=10,
                        prompt_lengths=lt)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(ref).tolist()
    _assert_no_near_ties(gate_log)


@pytest.mark.parametrize("name", SERVE)
def test_prefill_and_decode_logits_match_jax(params, gate_log, name):
    """Ragged prefill, then decode steps, each routing one token per row."""
    jp, tp = params
    jc, tc = _serve_cfgs(name)
    tokens, nxt = _tokens(2, (2, 12)), _tokens(3, (2, 4))
    lengths = np.array([7, 12], np.int32)
    jl, jcache = jdec.prefill(jp, _j(tokens), jc, max_seq=16,
                              lengths=_j(lengths))
    tl, tcache = tdec.prefill(tp, _t(tokens), tc, max_seq=16,
                              lengths=_t(lengths))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for t in range(4):
        jl, jcache = jdec.decode_step(jp, jcache, _j(nxt[:, t]), jc)
        tl, tcache = tdec.decode_step(tp, tcache, _t(nxt[:, t]), tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL,
                                   err_msg=f"step {t}")
    _assert_no_near_ties(gate_log)


# -- training ---------------------------------------------------------------------

@pytest.mark.parametrize("name", SERVE)
def test_three_steps_match_the_jax_trainer(gate_log, name):
    jc = replace(jmoe.MOE_CONFIGS[name], dtype=jnp.float32)
    tc = replace(tmoe.MOE_CONFIGS[name], dtype=torch.float32)
    train_cfg = jtr.TrainConfig(warmup_steps=2)
    js = jtr.init_state(jax.random.PRNGKey(0), jc, train_cfg)
    tp = _bridge(js["params"])
    ts = {"params": tp, "opt_state": ttr.make_optimizer(train_cfg).init(tp),
          "step": 0}
    step = jax.jit(functools.partial(jtr.train_step, cfg=jc, tc=train_cfg))
    rng = np.random.default_rng(5)
    for _ in range(3):
        b = rng.integers(0, tc.vocab_size, (2, 17)).astype(np.int32)
        js, lj = step(js, _j(b))
        ts, lt = ttr.train_step(ts, _t(b), tc, train_cfg)
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    assert ts["step"] == 3
    for path, leaf in jax.tree_util.tree_leaves_with_path(js["params"]):
        np.testing.assert_allclose(
            _leaf(ts["params"], path).numpy(), np.asarray(leaf), **PARAM_TOL,
            err_msg=jax.tree_util.keystr(path))
    assert ts["opt_state"]["mu"]["layers"]["w_router"].dtype == torch.float32
    _assert_no_near_ties(gate_log)


def test_train_job_runs_moe_on_the_cpu(capsys):
    out = tjob.main({"JOB_DEVICE": "cpu", "JOB_MODEL": "moe-test",
                     "JOB_BATCH": "2", "JOB_SEQ": "32", "JOB_STEPS": "10"})
    assert out["loss"] is not None and math.isfinite(out["loss"])
    assert out["tokens_per_s"] > 0
    assert "model=moe-test" in capsys.readouterr().err


# -- the server -------------------------------------------------------------------

SERVE_ENV = {"SERVE_MODEL": "moe-test", "SERVE_MAX_NEW": "8",
             "SERVE_DTYPE": "float32"}


def _jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX server's weights."""
    return _bridge(jmoe.init_params(jax.random.PRNGKey(0),
                                    jmoe.MOE_CONFIGS["moe-test"]))


def _ids(state):
    """Keep the token ids of each completion ``state`` renders."""
    seen, inner = [], state.decode_text

    def decode(ids):
        seen.append(list(ids))
        return inner(ids)

    state.decode_text = decode
    return seen


def test_server_complete_identical_to_jax(monkeypatch, gate_log):
    js = JState(dict(SERVE_ENV))
    js.warm()
    monkeypatch.setattr(tsjob, "init_params", _jax_weights)
    ts = tserver.ServingState(dict(SERVE_ENV, SERVE_DEVICE="cpu"))
    ts.warm()
    assert isinstance(ts.cfg, tmodels.MoEConfig)
    jids, tids = _ids(js), _ids(ts)
    for prompt in ["", "hello", "the quick brown fox"]:
        assert ts.complete(prompt) == js.complete(prompt)
    assert tids == jids and len(tids) == 3
    _assert_no_near_ties(gate_log)


# -- the kernel lane's launches, the kernels stood in for by plain versions --

@pytest.fixture()
def plain_kernels(monkeypatch):
    """Replace the five CUDA wrappers by their plain versions (counting
    launches as the wrappers do), so the kernel lane's control flow runs
    on the CPU: custom op, autograd functions, remat policy. Decode
    attention is counted only once it runs (decode), so a training run's
    counts keep their four keys."""
    counts = {"gmm": 0, "drhs": 0, "flash_fwd": 0, "flash_bwd": 0}

    def gmm(lhs, rhs, gs, trans_rhs=False):
        counts["gmm"] += 1
        rhs = rhs.transpose(1, 2) if trans_rhs else rhs
        return tgmm.grouped_matmul_reference(lhs, rhs, gs)

    def drhs(lhs, dout, gs):
        counts["drhs"] += 1
        return tgmm.gmm_drhs_reference(lhs, dout, gs, gs.shape[0], lhs.dtype)

    def fwd(q, k, v, causal, scale):
        counts["flash_fwd"] += 1
        return (tfa.attention_reference(q, k, v, causal, scale),
                tfa.logsumexp_reference(q, k, causal, scale))

    def bwd(q, k, v, o, lse, do, causal, scale):
        counts["flash_bwd"] += 1
        return tfa.attention_bwd_reference(q, k, v, o, lse, do, causal, scale)

    def dattn(q, k, v, limits, prompt_lengths=None, prompt_slots=None,
              table=None, k_scale=None, v_scale=None):
        counts["decode_attention"] = counts.get("decode_attention", 0) + 1
        return tda.decode_attention_reference(q, k, v, limits, prompt_lengths,
                                              prompt_slots, table, k_scale,
                                              v_scale)

    monkeypatch.setattr(tgmm, "gmm_cuda", gmm)
    monkeypatch.setattr(tda, "decode_attention_cuda", dattn)
    monkeypatch.setattr(tgmm, "gmm_drhs_cuda", drhs)
    monkeypatch.setattr(tfa, "flash_fwd_cuda", fwd)
    monkeypatch.setattr(tfa, "flash_bwd_cuda", bwd)
    return counts


# widths the kernel lane takes (K and N multiples of 128), two layers
LANE = tmoe.MoEConfig(
    vocab_size=256, d_model=128, n_layers=2, n_heads=2, n_kv_heads=1,
    d_ff=256, max_seq=128, n_experts=4, experts_per_token=2,
    dispatch_mode="grouped", dtype=torch.float32, remat=False)


@pytest.mark.parametrize("remat", [None, "dots", "moe"])
def test_kernel_lane_launches_per_layer_under_remat(plain_kernels, remat):
    """Per layer and step: 3 grouped products forward, 3 dlhs, and under
    remat the products recomputed in the backward: "moe" saves the w_down
    product (2 more, 8 in all, as under the reference's policy), "dots"
    saves none of the grouped products (3 more). drhs 3, flash 1 or 2
    forward and 1 backward. The gradients equal the plain lane's."""
    params = tmoe.init_params(LANE, torch.Generator().manual_seed(0), "cpu")
    tokens = _tokens(4, (2, 65))
    cfg = replace(LANE, use_kernel=True)
    if remat is not None:
        cfg = replace(cfg, remat=True, remat_policy=remat)
    _, gk, _ = _port_loss_and_grads(params, tokens, cfg)
    L = LANE.n_layers
    gmm = {None: 6, "moe": 8, "dots": 9}[remat]
    assert plain_kernels == {"gmm": gmm * L, "drhs": 3 * L,
                             "flash_fwd": (1 if remat is None else 2) * L,
                             "flash_bwd": L}
    _, gp, _ = _port_loss_and_grads(params, tokens,
                                    replace(cfg, use_kernel=False))
    for a, b in zip(gk.values(), gp.values()):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5, rtol=1e-5)


def test_kernel_lane_serving_launches(plain_kernels):
    """prefill: 3 grouped products and one flash forward a layer; each
    decode step 3 grouped products and one decode attention a layer."""
    params = tmoe.init_params(LANE, torch.Generator().manual_seed(1), "cpu")
    cfg = replace(LANE, use_kernel=True)
    prompt = _t(_tokens(5, (2, 16)))
    tdec.prefill(params, prompt, cfg)
    assert plain_kernels["gmm"] == 3 * LANE.n_layers
    assert plain_kernels["flash_fwd"] == LANE.n_layers
    out = tdec.generate(params, prompt, cfg, 4)
    assert plain_kernels["gmm"] == 3 * LANE.n_layers * (1 + 1 + 3)
    assert plain_kernels["drhs"] == plain_kernels["flash_bwd"] == 0
    assert plain_kernels["decode_attention"] == 3 * LANE.n_layers
    ref = tdec.generate(params, prompt, replace(cfg, use_kernel=False), 4)
    assert out.tolist() == ref.tolist()


def test_moe_test_widths_are_refused_by_the_kernel_lane(params):
    """K = d_model = 64 is below the kernel's multiple-of-128 rule, as on
    the TPU: moe-test-grouped runs on the CPU lane only."""
    _, tp = params
    cfg = replace(tmoe.MOE_CONFIGS["moe-test-grouped"], dtype=torch.float32,
                  use_kernel=True)
    x = torch.zeros(1, 4, 64)
    layer = {k: v[0] for k, v in tp["layers"].items()}
    with pytest.raises(ValueError, match="K = 64 must be a multiple of 128"):
        tmoe.moe_sublayer(cfg, x, layer)
