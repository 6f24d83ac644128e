"""The port's compiled programs on the CPU (``util/graphs.py``), where a
program is its eager body with the same keys and counts as on the card:
the in-place train step (``make_train_step``) against the out-of-place
``train_step`` and against optax, the in-place AdamW against the update as
it was written out of place, ``decode_segment`` from a device ``start``
and ``prefill`` into a caller's cache against JAX and against themselves,
the greedy serving lane against JAX's greedy tokens, and the program
cache's keys and capture counts."""

import gc
import weakref
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.train import trainer as jtr
from tpu_kubernetes_torch.models import CONFIGS
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.ops import adamw as tadamw
from tpu_kubernetes_torch.ops import norms as tnorms
from tpu_kubernetes_torch.serve import server as tserver
from tpu_kubernetes_torch.train import trainer as ttr
from tpu_kubernetes_torch.util import graphs as tgraphs

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
TC = ttr.TrainConfig(warmup_steps=2)
# float32 parameters after three AdamW steps, as tests/test_torch_train.py
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)


def _tokens(seed, shape, vocab=256):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def params():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


# -- the train step ----------------------------------------------------------

def _copy_state(state):
    return {"params": ttr.tree_map(torch.clone, state["params"]),
            "opt_state": {"count": state["opt_state"]["count"].clone(),
                          "mu": ttr.tree_map(torch.clone,
                                             state["opt_state"]["mu"]),
                          "nu": ttr.tree_map(torch.clone,
                                             state["opt_state"]["nu"])},
            "step": state["step"]}


@pytest.mark.parametrize("model,accum,grad_clip", [
    ("llama-test", 1, 1.0), ("llama-test", 2, 1.0), ("llama-test", 1, 0.05),
    ("moe-test", 1, 1.0), ("moe-test-grouped", 1, 1.0)])
def test_in_place_step_equals_train_step(model, accum, grad_clip):
    """make_train_step's body, run eagerly (the CPU's program), against
    train_step over three steps from one f32 state and the same batches:
    the same loss, gradients and update, in place instead of out of
    place, so the losses and every leaf of params, mu, nu and the count
    are equal bit for bit (the bias corrections' pow runs on the device
    in both)."""
    cfg = replace(CONFIGS[model], dtype=torch.float32)
    tc = replace(TC, accum_steps=accum, grad_clip=grad_clip)
    state = ttr.init_state(torch.Generator().manual_seed(0), cfg, tc, "cpu")
    ref = _copy_state(state)
    step = ttr.make_train_step(cfg, tc, state, (4, 33))
    rng = np.random.default_rng(3)
    for _ in range(3):
        batch = torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 33))
                                 .astype(np.int32))
        ref, want = ttr.train_step(ref, batch, cfg, tc)
        got = step(batch)
        assert torch.equal(got, want)
    assert state["step"] == ref["step"] == 3
    assert int(state["opt_state"]["count"]) == 3
    for tree in ("params",):
        for a, b in zip(ttr.tree_leaves(state[tree]),
                        ttr.tree_leaves(ref[tree])):
            assert torch.equal(a, b)
    for part in ("mu", "nu"):
        for a, b in zip(ttr.tree_leaves(state["opt_state"][part]),
                        ttr.tree_leaves(ref["opt_state"][part])):
            assert torch.equal(a, b)
    assert step.program.captures == 1 and step.program.replays == 2


def test_in_place_step_matches_optax_three_steps():
    """The job's step (make_train_step, in place) against optax from the
    same weights and batches: f32 parameters within PARAM_TOL, losses
    within 1e-6 relative (summation order and the bias corrections'
    pow)."""
    js = jtr.init_state(jax.random.PRNGKey(0), JCFG, TC)
    tp = params_from_numpy(jax.tree.map(np.asarray, js["params"]),
                           device="cpu")
    state = {"params": tp, "opt_state": ttr.make_optimizer(TC).init(tp),
             "step": 0}
    step = ttr.make_train_step(TCFG, TC, state, (4, 33))
    jstep = jax.jit(lambda s, b: jtr.train_step(s, b, JCFG, TC))
    rng = np.random.default_rng(3)
    for _ in range(3):
        b = rng.integers(0, 256, (4, 33)).astype(np.int32)
        js, lj = jstep(js, jnp.asarray(b))
        lt = step(torch.from_numpy(b))
        np.testing.assert_allclose(lt.item(), float(lj), rtol=1e-6)
    for path, leaf in jax.tree_util.tree_leaves_with_path(js["params"]):
        got = state["params"]
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got.numpy(), np.asarray(leaf),
                                   **PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_make_train_step_refuses_another_batch_shape():
    state = ttr.init_state(torch.Generator().manual_seed(0), TCFG, TC, "cpu")
    step = ttr.make_train_step(TCFG, TC, state, (2, 9))
    with pytest.raises(ValueError, match="not the step's"):
        step(torch.zeros((2, 10), dtype=torch.int32))
    with pytest.raises(ValueError, match="not divisible"):
        ttr.make_train_step(TCFG, replace(TC, accum_steps=2), state, (3, 9))


def _update_out_of_place(opt, grads, opt_state, params, scalars):
    """AdamW.update as the port wrote it before the update went in place:
    a new tensor for every leaf, its scalars handed in as host floats."""
    step_size, bc1, bc2 = (float(x) for x in scalars)
    g_leaves = ttr.tree_leaves(grads)
    norm = torch.sqrt(sum(torch.sum(g.float() * g.float())
                          for g in g_leaves))
    keep = norm < opt.grad_clip
    clip_by = {}
    new_p, new_mu, new_nu = [], [], []
    for g, mu, nu, p in zip(g_leaves, ttr.tree_leaves(opt_state["mu"]),
                            ttr.tree_leaves(opt_state["nu"]),
                            ttr.tree_leaves(params)):
        if p.dtype not in clip_by:
            clip_by[p.dtype] = (
                torch.where(keep, 1.0, norm.to(p.dtype).float()),
                torch.where(keep, 1.0, opt.grad_clip))
        div, mul = clip_by[p.dtype]
        g = g.float() / div * mul
        mu32 = (1 - opt.b1) * g + opt.b1 * mu.float()
        nu32 = (1 - opt.b2) * (g * g) + opt.b2 * nu.float()
        mu, nu = mu32.to(mu.dtype), nu32.to(nu.dtype)
        u = (mu32 / bc1) / (torch.sqrt(nu32 / bc2) + opt.eps)
        u = u + opt.weight_decay * p.float()
        lr = torch.tensor(step_size, dtype=p.dtype).item()
        new_p.append((p.float() + lr * u).to(p.dtype))
        new_mu.append(mu)
        new_nu.append(nu)
    return new_p, new_mu, new_nu


@pytest.mark.parametrize("grad_clip", [1e3, 1.0, 0.05])
def test_in_place_adamw_equals_the_out_of_place_update(grad_clip):
    """AdamW.update_ (the plain version, in place) against the out-of-place
    loop it replaces, given the same step scalars: three steps over a bf16
    and an f32 leaf (MoE's router), clipped and not, bit for bit."""
    opt = ttr.AdamW(learning_rate=1e-2, warmup_steps=2, b1=0.9, b2=0.95,
                    weight_decay=0.1, grad_clip=grad_clip)
    g = torch.Generator().manual_seed(4)
    params = {"w": torch.randn((64, 96), generator=g).to(torch.bfloat16),
              "layers": {"w_router": torch.randn((96, 8), generator=g)}}
    state = opt.init(params)
    ref_p = ttr.tree_leaves(params)
    ref_mu = ttr.tree_leaves(state["mu"])
    ref_nu = ttr.tree_leaves(state["nu"])
    params = ttr.tree_map(torch.clone, params)
    for _ in range(3):
        grads = ttr.tree_map(
            lambda p: (torch.randn(p.shape, generator=g) * 0.3).to(p.dtype),
            params)
        scalars = opt.scalars(state["count"])
        old_state = {"mu": ttr._unflatten(params, iter(ref_mu)),
                     "nu": ttr._unflatten(params, iter(ref_nu))}
        ref_p, ref_mu, ref_nu = _update_out_of_place(
            opt, grads, old_state, ttr._unflatten(params, iter(ref_p)),
            scalars)
        opt.update_(ttr.tree_leaves(grads), state, params)
        for got, want in ((ttr.tree_leaves(params), ref_p),
                          (ttr.tree_leaves(state["mu"]), ref_mu),
                          (ttr.tree_leaves(state["nu"]), ref_nu)):
            for a, b in zip(got, want):
                assert a.dtype == b.dtype and torch.equal(a, b)
    assert int(state["count"]) == 3


def test_step_scalars_are_optax_f32():
    """The step size and bias corrections, computed on the count's device:
    the schedule bit for bit with numpy's f32 arithmetic, each bias
    correction within 1e-6 relative of numpy's f32 pow."""
    opt = ttr.make_optimizer(TC)
    f32 = np.float32
    for count in (0, 1, 2, 5):
        s = opt.scalars(torch.tensor(count, dtype=torch.int32))
        assert s.dtype == torch.float32 and s.shape == (3,)
        assert s[0].item() == -opt.schedule(count).item()
        for got, b in ((s[1], opt.b1), (s[2], opt.b2)):
            want = f32(1) - f32(b) ** f32(count + 1)
            assert got.item() == pytest.approx(float(want), rel=1e-6)


# -- decode ------------------------------------------------------------------

@pytest.mark.parametrize("ragged", [False, True])
def test_prefill_into_a_callers_cache_equals_its_own(params, ragged):
    """A dirty caller-owned cache of the same span comes back holding what
    a fresh one holds (zeros past the prompt included), and the logits
    are the same."""
    _, tp = params
    tokens = torch.from_numpy(_tokens(1, (3, 16)))
    lengths = torch.tensor([16, 5, 11], dtype=torch.int32) if ragged \
        else None
    want_logits, want = tdec.prefill(tp, tokens, TCFG, max_seq=24,
                                     lengths=lengths)
    mine = tdec.init_cache(TCFG, 3, 24, device="cpu")
    mine.k.normal_()
    mine.v.normal_()
    logits, got = tdec.prefill(tp, tokens, TCFG, max_seq=24, lengths=lengths,
                               cache=mine)
    assert got.k is mine.k and got.v is mine.v
    assert torch.equal(logits, want_logits)
    assert torch.equal(got.k, want.k) and torch.equal(got.v, want.v)
    assert got.length == want.length == 16
    assert got.prompt_slots == want.prompt_slots
    with pytest.raises(ValueError, match="do not hold"):
        tdec.prefill(tp, tokens, TCFG, max_seq=20, cache=mine)


@pytest.mark.parametrize("ragged", [False, True])
def test_decode_segment_from_a_device_start_equals_jax(params, ragged):
    """Segments from an explicit 0-d ``start`` tensor (a captured
    program's input) against JAX's segments and the default ``start``:
    the same tokens and the same cache."""
    jp, tp = params
    prompt = _tokens(7, (2, 16))
    lengths = np.array([7, 16], np.int32) if ragged else None
    span = 28
    jl, jc = jdec.prefill(jp, jnp.asarray(prompt), JCFG, max_seq=span,
                          lengths=None if lengths is None
                          else jnp.asarray(lengths))
    caches = [tdec.prefill(tp, torch.from_numpy(prompt), TCFG, max_seq=span,
                           lengths=None if lengths is None
                           else torch.from_numpy(lengths))
              for _ in range(2)]
    jtok = jnp.argmax(jl, axis=-1).astype(jnp.int32)
    toks = [torch.argmax(lg, dim=-1).to(torch.int32) for lg, _ in caches]
    caches = [c for _, c in caches]
    done = [torch.zeros(2, dtype=torch.bool)] * 2
    start = torch.zeros((), dtype=torch.int64)
    for steps in (4, 4, 3):
        jt, jtok, _, jc = jdec.decode_segment(
            jp, jc, jtok, jnp.zeros((2,), bool), JCFG, steps)
        start.fill_(caches[0].length)
        a, toks[0], done[0], caches[0] = tdec.decode_segment(
            tp, caches[0], toks[0], done[0], TCFG, steps, start=start)
        b, toks[1], done[1], caches[1] = tdec.decode_segment(
            tp, caches[1], toks[1], done[1], TCFG, steps)
        assert a.tolist() == b.tolist() == np.asarray(jt).tolist()
    assert caches[0].length == caches[1].length == 27
    assert torch.equal(caches[0].k, caches[1].k)
    np.testing.assert_allclose(caches[0].k.numpy(), np.asarray(jc.k),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("lengths", [None, [5, 8]])
def test_greedy_lane_equals_jax_generate(params, lengths):
    """The serving lane's programs (prefill into its own cache, segments
    of 3 steps and a tail of 2) give JAX's greedy tokens, uniform and
    ragged."""
    jp, tp = params
    prompt = _tokens(5, (2, 8))
    lj = None if lengths is None else jnp.asarray(np.array(lengths, np.int32))
    ref = jdec.generate(jp, jnp.asarray(prompt), JCFG, max_new_tokens=9,
                        cache_span=17, prompt_lengths=lj)
    lane = tserver.GreedyLane(tp, TCFG)
    lt = torch.tensor(lengths or [8, 8], dtype=torch.int32)
    got, steps_run = lane.run(torch.from_numpy(prompt), lt, [9, 9], 9, 3)
    assert steps_run == 8
    assert got == np.asarray(ref).tolist()
    assert lane.programs.captures == {("prefill", 2, 8, 17): 1,
                                      ("decode", 2, 8, 17, 3): 1,
                                      ("decode", 2, 8, 17, 2): 1}
    assert lane.programs.replays == {("decode", 2, 8, 17, 3): 1}


# -- the program cache -------------------------------------------------------

def _server(**extra):
    env = {"SERVE_MODEL": "llama-test", "SERVE_DEVICE": "cpu",
           "SERVE_MAX_NEW": "8", "SERVE_EARLY_EXIT_STEPS": "4", **extra}
    return tserver.ServingState(env)


def test_server_builds_each_key_once():
    """Repeated requests of one bucket replay the keys the first one
    built; a budget whose decode ends in a shorter segment adds that tail
    as a key of its own."""
    st = _server()
    st.warm()                       # the default request: width 16, 8 new
    keys = dict(st.greedy.programs.captures)
    # warm()'s streamed request adds the sampled lane's greedy step
    assert keys == {("prefill", 1, 16, 24): 1, ("decode", 1, 16, 24, 4): 1,
                    ("decode", 1, 16, 24, 3): 1,
                    ("step", 1, 16, 24, "greedy"): 1}
    first = st.complete("hello", max_new_tokens=8)
    again = st.complete("hello", max_new_tokens=8)
    assert first == again
    assert st.greedy.programs.captures == keys
    # warm()'s streamed request prefills through the lane's program too,
    # then runs 7 steps (a capture and 6 replays) for its 8 tokens
    assert st.greedy.programs.replays == {("prefill", 1, 16, 24): 3,
                                          ("decode", 1, 16, 24, 4): 2,
                                          ("decode", 1, 16, 24, 3): 2,
                                          ("step", 1, 16, 24, "greedy"): 6}
    st.complete("hello", max_new_tokens=2)    # run_max_new 8 → the same keys
    assert st.greedy.programs.captures == keys
    st.complete("x" * 20, max_new_tokens=3)   # width 32: a new bucket
    assert ("prefill", 1, 32, 40) in st.greedy.programs.captures
    assert all(n == 1 for n in st.greedy.programs.captures.values())


def test_a_key_is_captured_once():
    """A key's body is built once and its program captures at its first
    call only; the counts read by key."""
    cache = tgraphs.Programs("cpu")
    runs, builds = [], []

    def build():
        builds.append(1)
        return lambda: runs.append(1)

    prog = cache.get("k", build)
    assert cache.get("k", build) is prog
    assert cache.captures == {} and cache.replays == {}
    for _ in range(3):
        prog()
    assert runs == [1, 1, 1] and builds == [1]
    assert prog.captures == 1 and prog.replays == 2
    assert cache.captures == {"k": 1} and cache.replays == {"k": 2}


def test_a_dropped_lane_frees_its_programs_without_the_collector(params):
    """No program holds a reference back to its owner: with the garbage
    collector off, dropping a lane or a train step frees its programs at
    once (on the card, their graphs), so no collection can destroy a
    graph later, in the middle of another capture."""
    lane = tserver.GreedyLane(params[1], TCFG, eos_id=3)
    lane.run(torch.ones((2, 8), dtype=torch.int32),
             torch.tensor([8, 5], dtype=torch.int32), [5, 5], 5, 3)
    state = ttr.init_state(torch.Generator().manual_seed(0), TCFG, TC, "cpu")
    step = ttr.make_train_step(TCFG, TC, state, (2, 9))
    step(torch.ones((2, 9), dtype=torch.int32))
    refs = [weakref.ref(p) for p in (*lane.programs._programs.values(),
                                     step.program)]
    assert len(refs) == 4
    collecting = gc.isenabled()
    gc.disable()
    try:
        del lane, step
        assert [r() for r in refs] == [None] * 4
    finally:
        if collecting:
            gc.enable()


def test_device_launches_take_out_captures_and_add_replays():
    tgraphs.reset_launches()
    try:
        tgraphs._add(tgraphs.CAPTURED, {"gmm": 3})
        tgraphs._add(tgraphs.REPLAYED, {"gmm": 3})
        tgraphs._add(tgraphs.REPLAYED, {"gmm": 3})
        assert tgraphs.device_launches({"gmm": 6, "flash_fwd": 2}) == {
            "gmm": 9, "flash_fwd": 2}
    finally:
        tgraphs.reset_launches()


def test_rope_tables_are_built_once_and_equal_the_frequencies():
    a = tnorms.rope_tables(16, 128, 10000.0, "cpu")
    b = tnorms.rope_tables(16, 128, 10000.0, torch.device("cpu"))
    assert a[0] is b[0] and a[1] is b[1]
    ref = tnorms.rope_frequencies(16, 128, 10000.0, "cpu")
    assert torch.equal(a[0], ref[0]) and torch.equal(a[1], ref[1])


def test_the_plain_adamw_is_what_cpu_leaves_take():
    """adamw_ on CPU leaves: the plain norm and update, no launch."""
    before = (tadamw.global_norm_cuda.launches,
              tadamw.adamw_update_cuda_.launches)
    leaves = [torch.ones(8), torch.ones(4, dtype=torch.bfloat16)]
    p = [torch.zeros(8), torch.zeros(4, dtype=torch.bfloat16)]
    mu = [torch.zeros_like(x) for x in p]
    nu = [torch.zeros_like(x) for x in p]
    h = tadamw.Hyper(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.0,
                     grad_clip=1.0)
    norm = tadamw.adamw_(leaves, p, mu, nu,
                         torch.tensor([-0.1, 0.1, 0.05]), h)
    assert norm.item() == pytest.approx(np.sqrt(12.0))
    assert (tadamw.global_norm_cuda.launches,
            tadamw.adamw_update_cuda_.launches) == before
    assert all(bool((x < 0).all()) for x in p)
