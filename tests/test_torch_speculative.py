"""The port's speculative decoding (``models/speculative.py``) against the
JAX package's (``tests/test_speculative.py`` re-run against the port,
``test_draft_kv_quant_still_exact`` and its int8 draft cache included).

The load-bearing property: greedy speculative output is EXACTLY the
target's own greedy decode, whatever the draft proposes. Here the oracle
is the JAX package's ``generate`` at the reference's speculative span
(``prompt + new + draft_k``; the port pads the prompt to its width bucket
first), run on the same float32 ``llama-test`` weights (carried over by
``models.from_jax``), so each case holds the port's tokens to the
reference's. The rounds run
as compiled programs (``util/graphs.py``: their eager bodies on the CPU);
the n-gram matchers, on the device and on the host, are held to JAX's on
the same contexts."""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.models import speculative as jspec
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import forward as tforward
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models import speculative as tspec
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.util.graphs import Programs

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
MAX_NEW = 12


def _port(jp):
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


@pytest.fixture(scope="module")
def params():
    """(JAX target params, the same weights as port tensors)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return jp, _port(jp)


@pytest.fixture(scope="module")
def prompt():
    """(1, 7) int32 numpy, JAX's seed-9 draw."""
    return np.asarray(jax.random.randint(jax.random.PRNGKey(9), (1, 7), 0,
                                         JCFG.vocab_size), np.int32)


@pytest.fixture(scope="module")
def oracle_at(params, prompt):
    """JAX's greedy generate at the speculative span → numpy (1, new)."""
    jp = params[0]

    def _oracle(draft_k, max_new=MAX_NEW, p=None):
        p = prompt if p is None else p
        return np.asarray(jdec.generate(
            jp, jnp.asarray(p), JCFG, max_new_tokens=max_new,
            cache_span=p.shape[1] + max_new + draft_k))

    return _oracle


def _t(a):
    return torch.from_numpy(np.array(a))


def test_chunk_decode_matches_sequential_steps(params, prompt):
    """decode_chunk(c tokens) == c sequential decode_steps (same cache
    shapes), and both equal JAX's decode_chunk within 1e-4: the
    verification primitive must be exact."""
    jp, tp = params
    logits, cache = tdec.prefill(tp, _t(prompt), TCFG, max_seq=32)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    chunk, seq_logits = [tok], []
    c_step = cache
    for _ in range(3):
        lg, c_step = tdec.decode_step(tp, c_step, chunk[-1], TCFG)
        seq_logits.append(lg)
        chunk.append(torch.argmax(lg, dim=-1).to(torch.int32))
    _, cache = tdec.prefill(tp, _t(prompt), TCFG, max_seq=32)
    tokens = torch.stack(chunk[:3], dim=1)
    chunk_logits, c_chunk = tdec.decode_chunk(tp, cache, tokens, TCFG)
    torch.testing.assert_close(chunk_logits, torch.stack(seq_logits, dim=1),
                               atol=2e-2, rtol=2e-2)
    assert c_chunk.length == c_step.length
    _, jc = jdec.prefill(jp, jnp.asarray(prompt), JCFG, max_seq=32)
    jl, _ = jdec.decode_chunk(jp, jc, jnp.asarray(tokens.numpy()), JCFG)
    np.testing.assert_allclose(chunk_logits.numpy(), np.asarray(jl),
                               atol=1e-4, rtol=1e-4)


def test_perfect_draft_exact_and_fast(params, prompt, oracle_at):
    """Draft == target: every proposal accepted, so each round emits
    draft_k + 1 tokens and the output is the oracle exactly; the stats
    count what the reference's do (rounds emit 4, 4, 3: accepted 9)."""
    tp = params[1]
    out, stats = tspec.speculative_generate(tp, tp, _t(prompt), TCFG, TCFG,
                                            MAX_NEW, draft_k=3)
    np.testing.assert_array_equal(out.numpy(), oracle_at(3))
    rounds = stats.rounds
    rem = (MAX_NEW - 1) % 4
    assert stats.accepted == MAX_NEW - 1 - rounds + (1 if rem else 0)
    assert stats.accepted <= stats.drafted
    assert rounds == -(-(MAX_NEW - 1) // 4)


def test_random_draft_still_exact(params, prompt, oracle_at):
    """A draft that knows nothing of the target (JAX's seed-123 init) may
    be rejected constantly; the output must not change."""
    draft = _port(jllama.init_params(jax.random.PRNGKey(123), JCFG))
    out, stats = tspec.speculative_generate(params[1], draft, _t(prompt),
                                            TCFG, TCFG, MAX_NEW, draft_k=4)
    np.testing.assert_array_equal(out.numpy(), oracle_at(4))
    assert stats.rounds <= MAX_NEW


def test_smaller_draft_config_exact(params, prompt, oracle_at):
    """The draft can be another architecture (fewer layers, narrower MLP):
    exactness is a property of the acceptance rule."""
    jd = replace(JCFG, n_layers=1, d_ff=64)
    draft = _port(jllama.init_params(jax.random.PRNGKey(5), jd))
    out, _ = tspec.speculative_generate(
        params[1], draft, _t(prompt), TCFG,
        replace(TCFG, n_layers=1, d_ff=64), MAX_NEW, draft_k=2)
    np.testing.assert_array_equal(out.numpy(), oracle_at(2))


def test_programs_shared_across_calls(params, prompt, oracle_at):
    """One Programs cache across calls (the jitted function's
    counterpart): the same tokens each call, each key built once, the
    second call all replays."""
    tp = params[1]
    programs = Programs("cpu")
    outs = [tspec.speculative_generate(tp, tp, _t(prompt), TCFG, TCFG,
                                       MAX_NEW, draft_k=3,
                                       programs=programs)[0]
            for _ in range(2)]
    for out in outs:
        np.testing.assert_array_equal(out.numpy(), oracle_at(3))
    # the 7-token prompt's width bucket 16, its span 16 + new + draft_k
    key = ("draft", 16, 16 + MAX_NEW + 3, 3)
    assert programs.captures == {("spec_prefill",) + key: 1,
                                 ("spec_round",) + key: 1}
    assert programs.replays == {("spec_prefill",) + key: 1,
                                ("spec_round",) + key: 2 * 3 - 1}


def test_many_prompt_lengths_share_a_bucket_s_programs_and_caches(
        params, oracle_at):
    """Prompts of eight lengths through one Programs (a job's): one
    prefill and one round program a width bucket (16, 32, 64), each
    captured once, and one set of caches a bucket, whatever the number of
    lengths; every output the reference's greedy tokens."""
    tp = params[1]
    programs = Programs("cpu")
    rng = np.random.default_rng(3)
    for plen in (1, 5, 9, 16, 17, 23, 31, 40):
        p = rng.integers(0, JCFG.vocab_size, (1, plen), dtype=np.int32)
        out, _ = tspec.prompt_lookup_generate(tp, _t(p), TCFG, MAX_NEW,
                                              draft_k=4, programs=programs)
        np.testing.assert_array_equal(out.numpy(), oracle_at(4, p=p))
    widths = (16, 32, 64)
    assert programs.captures == {
        (name, "lookup2", w, w + MAX_NEW + 4, 4): 1
        for w in widths for name in ("spec_prefill", "spec_round")}
    runs = {id(prog.body.run) for key, prog in programs._programs.items()
            if key[0] == "spec_prefill"}
    assert len(runs) == len(widths)


def test_single_new_token(params, prompt, oracle_at):
    tp = params[1]
    out, stats = tspec.speculative_generate(tp, tp, _t(prompt), TCFG, TCFG,
                                            1, draft_k=2)
    np.testing.assert_array_equal(out.numpy(), oracle_at(2, max_new=1))
    assert stats.rounds == 0


class TestNgramMatcher:
    """The device matcher on the reference's contexts, against JAX's
    ``_ngram_propose`` (a broken matcher only degrades to the fallback in
    the exactness loop, so the proposals are pinned here)."""

    def _propose(self, ctx, valid, n, k, last=99):
        want = np.asarray(jspec._ngram_propose(
            jnp.asarray(ctx, jnp.int32), jnp.asarray(valid, jnp.int32), n,
            k, jnp.asarray(last, jnp.int32)))
        got = tspec._ngram_propose(torch.tensor(ctx, dtype=torch.int32),
                                   torch.tensor(valid), n, k,
                                   torch.tensor(last, dtype=torch.int32))
        np.testing.assert_array_equal(got.numpy(), want)
        return got.numpy()

    def test_matches_continuation(self):
        ctx = [1, 2, 3, 7, 8, 1, 2, 0, 0, 0]
        np.testing.assert_array_equal(
            self._propose(ctx, valid=7, n=2, k=2), [3, 7])

    def test_latest_match_wins(self):
        ctx = [1, 2, 3, 1, 2, 4, 1, 2, 0, 0]
        np.testing.assert_array_equal(
            self._propose(ctx, valid=8, n=2, k=1), [4])

    def test_no_match_falls_back_to_last(self):
        ctx = [1, 2, 3, 4, 5, 6, 0, 0]
        np.testing.assert_array_equal(
            self._propose(ctx, valid=6, n=2, k=3, last=42), [42, 42, 42])

    def test_unseen_context_is_invisible(self):
        ctx = [9, 9, 1, 2, 3, 9, 9, 9, 9, 0]
        np.testing.assert_array_equal(
            self._propose(ctx, valid=5, n=2, k=2, last=7), [7, 7])

    @pytest.mark.parametrize("seed", range(6))
    def test_random_contexts_match_jax_and_the_host_matcher(self, seed):
        """Short contexts over a 4-token alphabet (repeats everywhere):
        the device matcher equals JAX's, and the host matcher over the
        seen tokens equals both."""
        rng = np.random.default_rng(seed)
        n, k = int(rng.integers(1, 4)), int(rng.integers(1, 6))
        valid = int(rng.integers(n + 1, 20))
        ctx = rng.integers(0, 4, valid + k).tolist()
        got = self._propose(ctx, valid, n, k, last=11)
        assert tspec.ngram_propose_host(ctx[:valid], n, k, 11) == \
            got.tolist() == jspec.ngram_propose_host(ctx[:valid], n, k, 11)


class TestPromptLookup:
    """Draft-model-free n-gram drafting: the same exactness guarantee."""

    def test_exact_vs_oracle(self, params, prompt, oracle_at):
        out, stats = tspec.prompt_lookup_generate(params[1], _t(prompt),
                                                  TCFG, MAX_NEW, draft_k=5,
                                                  ngram=2)
        np.testing.assert_array_equal(out.numpy(), oracle_at(5))
        assert stats.rounds <= MAX_NEW

    def test_repetitive_prompt_accepts(self, params, oracle_at):
        """A periodic prompt makes the n-gram continuation a plausible
        proposal; whatever is accepted, the output equals plain greedy,
        and the stats equal JAX's prompt_lookup_generate's."""
        jp, tp = params
        pat = np.asarray([[5, 9, 11, 5, 9, 11, 5, 9, 11, 5, 9]], np.int32)
        out, stats = tspec.prompt_lookup_generate(tp, _t(pat), TCFG, 10,
                                                  draft_k=4, ngram=2)
        np.testing.assert_array_equal(out.numpy(),
                                      oracle_at(4, max_new=10, p=pat))
        _, jstats = jspec.prompt_lookup_generate(jp, jnp.asarray(pat), JCFG,
                                                 10, draft_k=4, ngram=2)
        assert tuple(stats) == tuple(int(x) for x in jstats)

    def test_short_prompt_no_match_fallback(self, params):
        """ngram > prompt length exercises the no-match fallback. This
        seed and prompt hit a genuine logit tie in the reference, so, as
        there, every emitted token must be the argmax under teacher
        forcing within 5e-2."""
        tp = params[1]
        tiny = torch.tensor([[3]], dtype=torch.int32)
        out, _ = tspec.prompt_lookup_generate(tp, tiny, TCFG, 6, draft_k=3,
                                              ngram=3)
        seq = torch.cat([tiny, out], dim=1)
        logits = tforward(tp, seq[:, :-1], TCFG)[0].numpy()
        preds = logits[tiny.shape[1] - 1:]
        chosen = np.take_along_axis(preds, out.numpy()[0][:, None],
                                    axis=1)[:, 0]
        assert (preds.max(axis=1) - chosen <= 5e-2).all()

    def test_programs_shared_across_calls(self, params, prompt, oracle_at):
        programs = Programs("cpu")
        for _ in range(2):
            out, _ = tspec.prompt_lookup_generate(
                params[1], _t(prompt), TCFG, MAX_NEW, draft_k=4, ngram=2,
                programs=programs)
            np.testing.assert_array_equal(out.numpy(), oracle_at(4))
        assert set(programs.captures.values()) == {1}

    def test_oversized_ngram_rejected(self, params):
        tiny = torch.tensor([[3, 4]], dtype=torch.int32)
        with pytest.raises(ValueError, match="ngram"):
            tspec.prompt_lookup_generate(params[1], tiny, TCFG, 2,
                                         draft_k=2, ngram=10)


def test_batch_gt1_rejected(params):
    two = torch.zeros((2, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="batch-1"):
        tspec.speculative_generate(params[1], params[1], two, TCFG, TCFG, 4)


def test_moe_target_rejected():
    from tpu_kubernetes_torch.models import moe as tmoe

    cfg = tmoe.MOE_CONFIGS["moe-test"]
    with pytest.raises(ValueError, match="dense target"):
        tspec._check_target(cfg, torch.zeros((1, 4), dtype=torch.int32))


def test_draft_kv_quant_still_exact(params, prompt, oracle_at):
    """An int8 KV cache on the DRAFT (JAX's seed-123 draft) changes its
    proposals but never the output: the tokens are the oracle's, and the
    draft's cache really is int8 (its programs' run holds int8 K/V)."""
    draft = _port(jllama.init_params(jax.random.PRNGKey(123), JCFG))
    programs = Programs("cpu")
    out, stats = tspec.speculative_generate(
        params[1], draft, _t(prompt), TCFG, TCFG, MAX_NEW, draft_k=4,
        draft_kv_quant=True, programs=programs)
    np.testing.assert_array_equal(out.numpy(), oracle_at(4))
    assert stats.rounds <= MAX_NEW
    (key,) = [k for k in programs.captures if k[0] == "spec_prefill"]
    assert key[1] == "draft_kvq"
    run = programs.get(key, None).body.run
    assert run.cache_d.k.dtype == torch.int8
    assert run.cache_d.k_scale is not None and run.cache_t.k_scale is None


def test_window_past_the_chunk_route_and_int8_draft_refused(params, prompt):
    """draft_k + 1 past MAX_CHUNK (the decode-attention kernel's chunk
    route) is refused by name, with an int8 draft cache as without one."""
    tp = params[1]
    with pytest.raises(ValueError, match="MAX_CHUNK = 16"):
        tspec.prompt_lookup_generate(tp, _t(prompt), TCFG, 4, draft_k=16)
    with pytest.raises(ValueError, match="MAX_CHUNK = 16"):
        tspec.speculative_generate(tp, tp, _t(prompt), TCFG, TCFG, 4,
                                   draft_k=16, draft_kv_quant=True)


class TestNgramProposeHost:
    """The host proposer's edge cases (the reference's, in
    ``tests/test_decode.py``), against the reference's own function."""

    @pytest.mark.parametrize("ctx, n, k, last, want", [
        ([1, 2, 3, 1, 2, 4, 1, 2], 2, 2, 99, [4, 1]),
        ([], 2, 3, 7, [7, 7, 7]),
        ([5, 5, 5, 5], 1, 6, 8, [5, 8, 8, 8, 8, 8]),
        ([3], 3, 2, 4, [4, 4]),
        ([2, 3, 2, 3], 2, 3, 6, [2, 3, 6]),
    ])
    def test_edge_cases(self, ctx, n, k, last, want):
        assert tspec.ngram_propose_host(ctx, n, k, last) == want
        assert jspec.ngram_propose_host(ctx, n, k, last) == want

    def test_rejects_bad_args(self):
        with pytest.raises(ValueError, match="ngram"):
            tspec.ngram_propose_host([1, 2, 3], 0, 2, 9)
        with pytest.raises(ValueError, match="draft_k"):
            tspec.ngram_propose_host([1, 2, 3], 2, 0, 9)
