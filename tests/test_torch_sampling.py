"""The port's sampler and its sampled programs against the JAX package on
the CPU.

The sampler is split in two (``models/decode.py``): ``filter_logits``
(temperature, top-k, nucleus) and a Gumbel-max ``draw``. Since
``jax.random.categorical`` is ``argmax(gumbel(key, shape) + logits)``,
the port handed JAX's own noise must pick JAX's token: over a grid of
temperature × top_k × top_p on random (4, 256) and (2, 32000) logits it
does, exactly. JAX's filtered logits are read from its own ``_sample``
(``jax.random.categorical`` spied on), and the kept sets are equal.

XLA and torch may round a softmax and a cumsum differently, so a token
whose exclusive prefix mass lies within 1e-6 of ``top_p`` can be kept on
one side only. The logits are drawn so that no row has such a token for
top_p < 1 (a row that has one is drawn again from the next seed). At
top_p = 1 no row avoids it: the f32 prefix sums of the far tail sit at
1 within their own rounding, which over V terms is up to V·2⁻²⁴ (2e-3 at
V = 32,000) and decides on each side whether ``mass < 1`` holds. There
the tokens whose exclusive mass lies within V·2⁻²⁴ of 1, and only those,
are left out of the kept-set comparison (the token test keeps them all).

Then the programs (``serve/server.py`` ``SampledLane``) with
``graphs=False`` on the CPU: the same bodies under the same keys as on
the card, each key captured once; a seeded request's tokens equal
``generate``'s eager loop, streamed or not; one key serves two
temperatures. The graphed draws are held to the eager ones on the card
(``tests/test_torch_kernel_cuda.py``, ``chip_smoke.py``)."""

import itertools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import decode as jdec
from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob
from tpu_kubernetes_torch.serve import server as tserver

SHAPES = [(4, 256), (2, 32000)]
TEMPERATURES = [0.5, 1.0, 2.0]      # powers of two: both divide exactly
TOP_KS = [0, 1, 5]
TOP_PS = [0.0, 0.5, 0.9, 1.0]
GRID = list(itertools.product(SHAPES, TEMPERATURES, TOP_KS, TOP_PS))
# where XLA's and torch's softmax + cumsum may round a token to the other
# side of a top_p < 1; at top_p = 1 the bound of a V-term f32 prefix sum
NUCLEUS_MARGIN = 1e-6


def _case_id(case):
    (b, v), t, k, p = case
    return f"{b}x{v}-t{t}-k{k}-p{p}"


def _exclusive_mass(row: np.ndarray, t: float, k: int) -> np.ndarray:
    """Each token's exclusive prefix mass in float64, after the
    temperature and the top-k mask, in the row's token order; NaN for a
    token the top-k mask removes (on both sides, whatever the nucleus)."""
    x = row.astype(np.float64) / t
    if k:
        x = np.where(x < np.sort(x)[-k], -np.inf, x)
    order = np.argsort(-x, kind="stable")
    p = np.exp(x[order] - x[order[0]])
    p /= p.sum()
    mass = np.empty_like(p)
    mass[order] = np.cumsum(p) - p
    return np.where(np.isinf(x), np.nan, mass)


def _near_top_p(row, t, k, p) -> np.ndarray:
    """The tokens the two frameworks may keep differently."""
    if not p:
        return np.zeros(row.shape, bool)
    margin = NUCLEUS_MARGIN if p < 1.0 else row.size * 2.0 ** -24
    return np.abs(_exclusive_mass(row, t, k) - p) <= margin


def _logits(case) -> np.ndarray:
    """Random f32 logits of the case's shape from a seed; below top_p = 1
    a row with a token within the margin of top_p is drawn again."""
    (b, v), t, k, p = case
    seed = GRID.index(case) * 1000
    rows = []
    for _ in range(b):
        while True:
            row = np.random.default_rng(seed).normal(
                0.0, 2.0, v).astype(np.float32)
            seed += 1
            if p >= 1.0 or not _near_top_p(row, t, k, p).any():
                break
        rows.append(row)
    return np.stack(rows)


def _jax_filtered(logits, t, k, p) -> np.ndarray:
    """The logits JAX's own ``_sample`` hands ``jax.random.categorical``."""
    seen = {}

    def spy(key, lg, axis=-1):
        seen["logits"] = np.asarray(lg)
        return jnp.argmax(lg, axis=axis)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "categorical", spy)
        jdec._sample(jnp.asarray(logits), jax.random.PRNGKey(0), t, k, p)
    return seen["logits"]


@pytest.mark.parametrize("case", GRID, ids=_case_id)
def test_draw_with_jax_noise_picks_jax_token(case):
    """Exact: the filter and the Gumbel-max draw, given
    ``jax.random.gumbel(key, shape)``, pick ``jax.random.categorical``'s
    token in every row."""
    _, t, k, p = case
    logits = _logits(case)
    key = jax.random.PRNGKey(GRID.index(case))
    want = np.asarray(jdec._sample(jnp.asarray(logits), key, t, k, p))
    noise = np.array(jax.random.gumbel(key, logits.shape))
    got = tdec.draw(tdec.filter_logits(torch.from_numpy(logits), t, k, p),
                    noise=torch.from_numpy(noise))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", GRID, ids=_case_id)
def test_filter_keeps_jax_set(case):
    """The kept tokens equal JAX's (outside the margin of top_p, see the
    module docstring), the kept values are JAX's scaled logits bit for
    bit, and the program form (the knobs as one device tensor under a
    variant) filters exactly as the number form."""
    _, t, k, p = case
    logits = _logits(case)
    want = _jax_filtered(logits, t, k, p)
    got = tdec.filter_logits(torch.from_numpy(logits), t, k, p).numpy()
    judged = ~np.stack([_near_top_p(r, t, k, p) for r in logits])
    kept_j, kept_t = want > -1e29, got > -1e29
    np.testing.assert_array_equal(kept_t[judged], kept_j[judged])
    both = kept_j & kept_t
    np.testing.assert_array_equal(got[both], want[both])
    assert kept_t.any(axis=1).all()      # the best token always stays

    knobs = tdec.sampling_knobs(t, k, p)
    variant = tdec.sampling_variant(t, k, p)
    program_form = tdec.filter_logits(
        torch.from_numpy(logits), knobs[0],
        knobs[1] if "+top_k" in variant else 0,
        knobs[2] if "+top_p" in variant else 0.0)
    np.testing.assert_array_equal(program_form.numpy(), got)


@pytest.mark.parametrize("knobs, variant", [
    ((0.0, 0, 0.0), "greedy"), ((0.0, 5, 0.9), "greedy"),
    ((0.7, 0, 0.0), "sample"), ((0.7, 40, 0.0), "sample+top_k"),
    ((0.7, 0, 0.95), "sample+top_p"), ((1.3, 3, 0.5), "sample+top_k+top_p"),
    ((1.0, -2, -0.5), "sample"),
])
def test_variant_names_the_parts_that_run(knobs, variant):
    """Temperature 0 is greedy whatever the filters (the reference's
    ``_sample``); a filter is on above 0."""
    assert tdec.sampling_variant(*knobs) == variant


def test_top_k_past_the_vocab_keeps_every_token():
    logits = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    for k in (16, 17, torch.tensor(400.0)):
        np.testing.assert_array_equal(
            tdec.filter_logits(logits, 1.0, k).numpy(), logits.numpy())


# -- the programs on the CPU ---------------------------------------------------

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
SAMPLED = [dict(temperature=0.9), dict(temperature=0.8, top_k=20),
           dict(temperature=1.1, top_p=0.9),
           dict(temperature=0.8, top_k=50, top_p=0.9)]


def _variant_id(knobs):
    return tdec.sampling_variant(knobs.get("temperature", 0.0),
                                 knobs.get("top_k", 0), knobs.get("top_p", 0))


@pytest.fixture(scope="module")
def tparams():
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    return params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")


def _lane(tparams, eos_id=None):
    return tserver.SampledLane(tserver.GreedyLane(tparams, TCFG, eos_id,
                                                  graphs=False))


def _rows(seed, lengths, width):
    rng = np.random.default_rng(seed)
    rows = np.zeros((len(lengths), width), np.int32)
    for i, n in enumerate(lengths):
        rows[i, :n] = rng.integers(1, TCFG.vocab_size, n)
    return torch.from_numpy(rows), torch.tensor(lengths, dtype=torch.int32)


def _eager(tparams, rows, lengths, new, span, seed, eos_id=None, **knobs):
    return tdec.generate(tparams, rows, TCFG, new, cache_span=span,
                         prompt_lengths=lengths, eos_id=eos_id,
                         generator=torch.Generator().manual_seed(seed),
                         **knobs)


@pytest.mark.parametrize("knobs", SAMPLED, ids=_variant_id)
def test_generate_program_draws_generate_eager_loop(tparams, knobs):
    """Seeded tokens of the generate program, at its first call and at
    later ones, equal ``generate``'s eager loop with the same seed; the
    key is captured once, and a second seed draws other tokens."""
    lane = _lane(tparams)
    rows, lengths = _rows(1, [9, 16, 4], 16)
    want = _eager(tparams, rows, lengths, 8, 24, 7, **knobs)
    for _ in range(3):
        got = lane.generate(rows, lengths, 8, 24, seed=7, **knobs)
        assert torch.equal(got, want)
    other = lane.generate(rows, lengths, 8, 24, seed=8, **knobs)
    assert not torch.equal(other, want)
    key = ("generate", 3, 16, 24, 8, _variant_id(knobs))
    assert lane.programs.captures == {key: 1}
    assert lane.programs.replays == {key: 3}


def test_one_key_serves_two_temperatures(tparams):
    """The knob values are the program's input: two temperatures (and two
    top_p) run one program, each drawing its own eager tokens."""
    lane = _lane(tparams)
    rows, lengths = _rows(2, [5], 16)
    for t, p in ((0.6, 0.8), (1.7, 0.95)):
        got = lane.generate(rows, lengths, 8, 24, temperature=t, top_p=p,
                            seed=3)
        assert torch.equal(got, _eager(tparams, rows, lengths, 8, 24, 3,
                                       temperature=t, top_p=p))
    assert lane.programs.captures == {
        ("generate", 1, 16, 24, 8, "sample+top_p"): 1}


def test_greedy_program_equals_jax_generate_with_eos():
    """The greedy variant of the program is JAX's greedy ``generate``
    token for token, ragged and with an EOS id (f32 weights)."""
    jp = jllama.init_params(jax.random.PRNGKey(0), JCFG)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rows, lengths = _rows(3, [12, 7], 12)
    free = np.asarray(jdec.generate(jp, jnp.asarray(rows.numpy()), JCFG, 8,
                                    prompt_lengths=jnp.asarray(lengths)))
    eos = int(free[0, 3])
    want = np.asarray(jdec.generate(jp, jnp.asarray(rows.numpy()), JCFG, 8,
                                    prompt_lengths=jnp.asarray(lengths),
                                    eos_id=eos))
    got = _lane(tp, eos_id=eos).generate(rows, lengths, 8, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_top_k_one_is_the_greedy_program(tparams):
    lane = _lane(tparams)
    rows, lengths = _rows(4, [11, 3], 16)
    greedy = lane.generate(rows, lengths, 8, 24)
    assert torch.equal(lane.generate(rows, lengths, 8, 24, temperature=0.8,
                                     top_k=1, seed=5), greedy)


@pytest.mark.parametrize("knobs", [{}] + SAMPLED, ids=lambda k: _variant_id(
    k) if k else "greedy")
def test_stream_yields_the_generate_program_tokens(tparams, knobs):
    """The lane's token loop (prefill, "draw", one "step" a token) yields
    the generate program's tokens for the seed, row for row; its draw and
    step keys are captured once each."""
    lane = _lane(tparams)
    ids = [7, 3, 99, 41, 5]
    rows, lengths = tserver._pad_rows([ids], 16), torch.tensor([5])
    want = lane.generate(rows, lengths, 8, 24, seed=11, **knobs)[0].tolist()
    got = list(lane.stream(ids, 16, 24, seed=11, **knobs))
    assert got == want
    variant = _variant_id(knobs) if knobs else "greedy"
    steps = {("step", 1, 16, 24, variant): 1}
    if variant != "greedy":
        steps[("draw", 1, 16, 24, variant)] = 1
    assert {k: n for k, n in lane.programs.captures.items()
            if k[0] in ("step", "draw")} == steps


def _jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX server's weights."""
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.CONFIGS["llama-test"])
    return params_from_numpy(jax.tree.map(np.asarray, jp), device=device)


def _state(**extra):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        st = tserver.ServingState({"SERVE_MODEL": "llama-test",
                                   "SERVE_MAX_NEW": "8",
                                   "SERVE_DTYPE": "float32",
                                   "SERVE_DEVICE": "cpu", **extra})
    st.warm()
    return st


def test_server_serves_every_sampled_request_of_a_shape_with_one_program():
    """Through ``ServingState``: sampled requests of one width bucket with
    different knob values replay one generate program; each response
    equals ``generate``'s eager loop with the request's seed; streamed
    equals non-streamed for every variant."""
    st = _state()
    ids = st.encode("sample me")
    rows, lengths = tserver._pad_rows([ids], 16), torch.tensor([len(ids)])
    for t, seed in ((0.7, 1), (1.4, 2), (0.7, 1)):
        out = st.complete("sample me", 8, temperature=t, seed=seed)
        want = _eager(st.params, rows, lengths, 8, 24, seed,
                      temperature=t)[0].tolist()
        assert out["text"] == st.decode_text(want)
    key = ("generate", 1, 16, 24, 8, "sample")
    assert st.greedy.programs.captures[key] == 1
    assert st.greedy.programs.replays[key] == 2
    for knobs in SAMPLED:
        plain = st.complete("stream me", 6, seed=4, **knobs)
        streamed = "".join(st.stream("stream me", 6, seed=4, **knobs))
        assert streamed == plain["text"]
    assert all(n == 1 for n in st.greedy.programs.captures.values())
