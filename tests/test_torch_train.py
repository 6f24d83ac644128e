"""The port's training slice against the JAX package on ``llama-test``,
from the same weights (carried over by ``models.from_jax``, zero moments
on both sides) and the same numpy tokens: the loss and every gradient
leaf against ``jax.value_and_grad`` (remat off, "dots" and "full"), the
parameters and loss after three ``train_step``s against optax (f32 tight,
bf16 within a stated tolerance; the first step at lr 0, a clipped step,
``accum_steps=2``), ``local_batches`` against the reference's, and the
training job on the CPU."""

import functools
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.train import data as jdata
from tpu_kubernetes.train import trainer as jtr
from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.train import data as tdata
from tpu_kubernetes_torch.train import finetune as tfinetune
from tpu_kubernetes_torch.train import job as tjob
from tpu_kubernetes_torch.train import trainer as ttr

JCFG = replace(jllama.CONFIGS["llama-test"], dtype=jnp.float32)
TCFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
# float32 through two layers and the loss: summation order (XLA vs ATen)
# and transcendental ulps only
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
# float32 parameters after three AdamW steps: the update of each element is
# lr·(mu/√nu + wd·p) from gradients that agree to ~1e-7, so the parameters
# agree to a few f32 ulps (measured 1.2e-7 abs)
PARAM_TOL = dict(atol=1e-6, rtol=1e-5)
TC = jtr.TrainConfig(warmup_steps=2)


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(
        0, TCFG.vocab_size, shape).astype(np.int32)


def _leaf(tree, path):
    for key in path:
        tree = tree[key.key]
    return tree


def _t_state(jstate, tc):
    tp = params_from_numpy(jax.tree.map(np.asarray, jstate["params"]),
                           device="cpu")
    return {"params": tp, "opt_state": ttr.make_optimizer(tc).init(tp),
            "step": 0}


@pytest.fixture(scope="module")
def jparams():
    return jllama.init_params(jax.random.PRNGKey(0), JCFG)


@pytest.mark.parametrize("remat", [None, "dots", "full"])
def test_loss_and_every_gradient_leaf_match_jax(jparams, remat):
    tokens = _tokens(0, (2, 17))
    lj, gj = jax.value_and_grad(jllama.loss_fn)(jparams, jnp.asarray(tokens),
                                                JCFG)
    cfg = TCFG if remat is None else replace(TCFG, remat=True,
                                             remat_policy=remat)
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    leaves = ttr.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    loss = tllama.loss_fn(tp, torch.from_numpy(tokens), cfg)
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(loss.item(), float(lj), rtol=1e-6)
    for path, g in jax.tree_util.tree_leaves_with_path(gj):
        got = grads[id(_leaf(tp, path))]
        np.testing.assert_allclose(got.numpy(), np.asarray(g), **GRAD_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def _run_both(tc, steps=3, jcfg=JCFG, tcfg=TCFG, rows=4, seed=3):
    """``steps`` train steps on both sides from the same state and
    batches → (JAX state, port state, JAX losses, port losses, port
    states after each step)."""
    js = jtr.init_state(jax.random.PRNGKey(0), jcfg, tc)
    ts = _t_state(js, tc)
    step = jax.jit(functools.partial(jtr.train_step, cfg=jcfg, tc=tc))
    rng = np.random.default_rng(seed)
    jl, tl, seen = [], [], [ts]
    for _ in range(steps):
        b = rng.integers(0, tcfg.vocab_size, (rows, 33)).astype(np.int32)
        js, lj = step(js, jnp.asarray(b))
        ts, lt = ttr.train_step(ts, torch.from_numpy(b), tcfg, tc)
        jl.append(float(lj))
        tl.append(lt.item())
        seen.append(ts)
    return js, ts, jl, tl, seen


def _global_norm(params, tokens, cfg):
    leaves = [p.detach().requires_grad_(True)
              for p in ttr.tree_leaves(params)]
    loss = tllama.loss_fn(ttr._unflatten(params, iter(leaves)), tokens, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return float(torch.sqrt(sum((g.float() ** 2).sum() for g in grads)))


@pytest.mark.parametrize("grad_clip", [1e3, 0.05])
def test_three_steps_match_optax_f32(grad_clip):
    """Parameters and losses after three steps, f32: clipping never
    engages at 1e3 and engages on every step at 0.05."""
    tc = replace(TC, grad_clip=grad_clip)
    js, ts, jl, tl, seen = _run_both(tc)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    for path, leaf in jax.tree_util.tree_leaves_with_path(js["params"]):
        np.testing.assert_allclose(
            _leaf(ts["params"], path).numpy(), np.asarray(leaf), **PARAM_TOL,
            err_msg=jax.tree_util.keystr(path))
    assert ts["step"] == 3 and ts["opt_state"]["count"] == 3
    # the same batches again, to read the gradient norm of each step
    rng = np.random.default_rng(3)
    norms = [_global_norm(s["params"], torch.from_numpy(
        rng.integers(0, 256, (4, 33)).astype(np.int32)), TCFG)
        for s in seen[:3]]
    assert all(n < grad_clip for n in norms) or all(n > grad_clip
                                                    for n in norms)
    assert (norms[0] > grad_clip) == (grad_clip < 1.0)


@pytest.mark.parametrize("warmup", [0, 1, 3, 100])
def test_schedule_is_optax_linear_schedule(warmup):
    """The learning rate at each count, f32 bit for bit, including optax's
    constant-init rule for a warmup of 0 steps."""
    import optax

    ref = optax.linear_schedule(0.0, TC.learning_rate, warmup)
    opt = ttr.make_optimizer(replace(TC, warmup_steps=warmup))
    for count in (0, 1, 2, 3, 50, 99, 100, 101, 10_000):
        assert opt.schedule(count) == np.float32(ref(count)), count


def test_first_step_runs_at_lr_zero():
    """linear_schedule(0, lr, warmup) is read before the count moves: the
    first update leaves every parameter bit for bit as it was, while the
    moments move."""
    _, _, _, _, seen = _run_both(TC, steps=2)
    p0, p1, p2 = (ttr.tree_leaves(s["params"]) for s in seen)
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
    assert not all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert any(bool(m.abs().sum() > 0)
               for m in ttr.tree_leaves(seen[1]["opt_state"]["mu"]))


def test_accum_steps_2_equals_full_batch_and_optax():
    """accum_steps=2: f32 gradient sums, one cast, the mean of the two
    micro-losses — against the port's full-batch step and optax's."""
    acc = replace(TC, accum_steps=2)
    js, ts, jl, tl, _ = _run_both(acc)
    _, full, _, fl, _ = _run_both(TC)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    np.testing.assert_allclose(tl, fl, rtol=1e-6)
    for path, leaf in jax.tree_util.tree_leaves_with_path(js["params"]):
        got = _leaf(ts["params"], path).numpy()
        np.testing.assert_allclose(got, np.asarray(leaf), **PARAM_TOL)
        np.testing.assert_allclose(got, _leaf(full["params"], path).numpy(),
                                   **PARAM_TOL)


def test_three_steps_close_to_optax_bf16():
    """bf16 params, moments and activations on both sides. XLA and ATen
    round the bf16 forward and backward at different places, so gradient
    elements differ by bf16 roundings, and Adam's first steps move an
    element by about lr_t·sign(g) whatever its size: a small gradient
    that rounds the other way moves its element the other way. Bound:
    |Δp| ≤ 2·Σ lr_t (the steps at lr/2 and lr after the lr-0 step) plus
    one bf16 ulp (2^-8 relative); losses within 5e-3 (measured 1.1e-3);
    and most elements bit-identical (measured over 97 %)."""
    js, ts, jl, tl, _ = _run_both(TC, jcfg=jllama.CONFIGS["llama-test"],
                                  tcfg=tllama.CONFIGS["llama-test"])
    np.testing.assert_allclose(tl, jl, atol=5e-3)
    lr_sum = TC.learning_rate * 1.5
    for path, leaf in jax.tree_util.tree_leaves_with_path(js["params"]):
        got = _leaf(ts["params"], path)
        assert got.dtype == torch.bfloat16
        ref = np.asarray(leaf).astype(np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref,
                                   atol=2 * lr_sum, rtol=2 ** -8,
                                   err_msg=jax.tree_util.keystr(path))
        assert (got.float().numpy() == ref).mean() > 0.9
    for m in ttr.tree_leaves(ts["opt_state"]["mu"]):
        assert m.dtype == torch.bfloat16      # optax keeps param dtype


def test_loss_decreases_overfitting_one_batch():
    """tests/test_train.py's check on the port: five steps on one batch."""
    state = ttr.init_state(torch.Generator().manual_seed(0), TCFG, TC, "cpu")
    batch = next(ttr.synthetic_batches(TCFG.vocab_size, 2, 64, seed=7,
                                       device="cpu"))
    losses = []
    for _ in range(5):
        state, loss = ttr.train_step(state, batch, TCFG, TC)
        losses.append(loss.item())
    assert losses[-1] < losses[0]
    assert state["step"] == 5


def test_eval_step_is_the_loss_without_gradient(jparams):
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    tokens = torch.from_numpy(_tokens(4, (2, 17)))
    for p in ttr.tree_leaves(tp):
        p.requires_grad_(True)
    got = ttr.make_eval_step(TCFG, tp, tokens.shape)(tokens)
    assert not got.requires_grad
    assert got.item() == pytest.approx(
        float(jllama.loss_fn(jparams, jnp.asarray(tokens.numpy()), JCFG)),
        rel=1e-6)


def test_synthetic_batches_are_seeded_int32_windows():
    a = next(ttr.synthetic_batches(256, 3, 16, seed=5, device="cpu"))
    b = next(ttr.synthetic_batches(256, 3, 16, seed=5, device="cpu"))
    c = next(ttr.synthetic_batches(256, 3, 16, seed=6, device="cpu"))
    assert a.shape == (3, 17) and a.dtype == torch.int32
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.min()) >= 0 and int(a.max()) < 256


@pytest.mark.parametrize("bad,err", [
    # adafactor is ported now (tests/test_torch_adafactor.py): the case
    # refuses another name, and the id keeps the case it had
    pytest.param(dict(optimizer="Adafactor"), ValueError,
                 id="bad0-NotImplementedError"),
    (dict(optimizer="sgd"), ValueError),
])
def test_make_optimizer_refuses(bad, err):
    with pytest.raises(err, match="unknown optimizer"):
        ttr.make_optimizer(replace(TC, **bad))
    assert isinstance(ttr.make_optimizer(replace(TC, optimizer="adafactor")),
                      ttr.Adafactor)


def test_train_step_refuses_bad_accumulation():
    state = ttr.init_state(torch.Generator().manual_seed(0), TCFG, TC, "cpu")
    batch = torch.zeros((3, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="accum_steps must be"):
        ttr.train_step(state, batch, TCFG, replace(TC, accum_steps=0))
    with pytest.raises(ValueError, match="not divisible"):
        ttr.train_step(state, batch, TCFG, replace(TC, accum_steps=2))


@pytest.mark.parametrize("policy,err", [("bogus", ValueError)])
def test_remat_policy_refusals(policy, err):
    with pytest.raises(err):
        tllama.remat_policy_kwargs(replace(TCFG, remat=True,
                                           remat_policy=policy))


def test_remat_policy_moe_on_a_dense_model_is_dots():
    """"moe" is "dots" plus the MoE layer's names, which a dense model
    never places: its gradients equal those without remat, as in JAX."""
    tokens = torch.from_numpy(_tokens(0, (2, 17)))
    params = tllama.init_params(TCFG, torch.Generator().manual_seed(0), "cpu")
    grads = []
    for cfg in (TCFG, replace(TCFG, remat=True, remat_policy="moe")):
        leaves = [p.detach().requires_grad_(True)
                  for p in ttr.tree_leaves(params)]
        loss = tllama.loss_fn(ttr._unflatten(params, iter(leaves)), tokens,
                              cfg)
        grads.append(torch.autograd.grad(loss, leaves))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_llama_test_preset_has_remat_off_like_jax():
    assert tllama.CONFIGS["llama-test"].remat is False
    assert tllama.CONFIGS["llama-1b"].remat is True
    assert tllama.CONFIGS["llama-1b"].remat_policy == "dots"


# -- data ------------------------------------------------------------------------

@pytest.fixture()
def token_dir(tmp_path):
    """Two shards of uint16 tokens, 1000 + 500 tokens."""
    rng = np.random.default_rng(0)
    (tmp_path / "a.bin").write_bytes(
        rng.integers(0, 256, 1000, dtype=np.uint16).tobytes())
    (tmp_path / "b.bin").write_bytes(
        rng.integers(0, 256, 500, dtype=np.uint16).tobytes())
    return tmp_path


def test_token_dataset_windows_match_jax(token_dir):
    ref = jdata.TokenDataset(token_dir, seq=9, vocab_size=256)
    got = tdata.TokenDataset(token_dir, seq=9, vocab_size=256)
    assert len(got) == len(ref) == 150
    for i in (0, 3, 99, 100, 149):
        np.testing.assert_array_equal(got.sequence(i), ref.sequence(i))
    with pytest.raises(tdata.DataError, match="no token shards"):
        tdata.TokenDataset(token_dir / "nope.bin", seq=9, vocab_size=256)


@pytest.mark.parametrize("start_step", [0, 4])
def test_local_batches_identical_to_jax(token_dir, start_step):
    """Same file, seed and start_step → the same batches, across an epoch
    boundary (3 steps per epoch here)."""
    kw = dict(seed=3, epochs=2, start_step=start_step)
    ref = list(jdata.local_batches(
        jdata.TokenDataset(token_dir, seq=9, vocab_size=256), 40,
        process_index=0, process_count=1, **kw))
    got = list(tdata.local_batches(
        tdata.TokenDataset(token_dir, seq=9, vocab_size=256), 40, **kw))
    assert len(got) == len(ref) == 6 - start_step
    for a, b in zip(got, ref):
        assert a.dtype == np.int32
        np.testing.assert_array_equal(a, b)


def test_input_pipeline_yields_tensors_on_the_device(token_dir):
    it = tdata.input_pipeline(token_dir, 8, 9, 256, "cpu", seed=2)
    ref = tdata.local_batches(
        tdata.TokenDataset(token_dir, seq=9, vocab_size=256), 8, seed=2)
    for _ in range(3):
        got = next(it)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), next(ref))
    it.close()


def test_prefetch_reraises_and_releases():
    def boom():
        yield 1
        raise RuntimeError("bad shard")

    it = tdata.prefetch(boom())
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="bad shard"):
        next(it)
    assert list(tdata.prefetch(iter(range(5)), depth=0)) == list(range(5))


# -- the job ---------------------------------------------------------------------

JOB_ENV = {"JOB_DEVICE": "cpu", "JOB_MODEL": "llama-test", "JOB_BATCH": "2",
           "JOB_SEQ": "32", "JOB_STEPS": "10"}


def test_job_trains_on_the_cpu(capsys):
    out = tjob.main(dict(JOB_ENV))
    err = capsys.readouterr().err
    assert "FIRST TRAIN STEP at +" in err and "step=10 loss=" in err
    assert "tokens/s=" in err and "[job] done" in err
    assert np.isfinite(out["loss"]) and out["tokens_per_s"] > 0


def test_job_reads_token_files_and_evaluates(token_dir, capsys):
    env = {**JOB_ENV, "JOB_SEQ": "8", "JOB_STEPS": "4", "JOB_ACCUM_STEPS": "2",
           "JOB_MESH": "data=1,fsdp=1", "JOB_DATA_PATH": str(token_dir),
           "JOB_EVAL_DATA_PATH": str(token_dir / "b.bin"),
           "JOB_EVAL_EVERY": "2", "JOB_EVAL_BATCHES": "2"}
    out = tjob.main(env)
    err = capsys.readouterr().err
    assert f"data: {token_dir}" in err
    assert "eval step=2 loss=" in err and "eval step=4 loss=" in err
    assert np.isfinite(out["loss"])


@pytest.mark.parametrize("extra,match", [
    # meshes train now (tests/test_torch_parallel_job.py): what stays
    # refused of them, the ids keeping the cases they had — a mesh that
    # wants more devices than exist (on the CPU one gloo rank a core), and
    # the finetune job's FT_MESH (the sharded LoRA step, item 7b)
    pytest.param({"JOB_MESH": "data=4096"}, "wants 4096 devices",
                 id="extra0-parallel slice"),
    pytest.param({"FT_MESH": "fsdp=4"}, "queue 1 item 7b",
                 id="extra1-parallel slice"),
    # checkpoints and adafactor are ported now (tests/test_torch_checkpoint.py,
    # tests/test_torch_adafactor.py): what stays refused of each, the ids
    # keeping the cases they had
    pytest.param({"JOB_CHECKPOINT_DIR": "gs://bucket/run"},
                 "local directory only", id="extra2-queue 1"),
    pytest.param({"JOB_OPTIMIZER": "sgd"}, "unknown optimizer",
                 id="extra3-ROADMAP"),
    ({"JOB_ACCUM_STEPS": "3"}, "not divisible"),
    ({"JOB_MODEL": "llama-3000"}, "unknown JOB_MODEL"),
])
def test_job_refusals_name_what_is_missing(extra, match):
    main = tfinetune.run_finetune if "FT_MESH" in extra else tjob.main
    with pytest.raises((SystemExit, ValueError), match=match):
        main({**JOB_ENV, **extra})


def test_job_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="JOB_DEVICE=cpu"):
        tjob.main({k: v for k, v in JOB_ENV.items() if k != "JOB_DEVICE"})
