"""The port's checkpoints (``train/checkpoint.py``) and the training job's
resume (``train/job.py``, JOB_CHECKPOINT_DIR / JOB_CHECKPOINT_EVERY), on
the CPU: a save → restore round trip of an AdamW and an Adafactor state,
``max_to_keep``, a partial save ignored, the refusals, and a resumed run
equal bit for bit to an uninterrupted one, through a step program built
before the restore and through the job."""

import os
from dataclasses import replace

import numpy as np
import pytest
import torch

from tpu_kubernetes_torch.models import llama as tllama
from tpu_kubernetes_torch.train import checkpoint as ckpt
from tpu_kubernetes_torch.train import job as tjob
from tpu_kubernetes_torch.train import trainer as ttr

CFG = replace(tllama.CONFIGS["llama-test"], dtype=torch.float32)
OPTIMIZERS = {"adamw": ttr.TrainConfig(warmup_steps=2),
              "adafactor": ttr.TrainConfig(warmup_steps=2,
                                           optimizer="adafactor")}


def _state(tc, seed=0, cfg=CFG):
    return ttr.init_state(torch.Generator().manual_seed(seed), cfg, tc, "cpu")


def _batches(n, seed=7):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randint(0, CFG.vocab_size, (2, 33), generator=gen,
                          dtype=torch.int32) for _ in range(n)]


def _tensors(state):
    return [*ttr.tree_leaves(state["params"]),
            *ttr.tree_leaves(state["opt_state"])]


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_save_restore_round_trip(tmp_path, opt):
    """Every tensor and the host step come back into a fresh state, in
    place (the same tensors), bit for bit."""
    tc = OPTIMIZERS[opt]
    state = _state(tc)
    for b in _batches(2):
        state, _ = ttr.train_step(state, b, CFG, tc)
    ckpt.save(tmp_path / "ck", state, step=2)
    assert ckpt.latest_step(tmp_path / "ck") == 2
    fresh = _state(tc, seed=1)
    ptrs = [t.data_ptr() for t in _tensors(fresh)]
    out = ckpt.restore(tmp_path / "ck", like=fresh)
    assert out is fresh and fresh["step"] == 2
    assert [t.data_ptr() for t in _tensors(fresh)] == ptrs
    for a, b in zip(_tensors(state), _tensors(fresh)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_restore_keeps_the_dtypes_of_a_bf16_state(tmp_path):
    tc = OPTIMIZERS["adafactor"]
    cfg = tllama.CONFIGS["llama-test"]
    state = _state(tc, cfg=cfg)
    state, _ = ttr.train_step(state, _batches(1)[0], cfg, tc)
    ckpt.save(tmp_path, state, step=1)
    fresh = ckpt.restore(tmp_path, like=_state(tc, seed=3, cfg=cfg))
    for a, b in zip(_tensors(state), _tensors(fresh)):
        assert b.dtype == a.dtype and torch.equal(a, b)
    assert fresh["opt_state"]["mu"]["embed"].dtype == torch.bfloat16


def test_max_to_keep_prunes_the_oldest(tmp_path):
    state = {"w": torch.arange(4.0), "step": 0}
    for step in range(1, 6):
        state["step"] = step
        ckpt.save(tmp_path, state, step=step, max_to_keep=2)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["4", "5"]
    assert ckpt.latest_step(tmp_path) == 5
    like = {"w": torch.zeros(4), "step": None}
    assert ckpt.restore(tmp_path, like, step=4)["step"] == 4
    with pytest.raises(ckpt.CheckpointError, match="step 3"):
        ckpt.restore(tmp_path, like, step=3)


def test_a_partial_save_is_ignored(tmp_path):
    """A save that died before its rename leaves a temporary directory,
    and a step directory without its file is no checkpoint: latest_step
    and restore take the last complete one."""
    state = {"w": torch.ones(3), "step": 1}
    ckpt.save(tmp_path, state, step=1)
    (tmp_path / ".tmp-7-123").mkdir()
    (tmp_path / ".tmp-7-123" / ckpt.STATE_FILE).write_bytes(b"partial")
    (tmp_path / "9").mkdir()
    assert ckpt.latest_step(tmp_path) == 1
    like = {"w": torch.zeros(3), "step": 0}
    assert ckpt.restore(tmp_path, like)["step"] == 1
    assert torch.equal(like["w"], torch.ones(3))
    # the next save of that step replaces its own leftover
    (tmp_path / f".tmp-2-{os.getpid()}").mkdir()
    ckpt.save(tmp_path, state, step=2)
    assert ckpt.latest_step(tmp_path) == 2


@pytest.mark.parametrize("case", ["none", "url", "shape", "dtype", "missing",
                                  "unexpected"])
def test_checkpoint_error(tmp_path, case):
    like = {"w": torch.zeros(3), "step": 0}
    if case == "none":
        with pytest.raises(ckpt.CheckpointError, match="no checkpoints"):
            ckpt.restore(tmp_path / "empty", like)
        assert ckpt.latest_step(tmp_path / "empty") is None
        return
    if case == "url":
        for call in (lambda: ckpt.restore("gs://bucket/run", like),
                     lambda: ckpt.save("gs://bucket/run", like, step=1),
                     lambda: ckpt.latest_step("gs://bucket/run")):
            with pytest.raises(ckpt.CheckpointError,
                               match="gs://bucket/run.*no remote store"):
                call()
        return
    saved = {"w": torch.ones(3), "step": 1}
    if case == "shape":
        like["w"] = torch.zeros(4)
    elif case == "dtype":
        like["w"] = torch.zeros(3, dtype=torch.bfloat16)
    elif case == "missing":
        like["v"] = torch.zeros(2)
    else:
        saved["extra"] = {"u": torch.zeros(1)}
    ckpt.save(tmp_path, saved, step=1)
    before = {k: v.clone() if isinstance(v, torch.Tensor) else v
              for k, v in like.items()}
    with pytest.raises(ckpt.CheckpointError,
                       match={"shape": "the state's", "dtype": "the state's",
                              "missing": "missing ..v.",
                              "unexpected": "unexpected ..extra/u"}[case]):
        ckpt.restore(tmp_path, like)
    for k, v in before.items():     # nothing of like changed
        assert (torch.equal(like[k], v) if isinstance(v, torch.Tensor)
                else like[k] == v)


def test_saves_and_restores_are_observed(tmp_path):
    def count(op):
        return ckpt.CKPT_SECONDS.labels(op).count

    saves, restores = count("save"), count("restore")
    ckpt.save(tmp_path, {"w": torch.ones(1)}, step=1)
    ckpt.restore(tmp_path, {"w": torch.zeros(1)})
    assert (count("save"), count("restore")) == (saves + 1, restores + 1)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_resume_equals_an_uninterrupted_run(tmp_path, opt):
    """Save at step 2, restore into a fresh state whose step program was
    built before the restore, then step 3: the loss and every tensor equal
    the uninterrupted run's, bit for bit."""
    tc = OPTIMIZERS[opt]
    batches = _batches(3)
    full = _state(tc)
    full_step = ttr.make_train_step(CFG, tc, full, (2, 33), graphs=False)
    losses = [full_step(b).item() for b in batches]

    first = _state(tc)
    first_step = ttr.make_train_step(CFG, tc, first, (2, 33), graphs=False)
    for b in batches[:2]:
        first_step(b)
    ckpt.save(tmp_path, first, step=first["step"])

    resumed = _state(tc, seed=9)           # other weights until the restore
    step = ttr.make_train_step(CFG, tc, resumed, (2, 33), graphs=False)
    ckpt.restore(tmp_path, like=resumed)
    assert resumed["step"] == 2
    assert step(batches[2]).item() == losses[2]
    assert resumed["step"] == full["step"] == 3
    for a, b in zip(_tensors(full), _tensors(resumed)):
        assert torch.equal(a, b)


# -- the job ------------------------------------------------------------------

JOB = {"JOB_DEVICE": "cpu", "JOB_MODEL": "llama-test", "JOB_BATCH": "2",
       "JOB_SEQ": "32"}


@pytest.fixture()
def token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 256, 40 * 33,
                                      dtype=np.uint16).tofile(path)
    return path


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_job_resumes_where_it_stopped(tmp_path, token_file, capsys, opt):
    """Three steps that checkpoint at step 3, then a second call that logs
    "resumed from step 3" and runs steps 4-6 through the token file from
    step 3 on: its losses are the uninterrupted six-step run's last
    three."""
    env = {**JOB, "JOB_DATA_PATH": str(token_file), "JOB_OPTIMIZER": opt}
    full = tjob.main({**env, "JOB_STEPS": "6"})
    ck = {**env, "JOB_CHECKPOINT_DIR": str(tmp_path / "ck"),
          "JOB_CHECKPOINT_EVERY": "3"}
    first = tjob.main({**ck, "JOB_STEPS": "3"})
    err = capsys.readouterr().err
    assert "checkpointed step 3" in err and "resumed" not in err
    second = tjob.main({**ck, "JOB_STEPS": "6"})
    err = capsys.readouterr().err
    assert "resumed from step 3" in err
    assert f"data: {token_file} (from step 3)" in err
    assert second["start_step"] == 3 and first["start_step"] == 0
    assert first["losses"] + second["losses"] == full["losses"]
    assert ckpt.latest_step(tmp_path / "ck") == 6


def test_job_without_a_checkpoint_logs_no_resume(tmp_path, capsys):
    """An empty directory is a fresh start; a directory whose checkpoint
    does not fit the state logs "no resume" and starts fresh too."""
    out = tjob.main({**JOB, "JOB_STEPS": "2",
                     "JOB_CHECKPOINT_DIR": str(tmp_path / "ck")})
    assert out["start_step"] == 0
    ckpt.save(tmp_path / "other", {"w": torch.ones(1), "step": 4}, step=4)
    out = tjob.main({**JOB, "JOB_STEPS": "2",
                     "JOB_CHECKPOINT_DIR": str(tmp_path / "other")})
    err = capsys.readouterr().err
    assert "no resume: checkpoint" in err and out["start_step"] == 0
    assert len(out["losses"]) == 2


def test_job_refuses_a_remote_checkpoint_dir():
    with pytest.raises(SystemExit, match="local directory only"):
        tjob.main({**JOB, "JOB_CHECKPOINT_DIR": "gs://bucket/run"})
