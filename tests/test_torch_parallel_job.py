"""``python -m tpu_kubernetes_torch.train.job`` over a mesh on the CPU
(``JOB_DEVICE=cpu``: one gloo worker per rank): the reference's entry-point
cases (``tests/test_job_entrypoint.py``: the virtual mesh, the multislice
hybrid mesh, checkpoint and resume) against the port, its log lines (from
rank 0 alone) beside the JAX job's, and its losses against the port's
one-device job on the same seed and token file."""

import numpy as np
import pytest

from tpu_kubernetes_torch.train import job as tjob

ENV = {"JOB_DEVICE": "cpu", "JOB_MODEL": "llama-test", "JOB_BATCH": "8",
       "JOB_SEQ": "32", "JOB_STEPS": "10"}
MESH = {"JOB_MESH": "data=2,fsdp=2,tensor=2"}
# llama-test is bf16: the sharded step reduces its products and gradients
# in other orders than one device (the f32 steps agree to 1e-6:
# tests/test_torch_parallel_train.py); measured 1.3e-3 abs at loss ≈ 5.6
LOSS_ATOL = 1e-2


@pytest.fixture(scope="module")
def token_file(tmp_path_factory):
    d = tmp_path_factory.mktemp("tokens")
    rng = np.random.default_rng(0)
    rng.integers(0, 256, 33 * 96).astype(np.uint16).tofile(d / "a.bin")
    return d / "a.bin"


def _job(capfd, **extra):
    out = tjob.main({**ENV, **extra})
    return out, capfd.readouterr().err


@pytest.fixture(scope="module")
def one_device(token_file):
    return tjob.main({**ENV, "JOB_DATA_PATH": str(token_file)})


def test_job_trains_over_the_virtual_mesh_and_logs_the_marker(
        capfd, token_file, one_device):
    out, err = _job(capfd, **MESH, JOB_DATA_PATH=str(token_file))
    assert "mesh={'data': 2, 'fsdp': 2, 'tensor': 2}" in err
    assert "FIRST TRAIN STEP at +" in err
    assert f"data: {token_file}" in err and "done" in err
    # rank 0 alone logs
    assert err.count("FIRST TRAIN STEP at +") == 1
    assert err.count("step=10 loss=") == 1 and err.count("[job] done") == 1
    np.testing.assert_allclose(out["losses"], one_device["losses"],
                               atol=LOSS_ATOL)


def test_job_multislice_hybrid_mesh(capfd):
    out, err = _job(capfd, JOB_DCN_MESH="data=2", JOB_MESH="fsdp=2,tensor=2",
                    JOB_STEPS="3")
    assert "mesh={'data': 2, 'fsdp': 2, 'tensor': 2}" in err
    assert "FIRST TRAIN STEP at +" in err
    assert len(out["losses"]) == 3 and np.all(np.isfinite(out["losses"]))


def test_job_checkpoints_and_resumes_across_meshes(capfd, tmp_path,
                                                    token_file, one_device):
    """A sharded run saves step 2 (gathered, rank 0 writes); one device
    resumes it to step 4 and saves; fsdp=4 resumes that to step 10. The
    losses are the uninterrupted one-device run's."""
    ckpt = str(tmp_path / "ckpt")
    common = {"JOB_CHECKPOINT_DIR": ckpt, "JOB_DATA_PATH": str(token_file)}
    first, err = _job(capfd, **MESH, **common, JOB_STEPS="2",
                      JOB_CHECKPOINT_EVERY="2")
    assert "checkpointed step 2" in err
    second, err = _job(capfd, **common, JOB_STEPS="4",
                       JOB_CHECKPOINT_EVERY="4")
    assert "resumed from step 2" in err and "checkpointed step 4" in err
    third, err = _job(capfd, **common, JOB_MESH="fsdp=4",
                      JOB_CHECKPOINT_EVERY="50")
    assert "resumed from step 4" in err and "done" in err
    assert (first["start_step"], second["start_step"],
            third["start_step"]) == (0, 2, 4)
    losses = first["losses"] + second["losses"] + third["losses"]
    np.testing.assert_allclose(losses, one_device["losses"], atol=LOSS_ATOL)


def test_job_evaluates_over_the_mesh(capfd, token_file):
    out, err = _job(capfd, **MESH, JOB_DATA_PATH=str(token_file),
                    JOB_EVAL_DATA_PATH=str(token_file), JOB_STEPS="4",
                    JOB_EVAL_EVERY="2", JOB_EVAL_BATCHES="2",
                    JOB_ACCUM_STEPS="2")
    assert "eval step=2 loss=" in err and "eval step=4 loss=" in err
    assert err.count("eval step=2 loss=") == 1


def test_log_lines_beside_the_jax_jobs(capfd, monkeypatch, tmp_path,
                                       token_file):
    """The JAX job on the same mesh of the virtual devices and the same
    token file logs the same lines; its loss after 10 steps is within 0.1
    of the port's (the two jobs draw their random weights from different
    generators, so only the loss's scale compares)."""
    from tpu_kubernetes.train import job as jjob

    for k, v in {**ENV, **MESH, "JOB_DATA_PATH": str(token_file),
                 "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "xla")}.items():
        monkeypatch.setenv(k, v)
    jjob.main()
    jerr = capfd.readouterr().err
    out, err = _job(capfd, **MESH, JOB_DATA_PATH=str(token_file))
    markers = ["mesh={'data': 2, 'fsdp': 2, 'tensor': 2}",
               "FIRST TRAIN STEP at +", "step=10 loss=",
               f"data: {token_file}", "[job] done"]
    for m in markers:
        assert m in jerr and m in err, m

    def step10(text):
        line = next(x for x in text.splitlines() if "step=10 loss=" in x)
        return float(line.split("loss=")[1].split()[0])

    assert abs(step10(jerr) - step10(err)) < 0.1
