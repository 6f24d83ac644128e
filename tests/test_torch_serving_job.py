"""The port's batch job over a mesh (``tpu_kubernetes_torch/serve/job.py``
with ``SERVE_MESH`` and ``JAX_NUM_PROCESSES``, ``SERVE_DEVICE=cpu``: one
gloo worker a rank) against the JAX package's job on one device
(``SERVE_MESH=tensor=1``). Both serve the same float32 weights, written
once as a transformers checkpoint (``SERVE_HF_CHECKPOINT``), so the
spawned workers read them as the JAX job does: the greedy completions
and the output files are identical at ``tensor=2`` (a partial host: 2 of
the cores) and ``data=2,tensor=2``. The reference's
``test_multihost_serving_token_parity``: two job processes on a
localhost coordinator (``JAX_NUM_PROCESSES=2``, the default mesh: one
rank a host) write the one-process run's bytes, and only process 0
writes. A mesh that wants more devices than exist is refused with the
reference's message before any worker starts."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.serve import job as jjob
from tpu_kubernetes_torch.models import CONFIGS, export_hf_llama
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ["hello tpu", "rings of ici", "short", "a longer prompt on the card",
           "x", "the quick brown fox", "sharded", "serving!"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """→ (prompts file, HF checkpoint of the JAX job's weights, the JAX
    job's completions and file bytes on one device)."""
    tmp = tmp_path_factory.mktemp("serving-job")
    prompts = tmp / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    jp = jllama.init_params(jax.random.PRNGKey(0),
                            jllama.CONFIGS["llama-test"])
    ckpt = tmp / "ckpt"
    export_hf_llama(params_from_numpy(jax.tree.map(np.asarray, jp),
                                      device="cpu"),
                    CONFIGS["llama-test"], str(ckpt))
    out = tmp / "jax.txt"
    want = jjob.run_serving(dict(_env(prompts, out, ckpt),
                                 SERVE_MESH="tensor=1"))
    return prompts, ckpt, want, out.read_bytes()


def _env(prompts, out, ckpt=None, **extra):
    env = {"SERVE_PROMPTS": str(prompts), "SERVE_OUT": str(out),
           "SERVE_MAX_NEW": "6", "SERVE_BATCH": "4",
           "SERVE_DTYPE": "float32"}
    if ckpt is None:
        env["SERVE_MODEL"] = "llama-test"
    else:
        env["SERVE_HF_CHECKPOINT"] = str(ckpt)
    env.update({k: str(v) for k, v in extra.items()})
    return env


@pytest.mark.parametrize("mesh", ["tensor=2", "data=2,tensor=2"])
def test_sharded_job_equals_the_jax_job_on_one_device(setup, tmp_path, mesh,
                                                      capfd):
    prompts, ckpt, want, want_bytes = setup
    out = tmp_path / "port.txt"
    got = tjob.run_serving(_env(prompts, out, ckpt, SERVE_MESH=mesh,
                                SERVE_DEVICE="cpu"))
    assert got == want
    assert out.read_bytes() == want_bytes
    err = capfd.readouterr().err
    n = 2 if mesh == "tensor=2" else 4
    assert f"partial-host mesh: {n} of " in err
    assert f": {n} ranks" in err
    # only rank 0 logs and writes
    assert err.count("wrote ") == 1 and err.count("tok/s") == 1


def test_multihost_serving_token_parity(tmp_path):
    """Two job processes (one gloo rank each) on a localhost coordinator
    give the one-process two-rank run's file byte for byte; only process
    0 writes."""
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("\n".join(PROMPTS) + "\n")
    ref = tmp_path / "ref.txt"
    common = {**os.environ, "SERVE_DEVICE": "cpu"}
    for k in ("JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES",
              "JAX_PROCESS_ID"):
        common.pop(k, None)
    tjob.run_serving(_env(prompts, ref, SERVE_MESH="tensor=2",
                          SERVE_DEVICE="cpu"))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tpu_kubernetes_torch.serve.job"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT,
        env={**common, **_env(prompts, tmp_path / f"mh{pid}.txt"),
             "JAX_COORDINATOR_ADDRESS": f"127.0.0.1:{port}",
             "JAX_NUM_PROCESSES": "2", "JAX_PROCESS_ID": str(pid)})
        for pid in range(2)]
    errs = []
    try:
        for p in procs:
            errs.append(p.communicate(timeout=180)[1])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert [p.returncode for p in procs] == [0, 0], [e[-2000:] for e in errs]
    assert (tmp_path / "mh0.txt").read_bytes() == ref.read_bytes()
    assert not (tmp_path / "mh1.txt").exists()
    assert "mesh={'tensor': 2}: 2 ranks" in errs[0]


@pytest.mark.parametrize("extra, match", [
    ({"SERVE_MESH": "tensor=999"},
     r"SERVE_MESH \{'tensor': 999\} wants 999 devices, have \d+"),
    # over several hosts the mesh covers every device (one a host here)
    ({"SERVE_MESH": "tensor=4", "JAX_NUM_PROCESSES": "2"},
     r"SERVE_MESH \{'tensor': 4\} wants 4 devices, have 2"),
])
def test_oversized_mesh_refused_before_any_worker(tmp_path, extra, match,
                                                  monkeypatch):
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("x\n")

    def no_spawn(*args, **kwargs):
        raise AssertionError("a worker was started")

    import tpu_kubernetes_torch.train.job as train_job

    monkeypatch.setattr(train_job, "_spawn", no_spawn)
    with pytest.raises(SystemExit, match=match):
        tjob.run_serving(_env(prompts, tmp_path / "o.txt",
                              SERVE_DEVICE="cpu", **extra))
