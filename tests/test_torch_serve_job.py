"""The port's batch inference job (``tpu_kubernetes_torch/serve/job.py``
``run_serving``) against the JAX package's (``tests/test_serve_job.py``
re-run against the port): prompts file in, completions out.

Both jobs serve ``llama-test`` in float32 (``SERVE_DTYPE``) from the same
weights (the port's ``init_params`` patched to the JAX job's), the JAX
one on one device (``SERVE_MESH=tensor=1``): greedy completions are
identical line by line, and the output files byte for byte, at
``SERVE_BATCH`` 1, 3 and 8, with ``SERVE_EOS_ID`` and with
``SERVE_CACHE_SPAN`` pinned. The whole file runs one generate program
(one capture, the batches − 1 replays); sampled output is the eager
``generate`` loop's with one generator seeded once from ``SERVE_SEED``
(its draws differ from ``jax.random``'s, so sampled output is never
compared with JAX). The refusals name what is missing."""

import ast
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from tpu_kubernetes.models import llama as jllama
from tpu_kubernetes.serve import job as jjob
from tpu_kubernetes_torch.models import decode as tdec
from tpu_kubernetes_torch.models.from_jax import params_from_numpy
from tpu_kubernetes_torch.serve import job as tjob
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parents[1]
PROMPTS = ["hello tpu", "rings of ici", "short", "a longer prompt on the card",
           "x", "the quick brown fox"]


def _jax_weights(cfg, generator, device):
    """Stands in for the port's init_params: the JAX job's weights."""
    jp = jllama.init_params(jax.random.PRNGKey(0), jllama.CONFIGS["llama-test"])
    return params_from_numpy(jax.tree.map(np.asarray, jp), device=device)


@pytest.fixture()
def prompts_file(tmp_path):
    p = tmp_path / "prompts.txt"
    p.write_text("\n".join(PROMPTS) + "\n")
    return p


def _env(prompts, out, **extra):
    env = {"SERVE_PROMPTS": str(prompts), "SERVE_OUT": str(out),
           "SERVE_MODEL": "llama-test", "SERVE_MAX_NEW": "6",
           "SERVE_BATCH": "2", "SERVE_DTYPE": "float32"}
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _port(env):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        return tjob.run_serving(dict(env, SERVE_DEVICE="cpu"))


def _jax(env):
    return jjob.run_serving(dict(env, SERVE_MESH="tensor=1"))


def _programs(stderr: str) -> tuple[dict, dict]:
    line = re.search(r"generate program: captures (\{.*\}), replays "
                     r"(\{.*\})", stderr)
    assert line, stderr
    return ast.literal_eval(line.group(1)), ast.literal_eval(line.group(2))


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_greedy_completions_equal_jax_line_by_line(tmp_path, prompts_file,
                                                   batch, capsys):
    """Identical completions and output files; one capture for the file
    and a replay for every later batch."""
    env = _env(prompts_file, tmp_path / "t.txt", SERVE_BATCH=batch)
    got = _port(env)
    capsys.readouterr()
    want = _jax(dict(env, SERVE_OUT=str(tmp_path / "j.txt")))
    assert got == want
    assert (tmp_path / "t.txt").read_bytes() == \
        (tmp_path / "j.txt").read_bytes()
    got = _port(env)
    captures, replays = _programs(capsys.readouterr().err)
    batches = -(-len(PROMPTS) // batch)
    width = max(len(p.encode()) for p in PROMPTS)
    key = ("generate", batch, width, width + 6, 6, "greedy")
    assert captures == {key: 1}
    assert replays == ({key: batches - 1} if batches > 1 else {})


def _eager_ids(env, batch, generator=None, **knobs) -> list:
    """The job's batches through ``generate``'s eager loop, one generator
    for the whole file → every prompt's token ids."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tjob, "init_params", _jax_weights)
        params, cfg, encode, _ = tjob.load_serving_stack(
            dict(env, SERVE_DEVICE="cpu"))
    rows = [encode(p) for p in PROMPTS]
    width = max(map(len, rows))
    ids = []
    for start in range(0, len(rows), batch):
        part = rows[start:start + batch]
        n = len(part)
        part += [part[-1]] * (batch - n)
        padded = torch.zeros((batch, width), dtype=torch.int32)
        for i, r in enumerate(part):
            padded[i, :len(r)] = torch.tensor(r)
        out = tdec.generate(params, padded, cfg, 6, generator=generator,
                            prompt_lengths=torch.tensor(
                                [len(r) for r in part], dtype=torch.int32),
                            **knobs)
        ids += out[:n].tolist()
    return ids


def test_eos_id_trims_like_jax(tmp_path, prompts_file):
    """With SERVE_EOS_ID every completion stops before the first EOS, as
    JAX's; the EOS is the third token of the first prompt's free-running
    greedy output."""
    env = _env(prompts_file, tmp_path / "t.txt")
    eos = _eager_ids(env, 2)[0][2]
    got = _port(dict(env, SERVE_EOS_ID=eos))
    assert got == _jax(dict(env, SERVE_EOS_ID=eos,
                            SERVE_OUT=str(tmp_path / "j.txt")))
    assert got[0] == bytes(_eager_ids(env, 2)[0][:2]).decode(
        "utf-8", errors="replace")


def test_pinned_cache_span_equals_jax(tmp_path, prompts_file, capsys):
    env = _env(prompts_file, tmp_path / "t.txt", SERVE_CACHE_SPAN="64",
               SERVE_BATCH="4")
    got = _port(env)
    captures, _ = _programs(capsys.readouterr().err)
    assert list(captures)[0][3] == 64
    assert got == _jax(dict(env, SERVE_OUT=str(tmp_path / "j.txt")))


def test_sampled_output_is_the_eager_loop_seeded_once(tmp_path,
                                                      prompts_file):
    """Sampled: the same SERVE_SEED gives the same file, another seed
    another one, and the completions are ``generate``'s eager loop with
    ONE generator seeded once, its draws carrying on across batches."""
    knobs = dict(SERVE_TEMPERATURE="0.8", SERVE_TOP_K="40",
                 SERVE_TOP_P="0.9", SERVE_SEED="5", SERVE_BATCH="4")
    env = _env(prompts_file, tmp_path / "a.txt", **knobs)
    first = _port(env)
    assert _port(dict(env, SERVE_OUT=str(tmp_path / "b.txt"))) == first
    assert (tmp_path / "a.txt").read_bytes() == \
        (tmp_path / "b.txt").read_bytes()
    assert _port(dict(env, SERVE_SEED="6")) != first
    want = _eager_ids(env, 4, torch.Generator().manual_seed(5),
                      temperature=0.8, top_k=40, top_p=0.9)
    assert first == [bytes(r).decode("utf-8", errors="replace")
                     for r in want]


def test_empty_prompt_line_rejected(tmp_path):
    p = tmp_path / "p.txt"
    p.write_text("fine\n\nalso fine\n")
    with pytest.raises(SystemExit, match="empty prompt line"):
        _port(_env(p, tmp_path / "o.txt"))


def test_overlong_prompt_rejected(tmp_path):
    p = tmp_path / "p.txt"
    p.write_text("x" * 500 + "\n")      # llama-test max_seq = 128
    with pytest.raises(SystemExit, match="max_seq"):
        _port(_env(p, tmp_path / "o.txt"))


def test_missing_or_empty_prompts_rejected(tmp_path):
    with pytest.raises(SystemExit, match="SERVE_PROMPTS"):
        tjob.run_serving({"SERVE_MODEL": "llama-test", "SERVE_DEVICE": "cpu"})
    p = tmp_path / "p.txt"
    p.write_text("")
    with pytest.raises(SystemExit, match="holds no prompts"):
        _port(_env(p, tmp_path / "o.txt"))


# the knobs queue 1 item 3.4 (speculation) brought: served now
SPEC_KNOBS = {"SERVE_PROMPT_LOOKUP", "SERVE_DRAFT_MODEL", "SERVE_DRAFT_K",
              "SERVE_NGRAM"}


@pytest.mark.parametrize("name, value, item", [
    ("SERVE_PROMPT_LOOKUP", "1", "item 3.4"),
    ("SERVE_DRAFT_MODEL", "llama-test", "item 3.4"),
    # served since the HF conversion (item 6): the job runs on a draft
    # checkpoint written here; the id keeps the item it had
    pytest.param("SERVE_DRAFT_HF_CHECKPOINT", "/tmp/draft", "item 6",
                 id="SERVE_DRAFT_HF_CHECKPOINT-/tmp/draft-item 3.4"),
    ("SERVE_DRAFT_K", "3", "item 3.4"),
    ("SERVE_NGRAM", "3", "item 3.4"),
    # item 7 was split: sharded serving is item 7c, whose batch-job half
    # (7c.1) serves both now; the ids keep the item they had
    pytest.param("SERVE_MESH", "tensor=2", "item 7c",
                 id="SERVE_MESH-tensor=2-item 7"),
    pytest.param("JAX_NUM_PROCESSES", "2", "item 7c",
                 id="JAX_NUM_PROCESSES-2-item 7"),
])
def test_later_knobs_refused_by_name_with_their_item(tmp_path, prompts_file,
                                                     name, value, item):
    """Each knob past the plain path was refused by name with the item
    that brings it; all are served now: the job runs. The four item 3.4
    brought, the HF draft of item 6, and the mesh and the multi-host
    contract of item 7c.1 (``SERVE_MESH=tensor=2``: two gloo workers;
    ``JAX_NUM_PROCESSES=2``: this process and a second job process on a
    localhost coordinator)."""
    assert item in ("item 3.4", "item 6", "item 7c")
    assert not hasattr(tjob, "LATER_JOB_KNOBS")
    if name == "SERVE_DRAFT_HF_CHECKPOINT":
        from tpu_kubernetes_torch.models import (
        CONFIGS,
        export_hf_llama,
        init_params,
    )

        cfg = CONFIGS["llama-test"]
        value = str(tmp_path / "draft")
        export_hf_llama(init_params(cfg, torch.Generator().manual_seed(1),
                                    "cpu"), cfg, value)
    env = _env(prompts_file, tmp_path / "o.txt", **{name: value})
    if name == "JAX_NUM_PROCESSES":
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(env, JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}")
        other = subprocess.Popen(
            [sys.executable, "-m", "tpu_kubernetes_torch.serve.job"],
            cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
            text=True, env={**os.environ, **env, "SERVE_DEVICE": "cpu",
                            "JAX_PROCESS_ID": "1",
                            "SERVE_OUT": str(tmp_path / "o1.txt")})
        try:
            out = _port(dict(env, JAX_PROCESS_ID="0"))
            assert other.wait(timeout=120) == 0, other.stderr.read()
        finally:
            if other.poll() is None:
                other.kill()
            other.communicate()
        assert not (tmp_path / "o1.txt").exists()     # process 0 writes
    else:
        out = _port(env)
    assert len(out) == len(PROMPTS)


def test_falsy_knobs_are_not_refused(tmp_path, prompts_file):
    """SERVE_PROMPT_LOOKUP=0 (and the other knobs at their reference
    defaults) leave the plain path on, as in the reference."""
    out = _port(_env(prompts_file, tmp_path / "o.txt",
                     SERVE_PROMPT_LOOKUP="0", SERVE_KV_QUANT="false",
                     SERVE_DRAFT_K="4", JAX_NUM_PROCESSES="1",
                     SERVE_TEMPERATURE="0.7"))
    assert len(out) == len(PROMPTS)


def test_cli_subprocess_on_the_cpu(tmp_path, prompts_file):
    out = tmp_path / "out.txt"
    env = {**os.environ, **_env(prompts_file, out), "SERVE_DEVICE": "cpu"}
    r = subprocess.run(
        [sys.executable, "-m", "tpu_kubernetes_torch.serve.job"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert len(out.read_text().splitlines()) == len(PROMPTS)
    assert "tok/s" in r.stderr
    assert "RuntimeWarning" not in r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "tpu_kubernetes_torch.serve.job"],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env={**env, "SERVE_DEVICE": "", "SERVE_OUT": "-"})
    if not torch.cuda.is_available():
        assert r.returncode != 0
        assert "SERVE_DEVICE" in r.stderr
