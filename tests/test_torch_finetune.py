"""The port's finetune job (``train/finetune.py``) and the model lifecycle
through it, on the CPU: the reference's ``tests/test_finetune_job.py``
and ``tests/test_finetune_flow.py`` against the port (a pretrained
checkpoint → LoRA → merge → int8 → serve → export), serving from HF
checkpoints (SERVE_HF_CHECKPOINT, through ``run_serving`` and the
server, equal to the JAX package's batch job on the same checkpoint),
and a SERVE_DRAFT_HF_CHECKPOINT draft against the same draft by preset."""

import os
import re
import subprocess
import sys
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch
from transformers import LlamaConfig, LlamaForCausalLM

from tpu_kubernetes.serve import job as jjob
from tpu_kubernetes.train.corpus import build_shards
from tpu_kubernetes_torch.models import (
    CONFIGS,
    export_hf_llama,
    forward,
    generate,
    init_params,
    load_hf,
)
from tpu_kubernetes_torch.models.quant import quantize_for_decode
from tpu_kubernetes_torch.serve import job as tjob
from tpu_kubernetes_torch.serve import server as tserver
from tpu_kubernetes_torch.train.checkpoint import restore
from tpu_kubernetes_torch.train.data import TokenDataset
from tpu_kubernetes_torch.train.finetune import run_finetune
from tpu_kubernetes_torch.train.lora import (
    LoraConfig,
    init_lora_state,
    make_lora_step,
    merge_lora,
)
from tpu_kubernetes_torch.train.trainer import tree_leaves
from tests.torch_ops_support import keep_jax_ledger  # noqa: F401 — autouse
from tests.torch_ops_support import black_box_dirs  # noqa: F401 — autouse

ROOT = Path(__file__).resolve().parent.parent
FT = {"FT_DEVICE": "cpu", "FT_MODEL": "llama-test"}


def test_requires_out_dir():
    with pytest.raises(SystemExit, match="FT_OUT"):
        run_finetune(dict(FT))


@pytest.mark.parametrize("extra,match", [
    ({"FT_MESH": "fsdp=4"}, r"queue 1 item 7"),
    ({"FT_MODEL": "llama-3000"}, "unknown FT_MODEL"),
])
def test_refusals(extra, match):
    with pytest.raises(SystemExit, match=match):
        run_finetune({**FT, "FT_OUT": "/tmp/never", **extra})


def test_smoke_run_produces_loadable_merged_weights(tmp_path, capsys):
    out = tmp_path / "merged"
    got = run_finetune({**FT, "FT_STEPS": "3", "FT_BATCH": "4",
                        "FT_SEQ": "32", "FT_RANK": "2", "FT_OUT": str(out),
                        "FT_MESH": "data=1"})
    err = capsys.readouterr().err
    assert "FIRST FINETUNE STEP" in err and "step 3/3 loss=" in err
    assert len(got["losses"]) == 3 and got["step_s"] > 0
    cfg = CONFIGS["llama-test"]
    like = {"params": init_params(cfg, torch.Generator().manual_seed(0),
                                  "cpu")}
    base = {k: v.clone() for k, v in like["params"]["layers"].items()}
    restored = restore(out, like=like)
    layers = restored["params"]["layers"]
    # the merged weights differ from the base on the adapted leaves only
    for name in ("wq", "wk", "wv", "wo"):
        assert not torch.equal(layers[name], base[name]), name
    for name in ("w_gate", "w_up", "w_down", "attn_norm", "mlp_norm"):
        assert torch.equal(layers[name], base[name]), name


def test_graphed_job_losses_are_the_eager_steps(tmp_path):
    """The job's losses are make_lora_step's, eager, from the same seeds
    and synthetic batches."""
    got = run_finetune({**FT, "FT_STEPS": "3", "FT_BATCH": "2",
                        "FT_SEQ": "16", "FT_OUT": str(tmp_path)})
    from tpu_kubernetes_torch.train.trainer import synthetic_batches

    cfg = CONFIGS["llama-test"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    lc = LoraConfig()
    state = init_lora_state(torch.Generator().manual_seed(1), params, cfg,
                            lc)
    step = make_lora_step(cfg, lc, state, params, (2, 17), graphs=False)
    batches = synthetic_batches(cfg.vocab_size, 2, 16, device="cpu")
    assert [step(next(batches)).item() for _ in range(3)] == got["losses"]


def test_cli_subprocess_with_hf_export(tmp_path):
    out, export = tmp_path / "merged", tmp_path / "hf"
    env = {**os.environ, **FT, "FT_STEPS": "2", "FT_BATCH": "4",
           "FT_SEQ": "32", "FT_RANK": "2", "FT_OUT": str(out),
           "FT_EXPORT_HF": str(export)}
    r = subprocess.run(
        [sys.executable, "-m", "tpu_kubernetes_torch.train.finetune"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "FIRST FINETUNE STEP" in r.stderr
    model = LlamaForCausalLM.from_pretrained(str(export))
    assert model.config.vocab_size == 256
    # the export is the merged checkpoint's weights
    merged = restore(out, like={"params": init_params(
        CONFIGS["llama-test"], torch.Generator().manual_seed(5), "cpu")})
    params, _ = load_hf(str(export), device="cpu")
    for a, b in zip(tree_leaves(merged["params"]), tree_leaves(params)):
        assert torch.equal(a, b)


def test_moe_hf_export_rejected_before_training():
    with pytest.raises(SystemExit, match="dense family"):
        run_finetune({**FT, "FT_MODEL": "moe-test", "FT_STEPS": "100000",
                      "FT_OUT": "/tmp/never", "FT_EXPORT_HF": "/tmp/never-hf"})


def test_finetune_from_an_hf_checkpoint_on_token_files(tmp_path, capsys):
    hf = _pretrained()
    hf.save_pretrained(str(tmp_path / "pretrained"))
    shards = _shards(tmp_path)
    run_finetune({"FT_DEVICE": "cpu", "FT_STEPS": "2", "FT_SEQ": "32",
                  "FT_HF_CHECKPOINT": str(tmp_path / "pretrained"),
                  "FT_DATA_PATH": str(shards), "FT_OUT": str(tmp_path / "o")})
    err = capsys.readouterr().err
    assert f"base: HF checkpoint {tmp_path / 'pretrained'}" in err
    assert f"data: {shards}" in err


# -- the lifecycle (tests/test_finetune_flow.py) ------------------------------

def _pretrained():
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=128, tie_word_embeddings=False,
    )).eval()


def _shards(tmp_path):
    text = tmp_path / "corpus.txt"
    text.write_text("the rings of ici carry the collectives\n" * 40)
    shards = tmp_path / "shards"
    build_shards([text], shards)
    return shards


def test_pretrained_to_served_lifecycle(tmp_path):
    # 1. a "pretrained" model arrives as a transformers checkpoint
    ckpt = tmp_path / "pretrained"
    _pretrained().save_pretrained(str(ckpt))
    params, cfg = load_hf(str(ckpt), dtype=torch.float32, device="cpu")

    # 2. corpus → token shards → training windows
    ds = TokenDataset(_shards(tmp_path), seq=32, vocab_size=cfg.vocab_size)
    batch = torch.from_numpy(np.stack([ds.sequence(i) for i in range(4)]))

    # 3. LoRA-finetune the frozen base on that corpus
    lc = LoraConfig(rank=4)
    state = init_lora_state(torch.Generator().manual_seed(1), params, cfg,
                            lc, learning_rate=5e-3)
    step = make_lora_step(cfg, lc, state, params, tuple(batch.shape),
                          learning_rate=5e-3)
    first = step(batch).item()
    for _ in range(6):
        loss = step(batch).item()
    assert loss < first   # it learned the corpus

    # 4. merge and quantize for serving
    merged = merge_lora(params, state["adapters"], lc)
    qmerged = quantize_for_decode(merged, cfg)
    prompt = torch.tensor([list(b"the rings")], dtype=torch.int32)
    out = generate(qmerged, prompt, cfg, max_new_tokens=8)
    assert out.shape == (1, 8)

    # 5. the serving entry point serves the merged weights end to end,
    #    through its HF-checkpoint path, as the JAX package's does
    served = tmp_path / "finetuned"
    export_hf_llama(merged, cfg, served, torch_dtype=torch.float32)
    prompts = tmp_path / "prompts.txt"
    prompts.write_text("the rings\nof ici\n")
    env = {"SERVE_HF_CHECKPOINT": str(served), "SERVE_PROMPTS": str(prompts),
           "SERVE_OUT": str(tmp_path / "completions.txt"),
           "SERVE_MAX_NEW": "6", "SERVE_BATCH": "2",
           "SERVE_DTYPE": "float32"}
    completions = tjob.run_serving({**env, "SERVE_DEVICE": "cpu"})
    assert len(completions) == 2
    assert completions == jjob.run_serving(
        {**env, "SERVE_OUT": str(tmp_path / "jax.txt")})

    # 6. and the exported checkpoint is a real transformers model
    reloaded = LlamaForCausalLM.from_pretrained(str(served))
    tokens = np.random.default_rng(0).integers(0, 256, (1, 9))
    with torch.no_grad():
        theirs = reloaded(torch.tensor(tokens)).logits.numpy()
        ours = forward(merged, torch.tensor(tokens), cfg).numpy()
    np.testing.assert_allclose(ours, theirs, atol=2e-3, rtol=2e-2)


def test_server_serves_an_hf_checkpoint(tmp_path):
    """SERVE_HF_CHECKPOINT through the server's bring-up: the weights are
    the checkpoint's (bf16 by default), and a greedy completion equals the
    batch job's on the same checkpoint."""
    ckpt = tmp_path / "pretrained"
    _pretrained().save_pretrained(str(ckpt))
    env = {"SERVE_HF_CHECKPOINT": str(ckpt), "SERVE_DEVICE": "cpu",
           "SERVE_MAX_NEW": "6", "SERVE_DTYPE": "float32"}
    st = tserver.ServingState(dict(env))
    want, _ = load_hf(str(ckpt), device="cpu")
    for a, b in zip(tree_leaves(want), tree_leaves(st.params)):
        assert torch.equal(a.float(), b)
    prompts = tmp_path / "p.txt"
    prompts.write_text("the rings\n")
    job = tjob.run_serving({**env, "SERVE_PROMPTS": str(prompts),
                            "SERVE_OUT": str(tmp_path / "o.txt"),
                            "SERVE_BATCH": "1"})
    assert st.complete("the rings", max_new_tokens=6)["text"] == job[0]


def test_an_unreadable_hf_checkpoint_is_refused_by_name(tmp_path):
    with pytest.raises(SystemExit, match="SERVE_HF_CHECKPOINT="):
        tjob.load_serving_stack({"SERVE_HF_CHECKPOINT": str(tmp_path / "no"),
                                 "SERVE_DEVICE": "cpu"})


# -- the draft (SERVE_DRAFT_HF_CHECKPOINT) ------------------------------------

@pytest.fixture()
def preset_draft(tmp_path):
    """The SERVE_DRAFT_MODEL=llama-test draft's own weights (seed 1),
    exported as an HF checkpoint."""
    cfg = CONFIGS["llama-test"]
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    export_hf_llama(params, cfg, tmp_path / "draft")
    return tmp_path / "draft"


def test_hf_draft_is_the_preset_draft_in_run_serving(tmp_path, capsys,
                                                     preset_draft):
    """The same completions and the same acceptance as the preset draft:
    the draft loaded from its checkpoint is the same model."""
    prompts = tmp_path / "p.txt"
    prompts.write_text("the rings of ici\nabcabcabcabc\n")
    env = {"SERVE_DEVICE": "cpu", "SERVE_PROMPTS": str(prompts),
           "SERVE_MAX_NEW": "12", "SERVE_DRAFT_K": "3",
           "SERVE_DTYPE": "float32", "SERVE_OUT": str(tmp_path / "o.txt")}
    by_preset = tjob.run_serving({**env, "SERVE_DRAFT_MODEL": "llama-test"})
    preset_log = capsys.readouterr().err
    by_hf = tjob.run_serving({**env,
                              "SERVE_DRAFT_HF_CHECKPOINT": str(preset_draft)})
    hf_log = capsys.readouterr().err
    assert f"draft: HF checkpoint {preset_draft}" in hf_log
    assert by_hf == by_preset

    def accepted(log):
        return re.search(r"speculative: k=3, accepted (\d+/\d+)",
                         log).group(1)

    assert accepted(hf_log) == accepted(preset_log)


def test_hf_draft_in_the_server(preset_draft):
    """The slot engine's proposer from SERVE_DRAFT_HF_CHECKPOINT: the same
    draft weights as the preset's, in the target's dtype; a draft of
    another vocab is refused after its load, by the preset's rule."""
    base = {"SERVE_DEVICE": "cpu", "SERVE_MODEL": "llama-test",
            "SERVE_DTYPE": "float32", "SERVE_CONTINUOUS_BATCHING": "1",
            "SERVE_DRAFT_K": "3"}
    st = tserver.ServingState(dict(
        base, SERVE_DRAFT_HF_CHECKPOINT=str(preset_draft)))
    ref = tserver.ServingState(dict(base, SERVE_DRAFT_MODEL="llama-test"))
    try:
        assert st.spec_source == "draft" == ref.spec_source
        # an imported config keeps ModelConfig's remat default, as the
        # reference's config_from_hf does; the preset turns it off
        assert replace(st.draft.cfg, remat=False) == ref.draft.cfg
        assert st.draft.cfg.dtype == torch.float32
        for a, b in zip(tree_leaves(st.draft.params),
                        tree_leaves(ref.draft.params)):
            assert torch.equal(a, b)
        out = st.complete("the rings of ici", max_new_tokens=8)
        assert out["text"] == ref.complete("the rings of ici",
                                           max_new_tokens=8)["text"]
    finally:
        st._engine.close()
        ref._engine.close()


def test_hf_draft_of_another_vocab_is_refused(tmp_path):
    cfg = replace(CONFIGS["llama-test"], vocab_size=512)
    params = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    export_hf_llama(params, cfg, tmp_path / "draft")
    base = {"SERVE_DEVICE": "cpu", "SERVE_MODEL": "llama-test",
            "SERVE_CONTINUOUS_BATCHING": "1",
            "SERVE_DRAFT_HF_CHECKPOINT": str(tmp_path / "draft")}
    with pytest.raises(ValueError, match="draft vocab 512 != target vocab"):
        tserver.ServingState(base)
    prompts = tmp_path / "p.txt"
    prompts.write_text("abc\n")
    with pytest.raises(SystemExit, match="draft vocab 512 != target vocab"):
        tjob.run_serving({**base, "SERVE_PROMPTS": str(prompts)})
