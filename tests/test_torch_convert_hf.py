"""The port's HF interop (``models/convert_hf.py``) against the JAX
package's and against ``transformers``: the import of a code-built Llama
and Mixtral is bit for bit the JAX package's (f32 and bf16), the logits
and greedy tokens match ``transformers``, ``hf_state_dict_from_params``
inverts the import exactly, and the reference's ``test_convert_hf.py``
cases (the guards, tied embeddings, truncation, export) run on the port.
Nothing is fetched: every model is built from a config written here."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers
from transformers import LlamaConfig, LlamaForCausalLM

from tpu_kubernetes.models import convert_hf as jconv
from tpu_kubernetes_torch.models import CONFIGS, forward, generate
from tpu_kubernetes_torch.models import convert_hf as tconv
from tpu_kubernetes_torch.models import init_params, param_count
from tpu_kubernetes_torch.train.trainer import tree_leaves

# f32 logits against transformers' forward: summation order and the two
# RoPE table constructions (the reference's own bound,
# tests/test_convert_hf.py)
LOGIT_TOL = dict(atol=2e-4, rtol=2e-3)
MOE_LOGIT_TOL = dict(atol=3e-4, rtol=3e-3)


def _llama(**over):
    torch.manual_seed(0)
    return LlamaForCausalLM(LlamaConfig(**{
        "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
        "num_hidden_layers": 2, "num_attention_heads": 4,
        "num_key_value_heads": 2, "max_position_embeddings": 128,
        "tie_word_embeddings": False, "attention_bias": False,
        **over})).eval()


@pytest.fixture(scope="module")
def hf_model():
    return _llama()


@pytest.fixture(scope="module")
def hf_moe():
    from transformers import MixtralConfig, MixtralForCausalLM

    torch.manual_seed(1)
    return MixtralForCausalLM(MixtralConfig(
        vocab_size=256, hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=128, tie_word_embeddings=False,
    )).eval()


def _same_as_jax(ours: dict, theirs: dict) -> None:
    """Every leaf of the JAX package's tree, as numpy, equals the port's
    bit for bit, and the port has no other leaf."""
    paths = jax.tree_util.tree_leaves_with_path(theirs)
    assert len(paths) == len(tree_leaves(ours))
    for path, leaf in paths:
        got = ours
        for key in path:
            got = got[key.key]
        ref = np.asarray(leaf)
        assert str(got.dtype).removeprefix("torch.") == ref.dtype.name
        np.testing.assert_array_equal(got.float().numpy(),
                                      ref.astype(np.float32),
                                      err_msg=jax.tree_util.keystr(path))


def _jdtype(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_llama_import_is_the_jax_packages_bit_for_bit(hf_model, dtype):
    params, cfg = tconv.load_hf(hf_model, dtype=dtype, device="cpu")
    jparams, jcfg = jconv.load_hf(hf_model, dtype=_jdtype(dtype))
    _same_as_jax(params, jparams)
    for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                  "n_kv_heads", "d_ff", "max_seq", "rope_theta", "norm_eps"):
        assert getattr(cfg, field) == getattr(jcfg, field), field
    assert cfg.dtype == dtype


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mixtral_import_is_the_jax_packages_bit_for_bit(hf_moe, dtype):
    params, cfg = tconv.load_hf(hf_moe, dtype=dtype, device="cpu")
    jparams, jcfg = jconv.load_hf(hf_moe, dtype=_jdtype(dtype))
    _same_as_jax(params, jparams)
    assert params["layers"]["w_router"].dtype == torch.float32
    assert (cfg.n_experts, cfg.experts_per_token, cfg.capacity_factor) == (
        jcfg.n_experts, jcfg.experts_per_token, jcfg.capacity_factor)


def test_the_import_shares_no_storage_with_the_checkpoint(hf_model):
    params, _ = tconv.load_hf(hf_model, dtype=torch.float32, device="cpu")
    theirs = {t.untyped_storage().data_ptr()
              for t in hf_model.state_dict().values()}
    assert not theirs & {t.untyped_storage().data_ptr()
                         for t in tree_leaves(params)}


def test_config_mapping(hf_model):
    cfg = tconv.config_from_hf(hf_model.config, dtype=torch.float32)
    assert (cfg.vocab_size, cfg.d_model, cfg.n_layers) == (256, 64, 2)
    assert (cfg.n_heads, cfg.n_kv_heads, cfg.d_ff) == (4, 2, 128)


def test_logit_parity_with_transformers(hf_model):
    params, cfg = tconv.load_hf_llama(hf_model, dtype=torch.float32,
                                      device="cpu")
    assert param_count(params) == sum(p.numel()
                                      for p in hf_model.parameters())
    tokens = np.random.default_rng(0).integers(0, 256, (2, 17))
    with torch.no_grad():
        ref = hf_model(torch.tensor(tokens)).logits.numpy()
        got = forward(params, torch.tensor(tokens), cfg).numpy()
    np.testing.assert_allclose(got, ref, **LOGIT_TOL)


def test_greedy_generation_matches_transformers(hf_model):
    params, cfg = tconv.load_hf_llama(hf_model, dtype=torch.float32,
                                      device="cpu")
    prompt = np.random.default_rng(1).integers(0, 256, (1, 8))
    with torch.no_grad():
        ref = hf_model.generate(
            torch.tensor(prompt), max_new_tokens=6, do_sample=False,
            pad_token_id=0).numpy()[:, 8:]
    got = generate(params, torch.tensor(prompt, dtype=torch.int32), cfg,
                   max_new_tokens=6)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mixtral_logit_parity_with_transformers(hf_moe):
    params, cfg = tconv.load_hf(hf_moe, dtype=torch.float32, device="cpu")
    assert cfg.capacity_factor == float(cfg.n_experts)   # dropless
    tokens = np.random.default_rng(2).integers(0, 256, (2, 15))
    with torch.no_grad():
        ref = hf_moe(torch.tensor(tokens)).logits.numpy()
        got = forward(params, torch.tensor(tokens), cfg).numpy()
    np.testing.assert_allclose(got, ref, **MOE_LOGIT_TOL)


def test_tied_embeddings_fall_back_to_embed(hf_model):
    sd = {k: v for k, v in hf_model.state_dict().items()
          if k != "lm_head.weight"}
    cfg = tconv.config_from_hf(hf_model.config, dtype=torch.float32)
    params = tconv.params_from_hf_state_dict(sd, cfg, device="cpu")
    assert torch.equal(params["lm_head"], params["embed"].T)
    assert params["lm_head"].is_contiguous()
    jparams = jconv.params_from_hf_state_dict(
        sd, jconv.config_from_hf(hf_model.config, dtype=jnp.float32))
    _same_as_jax(params, jparams)


def test_truncated_checkpoint_rejected(hf_model):
    sd = dict(hf_model.state_dict())
    del sd["model.layers.1.mlp.up_proj.weight"]
    cfg = tconv.config_from_hf(hf_model.config, dtype=torch.float32)
    with pytest.raises(tconv.ConvertError, match="missing"):
        tconv.params_from_hf_state_dict(sd, cfg, device="cpu")


@pytest.mark.parametrize("over,match", [
    (dict(rope_scaling={"rope_type": "linear", "factor": 2.0}),
     "rope_scaling"),
    (dict(attention_bias=True), "attention_bias"),
])
def test_unrepresentable_llama_configs_refused(over, match):
    cfg = LlamaConfig(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      max_position_embeddings=128, **over)
    with pytest.raises(tconv.ConvertError, match=match):
        tconv.config_from_hf(cfg)
    with pytest.raises(jconv.ConvertError, match=match):
        jconv.config_from_hf(cfg)


def test_llama_alias_rejects_moe(hf_moe):
    with pytest.raises(tconv.ConvertError, match="use load_hf"):
        tconv.load_hf_llama(hf_moe, dtype=torch.float32, device="cpu")


def test_sliding_window_refused(hf_moe):
    cfg = hf_moe.config
    cfg.sliding_window = 64  # < max_position_embeddings=128
    try:
        with pytest.raises(tconv.ConvertError, match="sliding_window"):
            tconv.moe_config_from_hf(cfg, dtype=torch.float32)
    finally:
        cfg.sliding_window = None


def test_unsupported_model_type_refused(hf_model):
    class Other:
        config = type("C", (), {"model_type": "gpt2"})()

    with pytest.raises(tconv.ConvertError, match="unsupported model_type"):
        tconv.load_hf(Other(), device="cpu")


# -- export -------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_state_dict_mapping_inverts_the_import_exactly(hf_model, dtype):
    """import → hf_state_dict_from_params → import gives the same tree bit
    for bit, without transformers; the state dict has the checkpoint's keys
    and shapes and the tree's dtype."""
    params, cfg = tconv.load_hf(hf_model, dtype=dtype, device="cpu")
    sd = tconv.hf_state_dict_from_params(params, cfg)
    theirs = hf_model.state_dict()
    assert set(sd) == set(theirs)
    for k, v in sd.items():
        assert v.shape == theirs[k].shape and v.dtype == dtype
        assert v.is_contiguous()
    again = tconv.params_from_hf_state_dict(sd, cfg, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    if dtype == torch.float32:   # f32 end to end: the checkpoint's own bits
        for k, v in sd.items():
            assert torch.equal(v, theirs[k]), k


def test_state_dict_of_a_random_preset_round_trips():
    cfg = CONFIGS["llama-test"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    again = tconv.params_from_hf_state_dict(
        tconv.hf_state_dict_from_params(params, cfg), cfg, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(again)):
        assert a.dtype == b.dtype == torch.bfloat16 and torch.equal(a, b)


def test_round_trip_is_exact(hf_model):
    """import → export → import reproduces the tree bit for bit."""
    params, cfg = tconv.load_hf(hf_model, dtype=torch.float32, device="cpu")
    exported = tconv.export_hf_llama(params, cfg)
    params2, cfg2 = tconv.load_hf(exported, dtype=torch.float32,
                                  device="cpu")
    assert cfg2 == cfg
    for a, b in zip(tree_leaves(params), tree_leaves(params2)):
        assert torch.equal(a, b)


def test_exported_model_matches_our_forward(hf_model):
    params, cfg = tconv.load_hf(hf_model, dtype=torch.float32, device="cpu")
    exported = tconv.export_hf_llama(params, cfg)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 11))
    with torch.no_grad():
        theirs = exported(torch.tensor(tokens)).logits.numpy()
        ours = forward(params, torch.tensor(tokens), cfg).numpy()
    np.testing.assert_allclose(ours, theirs, **LOGIT_TOL)


def test_save_to_disk_and_reload(hf_model, tmp_path):
    """export to a directory, load_hf of the path (local files only): the
    same tree, and the JAX package's load of that path is the same bits."""
    params, cfg = tconv.load_hf(hf_model, dtype=torch.float32, device="cpu")
    tconv.export_hf_llama(params, cfg, tmp_path / "ckpt")
    params2, _ = tconv.load_hf(str(tmp_path / "ckpt"), dtype=torch.float32,
                               device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(params2)):
        assert torch.equal(a, b)
    jparams, _ = jconv.load_hf(str(tmp_path / "ckpt"), dtype=jnp.float32)
    _same_as_jax(params2, jparams)


def test_bf16_export_keeps_the_trees_dtype(hf_model):
    params, cfg = tconv.load_hf(hf_model, device="cpu")     # bf16 default
    exported = tconv.export_hf_llama(params, cfg)
    assert exported.model.embed_tokens.weight.dtype == torch.bfloat16
    params2, _ = tconv.load_hf(exported, device="cpu")
    for a, b in zip(tree_leaves(params), tree_leaves(params2)):
        assert torch.equal(a, b)


def test_moe_export_rejected():
    cfg = CONFIGS["moe-test"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(tconv.ConvertError, match="dense"):
        tconv.export_hf_llama(params, cfg)
    with pytest.raises(tconv.ConvertError, match="dense"):
        tconv.hf_state_dict_from_params(params, cfg)


def test_load_of_a_path_without_transformers_names_the_package(
        monkeypatch, tmp_path):
    """Where transformers is not installed (the card), load_hf of a path
    raises naming the package and falls back to nothing; the mappings still
    run."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(tconv.ConvertError, match="`transformers` package"):
        tconv.load_hf(str(tmp_path), device="cpu")
    with pytest.raises(tconv.ConvertError, match="`transformers` package"):
        tconv.export_hf_llama({"embed": torch.zeros(1)}, CONFIGS["llama-test"])
    cfg = CONFIGS["llama-test"]
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert tconv.params_from_hf_state_dict(
        tconv.hf_state_dict_from_params(params, cfg), cfg,
        device="cpu")["embed"].shape == params["embed"].shape
    assert transformers.__name__ == "transformers"   # restored after
