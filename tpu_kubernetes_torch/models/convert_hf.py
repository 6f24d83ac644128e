"""Hugging Face checkpoints ↔ the port's param trees (port of
``tpu_kubernetes/models/convert_hf.py``).

``transformers`` **Llama** (dense) and **Mixtral** (MoE) state dicts map
1:1 onto ``models/llama.py``'s and ``models/moe.py``'s trees: HF's
``nn.Linear`` stores ``(out, in)`` and the port ``(in, out)``, so every
matmul weight transposes; per-layer tensors stack on a leading layer
axis, and Mixtral's experts on an expert axis (HF's w1/w3/w2 are
gate/up/down). What the models cannot represent (``rope_scaling``,
attention bias, a sliding window shorter than the context) is refused.

The mappings are pure functions of torch tensors, with no
``transformers`` import, so they run where that package is absent (the
card):

* :func:`params_from_hf_state_dict` / :func:`params_from_hf_mixtral_state_dict`
  take a state dict of tensors and go through f32 as the reference's
  ``_np`` does, so a bf16 leaf is bit for bit the reference's;
* :func:`hf_state_dict_from_params` is the export's mapping, the exact
  inverse of the dense import.

:func:`load_hf` / :func:`load_hf_llama` take a live ``transformers``
model or a LOCAL checkpoint directory (``local_files_only=True``: nothing
is fetched), and :func:`export_hf_llama` builds the ``transformers``
model; these three need the ``transformers`` package and raise
:class:`ConvertError` naming it when it is not installed.
"""

from __future__ import annotations

import os
from typing import Any, Callable, Mapping

import torch

from tpu_kubernetes_torch.models.llama import ModelConfig
from tpu_kubernetes_torch.models.moe import MoEConfig


class ConvertError(Exception):
    pass


def _shared_config_fields(hf_config: Any, dtype: torch.dtype) -> dict:
    """The backbone fields both families share, with the guards against
    what the models cannot represent."""
    if getattr(hf_config, "rope_scaling", None):
        raise ConvertError(
            "rope_scaling is set (Llama 3.1+ style NTK/linear scaling); "
            "the in-tree models implement plain RoPE only"
        )
    if getattr(hf_config, "attention_bias", False):
        raise ConvertError(
            "attention_bias=True checkpoints carry q/k/v/o bias tensors "
            "the in-tree models have no slot for"
        )
    window = getattr(hf_config, "sliding_window", None)
    if window and window < hf_config.max_position_embeddings:
        raise ConvertError(
            f"sliding_window={window} < max_position_embeddings="
            f"{hf_config.max_position_embeddings}: the in-tree models are "
            "full-causal, logits would silently diverge past the window"
        )
    return dict(
        vocab_size=hf_config.vocab_size,
        d_model=hf_config.hidden_size,
        n_layers=hf_config.num_hidden_layers,
        n_heads=hf_config.num_attention_heads,
        n_kv_heads=getattr(
            hf_config, "num_key_value_heads", hf_config.num_attention_heads
        ),
        d_ff=hf_config.intermediate_size,
        max_seq=hf_config.max_position_embeddings,
        rope_theta=getattr(hf_config, "rope_theta", 10000.0),
        norm_eps=hf_config.rms_norm_eps,
        dtype=dtype,
    )


def config_from_hf(hf_config: Any, dtype: torch.dtype = torch.bfloat16
                   ) -> ModelConfig:
    """transformers LlamaConfig → ModelConfig (shape fields only)."""
    return ModelConfig(**_shared_config_fields(hf_config, dtype))


def moe_config_from_hf(hf_config: Any, dtype: torch.dtype = torch.bfloat16
                       ) -> MoEConfig:
    """transformers MixtralConfig → MoEConfig, dropless (capacity_factor =
    n_experts): HF Mixtral has no capacity, and in that regime the logits
    match HF's."""
    return MoEConfig(
        **_shared_config_fields(hf_config, dtype),
        n_experts=hf_config.num_local_experts,
        experts_per_token=hf_config.num_experts_per_tok,
        capacity_factor=float(hf_config.num_local_experts),
    )


def _getter(state_dict: Mapping[str, Any], device
            ) -> Callable[[str], torch.Tensor]:
    """key → a private f32 copy of the tensor on ``device``."""
    def get(key: str) -> torch.Tensor:
        if key not in state_dict:
            raise ConvertError(f"checkpoint is missing {key!r}")
        return state_dict[key].detach().to(device=device,
                                           dtype=torch.float32, copy=True)

    return get


def _stack(get: Callable, fmt: str, cfg: ModelConfig,
           transpose: bool = True) -> torch.Tensor:
    """Layer ``i``'s tensor ``fmt.format(i)`` for every layer, stacked on
    a leading axis in ``cfg.dtype``; a matmul weight transposed from
    HF's (out, in) to (in, out)."""
    rows = [get(fmt.format(i)) for i in range(cfg.n_layers)]
    if transpose:
        rows = [r.T for r in rows]
    return torch.stack(rows).to(cfg.dtype)


def _backbone_params(state_dict: Mapping[str, Any], cfg: ModelConfig,
                     device) -> tuple[dict, dict, Callable]:
    """The attention, norm and embedding weights both families share →
    (top-level params, the layer dict to extend, the getter). No
    ``lm_head.weight`` (tied embeddings) → ``embed.T``."""
    get = _getter(state_dict, device)

    def stack(fmt: str, transpose: bool) -> torch.Tensor:
        return _stack(get, fmt, cfg, transpose)

    embed = get("model.embed_tokens.weight")
    lm_head = (get("lm_head.weight") if "lm_head.weight" in state_dict
               else embed).T
    layers = {
        "attn_norm": stack("model.layers.{}.input_layernorm.weight", False),
        "wq": stack("model.layers.{}.self_attn.q_proj.weight", True),
        "wk": stack("model.layers.{}.self_attn.k_proj.weight", True),
        "wv": stack("model.layers.{}.self_attn.v_proj.weight", True),
        "wo": stack("model.layers.{}.self_attn.o_proj.weight", True),
        "mlp_norm": stack(
            "model.layers.{}.post_attention_layernorm.weight", False),
    }
    top = {
        "embed": embed.to(cfg.dtype),
        "final_norm": get("model.norm.weight").to(cfg.dtype),
        "lm_head": lm_head.to(cfg.dtype, memory_format=torch.contiguous_format,
                              copy=True),
    }
    return top, layers, get


def _tree(top: dict, layers: dict) -> dict:
    """The tree in ``init_params``' key order, so its leaves line up with a
    preset's."""
    return {"embed": top["embed"], "layers": layers,
            "final_norm": top["final_norm"], "lm_head": top["lm_head"]}


def params_from_hf_state_dict(state_dict: Mapping[str, Any],
                              cfg: ModelConfig,
                              device: torch.device | str = "cuda") -> dict:
    """HF Llama ``state_dict`` (tensors) → the ``models/llama.py`` tree in
    ``cfg.dtype`` on ``device``, sharing no storage with the state dict.
    Raises ConvertError on a missing key (a truncated or non-Llama
    checkpoint)."""
    top, layers, get = _backbone_params(state_dict, cfg, device)
    layers.update({
        name: _stack(get, f"model.layers.{{}}.mlp.{proj}.weight", cfg)
        for name, proj in (("w_gate", "gate_proj"), ("w_up", "up_proj"),
                           ("w_down", "down_proj"))
    })
    return _tree(top, layers)


def params_from_hf_mixtral_state_dict(state_dict: Mapping[str, Any],
                                      cfg: MoEConfig,
                                      device: torch.device | str = "cuda"
                                      ) -> dict:
    """HF Mixtral ``state_dict`` → the ``models/moe.py`` tree: expert
    weights stacked (layer, expert, …), the router in float32."""
    top, layers, get = _backbone_params(state_dict, cfg, device)

    def stack_experts(which: str) -> torch.Tensor:
        return torch.stack([
            torch.stack([
                get(f"model.layers.{i}.block_sparse_moe.experts.{e}."
                    f"{which}.weight").T
                for e in range(cfg.n_experts)])
            for i in range(cfg.n_layers)]).to(cfg.dtype)

    layers.update({
        "w_router": torch.stack([
            get(f"model.layers.{i}.block_sparse_moe.gate.weight").T
            for i in range(cfg.n_layers)]),
        "w_gate": stack_experts("w1"),
        "w_up": stack_experts("w3"),
        "w_down": stack_experts("w2"),
    })
    return _tree(top, layers)


_LAYER_NAMES = {
    "wq": "self_attn.q_proj", "wk": "self_attn.k_proj",
    "wv": "self_attn.v_proj", "wo": "self_attn.o_proj",
    "w_gate": "mlp.gate_proj", "w_up": "mlp.up_proj",
    "w_down": "mlp.down_proj",
}


def hf_state_dict_from_params(params: dict, cfg: ModelConfig,
                              dtype: torch.dtype | None = None) -> dict:
    """A DENSE param tree → an HF Llama state dict (``lm_head`` untied), on
    the params' device, in ``dtype`` (default: the embedding's), each
    tensor a compact copy: the exact inverse of
    :func:`params_from_hf_state_dict` (pure transposes; through f32 no
    value changes, so bf16 and f32 come back bit for bit)."""
    if isinstance(cfg, MoEConfig):
        raise ConvertError("export supports the dense family only")
    dtype = dtype or params["embed"].dtype

    def t(x: torch.Tensor) -> torch.Tensor:
        return x.to(dtype, memory_format=torch.contiguous_format, copy=True)

    layers = params["layers"]
    sd = {
        "model.embed_tokens.weight": t(params["embed"]),
        "model.norm.weight": t(params["final_norm"]),
        "lm_head.weight": t(params["lm_head"].T),
    }
    for i in range(cfg.n_layers):
        sd[f"model.layers.{i}.input_layernorm.weight"] = t(
            layers["attn_norm"][i])
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = t(
            layers["mlp_norm"][i])
        for ours, theirs in _LAYER_NAMES.items():
            sd[f"model.layers.{i}.{theirs}.weight"] = t(layers[ours][i].T)
    return sd


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise ConvertError(
            "this needs the `transformers` package, which is not installed "
            "(the pure mappings params_from_hf_state_dict and "
            "hf_state_dict_from_params do not)") from e
    return transformers


def _resolve_model(model_or_path: Any):
    """A path → the live transformers model (local files only)."""
    if isinstance(model_or_path, (str, bytes)) or hasattr(
            model_or_path, "__fspath__"):
        transformers = _transformers()
        if not os.path.isdir(model_or_path):
            # not a hub id either: nothing is ever fetched
            raise ConvertError(f"no checkpoint directory at "
                               f"{os.fsdecode(model_or_path)!r}")
        return transformers.AutoModelForCausalLM.from_pretrained(
            model_or_path, local_files_only=True)
    return model_or_path


def load_hf(model_or_path: Any, dtype: torch.dtype = torch.bfloat16,
            device: torch.device | str = "cuda"
            ) -> tuple[dict, ModelConfig]:
    """A live ``transformers`` model or a LOCAL checkpoint path →
    (params on ``device``, cfg), dispatched on the config's
    ``model_type`` (llama → dense, mixtral → MoE). Nothing is fetched."""
    model = _resolve_model(model_or_path)
    kind = getattr(model.config, "model_type", "llama")
    if kind == "mixtral":
        cfg = moe_config_from_hf(model.config, dtype=dtype)
        return params_from_hf_mixtral_state_dict(model.state_dict(), cfg,
                                                 device), cfg
    if kind == "llama":
        cfg = config_from_hf(model.config, dtype=dtype)
        return params_from_hf_state_dict(model.state_dict(), cfg,
                                         device), cfg
    raise ConvertError(f"unsupported model_type {kind!r} (llama | mixtral)")


def load_hf_llama(model_or_path: Any, dtype: torch.dtype = torch.bfloat16,
                  device: torch.device | str = "cuda"
                  ) -> tuple[dict, ModelConfig]:
    """Dense-only :func:`load_hf`: a MoE checkpoint is refused BEFORE any
    weight is converted."""
    model = _resolve_model(model_or_path)
    if getattr(model.config, "model_type", "llama") != "llama":
        raise ConvertError("checkpoint is not a dense Llama — use load_hf")
    return load_hf(model, dtype=dtype, device=device)


def export_hf_llama(params: dict, cfg: ModelConfig, path: Any = None,
                    torch_dtype: torch.dtype | None = None):
    """A DENSE param tree → a transformers ``LlamaForCausalLM`` on the CPU
    (saved to ``path`` when given), in ``torch_dtype`` (default: the
    embedding's dtype): :func:`hf_state_dict_from_params`, adopted by a
    model built on the meta device."""
    if isinstance(cfg, MoEConfig):
        raise ConvertError("export supports the dense family only")
    transformers = _transformers()
    torch_dtype = torch_dtype or params["embed"].dtype
    hf_config = transformers.LlamaConfig(
        vocab_size=cfg.vocab_size,
        hidden_size=cfg.d_model,
        intermediate_size=cfg.d_ff,
        num_hidden_layers=cfg.n_layers,
        num_attention_heads=cfg.n_heads,
        num_key_value_heads=cfg.n_kv_heads,
        max_position_embeddings=cfg.max_seq,
        rope_theta=cfg.rope_theta,
        rms_norm_eps=cfg.norm_eps,
        attention_bias=False,
        tie_word_embeddings=False,
        torch_dtype=torch_dtype,
    )
    sd = {k: v.cpu() for k, v in
          hf_state_dict_from_params(params, cfg, torch_dtype).items()}
    # built on the meta device, so no throwaway weights are allocated or
    # drawn; assign=True adopts the state dict's tensors
    with torch.device("meta"):
        model = transformers.LlamaForCausalLM(hf_config)
    model.load_state_dict(sd, assign=True)
    # the rotary inv_freq is a non-persistent buffer, not in the state
    # dict, and stayed on meta: rebuild that module for real
    model.model.rotary_emb = type(model.model.rotary_emb)(config=hf_config)
    if any(b.is_meta for b in model.buffers()):
        raise ConvertError("meta buffers remain after export")
    model.eval()
    if path is not None:
        model.save_pretrained(str(path))
    return model
