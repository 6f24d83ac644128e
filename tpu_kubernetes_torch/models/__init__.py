"""tpu_kubernetes_torch.models — the model families of the port: dense
LLaMA (models/llama.py: forward, loss, remat) and Mixture-of-Experts
(models/moe.py), their KV-cache inference, dense and paged, with the
warm-prefix resume, the speculative verify rounds and the sampler a CUDA
graph holds (models/decode.py), speculative decoding
(models/speculative.py), the JAX weight bridge (models/from_jax.py) and
the Hugging Face import and export (models/convert_hf.py).

As in the reference, ``init_params`` / ``logical_axes`` / ``forward`` /
``loss_fn`` here dispatch on the config's type, so the trainer and the
jobs take either family."""

from tpu_kubernetes_torch.models import llama as _llama
from tpu_kubernetes_torch.models import moe as _moe
from tpu_kubernetes_torch.models.decode import (  # noqa: F401
    KVCache,
    PagedKVCache,
    SlotState,
    cache_clear_row,
    cache_insert_row,
    decode_chunk,
    decode_segment,
    decode_segment_paged,
    decode_segment_slots,
    decode_step,
    decode_step_paged,
    decode_step_slots,
    decode_verify_paged,
    decode_verify_slots,
    draw,
    filter_logits,
    gather_pages,
    generate,
    generate_into,
    init_cache,
    init_paged_pool,
    init_slot_state,
    page_bytes,
    paged_clear_pages,
    paged_insert_row,
    prefill,
    prefill_chunked,
    prefill_resume,
    sample_tokens,
    sampling_knobs,
    sampling_variant,
)
from tpu_kubernetes_torch.models.convert_hf import (  # noqa: F401
    export_hf_llama,
    hf_state_dict_from_params,
    load_hf,
    load_hf_llama,
)
from tpu_kubernetes_torch.models.from_jax import params_from_numpy  # noqa: F401
from tpu_kubernetes_torch.models.speculative import (  # noqa: F401
    SpecStats,
    prompt_lookup_generate,
    speculative_generate,
)
from tpu_kubernetes_torch.models.llama import ModelConfig, param_count  # noqa: F401
from tpu_kubernetes_torch.models.moe import MoEConfig, expert_capacity  # noqa: F401

CONFIGS: dict[str, ModelConfig] = {**_llama.CONFIGS, **_moe.MOE_CONFIGS}


def _family(cfg: ModelConfig):
    return _moe if isinstance(cfg, MoEConfig) else _llama


def init_params(cfg: ModelConfig, generator, device="cuda") -> dict:
    return _family(cfg).init_params(cfg, generator, device)


def logical_axes(cfg: ModelConfig) -> dict:
    return _family(cfg).logical_axes(cfg)


def forward(params: dict, tokens, cfg: ModelConfig):
    return _family(cfg).forward(params, tokens, cfg)


def loss_fn(params: dict, tokens, cfg: ModelConfig):
    return _family(cfg).loss_fn(params, tokens, cfg)
