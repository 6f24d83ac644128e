"""Weight-only int8 quantization for the serving path (port of
``tpu_kubernetes/models/quant.py``).

A decode step reads every matmul weight once for a handful of rows, so its
floor is the bytes of the weights over the card's memory rate. Storing
the matmul weights as int8 with one f32 scale an output channel halves
those bytes against bf16. The weight-only int8 matmul kernel
(``ops/w8_matmul.py``) reads the int8 payload and forms each weight in
registers, so the bf16 weight never exists in device memory on a decode
step; a prefill (more than ``MAX_ROWS`` rows) dequantizes into a
temporary and multiplies with ``torch.matmul``.

* **Symmetric per-output-channel scales** (absmax / 127 over the input
  axis -2), rounded half to even and clipped to ±127, as the reference
  computes them: the same numpy weights give the same bits in ``q`` and
  ``s``.
* **Matmul weights only**: the layer stacks ``wq wk wv wo w_gate w_up
  w_down`` and ``lm_head``. The embedding, the norm gains and the MoE
  router keep their dtypes; MoE expert stacks quantize per expert (the
  expert axis is a leading batch axis).
* **Same tree**: a quantized leaf is ``{"q": int8, "s": f32}``; every
  weight product of the serving path goes through :func:`matmul_w`, which
  takes a plain tensor (``x @ w``, the training path's product) or a
  quantized leaf.
"""

from __future__ import annotations

import torch

from tpu_kubernetes_torch.ops.w8_matmul import w8_matmul

# leaves under params["layers"] that are (L[, E], in, out) matmul weights
LAYER_MATMUL_LEAVES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _quantize_leaf(w: torch.Tensor) -> dict:
    """(…, in, out) float weight → {"q": int8, "s": f32 (…, 1, out)}:
    symmetric absmax / 127 over the contraction axis -2."""
    w32 = w.float()
    absmax = w32.abs().amax(dim=-2, keepdim=True)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"q": q, "s": scale}


def is_quantized(leaf) -> bool:
    return isinstance(leaf, dict) and set(leaf) == {"q", "s"}


def weight(leaf, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """A quantized leaf dequantized as the reference does it,
    ``q.to(dtype) * s.to(dtype)`` (the product rounded to ``dtype``); a
    plain tensor passes straight through."""
    if is_quantized(leaf):
        return leaf["q"].to(dtype) * leaf["s"].to(dtype)
    return leaf


def matmul_w(x: torch.Tensor, leaf, use_kernel: bool | None = None
             ) -> torch.Tensor:
    """``x @ W`` for a weight leaf: a plain tensor multiplies as it is
    (autograd and all, the training path); a quantized leaf goes to the
    weight-only int8 matmul (``ops/w8_matmul.py``: on the card the kernel
    for up to ``MAX_ROWS`` rows, ``weight(leaf, x.dtype)`` and
    ``torch.matmul`` for more; on the CPU the plain version)."""
    if not is_quantized(leaf):
        return x @ leaf
    return w8_matmul(x, leaf["q"], leaf["s"], use_kernel=use_kernel)


def quantized_sharding(sharding) -> dict:
    """The shardings of an int8 leaf that replaces a weight laid out by
    ``sharding`` (a ``parallel.mesh.NamedSharding``): ``q`` as the weight;
    ``s`` (…, 1, out) split like the weight's output dimension, its size-1
    contraction dimension never split (the reference's
    ``serving_param_shardings``)."""
    from tpu_kubernetes_torch.parallel.mesh import NamedSharding, PartitionSpec

    spec = tuple(sharding.spec)
    s_spec = (PartitionSpec(*spec[:-2], None, spec[-1]) if len(spec) >= 2
              else sharding.spec)
    return {"q": sharding, "s": NamedSharding(sharding.mesh, s_spec)}


def layer_slice(leaf, li: int):
    """Layer ``li`` of a stacked leaf, plain or quantized (views)."""
    if is_quantized(leaf):
        return {"q": leaf["q"][li], "s": leaf["s"][li]}
    return leaf[li]


def quantize_for_decode(params: dict, cfg=None) -> dict:
    """Export-time quantization of a parameter tree for serving: the same
    keys, the layer matmul stacks and ``lm_head`` quantized; the
    embedding, the norms and the router untouched (the same tensors)."""
    del cfg  # both families share the leaf layout quantized here
    layers = dict(params["layers"])
    for name in LAYER_MATMUL_LEAVES:
        if name in layers:
            layers[name] = _quantize_leaf(layers[name])
    out = dict(params)
    out["layers"] = layers
    out["lm_head"] = _quantize_leaf(params["lm_head"])
    return out


def _leaves(tree: dict):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def quantized_param_bytes(params: dict) -> int:
    """Bytes the tree takes on the device, each leaf at its own itemsize
    (an int8 leaf 1 byte, its scales 4): what a decode step streams of
    its quantized weights."""
    return sum(t.numel() * t.element_size() for t in _leaves(params))


def matmul_weight_bytes(params: dict) -> int:
    """:func:`quantized_param_bytes` of the matmul weights alone (the
    layer matmul stacks and ``lm_head``, every expert of an MoE stack):
    the weight term of the analytic roofline (``obs/profile.py``)."""
    layers = params["layers"]
    return quantized_param_bytes(
        {"lm_head": params["lm_head"],
         **{k: layers[k] for k in LAYER_MATMUL_LEAVES if k in layers}})


def max_abs_error(w: torch.Tensor) -> float:
    """Worst-case absolute dequantization error of one weight tensor
    (bounded by scale / 2 a channel)."""
    back = weight(_quantize_leaf(w), torch.float32)
    return float((back - w.float()).abs().max())
