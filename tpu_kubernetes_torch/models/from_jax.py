"""The weight bridge: a JAX params tree, as numpy arrays, → the port's
tensors with the same keys and layout.

The port imports no JAX, so the caller converts first
(``jax.tree.map(np.asarray, params)``). JAX bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy`` rejects; they go
through float32 and are cast back, which is exact.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(arr, device: torch.device | str = "cuda",
                      dtype: torch.dtype | None = None) -> torch.Tensor:
    """One leaf. ``dtype`` overrides the leaf's own type."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))   # a writable copy
    return t.to(device=device, dtype=dtype or t.dtype)


def params_from_numpy(tree: dict, device: torch.device | str = "cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """A nested dict of numpy arrays → the same dict of tensors. ``dtype``
    casts the float weights; an int8-quantized leaf (``{"q": int8, "s":
    f32}``, ``models/quant.py``) keeps its int8 values and f32 scales
    whatever ``dtype`` says."""
    if set(tree) == {"q", "s"} and np.asarray(tree["q"]).dtype == np.int8:
        return {k: tensor_from_numpy(v, device) for k, v in tree.items()}
    return {
        k: (params_from_numpy(v, device, dtype) if isinstance(v, dict)
            else tensor_from_numpy(v, device, dtype))
        for k, v in tree.items()
    }
