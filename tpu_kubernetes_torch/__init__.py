"""tpu_kubernetes_torch — the PyTorch/CUDA port of the in-tree model stack.

It sits beside ``tpu_kubernetes/`` (the JAX reference) and mirrors its
layout, so each port file names the reference file it translates:
``ops/`` (norms, flash attention and its Hopper kernel under ``csrc/``),
``models/`` (dense LLaMA forward, KV-cache prefill and decode),
``train/`` (the training steps, one device and sharded, the jobs),
``parallel/`` (the mesh, the multi-process bootstrap, the collectives),
``serve/`` (the HTTP completions server) and ``util/envparse.py``.

The port imports ``torch`` and never JAX, and nothing from
``tpu_kubernetes``: where it needs a JAX-free helper of the reference it
keeps its own copy. Entry points run on ``cuda`` unless the caller asks
for the CPU.
"""

__version__ = "0.1.0"   # pyproject.toml's
