"""tpu_kubernetes_torch.serve — the port's live HTTP entry point
(``python -m tpu_kubernetes_torch.serve.server``: solo, round-batched and
continuous-batching greedy serving over a dense or paged KV cache, sampled
and streamed requests as compiled programs, chat completions), the batch
inference job and the model bring-up (``python -m
tpu_kubernetes_torch.serve.job``: ``run_serving``, ``load_serving_stack``)
and the paged engine's host page accounting (serve/pages.py). Neither
entry module is imported here, so that ``python -m`` runs each once, as
``__main__``."""

from tpu_kubernetes_torch.serve.pages import PagePool  # noqa: F401
