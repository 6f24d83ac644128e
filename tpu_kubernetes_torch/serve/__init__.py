"""tpu_kubernetes_torch.serve — the port's live HTTP entry point
(``python -m tpu_kubernetes_torch.serve.server``: solo, round-batched and
continuous-batching greedy serving over a dense or paged KV cache, sampled
and streamed requests, chat completions), its model bring-up
(serve/job.py) and the paged engine's host page accounting
(serve/pages.py). The server module is not imported here, so that
``python -m`` runs it once, as ``__main__``."""

from tpu_kubernetes_torch.serve.job import load_serving_stack  # noqa: F401
from tpu_kubernetes_torch.serve.pages import PagePool  # noqa: F401
