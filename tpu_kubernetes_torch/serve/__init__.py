"""tpu_kubernetes_torch.serve — the port's live HTTP entry point
(``python -m tpu_kubernetes_torch.serve.server``: solo, round-batched and
continuous-batching greedy serving, sampled and streamed requests, chat
completions) and its model bring-up (serve/job.py). The server module is
not imported here, so that ``python -m`` runs it once, as
``__main__``."""

from tpu_kubernetes_torch.serve.job import load_serving_stack  # noqa: F401
