"""tpu_kubernetes_torch.train — the port's training step, optimizer and
input pipeline for one device (train/trainer.py, train/data.py), the
training job (train/job.py) and the tokenizers (train/corpus.py)."""

from tpu_kubernetes_torch.train.data import (  # noqa: F401
    TokenDataset,
    input_pipeline,
    local_batches,
    prefetch,
)
from tpu_kubernetes_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    init_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
    synthetic_batches,
    train_step,
)
