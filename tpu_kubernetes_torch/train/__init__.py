"""tpu_kubernetes_torch.train — the port's training steps (one device,
and sharded over a mesh), optimizers and input pipeline
(train/trainer.py, train/data.py),
checkpoints (train/checkpoint.py), LoRA finetuning (train/lora.py), the
training and finetuning jobs (train/job.py, train/finetune.py) and the
tokenizers (train/corpus.py)."""

from tpu_kubernetes_torch.train.data import (  # noqa: F401
    TokenDataset,
    global_batches,
    input_pipeline,
    local_batches,
    prefetch,
)
from tpu_kubernetes_torch.train.trainer import (  # noqa: F401
    TrainConfig,
    gather_state,
    init_state,
    make_eval_step,
    make_optimizer,
    make_pipeline_train_step,
    make_sharded_eval_step,
    make_sharded_train_step,
    make_train_step,
    shard_batch,
    shard_state,
    state_shardings,
    synthetic_batches,
    train_step,
)
from tpu_kubernetes_torch.train.lora import (  # noqa: F401
    LoraConfig,
    init_lora_state,
    lora_shardings,
    lora_train_step,
    make_lora_step,
    make_sharded_lora_step,
    merge_lora,
)
