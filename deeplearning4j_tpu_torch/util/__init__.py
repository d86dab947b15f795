"""Decoding, parameter conversion, model archives, and the durable
training utilities: checkpoints (``checkpoint.py``) and the
fault-tolerant trainer (``recovery.py``)."""

from deeplearning4j_tpu_torch.util.checkpoint import (  # noqa: F401
    CheckpointListener, checkpoint_status, delete_checkpoint,
    list_checkpoints, list_good_checkpoints, load_checkpoint,
    restore_checkpoint, restore_distributed_checkpoint, save_checkpoint,
    save_distributed_checkpoint, verify_checkpoint)
from deeplearning4j_tpu_torch.util.recovery import (  # noqa: F401
    FaultTolerantTrainer)
