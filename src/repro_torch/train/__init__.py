"""The port's training substrate (reference `repro/train/`): AdamW, the
chunked-vocab train step, the synthetic LM data and checkpoints in the
reference's on-disk format."""
from .optimizer import AdamWConfig, adamw_init, adamw_state_skeleton, adamw_update
from .train_step import chunked_xent, make_loss_fn, make_train_step
from .data import DataConfig, SyntheticLM
from .checkpoint import latest_step, restore_checkpoint, save_checkpoint
