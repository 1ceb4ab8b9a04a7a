"""repro_torch.train — the in-house AdamW, the train-step factory and
atomic checkpoints (port of ``repro.train``)."""

from .optimizer import AdamWConfig, apply_updates, init_state, schedule
from .train_step import (make_decode_step, make_prefill_step,
                         make_train_step, microbatch)
from . import checkpoint

__all__ = ["AdamWConfig", "apply_updates", "init_state", "schedule",
           "make_decode_step", "make_prefill_step", "make_train_step",
           "microbatch", "checkpoint"]
