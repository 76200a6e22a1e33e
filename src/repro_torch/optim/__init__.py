"""AdamW and the learning-rate schedule: the PyTorch counterpart of
``repro.optim`` (its gradient compression, ``compress``, is multi-device
work and not ported)."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine"]
