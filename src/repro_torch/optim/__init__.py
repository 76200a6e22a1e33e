"""AdamW, the learning-rate schedule and gradient compression: the PyTorch
counterpart of ``repro.optim``."""
from .adamw import AdamWState, adamw_init, adamw_update, global_norm
from .compress import compressed_allreduce, error_feedback_compress
from .schedule import warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "global_norm",
           "warmup_cosine", "compressed_allreduce",
           "error_feedback_compress"]
