from .step import make_decode_step, make_prefill_step, make_train_step

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]
