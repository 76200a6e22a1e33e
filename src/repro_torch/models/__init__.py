from .model_zoo import Model, build_model, lm_loss

__all__ = ["Model", "build_model", "lm_loss"]
