from .model_loaders import Predictor, build_model, load_model

__all__ = ["Predictor", "build_model", "load_model"]
