from .upsample import upsample
from .predict import make_predictions, predict_rasterized, predict_single
from .run import run_pipeline

__all__ = ["upsample", "make_predictions", "predict_rasterized",
           "predict_single", "run_pipeline"]
