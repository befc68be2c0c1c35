from .io import load_cloud, save_cloud, LABELED_COLUMNS
from .fitting import power_law, fit_power_law, generate_log_bins, fit_circle_2d
from .device import resolve_device
from .early_stopping import EarlyStopper

__all__ = [
    "load_cloud",
    "save_cloud",
    "LABELED_COLUMNS",
    "power_law",
    "fit_power_law",
    "generate_log_bins",
    "fit_circle_2d",
    "resolve_device",
    "EarlyStopper",
]
