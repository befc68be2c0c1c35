from .params import QSMParams
from .engine import fit_qsm
from .structures import Cylinder, CylinderTracker, Sphere, SphereCluster

__all__ = [
    "QSMParams",
    "fit_qsm",
    "Cylinder",
    "CylinderTracker",
    "Sphere",
    "SphereCluster",
]
