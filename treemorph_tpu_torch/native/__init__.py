"""Native host-side runtime (C++ via ctypes).

The QSM stage's inner loops run on the host (inherently sequential sphere
following); the per-sphere clustering math lives in ``qsm_core.cpp`` behind
a plain C ABI. The shared library is built with the system ``g++`` at first
use (:mod:`treemorph_tpu_torch.utils.build`). The port carries no
scikit-learn fallback: a library that does not build raises.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from ..utils.build import build_library

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "qsm_core.cpp")

_lib = None


def _gxx(sources, out):
    return ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *sources,
            "-o", out]


def load():
    """The loaded library, built first if needed; raises if it cannot be
    built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_library("libqsm_core.so", [_SRC], _gxx))
    i32 = ctypes.c_int32
    f32 = ctypes.c_float
    pf = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    pi = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.dbscan_precomputed.argtypes = [pf, i32, f32, i32, pi]
    lib.angular_distance_matrix.argtypes = [pf, i32, pf]
    lib.euclidean_cluster.argtypes = [pf, i32, f32, i32, pi]
    lib.angular_dbscan_grid.argtypes = [pf, i32, f32, i32, pi]
    _lib = lib
    return lib


def dbscan_precomputed(
    dist: np.ndarray, eps: float, min_samples: int
) -> np.ndarray:
    """DBSCAN labels over a precomputed distance matrix (sklearn
    semantics)."""
    lib = load()
    n = dist.shape[0]
    dist = np.ascontiguousarray(dist, np.float32)
    labels = np.empty(n, np.int32)
    lib.dbscan_precomputed(dist, n, float(eps), int(min_samples), labels)
    return labels


def angular_cluster(
    unit_vectors: np.ndarray, eps: float, min_samples: int
) -> np.ndarray:
    """Angular DBSCAN over unit vectors — the per-sphere candidate
    clustering of the QSM engine — as exact grid DBSCAN in the chord
    metric: angle(u, v) <= eps  <=>  |u - v| <= 2 sin(eps/2)."""
    lib = load()
    n = len(unit_vectors)
    u = np.ascontiguousarray(unit_vectors, np.float32)
    labels = np.empty(n, np.int32)
    lib.angular_dbscan_grid(u, n, float(eps), int(min_samples), labels)
    return labels


def euclidean_cluster(
    points: np.ndarray, eps: float, min_cluster_size: int
) -> np.ndarray:
    """Flood-fill euclidean clustering (reference :859-886)."""
    lib = load()
    pts = np.ascontiguousarray(points, np.float32)
    labels = np.empty(len(points), np.int32)
    lib.euclidean_cluster(
        pts, len(points), float(eps), int(min_cluster_size), labels
    )
    return labels
