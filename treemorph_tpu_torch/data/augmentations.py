"""Point-cloud training augmentations.

Port of ``treemorph_tpu/data/augmentations.py`` (host numpy, copied). The
reference datasets accept a ``data_augmentations`` callable applied to
``(points, offsets)`` during training (``TreeSet.py:125-126``,
``RasterizedTreeSet.py:62-63``) but ship no implementations. These are the
standard geometric augmentations for tree clouds — every transform is
applied consistently to the offset labels so points + offsets still land on
the (transformed) cylinder surfaces.

All host-side numpy; compose with :func:`compose`.
"""

from __future__ import annotations

import numpy as np


def compose(*augmentations):
    """Chain augmentations left to right."""

    def apply(points, offsets, rng=None):
        rng = rng or np.random.default_rng()
        for aug in augmentations:
            points, offsets = aug(points, offsets, rng)
        return points, offsets

    return apply


def random_rotation_z(max_angle: float = 2 * np.pi):
    """Rotate about the vertical axis (gravity-preserving)."""

    def apply(points, offsets, rng):
        theta = rng.uniform(0, max_angle)
        c, s = np.cos(theta), np.sin(theta)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        return points @ rot.T, offsets @ rot.T

    return apply


def random_jitter(sigma: float = 0.005, clip: float = 0.02):
    """Gaussian per-point position noise; offsets are corrected so the
    target surface point (p + offset) is unchanged."""

    def apply(points, offsets, rng):
        noise = np.clip(
            rng.normal(0, sigma, points.shape), -clip, clip
        ).astype(points.dtype)
        return points + noise, offsets - noise

    return apply


def random_scale(low: float = 0.95, high: float = 1.05):
    """Uniform isotropic scale (offsets scale identically)."""

    def apply(points, offsets, rng):
        s = np.float32(rng.uniform(low, high))
        return points * s, offsets * s

    return apply


def random_flip_xy():
    """Random mirror over the x and/or y axis."""

    def apply(points, offsets, rng):
        sign = np.ones(3, np.float32)
        if rng.uniform() < 0.5:
            sign[0] = -1
        if rng.uniform() < 0.5:
            sign[1] = -1
        return points * sign, offsets * sign

    return apply


def random_dropout(max_fraction: float = 0.1):
    """Drop a random fraction of points (simulates occlusion).

    Returns fewer rows — callers pad afterwards, so shapes stay static at
    the batch level.
    """

    def apply(points, offsets, rng):
        frac = rng.uniform(0, max_fraction)
        keep = rng.uniform(size=len(points)) >= frac
        if not keep.any():
            return points, offsets
        return points[keep], offsets[keep]

    return apply


def default_augmentations():
    """A sensible default pipeline for tree clouds."""
    return compose(
        random_rotation_z(),
        random_flip_xy(),
        random_scale(),
        random_jitter(),
    )
