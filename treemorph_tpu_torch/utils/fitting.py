"""Host-side numerical fitting helpers.

Parity targets: power-law fitting and log-binning from reference
``Modules/Utils.py:58-142`` and the algebraic 2D circle fit used throughout
QSM fitting (``Modules/Projection.py:149-163``,
``Modules/Pipeline/QSMFittingDepthFirst.py:616-663``). These run on the host
(tiny problems, scipy), not the device.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import curve_fit


def power_law(x, a, b):
    """y = a * x**b."""
    return a * np.power(x, b)


def fit_power_law(x, y, eps: float = 1e-8):
    """Fit ``y = a * x**b`` in log-log space.

    Returns ``(x_fit, y_fit, a, b, a_err, b_err)`` exactly like reference
    ``Modules/Utils.py:62-101``: values clipped to ``eps``, fit of
    ``log y = log a + b log x`` via least squares, fitted curve sampled on 100
    log-spaced points from 1e-5 to max(x).
    """
    x_c = np.clip(np.asarray(x, dtype=np.float64), eps, None)
    y_c = np.clip(np.asarray(y, dtype=np.float64), eps, None)
    log_x, log_y = np.log(x_c), np.log(y_c)

    popt, pcov = curve_fit(lambda lx, log_a, b: log_a + b * lx, log_x, log_y)
    log_a, b = popt
    a = np.exp(log_a)
    perr = np.sqrt(np.diag(pcov))
    a_err = a * perr[0]
    b_err = perr[1]

    x_fit = np.logspace(-5, np.log10(x_c.max()), 100)
    y_fit = power_law(x_fit, a, b)
    return x_fit, y_fit, a, b, a_err, b_err


def generate_log_bins(min_val: float, max_val: float) -> np.ndarray:
    """1-2-...-9 log-decade bin edges covering [min_val, max_val].

    Parity with reference ``Modules/Utils.py:127-142``.
    """
    bins = []
    order_min = int(np.floor(np.log10(min_val)))
    order_max = int(np.ceil(np.log10(max_val)))
    for order in range(order_min, order_max + 1):
        for m in range(1, 10):
            value = m * 10.0**order
            if min_val <= value <= max_val:
                bins.append(value)
    bins = np.array(sorted(bins))
    if bins.size == 0:
        return np.array([min_val, max_val])
    if bins[0] > min_val:
        bins = np.insert(bins, 0, min_val)
    if bins[-1] < max_val:
        bins = np.append(bins, max_val)
    return bins


def fit_circle_2d(points_2d: np.ndarray):
    """Algebraic least-squares circle fit in 2D.

    Solves ``x^2 + y^2 = 2 a x + 2 b y + c`` for center (a, b) and radius
    ``sqrt(c + a^2 + b^2)``. Parity with reference
    ``Modules/Projection.py:149-163``; returns ``(center, radius)`` with NaNs
    on degenerate input.
    """
    points_2d = np.asarray(points_2d, dtype=np.float64)
    if points_2d.shape[0] < 3:
        return np.array([np.nan, np.nan]), np.nan
    x, y = points_2d[:, 0], points_2d[:, 1]
    A = np.stack([2 * x, 2 * y, np.ones_like(x)], axis=1)
    rhs = x**2 + y**2
    try:
        sol, _, _, _ = np.linalg.lstsq(A, rhs, rcond=None)
    except np.linalg.LinAlgError:
        return np.array([np.nan, np.nan]), np.nan
    a, b, c = sol
    radius_sq = c + a**2 + b**2
    if radius_sq < 0:
        return np.array([np.nan, np.nan]), np.nan
    return np.array([a, b]), float(np.sqrt(radius_sq))
