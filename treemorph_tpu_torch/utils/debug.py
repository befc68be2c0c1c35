"""Debug-mode toggles.

Port of ``treemorph_tpu/utils/debug.py`` (the reference's debug modes,
``torch.autograd.set_detect_anomaly`` and ``CUDA_LAUNCH_BLOCKING=1``):

- :func:`enable_nan_checks` turns on autograd's anomaly detection, which
  raises at the backward op that produced a NaN and names its forward;
- :func:`synchronous_mode` is the counterpart of ``jax.disable_jit``: while
  it is open, every hand-kernel wrapper of ``ops/`` synchronizes after its
  launch and checks the CUDA error state, so an asynchronous kernel error
  names the launch that caused it. Outside it no wrapper synchronizes.

``CUDA_LAUNCH_BLOCKING=1`` makes every launch of every library blocking,
but the CUDA runtime reads it only when it initializes: setting it after
the process has touched the card changes nothing, so it must be in the
environment before the program starts. :func:`synchronous_mode` can be
opened at any point.
"""

from __future__ import annotations

import contextlib

import torch

from ..ops import cuda


def enable_nan_checks(on: bool = True) -> None:
    """Fail at the first NaN-producing backward op (the reference's
    anomaly detection, train_utils.py:161)."""
    torch.autograd.set_detect_anomaly(on)


@contextlib.contextmanager
def synchronous_mode():
    """Synchronize and check the CUDA error state after every hand-kernel
    launch while open (``CUDA_LAUNCH_BLOCKING`` cannot be set once CUDA
    has been initialized; see the module docstring)."""
    old = cuda.SYNCHRONOUS
    cuda.SYNCHRONOUS = True
    try:
        yield
    finally:
        cuda.SYNCHRONOUS = old


@contextlib.contextmanager
def debug_mode():
    """NaN checks and synchronous kernel launches together."""
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(True)
    try:
        with synchronous_mode():
            yield
    finally:
        torch.autograd.set_detect_anomaly(old)
