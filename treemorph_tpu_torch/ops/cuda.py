"""Build, load and count the port's CUDA kernels.

Each ``csrc/{name}.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (``_build/lib{name}.so``) at first
use, and loaded with ctypes. Wrappers pass device pointers and PyTorch's
current stream as integers, and add one to :data:`LAUNCHES` for every
kernel they launch.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

from ..utils.build import PACKAGE_DIR, build_library

CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")

#: kernel launches per wrapper name, counted where each wrapper launches
LAUNCHES: Counter = Counter()

#: the ``__global__`` functions of each ``csrc/{name}.cu``, by the names
#: the profiler gives their launches
KERNEL_FUNCTIONS: dict[str, tuple[str, ...]] = {
    "band_conv": ("split_weights_kernel", "band_conv_kernel"),
    "band_conv_bwd": ("band_conv_bwd_kernel",),
    "brick_conv": ("split_weights_kernel", "live_bricks_kernel",
                   "brick_gemm_kernel"),
    "window_attention": ("window_attention_kernel",),
    "window_attention_bwd": ("dq_kernel", "dk_dv_kernel"),
}

_libs: dict[str, ctypes.CDLL] = {}

#: set by :func:`treemorph_tpu_torch.utils.debug.synchronous_mode`: each
#: wrapper then synchronizes after its launch, so a kernel's asynchronous
#: error names that launch rather than a later call
SYNCHRONOUS = False


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    for path in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _nvcc_command(sources, out):
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", out, *sources,
    ]


def kernel_names() -> list[str]:
    return sorted(
        f[: -len(".cu")] for f in os.listdir(CSRC_DIR) if f.endswith(".cu")
    )


def _build(name: str) -> str:
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    return build_library(f"lib{name}.so", [src], _nvcc_command)


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib{name}.so``, built first if needed; raises if the
    build or the load fails."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(_build(name))
    return _libs[name]


def build_all() -> float:
    """Compile every ``csrc/*.cu`` at once (one ``nvcc`` per source, all
    started together) and return the wall seconds. Raises if any fails."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor() as pool:
        for future in [pool.submit(_build, n) for n in kernel_names()]:
            future.result()
    return time.perf_counter() - t0


def stream_handle(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as an integer."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_launch(name: str, rc: int) -> None:
    """Raise if a launch returned a CUDA error; in synchronous mode, also
    if the kernel failed while it ran."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    if SYNCHRONOUS:
        import torch

        try:
            torch.cuda.synchronize()
        except RuntimeError as err:
            raise RuntimeError(f"{name} kernel failed: {err}") from err
