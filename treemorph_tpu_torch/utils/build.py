"""Build of the port's shared libraries from the sources in the checkout.

Both the QSM stage's C++ core (``native/qsm_core.cpp``, built with ``g++``)
and the CUDA kernels (``csrc/*.cu``, built with ``nvcc``) are compiled at
first use into ``treemorph_tpu_torch/_build/``, a directory ``.gitignore``
lists, and rebuilt when a source is newer than its library. A failed build
raises: the port has no fallback for a library it cannot build.
"""

from __future__ import annotations

import os
import subprocess
import tempfile

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")


def build_library(name: str, sources: list[str], command) -> str:
    """Path of ``_build/{name}``, compiled first if missing or older than
    any source. ``command(sources, out_path)`` returns the compiler argv;
    the library is written to a temporary name and moved into place, so
    concurrent processes never load a half-written file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    lib = os.path.join(BUILD_DIR, name)
    newest = max(os.path.getmtime(s) for s in sources)
    if os.path.exists(lib) and os.path.getmtime(lib) >= newest:
        return lib
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            command(sources, tmp), capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed ({proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib
