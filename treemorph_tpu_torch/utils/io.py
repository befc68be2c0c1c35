"""Host-side point-cloud IO.

Behavioral parity with the reference loader/saver
(``/root/reference/Modules/Utils.py:190-296``): ``.npy``, ``.txt`` (space or
comma separated), ``.las``/``.laz`` via laspy when present — with a
pure-numpy uncompressed-LAS codec (:mod:`treemorph_tpu_torch.utils.las`)
standing in for ``.las`` when it is not — always standardized to float32.
IO is a host concern: the pipeline pads the arrays returned here and moves
them to the device.

The de-facto labeled-cloud wire format (reference
``PreProcessing/LabelGenerationCuda.py:194-205``) is a float ``(N, 11)`` array:

    col 0:3   x, y, z
    col 3:6   offset vector to the nearest QSM cylinder surface
    col 6     nearest cylinder id
    col 7:11  features (normal nx, ny, nz + relative height)

``LABELED_COLUMNS`` documents that layout for the rest of the framework.
"""

from __future__ import annotations

import os

import numpy as np

LABELED_COLUMNS = {
    "xyz": slice(0, 3),
    "offset": slice(3, 6),
    "cylinder_id": 6,
    "features": slice(7, 11),
}

try:
    import laspy

    HAS_LASPY = True
except ImportError:
    HAS_LASPY = False

from . import las as _native_las


def load_cloud(path: str, all_columns: bool = False) -> np.ndarray | None:
    """Load a point cloud from ``.npy``/``.txt``/``.las``/``.laz``.

    Returns the XYZ columns as float32 ``(N, 3)`` by default; with
    ``all_columns=True`` returns every column (e.g. the full labeled format).
    Returns ``None`` on failure, mirroring the reference's tolerant loader
    (``Modules/Utils.py:190-250``).
    """
    ext = os.path.splitext(path)[1].lower()
    try:
        if ext == ".npy":
            data = np.load(path)
            if data.ndim == 1:
                if data.size % 3 != 0:
                    return None
                data = data.reshape(-1, 3)
        elif ext == ".txt":
            data = None
            for delim in (" ", ","):
                try:
                    data = np.loadtxt(path, delimiter=delim)
                    break
                except ValueError:
                    continue
            if data is None:
                return None
            if data.ndim == 1:
                data = data.reshape(1, -1)
        elif ext in (".las", ".laz"):
            if HAS_LASPY:
                with laspy.open(path) as f:
                    las = f.read()
                    data = np.stack([las.x, las.y, las.z], axis=1)
            elif ext == ".las":
                # native uncompressed-LAS codec (utils/las.py) — .laz
                # needs the LASzip codec, so without laspy it stays
                # unreadable and falls through to the tolerant None
                try:
                    data = _native_las.read_las(path)["xyz"]
                except (ValueError, NotImplementedError):
                    return None
            else:
                return None
        else:
            return None
    except (OSError, ValueError):
        return None

    if data.ndim != 2 or data.shape[1] < 3:
        return None
    if all_columns:
        return data.astype(np.float32)
    return data[:, :3].astype(np.float32)


def save_cloud(data: np.ndarray, path: str, save_type: str = "npy") -> str | None:
    """Save a point cloud as ``npy``, ``txt``, or ``laz``.

    Mirrors reference ``Modules/Utils.py:252-296``. Returns the path written,
    or ``None`` if ``data`` was empty.
    """
    if data is None or len(data) == 0:
        return None
    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    expected = "." + save_type
    if not path.lower().endswith(expected):
        path += expected

    if save_type == "npy":
        np.save(path, data)
    elif save_type == "txt":
        np.savetxt(path, data, fmt="%.6f")
    elif save_type in ("las", "laz"):
        if HAS_LASPY:
            header = laspy.LasHeader(point_format=3, version="1.4")
            header.scales = np.array([0.001, 0.001, 0.001])
            header.offsets = np.min(data[:, :3], axis=0)
            las = laspy.LasData(header)
            las.x = data[:, 0]
            las.y = data[:, 1]
            las.z = data[:, 2]
            las.write(path)
        else:
            # native writer emits uncompressed LAS (same 1.4/format-3
            # layout the laspy branch produces); a requested .laz becomes
            # .las since LASzip compression needs laspy/lazrs
            path = os.path.splitext(path)[0] + ".las"
            _native_las.write_las(path, data[:, :3])
    else:
        path = os.path.splitext(path)[0] + ".npy"
        np.save(path, data)
    return path
