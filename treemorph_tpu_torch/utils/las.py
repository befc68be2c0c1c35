"""Minimal pure-numpy LAS 1.2/1.4 point-cloud codec.

The reference loads/saves ``.las``/``.laz`` through laspy
(``/root/reference/Modules/Utils.py:190-296``).  laspy is not part of this
image, which would leave the LAS branch of :mod:`treemorph_tpu_torch.utils.io`
untested.  This module implements the
uncompressed LAS interchange format directly from the public ASPRS spec so
the ``.las`` path executes — and is round-trip tested — with zero optional
dependencies.  Compressed ``.laz`` still requires laspy/lazrs (the LASzip
codec is out of scope); :func:`read_las` raises ``ValueError`` on a
compressed point-format id so callers can fall back.

Supported:

- read: LAS 1.0-1.4 headers, point record formats 0-3 and 6-8 (the formats
  TLS exports actually use); returns scaled float64 XYZ plus intensity.
- write: LAS 1.4 / point format 3 records (matching the laspy writer this
  codec replaces: ``LasHeader(point_format=3, version="1.4")``), scale
  0.001 m and per-axis min offsets.

Everything is vectorized ``np.frombuffer`` / structured-array work; no
per-point Python loops.
"""

from __future__ import annotations

import os
import struct

import numpy as np

_SIGNATURE = b"LASF"

#: point-record byte layouts we can decode: format id -> (record length,
#: numpy structured dtype covering the standard fields we use)
_POINT_DTYPES = {
    0: np.dtype(
        [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("flags", "u1"), ("classification", "u1"), ("scan_angle", "i1"),
         ("user_data", "u1"), ("point_source_id", "<u2")]
    ),
    1: np.dtype(
        [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("flags", "u1"), ("classification", "u1"), ("scan_angle", "i1"),
         ("user_data", "u1"), ("point_source_id", "<u2"),
         ("gps_time", "<f8")]
    ),
    2: np.dtype(
        [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("flags", "u1"), ("classification", "u1"), ("scan_angle", "i1"),
         ("user_data", "u1"), ("point_source_id", "<u2"),
         ("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
    ),
    3: np.dtype(
        [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("flags", "u1"), ("classification", "u1"), ("scan_angle", "i1"),
         ("user_data", "u1"), ("point_source_id", "<u2"),
         ("gps_time", "<f8"),
         ("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
    ),
    6: np.dtype(
        [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("returns", "u1"), ("flags", "u1"), ("classification", "u1"),
         ("user_data", "u1"), ("scan_angle", "<i2"),
         ("point_source_id", "<u2"), ("gps_time", "<f8")]
    ),
    7: np.dtype(
        [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("returns", "u1"), ("flags", "u1"), ("classification", "u1"),
         ("user_data", "u1"), ("scan_angle", "<i2"),
         ("point_source_id", "<u2"), ("gps_time", "<f8"),
         ("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
    ),
    8: np.dtype(
        [("X", "<i4"), ("Y", "<i4"), ("Z", "<i4"), ("intensity", "<u2"),
         ("returns", "u1"), ("flags", "u1"), ("classification", "u1"),
         ("user_data", "u1"), ("scan_angle", "<i2"),
         ("point_source_id", "<u2"), ("gps_time", "<f8"),
         ("red", "<u2"), ("green", "<u2"), ("blue", "<u2"),
         ("nir", "<u2")]
    ),
}


def read_las(path_or_bytes) -> dict:
    """Read an uncompressed ``.las`` file.

    Returns ``{"xyz": float64 (N, 3), "intensity": uint16 (N,),
    "point_format": int, "version": (major, minor), "scales": (3,),
    "offsets": (3,)}``.  Raises ``ValueError`` on a malformed header or a
    LASzip-compressed point format (bit 7 of the format id set — the ``.laz``
    convention), ``NotImplementedError`` on an unsupported point format.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if len(buf) < 227 or buf[:4] != _SIGNATURE:
        raise ValueError("not a LAS file (missing LASF signature)")

    ver_major, ver_minor = buf[24], buf[25]
    header_size, point_offset = struct.unpack_from("<HI", buf, 94)
    fmt_id, rec_len = struct.unpack_from("<BH", buf, 104)
    legacy_count = struct.unpack_from("<I", buf, 107)[0]
    scales = np.array(struct.unpack_from("<3d", buf, 131))
    offsets = np.array(struct.unpack_from("<3d", buf, 155))
    if fmt_id & 0x80:
        raise ValueError(
            "LASzip-compressed point records (laz) need laspy/lazrs"
        )
    count = legacy_count
    if ver_minor >= 4 and header_size >= 375:
        count64 = struct.unpack_from("<Q", buf, 247)[0]
        if count64:
            count = count64
    if fmt_id not in _POINT_DTYPES:
        raise NotImplementedError(f"LAS point format {fmt_id}")
    base = _POINT_DTYPES[fmt_id]
    if rec_len < base.itemsize:
        raise ValueError(
            f"record length {rec_len} < format {fmt_id} minimum "
            f"{base.itemsize}"
        )
    # extra bytes after the standard fields (extra-bytes VLR payloads)
    # ride along unparsed
    dt = base
    if rec_len > base.itemsize:
        dt = np.dtype(
            base.descr + [("extra", "V", rec_len - base.itemsize)]
        )
    avail = (len(buf) - point_offset) // rec_len
    if count > avail:
        count = avail  # tolerate truncated files like the reference loader
    rec = np.frombuffer(
        buf, dtype=dt, count=count, offset=point_offset
    )
    xyz = (
        np.stack([rec["X"], rec["Y"], rec["Z"]], axis=1).astype(np.float64)
        * scales
        + offsets
    )
    return {
        "xyz": xyz,
        "intensity": np.asarray(rec["intensity"]),
        "point_format": fmt_id,
        "version": (ver_major, ver_minor),
        "scales": scales,
        "offsets": offsets,
    }


def write_las(path: str, xyz: np.ndarray, scales=(0.001, 0.001, 0.001),
              intensity: np.ndarray | None = None) -> str:
    """Write ``xyz`` as a LAS 1.4 file with point format 3 records.

    Matches the laspy writer it replaces (``utils/io.py`` historically used
    ``LasHeader(point_format=3, version="1.4")`` with 1 mm scales and
    per-axis min offsets).  Returns ``path``.
    """
    xyz = np.asarray(xyz, dtype=np.float64)
    if xyz.ndim != 2 or xyz.shape[1] < 3:
        raise ValueError(f"expected (N, >=3) coordinates, got {xyz.shape}")
    xyz = xyz[:, :3]
    n = len(xyz)
    scales = np.asarray(scales, dtype=np.float64)
    offsets = xyz.min(axis=0) if n else np.zeros(3)

    header_size = 375
    dt = _POINT_DTYPES[3]
    rec = np.zeros(n, dtype=dt)
    ixyz = np.round((xyz - offsets) / scales)
    # i32 storage bound: with 1 mm scale this is a ±2147 km extent
    if np.any(np.abs(ixyz) > np.iinfo(np.int32).max):
        raise ValueError("coordinate extent overflows i32 at this scale")
    rec["X"], rec["Y"], rec["Z"] = (
        ixyz[:, 0].astype(np.int32),
        ixyz[:, 1].astype(np.int32),
        ixyz[:, 2].astype(np.int32),
    )
    # single return, first of one — the canonical value for synthetic data
    rec["flags"] = 0b00001001
    if intensity is not None:
        rec["intensity"] = np.asarray(intensity, dtype=np.uint16)

    header = bytearray(header_size)
    header[0:4] = _SIGNATURE
    header[24] = 1  # version major
    header[25] = 4  # version minor
    header[26:26 + 13] = b"treemorph_tpu"
    header[58:58 + 13] = b"treemorph_tpu"
    struct.pack_into("<H", header, 94, header_size)
    struct.pack_into("<I", header, 96, header_size)  # points follow header
    struct.pack_into("<BH", header, 104, 3, dt.itemsize)
    legacy = n if n <= np.iinfo(np.uint32).max else 0
    struct.pack_into("<I", header, 107, legacy)
    struct.pack_into("<I", header, 111, legacy)  # returns[0]
    struct.pack_into("<3d", header, 131, *scales)
    struct.pack_into("<3d", header, 155, *offsets)
    mx = xyz.max(axis=0) if n else np.zeros(3)
    mn = xyz.min(axis=0) if n else np.zeros(3)
    struct.pack_into(
        "<6d", header, 179, mx[0], mn[0], mx[1], mn[1], mx[2], mn[2]
    )
    struct.pack_into("<Q", header, 247, n)
    struct.pack_into("<Q", header, 255, n)  # returns-by-number[0]

    directory = os.path.dirname(path)
    if directory:
        os.makedirs(directory, exist_ok=True)
    with open(path, "wb") as f:
        f.write(bytes(header))
        f.write(rec.tobytes())
    return path
