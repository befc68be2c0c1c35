"""Zstandard decompression through the system's ``libzstd``.

The JAX package's orbax checkpoints compress twice with zstd: the OCDBT
manifests and B-tree nodes, and every zarr chunk. The port reads them
without the ``zstandard`` module, which the card's machine lacks, by
binding the shared library (``libzstd.so.1``, found by
``ctypes.util.find_library("zstd")``) through ``ctypes``. The library is
loaded at the first call, never at import; without it the call raises.

A frame that records its content size is decoded in one
``ZSTD_decompress``; one that does not (a streaming writer's) goes through
the streaming API, ``ZSTD_decompressStream``.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_CONTENTSIZE_ERROR = (1 << 64) - 2
_lib = None


class _InBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


class _OutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("pos", ctypes.c_size_t)]


def _library():
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("zstd")
    if name is None:
        raise OSError("libzstd not found (ctypes.util.find_library('zstd') "
                      "is None): the zstd shared library is needed to read "
                      "orbax checkpoints")
    lib = ctypes.CDLL(name)
    lib.ZSTD_getFrameContentSize.restype = ctypes.c_ulonglong
    lib.ZSTD_getFrameContentSize.argtypes = [ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_decompress.restype = ctypes.c_size_t
    lib.ZSTD_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_getErrorName.restype = ctypes.c_char_p
    lib.ZSTD_getErrorName.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_initDStream.restype = ctypes.c_size_t
    lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_DStreamOutSize.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_OutBuffer),
        ctypes.POINTER(_InBuffer)]
    _lib = lib
    return lib


def _check(lib, code: int, what: str) -> int:
    if lib.ZSTD_isError(code):
        raise ValueError(f"zstd {what}: "
                         f"{lib.ZSTD_getErrorName(code).decode()}")
    return code


def decompress(data: bytes) -> bytes:
    """The content of the zstd frame ``data``."""
    lib = _library()
    data = bytes(data)
    size = lib.ZSTD_getFrameContentSize(data, len(data))
    if size == _CONTENTSIZE_ERROR:
        raise ValueError(f"not a zstd frame (first bytes {data[:4].hex()})")
    if size == _CONTENTSIZE_UNKNOWN:
        return _decompress_stream(lib, data)
    out = ctypes.create_string_buffer(max(size, 1))
    n = _check(lib, lib.ZSTD_decompress(out, size, data, len(data)),
               "decompress")
    if n != size:
        raise ValueError(f"zstd frame declares {size} bytes, decoded {n}")
    return out.raw[:n]


def _decompress_stream(lib, data: bytes) -> bytes:
    stream = lib.ZSTD_createDStream()
    if not stream:
        raise MemoryError("ZSTD_createDStream failed")
    try:
        _check(lib, lib.ZSTD_initDStream(stream), "initDStream")
        src = ctypes.create_string_buffer(data, len(data))
        inp = _InBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
        chunk = lib.ZSTD_DStreamOutSize()
        dst = ctypes.create_string_buffer(chunk)
        pieces = []
        left = 1
        while inp.pos < inp.size or left:
            out = _OutBuffer(ctypes.cast(dst, ctypes.c_void_p), chunk, 0)
            left = _check(lib, lib.ZSTD_decompressStream(
                stream, ctypes.byref(out), ctypes.byref(inp)),
                "decompressStream")
            pieces.append(dst.raw[:out.pos])
            if out.pos == 0 and inp.pos == inp.size and left:
                raise ValueError("zstd frame is truncated")
        return b"".join(pieces)
    finally:
        lib.ZSTD_freeDStream(stream)
