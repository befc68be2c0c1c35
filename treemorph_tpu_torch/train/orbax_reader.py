"""Reader of the JAX package's orbax checkpoints, in plain Python.

``treemorph_tpu/train/checkpoints.py::save_checkpoint`` writes a pytree
through orbax's ``StandardCheckpointer``: one OCDBT key-value database
(tensorstore's "optionally-cooperative distributed B+tree") holding one
zarr v2 array per leaf, and a ``_METADATA`` JSON naming each leaf's key
path. This module reads that layout without orbax, tensorstore or JAX:

- the root ``manifest.ocdbt``: its config, data-file table and inline
  version list (the latest version's root B-tree node); the per-process
  database under ``ocdbt.process_0/`` is reached through the data-file
  paths of the nodes, which carry it as their base path;
- the B-tree nodes (interior: key prefixes, subtree common prefixes, child
  references; leaf: keys, inline values or references to a value's data
  file, offset and length) and the values in the ``d/`` files;
- each leaf's ``<name>/.zarray`` (zarr v2: shape, chunks, dtype, fill
  value, order, zstd compressor) and its chunks ``<name>/i.j...``.

Manifests and nodes are containers: a 4-byte big-endian magic, the file's
length (u64 LE), a format version and a compression varint (0 none, 1
zstd), the body, and a CRC-32C of everything before it (u32 LE). zstd goes
through :mod:`treemorph_tpu_torch.utils.zstd`. Anything the reader does
not recognise raises ``ValueError`` naming the field and its value.

:func:`read_checkpoint` returns the nested dict of numpy arrays that the
key paths name; ``bfloat16`` leaves, which numpy cannot hold, come back as
``torch.bfloat16`` tensors.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np
import torch

from ..utils.zstd import decompress
from .checkpoints import load_metadata

__all__ = ["is_orbax_checkpoint", "read_checkpoint", "read_kv",
           "load_metadata"]

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
METADATA_FILE = "_METADATA"

#: zarr v2 dtypes of the leaves the JAX package saves
_DTYPES = {
    "<f4": np.dtype("<f4"), "<f8": np.dtype("<f8"), "<i4": np.dtype("<i4"),
    "<i8": np.dtype("<i8"), "|b1": np.dtype("bool"),
    "bfloat16": np.dtype("<u2"),
}
#: orbax's key types in ``_METADATA``'s ``key_metadata``
_KEY_SEQUENCE, _KEY_DICT = 1, 2
_VALUE_TYPES = ("np.ndarray", "jax.Array", "scalar")


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


class _Bytes:
    """A cursor over a decoded body."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError(f"{self.what}: truncated at byte {self.pos} "
                             f"(wants {n} more of {len(self.data)})")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def varint(self) -> int:
        value = shift = 0
        while True:
            b = self.u8()
            value |= (b & 0x7F) << shift
            if not b & 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"{self.what}: varint longer than 64 bits "
                                 f"at byte {self.pos}")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.data):
            raise ValueError(f"{self.what}: {len(self.data) - self.pos} "
                             f"bytes left after the last field")


def _container(raw: bytes, magic: int, what: str) -> _Bytes:
    """The body of a manifest or B-tree node file, checked and decoded."""
    if len(raw) < 16:
        raise ValueError(f"{what}: {len(raw)} bytes, shorter than the "
                         "12-byte header and 4-byte checksum")
    found = struct.unpack(">I", raw[:4])[0]
    if found != magic:
        raise ValueError(f"{what}: magic {found:#010x}, expected "
                         f"{magic:#010x}")
    length = struct.unpack("<Q", raw[4:12])[0]
    if length != len(raw):
        raise ValueError(f"{what}: length field {length}, file holds "
                         f"{len(raw)} bytes")
    stored = struct.unpack("<I", raw[-4:])[0]
    if crc32c(raw[:-4]) != stored:
        raise ValueError(f"{what}: CRC-32C {crc32c(raw[:-4]):#010x}, "
                         f"stored {stored:#010x}")
    head = _Bytes(raw[12:-4], what)
    version = head.varint()
    if version != 0:
        raise ValueError(f"{what}: format version {version}, expected 0")
    compression = head.varint()
    rest = head.data[head.pos:]
    if compression == 0:
        return _Bytes(rest, what)
    if compression == 1:
        return _Bytes(decompress(rest), what)
    raise ValueError(f"{what}: compression format {compression}, expected "
                     "0 (none) or 1 (zstd)")


def _data_file_table(body: _Bytes, base: str) -> list[tuple[str, str]]:
    """(base path, path) of each data file a manifest or node refers to,
    relative to the database root: prefix-coded path strings, each with
    the length of its base path, under ``base`` (the base path of the file
    that holds the table)."""
    n = body.varint()
    prefix = body.varints(max(n - 1, 0))
    suffix = body.varints(n)
    base_len = body.varints(n)
    paths, prev = [], b""
    for i in range(n):
        keep = prefix[i - 1] if i else 0
        if keep > len(prev):
            raise ValueError(f"{body.what}: data file {i} keeps {keep} "
                             f"bytes of a {len(prev)}-byte path")
        full = prev[:keep] + body.take(suffix[i])
        if base_len[i] > len(full):
            raise ValueError(f"{body.what}: data file {i} base path length "
                             f"{base_len[i]} > path length {len(full)}")
        full_path = full.decode()
        paths.append((base + full_path[:base_len[i]], base + full_path))
        prev = full
    return paths


def _config(body: _Bytes) -> dict:
    cfg = {"uuid": body.take(16).hex(), "manifest_kind": body.varint()}
    if cfg["manifest_kind"] != 0:
        raise ValueError(f"{body.what}: manifest_kind "
                         f"{cfg['manifest_kind']}, only 0 (single) is read")
    cfg["max_inline_value_bytes"] = body.varint()
    cfg["max_decoded_node_bytes"] = body.varint()
    cfg["version_tree_arity_log2"] = body.u8()
    cfg["compression"] = body.varint()
    if cfg["compression"] == 1:
        cfg["zstd_level"] = struct.unpack("<i", body.take(4))[0]
    elif cfg["compression"] != 0:
        raise ValueError(f"{body.what}: config compression method "
                         f"{cfg['compression']}, expected 0 or 1 (zstd)")
    return cfg


def _location(files: list, file_id: int, offset: int, length: int,
              what: str):
    """(path, offset, length, base path) of a value or node."""
    if file_id >= len(files):
        raise ValueError(f"{what}: data file id {file_id} of a table of "
                         f"{len(files)}")
    base, path = files[file_id]
    return path, offset, length, base


def read_manifest(root: str) -> dict:
    """The config, the inline versions and the version-tree node
    references of ``root/manifest.ocdbt``."""
    path = os.path.join(root, MANIFEST_FILE)
    with open(path, "rb") as f:
        body = _container(f.read(), MANIFEST_MAGIC, path)
    config = _config(body)
    files = _data_file_table(body, "")
    n = body.varint()
    generation = body.varints(n)
    height = [body.u8() for _ in range(n)]
    file_id, offset, length = (body.varints(n), body.varints(n),
                               body.varints(n))
    num_keys, tree_bytes, indirect_bytes = (body.varints(n),
                                            body.varints(n), body.varints(n))
    commit_time = [body.u64() for _ in range(n)]
    versions = [{
        "generation_number": generation[i], "root_height": height[i],
        "root": _location(files, file_id[i], offset[i], length[i], path),
        "num_keys": num_keys[i], "num_tree_bytes": tree_bytes[i],
        "num_indirect_value_bytes": indirect_bytes[i],
        "commit_time": commit_time[i],
    } for i in range(n)]
    m = body.varint()
    generation = body.varints(m)
    file_id, offset, length = (body.varints(m), body.varints(m),
                               body.varints(m))
    num_generations = body.varints(m)
    commit_time = [body.u64() for _ in range(m)]
    height = [body.u8() for _ in range(m)]
    version_nodes = [{
        "generation_number": generation[i],
        "location": _location(files, file_id[i], offset[i], length[i], path),
        "num_generations": num_generations[i],
        "commit_time": commit_time[i], "height": height[i],
    } for i in range(m)]
    body.end()
    if not versions:
        raise ValueError(f"{path}: no version")
    return {"config": config, "versions": versions,
            "version_tree_nodes": version_nodes}


def _read_range(root: str, location) -> bytes:
    rel, offset, length, _ = location
    with open(os.path.join(root, rel), "rb") as f:
        f.seek(offset)
        data = f.read(length)
    if len(data) != length:
        raise ValueError(f"{os.path.join(root, rel)}: {len(data)} bytes at "
                         f"offset {offset}, wanted {length}")
    return data


def _walk_node(root: str, location, height: int, prefix: bytes,
               out: dict):
    what = f"B-tree node {location[0]}:{location[1]}:{location[2]}"
    body = _container(_read_range(root, location), BTREE_MAGIC, what)
    found = body.u8()
    if found != height:
        raise ValueError(f"{what}: height {found}, its parent says {height}")
    files = _data_file_table(body, location[3])
    n = body.varint()
    key_prefix = body.varints(max(n - 1, 0))
    key_suffix = body.varints(n)
    common = body.varints(n) if height else None
    keys, prev = [], b""
    for i in range(n):
        keep = key_prefix[i - 1] if i else 0
        if keep > len(prev):
            raise ValueError(f"{what}: key {i} keeps {keep} bytes of a "
                             f"{len(prev)}-byte key")
        prev = prev[:keep] + body.take(key_suffix[i])
        keys.append(prev)
    if height:
        file_id, offset, length = (body.varints(n), body.varints(n),
                                   body.varints(n))
        body.varints(3 * n)  # num_keys, num_tree_bytes, indirect bytes
        body.end()
        for i in range(n):
            if common[i] > len(keys[i]):
                raise ValueError(f"{what}: subtree common prefix length "
                                 f"{common[i]} > key length {len(keys[i])}")
            child = _location(files, file_id[i], offset[i], length[i], what)
            _walk_node(root, child, height - 1,
                       prefix + keys[i][:common[i]], out)
        return
    value_length = body.varints(n)
    kind = body.varints(n)
    bad = [k for k in kind if k not in (0, 1)]
    if bad:
        raise ValueError(f"{what}: value kind {bad[0]}, expected 0 (inline) "
                         "or 1 (indirect)")
    indirect = [i for i in range(n) if kind[i] == 1]
    file_id = body.varints(len(indirect))
    offset = body.varints(len(indirect))
    refs = {i: _location(files, f, o, value_length[i], what)
            for i, f, o in zip(indirect, file_id, offset)}
    for i in range(n):
        if kind[i] == 0:
            out[prefix + keys[i]] = body.take(value_length[i])
    body.end()
    for i, ref in refs.items():
        out[prefix + keys[i]] = _read_range(root, ref)


def read_kv(path: str) -> dict[bytes, bytes]:
    """Every key and value of the OCDBT database at ``path`` (its latest
    version)."""
    manifest = read_manifest(path)
    latest = manifest["versions"][-1]
    out: dict[bytes, bytes] = {}
    if latest["num_keys"]:
        _walk_node(path, latest["root"], latest["root_height"], b"", out)
    if len(out) != latest["num_keys"]:
        raise ValueError(f"{path}: read {len(out)} keys, the manifest "
                         f"counts {latest['num_keys']}")
    return out


def _zarr_array(kv: dict, name: str):
    """Assemble the zarr v2 array ``name`` from its ``.zarray`` and
    chunks."""
    what = f"{name}/.zarray"
    meta = json.loads(kv[what.encode()])
    expected = {"zarr_format": 2, "order": "C", "filters": None}
    for field, value in expected.items():
        if meta.get(field) != value:
            raise ValueError(f"{what}: {field} {meta.get(field)!r}, expected "
                             f"{value!r}")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"{what}: compressor id {compressor.get('id')!r}, "
                         "expected 'zstd' or none")
    if meta["dtype"] not in _DTYPES:
        raise ValueError(f"{what}: dtype {meta['dtype']!r}, expected one of "
                         f"{sorted(_DTYPES)}")
    sep = meta.get("dimension_separator", ".")
    if sep not in (".", "/"):
        raise ValueError(f"{what}: dimension_separator {sep!r}")
    dtype = _DTYPES[meta["dtype"]]
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"{what}: chunks {list(chunks)} for shape "
                         f"{list(shape)}")
    fill = meta.get("fill_value")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    prefix = f"{name}/".encode()
    present = {k[len(prefix):].decode() for k in kv
               if k.startswith(prefix) and not k.endswith(b"/.zarray")
               and not k.endswith(b"/.zattrs")}
    wanted = set()
    for idx in np.ndindex(*grid):
        key = sep.join(map(str, idx)) if idx else "0"
        wanted.add(key)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        if key not in present:
            if fill is None:
                raise ValueError(f"{name}: chunk key {key!r} missing and "
                                 "fill_value is null")
            out[region] = np.asarray(fill).astype(dtype)
            continue
        data = kv[prefix + key.encode()]
        if compressor is not None:
            data = decompress(data)
        if len(data) != int(np.prod(chunks)) * dtype.itemsize:
            raise ValueError(f"{name}/{key}: {len(data)} bytes, a chunk of "
                             f"{list(chunks)} {meta['dtype']} holds "
                             f"{int(np.prod(chunks)) * dtype.itemsize}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        out[region] = chunk[tuple(slice(0, r.stop - r.start)
                                  for r in region)]
    extra = present - wanted
    if extra:
        raise ValueError(f"{name}: chunk key {sorted(extra)[0]!r} outside "
                         f"the chunk grid {grid}")
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


def is_orbax_checkpoint(path: str) -> bool:
    return os.path.exists(os.path.join(path, MANIFEST_FILE)) or \
        os.path.exists(os.path.join(path, METADATA_FILE))


def read_checkpoint(path: str) -> dict:
    """The pytree saved at ``path`` by the JAX package's
    ``save_checkpoint``, as nested dicts (lists for sequence keys) of
    numpy arrays (``torch.bfloat16`` tensors for bfloat16 leaves, Python
    numbers for orbax's scalar leaves)."""
    path = os.path.abspath(path)
    kv = read_kv(path)
    meta_path = os.path.join(path, METADATA_FILE)
    with open(meta_path) as f:
        meta = json.load(f)
    for field, value in (("use_ocdbt", True), ("use_zarr3", False)):
        if meta.get(field) != value:
            raise ValueError(f"{meta_path}: {field} {meta.get(field)!r}, "
                             f"expected {value!r}")
    if "tree_metadata" not in meta:
        raise ValueError(f"{meta_path}: no tree_metadata")
    tree: dict = {}
    for entry in meta["tree_metadata"].values():
        keys = entry["key_metadata"]
        value_type = entry["value_metadata"].get("value_type")
        if value_type not in _VALUE_TYPES:
            raise ValueError(f"{meta_path}: value_type {value_type!r}, "
                             f"expected one of {_VALUE_TYPES}")
        if entry["value_metadata"].get("skip_deserialize"):
            raise ValueError(f"{meta_path}: skip_deserialize true for "
                             f"{[k['key'] for k in keys]}")
        for k in keys:
            if k["key_type"] not in (_KEY_SEQUENCE, _KEY_DICT):
                raise ValueError(f"{meta_path}: key_type {k['key_type']!r} "
                                 f"of key {k['key']!r}")
        name = ".".join(str(k["key"]) for k in keys)
        value = _zarr_array(kv, name)
        if value_type == "scalar":
            value = value.item()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault((k["key"], k["key_type"]), {})
        node[(keys[-1]["key"], keys[-1]["key_type"])] = value
    return _containers(tree)


def _containers(node):
    """Turn the (key, key_type) tree into dicts and lists."""
    if not isinstance(node, dict):
        return node
    types = {t for _, t in node}
    if types == {_KEY_SEQUENCE}:
        items = sorted(node.items(), key=lambda kv: int(kv[0][0]))
        if [int(k) for (k, _), _ in items] != list(range(len(items))):
            raise ValueError(f"sequence keys {[k for (k, _), _ in items]} "
                             "are not 0..n-1")
        return [_containers(v) for _, v in items]
    return {k: _containers(v) for (k, _), v in node.items()}
