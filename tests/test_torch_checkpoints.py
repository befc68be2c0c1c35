"""The port's reader of the JAX package's orbax checkpoints against orbax.

``treemorph_tpu_torch.train.orbax_reader`` reads the OCDBT database and
zarr v2 arrays that ``treemorph_tpu/train/checkpoints.py`` writes through
orbax; here its arrays are held bit for bit to orbax's own restore, its
key-value walk to tensorstore's OCDBT driver (on a database with interior
B-tree nodes and a version tree), and ``load_model`` / ``exec_pipeline``
on a JAX deployment checkpoint to the JAX package's ``load_model``.

The committed fixture ``tests/data/jax_treelearn_P3/`` (the card's smoke
run serves a plot from it) is written by this module:

    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_checkpoints.py
"""

import hashlib
import json
import os
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import zstandard

import jax
import jax.numpy as jnp
import orbax.checkpoint as ocp
import tensorstore as ts

from treemorph_tpu.evaluation import model_loaders as jloaders
from treemorph_tpu.train.checkpoints import (
    save_checkpoint,
    save_model_checkpoint,
)
from treemorph_tpu_torch.evaluation.model_loaders import Predictor, load_model
from treemorph_tpu_torch.train import orbax_reader
from treemorph_tpu_torch.train.orbax_reader import read_checkpoint, read_kv
from treemorph_tpu_torch.utils import zstd

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, padded_inputs, t,
)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                    "jax_treelearn_P3")
FIXTURE = os.path.join(DATA, "checkpoint")
FIXTURE_SHA = os.path.join(DATA, "arrays.sha256.json")
#: the noise head's final bias of the committed fixture (it keeps points)
KEEP_BIAS = [5.0, -5.0]


def leaves(tree, path=()):
    """(key path, leaf) of a nested dict / list, in key order."""
    items = (tree.items() if isinstance(tree, dict)
             else enumerate(tree) if isinstance(tree, list) else None)
    if items is None:
        yield path, tree
        return
    for k, v in sorted(items, key=lambda kv: str(kv[0])):
        yield from leaves(v, path + (str(k),))


def leaf_bytes(x) -> bytes:
    """The bytes of a leaf as restored: a numpy array's (bfloat16 as its
    16-bit pattern, from ml_dtypes or torch), a Python number's repr."""
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy().tobytes()
    if isinstance(x, (int, float)):
        return repr(x).encode()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        x = x.view(np.int16)
    return np.ascontiguousarray(x).tobytes()


def sha256_of(tree) -> dict:
    return {"/".join(p): hashlib.sha256(leaf_bytes(v)).hexdigest()
            for p, v in leaves(tree)}


def orbax_restore(path):
    with ocp.StandardCheckpointer() as ckptr:
        return ckptr.restore(os.path.abspath(path))


def assert_bit_equal(got, want):
    got_leaves, want_leaves = dict(leaves(got)), dict(leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    for key, w in want_leaves.items():
        g = got_leaves[key]
        if isinstance(w, (int, float)):
            assert type(g) is type(w) and g == w, key
            continue
        w = np.asarray(w)
        if w.dtype.name == "bfloat16":
            assert isinstance(g, torch.Tensor) and g.dtype == torch.bfloat16
        else:
            assert g.dtype == w.dtype, key
        assert tuple(g.shape) == w.shape, key
        assert leaf_bytes(g) == leaf_bytes(w), key


@pytest.mark.parametrize("level", [1, 3, 9, 19])
def test_zstd_matches_zstandard(level):
    """The ctypes decoder on frames of every kind the zstandard module
    writes: raw and compressible data, with and without a content size
    (the streaming path), two frames back to back."""
    rng = np.random.default_rng(level)
    for data in (b"", rng.bytes(1000), rng.integers(0, 3, 150_000).astype(
            np.uint8).tobytes(), np.arange(20_000, dtype=np.float32)
            .tobytes()):
        for size in (True, False):
            frame = zstandard.ZstdCompressor(
                level=level, write_content_size=size).compress(data)
            assert zstd.decompress(frame) == data
    two = b"".join(zstandard.ZstdCompressor(
        level=level, write_content_size=False).compress(d)
        for d in (b"ab", b"cd"))
    assert zstd.decompress(two) == b"abcd"
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"0cdb")


def test_reader_matches_orbax_restore_bit_for_bit(tmp_path):
    """f32, f64, i32, i64, bool and bf16 leaves, 0-d arrays, orbax's
    Python scalars, a list, and a leaf split into a 5 x 4 grid of chunks
    with partial edge chunks (``chunk_byte_size``); orbax refuses empty
    arrays, so no checkpoint holds one."""
    rng = np.random.default_rng(0)
    tree = {
        "params": {
            "dense": {"kernel": rng.normal(size=(7, 5)).astype(np.float32),
                      "bias": np.float64(-2.5) * np.ones(5)},
            "ids": rng.integers(-9, 9, (4, 3)).astype(np.int32),
            "big": rng.integers(-2**40, 2**40, (3,)).astype(np.int64),
            "mask": rng.uniform(size=(6,)) < 0.5,
            "half": jnp.asarray(rng.normal(size=(9,)), jnp.bfloat16),
            "zero_d": np.array(3.25, np.float32),
            "layers": [np.arange(3, dtype=np.float32),
                       np.arange(2, dtype=np.int32)],
        },
        "step": 7,
        "rate": 0.5,
        "chunked": rng.normal(size=(37, 23)).astype(np.float32),
    }
    path = str(tmp_path / "ckpt")
    save_args = jax.tree.map(lambda _: ocp.SaveArgs(), tree)
    save_args["chunked"] = ocp.SaveArgs(chunk_byte_size=8 * 6 * 4)
    with ocp.StandardCheckpointer() as ckptr:
        ckptr.save(path, tree, save_args=save_args)
    kv = read_kv(path)
    chunks = [k for k in kv if k.startswith(b"chunked/")
              and not k.endswith(b".zarray")]
    assert len(chunks) > 1
    assert_bit_equal(read_checkpoint(path), orbax_restore(path))
    with pytest.raises(ValueError, match="zero size"):
        save_checkpoint(str(tmp_path / "empty"),
                        {"e": np.zeros((0, 3), np.float32)})


def test_reader_walks_interior_nodes_and_version_tree(tmp_path):
    """Every key and value of an OCDBT database that tensorstore wrote
    with 400-byte nodes (interior B-tree nodes, height 2), indirect values
    past 16 bytes and 40 versions (a version-tree node), against
    tensorstore's own reads."""
    spec = {"driver": "ocdbt", "base": f"file://{tmp_path}/",
            "config": {"max_decoded_node_bytes": 400,
                       "max_inline_value_bytes": 16,
                       "compression": {"id": "zstd", "level": 5}}}
    store = ts.KvStore.open(spec).result()
    for i in range(40):
        store.write(f"key{i:03d}/{'x' * (i % 5)}",
                    bytes([i]) * (3 + (i % 3) * 10)).result()
    manifest = orbax_reader.read_manifest(str(tmp_path))
    assert manifest["versions"][-1]["root_height"] >= 1
    assert manifest["version_tree_nodes"]
    kv = read_kv(str(tmp_path))
    keys = store.list().result()
    assert sorted(kv) == sorted(keys)
    for k in keys:
        assert kv[k] == store.read(k).result().value


def test_reader_refuses_what_it_does_not_know(tmp_path):
    """ValueError naming the field and its value: a zarr3 checkpoint, a
    manifest's magic, a corrupted node (its checksum), a dtype, a
    compressor and a chunk key outside the grid."""
    path = tmp_path / "ckpt"
    save_checkpoint(str(path), {"a": np.arange(4, dtype=np.float32)})
    meta = json.loads((path / "_METADATA").read_text())
    (path / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
    with pytest.raises(ValueError, match="use_zarr3 True"):
        read_checkpoint(str(path))
    raw = (path / "manifest.ocdbt").read_bytes()
    (path / "manifest.ocdbt").write_bytes(b"\x0c\xdb\x3a\x2b" + raw[4:])
    with pytest.raises(ValueError, match="manifest.ocdbt: magic 0x0cdb3a2b"):
        read_kv(str(path))
    (path / "manifest.ocdbt").write_bytes(raw)
    node = next((path / "d").iterdir())
    body = bytearray(node.read_bytes())
    body[20] ^= 1
    node.write_bytes(bytes(body))
    with pytest.raises(ValueError, match="CRC-32C"):
        read_kv(str(path))
    zarray = {"zarr_format": 2, "order": "C", "filters": None,
              "compressor": None, "dtype": "<f4", "shape": [2],
              "chunks": [2], "fill_value": None}
    for change, match in (({"dtype": "<u8"}, "dtype '<u8'"),
                          ({"compressor": {"id": "blosc"}},
                           "compressor id 'blosc'"),
                          ({"order": "F"}, "order 'F'")):
        kv = {b"x/.zarray": json.dumps({**zarray, **change}).encode(),
              b"x/0": bytes(8)}
        with pytest.raises(ValueError, match=match):
            orbax_reader._zarr_array(kv, "x")
    kv = {b"x/.zarray": json.dumps(zarray).encode(), b"x/0": bytes(8),
          b"x/1": bytes(8)}
    with pytest.raises(ValueError, match="chunk key '1'"):
        orbax_reader._zarr_array(kv, "x")


def test_committed_fixture_is_orbax_and_its_hashes_are_current():
    """The fixture the card's smoke run serves: the reader gives orbax's
    arrays bit for bit, every leaf's SHA-256 is the one recorded, and it
    is TreeLearn at the pipeline's width with the keeping noise bias."""
    ours = read_checkpoint(FIXTURE)
    assert_bit_equal(ours, orbax_restore(FIXTURE))
    with open(FIXTURE_SHA) as f:
        assert sha256_of(ours) == json.load(f)
    n = sum(np.asarray(v).size for _, v in leaves(ours["params"]))
    assert n == 2_392_325
    np.testing.assert_array_equal(
        ours["params"]["semantic_head"]["Dense_1"]["bias"], KEEP_BIAS)


def small_deployment(root):
    """A one-level channels-8 TreeLearn written by the JAX package's
    ``save_model_checkpoint`` as the offset and the noise model of plot 3
    (the reference's ``TreeLearn_{O,N}_P3`` naming), its architecture in
    the metadata as the JAX training CLI records it."""
    from test_torch_treelearn import jax_model_and_variables

    _, variables = jax_model_and_variables("gather", "float32", seed=3,
                                           num_blocks=1)
    head = variables["params"]["offset_head"]["Dense_1"]
    head["kernel"] = (head["kernel"] / 50).astype(np.float32)
    variables["params"]["semantic_head"]["Dense_1"]["bias"] = np.array(
        [0.5, -0.5], np.float32)
    meta = {"model": "treelearn", "plot": 3, "voxel_size": 0.02,
            "num_blocks": 1, "channels": 8, "depth": 5, "dim_feat": 4,
            "noise_distance": 0.05}
    state = SimpleNamespace(**variables)
    dirs = []
    for role, tag in (("offset", "O"), ("noise", "N")):
        save_model_checkpoint(os.path.join(root, role, f"TreeLearn_{tag}_P3"),
                              state, meta)
        dirs.append(os.path.join(root, role))
    return dirs


def test_load_model_matches_jax_load_model(tmp_path):
    """The port's ``load_model`` on a JAX deployment checkpoint gives the
    JAX ``load_model``'s outputs on one small cloud (f32, 1e-5 of
    scale)."""
    offset_dir, noise_dir = small_deployment(str(tmp_path))
    # the offset model alone: JAX compiles its init template per model
    jmodels = jloaders.load_model("treelearn", offset_dir, plots=(3,))
    tmodels = load_model("treelearn", offset_dir, noise_dir, device="cpu")
    assert list(jmodels) == ["O_P3"]
    assert sorted(tmodels) == ["N_P3", "O_P3"]
    assert tmodels["O_P3"].model.offset_head.Dense_0.weight.shape[1] == 8
    c, f, b, v = padded_inputs(5, 1500, 100)
    out_j = jmodels["O_P3"].predict_flat(*map(jnp.asarray, (c, f, b, v)))
    out_t = tmodels["O_P3"].predict_flat(c, f, b, v)
    for key in ("offset_predictions", "semantic_prediction_logits"):
        want = np.asarray(out_j[key])[v]
        got = out_t[key].numpy()[v]
        scale = np.abs(want).max()
        assert scale > 0
        assert np.abs(got - want).max() <= 1e-5 * scale, key


def test_exec_pipeline_runs_from_jax_model_dirs(tmp_path):
    """``python -m treemorph_tpu_torch.scripts.exec_pipeline`` with
    ``model_dirs`` naming the JAX training CLI's checkpoints writes the
    cylinder CSV that ``run_pipeline`` writes with the same weights
    injected."""
    from treemorph_tpu_torch import fixtures as tfix
    from treemorph_tpu_torch.pipeline.run import run_pipeline
    from treemorph_tpu_torch.scripts import exec_pipeline

    offset_dir, noise_dir = small_deployment(str(tmp_path))
    loaded = load_model("treelearn", offset_dir, noise_dir, device="cpu")
    rng = np.random.default_rng(21)
    qsm = tfix.synthetic_qsm(n_branches=2, rng=rng)
    pts, _ = tfix.synthetic_tree_cloud(qsm=qsm, points_per_m2=300,
                                       noise_scale=0.004, rng=rng)
    inp = tmp_path / "in"
    inp.mkdir()
    np.save(inp / "tree.npy", pts)

    def config(out):
        return {
            "general": {"input_dir": str(inp), "output_dir": str(out),
                        "save_qsm_cyl_csv": True},
            "model_dirs": {"treelearn": [offset_dir, noise_dir]},
            "stage1": {"predict_offset": True, "denoise": True,
                       "model_type": "treelearn"},
            "stage2": {"upsampling": False},
            "stage3": {"qsm_fitting": True,
                       "qsm_params": {"seed": 0,
                                      "clustering_type": "angular"}},
        }

    injected = run_pipeline(config(tmp_path / "a"), loaded["O_P3"],
                            loaded["N_P3"], device="cpu")
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(config(tmp_path / "b")))
    cli = exec_pipeline.main(["--config", str(cfg_path), "--device", "cpu"])
    assert injected[0]["cylinders"] > 0
    assert 0 < cli[0]["points"] == injected[0]["points"] <= len(pts)
    csvs = [(tmp_path / d / "treelearn" / "tree_qsm_depth_cylinders.csv")
            .read_bytes() for d in "ab"]
    assert csvs[0] == csvs[1]


def write_fixture():
    """Write ``tests/data/jax_treelearn_P3/``: TreeLearn at the pipeline's
    width (``FAMILY_DEFAULTS``: channels 32, 3 blocks, k = 3) initialized
    as the JAX ``load_model`` initializes its template (key 0), its
    semantic head's final bias set to :data:`KEEP_BIAS`, saved through
    ``save_model_checkpoint`` with the training CLI's metadata, and the
    SHA-256 of every leaf as orbax restores it."""
    model = jloaders.build_model("treelearn")
    variables = jax.device_get(jloaders._init_variables("treelearn", model))
    variables = jax.tree.map(np.asarray, variables)
    variables["params"]["semantic_head"]["Dense_1"]["bias"] = np.array(
        KEEP_BIAS, np.float32)
    shutil.rmtree(DATA, ignore_errors=True)
    os.makedirs(DATA)
    meta = {"model": "treelearn", "plot": 3, "voxel_size": 0.02,
            "num_blocks": 3, "channels": 32, "depth": 5, "dim_feat": 4,
            "noise_distance": 0.05}
    save_model_checkpoint(FIXTURE, SimpleNamespace(**variables), meta)
    with open(FIXTURE_SHA, "w") as f:
        json.dump(sha256_of(orbax_restore(FIXTURE)), f, indent=1,
                  sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    write_fixture()
