"""The port's rasterizer and raster datasets against the JAX package's:
``rasterize_clouds`` (the metadata JSON and byte-identical raster files),
the flattened and hierarchical datasets' samples and minibatches, and the
hierarchical iterators' batch sequences under one numpy seed.

Inputs are labeled clouds of a synthetic tree's scan (the (N, 11) layout
of ``test_torch_train.labeled_cloud``) cut into 0.2 m rasters, so that a
few hundred points make dozens of rasters.
"""

import json
import os

import numpy as np
import pytest

from treemorph_tpu.data import rasterized as jraster
from treemorph_tpu.preprocess.rasterize import (
    rasterize_clouds as jrasterize,
)
from treemorph_tpu_torch.data import rasterized as traster
from treemorph_tpu_torch.preprocess import clean_stem, rasterize_clouds

from test_torch_ops import fresh_jax_caches, one_torch_thread  # noqa: F401
from test_torch_train import assert_batches_equal, labeled_cloud

RASTER, STRIDE = 0.2, 0.1


def write_clouds(root, plots=(1, 2), trees=2, n=300):
    """Labeled clouds ``{plot}_{tree}_labeled.npy`` under ``root``; their
    paths in order."""
    paths = []
    for plot in plots:
        for tree in range(trees):
            path = root / f"{plot}_{tree}_labeled.npy"
            np.save(path, labeled_cloud(10 * plot + tree, n + 41 * tree))
            paths.append(str(path))
    return paths


@pytest.fixture(scope="module")
def rasterized(tmp_path_factory):
    """Both packages' rasterizer outputs of the same clouds: ``(paths,
    {"jax": (metadata, raster dir), "port": (...)})``, metadata also
    written as JSON under each output root."""
    root = tmp_path_factory.mktemp("rasters")
    paths = write_clouds(root)
    out = {}
    for name, fn in (("jax", jrasterize), ("port", rasterize_clouds)):
        meta = fn(paths, output_dir=str(root / name),
                  json_path=str(root / f"{name}.json"),
                  raster_size=RASTER, stride=STRIDE, store_metadata=True)
        out[name] = (meta, root / name / f"rasterized_R{RASTER}_S{STRIDE}")
    return paths, out


@pytest.mark.parametrize("min_points", [1, 25])
def test_rasterize_clouds_matches_jax(tmp_path, min_points):
    """The same metadata (and JSON file) and byte-identical per-raster
    ``.npy`` files, trailing point-index column included."""
    paths = write_clouds(tmp_path, plots=(3,))
    metas = []
    for name, fn in (("jax", jrasterize), ("port", rasterize_clouds)):
        metas.append(fn(paths, output_dir=str(tmp_path / name),
                        json_path=str(tmp_path / f"{name}.json"),
                        raster_size=RASTER, stride=STRIDE,
                        store_metadata=True, min_points=min_points))
    assert metas[0] == metas[1]
    assert sum(len(v["rasters"]) for v in metas[0].values()) > 10
    assert ((tmp_path / "jax.json").read_bytes()
            == (tmp_path / "port.json").read_bytes())
    dirs = [tmp_path / name / f"rasterized_R{RASTER}_S{STRIDE}"
            for name in ("jax", "port")]
    files = sorted(os.listdir(dirs[0]))
    assert files == sorted(os.listdir(dirs[1])) and files
    for f in files:
        assert (dirs[0] / f).read_bytes() == (dirs[1] / f).read_bytes(), f
    if min_points > 1:
        sizes = [len(np.load(dirs[1] / f)) for f in files]
        assert min(sizes) >= min_points
    assert clean_stem(paths[0]) == "3_0"


def test_raster_dataset_matches_jax(rasterized):
    """Every sample of ``raster_dataset_from_dir`` (training and not) and
    the padded batches of the flattened view."""
    from treemorph_tpu.data import batch_iterator as jbatches
    from treemorph_tpu_torch.data import batch_iterator as tbatches

    _, out = rasterized
    raster_dir = str(out["port"][1])
    for training in (True, False):
        jds = jraster.raster_dataset_from_dir(raster_dir, training)
        tds = traster.raster_dataset_from_dir(raster_dir, training)
        assert tds.data_paths == jds.data_paths and len(tds) > 20
        for i in range(len(tds)):
            a, b = tds[i], jds[i]
            for field in ("points", "feats", "offsets", "semantic_label",
                          "offset_mask"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
            assert a.path == b.path
    got = list(tbatches(tds, 4, 64, rng=np.random.default_rng(2)))
    want = list(jbatches(jds, 4, 64, rng=np.random.default_rng(2)))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert_batches_equal(a, b)


def test_hierarchical_dataset_matches_jax(rasterized):
    """Trees merged from two metadata JSONs (the second repeats a tree's
    rasters), each tree's rasters and its ``minibatches``: the same
    PaddedBatch, padding bucket and point ids."""
    _, out = rasterized
    meta = out["jax"][0]
    root = out["jax"][1].parent.parent
    first = {k: meta[k] for k in list(meta)[:3]}
    extra = {list(meta)[0]: meta[list(meta)[0]],
             list(meta)[3]: meta[list(meta)[3]]}
    files = []
    for i, part in enumerate((first, extra)):
        files.append(str(root / f"part{i}.json"))
        with open(files[-1], "w") as f:
            json.dump(part, f)
    jds = jraster.HierarchicalRasterDataset(files, minibatch_size=5)
    tds = traster.HierarchicalRasterDataset(files, minibatch_size=5)
    assert tds.tree_keys == jds.tree_keys and len(tds) == 4
    n_batches = 0
    for i in range(len(tds)):
        a, b = tds[i], jds[i]
        assert a.cloud_length == b.cloud_length and a.path == b.path
        for field in ("points", "feats", "offsets", "semantic_label",
                      "offset_mask"):
            np.testing.assert_array_equal(getattr(a, field),
                                          getattr(b, field))
        assert len(a.raster_point_ids) == len(b.raster_point_ids)
        for p, q in zip(a.raster_point_ids, b.raster_point_ids):
            np.testing.assert_array_equal(p, q)
        pairs = zip(tds.minibatches(a, 128), jds.minibatches(b, 128))
        for (tb, tids), (jb, jids) in pairs:
            assert_batches_equal(tb, jb)
            assert tb.num_points % 128 == 0
            for p, q in zip(tids, jids):
                np.testing.assert_array_equal(p, q)
            n_batches += 1
    assert n_batches > len(tds)
    single = traster.HierarchicalRasterDataset(files, single_sample=True)
    assert single.tree_keys == tds.tree_keys[:1]


@pytest.mark.parametrize("grouped", [False, True])
def test_hierarchical_iterators_match_jax(rasterized, grouped):
    """``hierarchical_batch_iterator`` and ``hierarchical_group_iterator``
    (two trees a group) give JAX's batch sequence, grouped alike, under one
    numpy seed for two epochs, and leave the seed's generator in the same
    state; a dataset out of training keeps the trees' order."""
    _, out = rasterized
    path = str(out["port"][1].parent.parent / "port.json")
    for training in (True, False):
        seqs = []
        for mod in (traster, jraster):
            ds = mod.HierarchicalRasterDataset(path, training=training,
                                               minibatch_size=6)
            rng = np.random.default_rng(4)
            epochs = []
            for _ in range(2):
                if grouped:
                    epochs.append([list(g) for g in
                                   mod.hierarchical_group_iterator(
                                       ds, 64, rng=rng, trees_per_step=2)])
                else:
                    epochs.append(list(mod.hierarchical_batch_iterator(
                        ds, 64, rng=rng)))
            seqs.append((epochs, rng.random()))
        (got, tail_t), (want, tail_j) = seqs
        assert tail_t == tail_j
        flat = []
        for ge, we in zip(got, want):
            assert len(ge) == len(we) > 0
            for a, b in zip(ge, we):
                if grouped:
                    assert len(a) == len(b) > 0
                    flat.extend(zip(a, b))
                else:
                    flat.append((a, b))
        for a, b in flat:
            assert_batches_equal(a, b)
        if grouped:
            assert len(got[0]) == 2  # four trees, two a group
