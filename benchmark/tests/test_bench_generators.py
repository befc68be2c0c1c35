"""The traffic generator repeats from a seed, varies with it, and labels
every point exactly."""

import json
import os

import numpy as np

from benchmark.lib import traffic, trees

from conftest import load

SPEC = dict(load("benchmark", "traffic", "train_b30.json"), trees=3,
            points_per_tree=4096)


def write(tmp_path, seed, name):
    root = tmp_path / name
    root.mkdir()
    manifest, paths = traffic.write_training_set(SPEC, seed, str(root))
    return manifest, [np.load(p) for p in paths]


def test_a_seed_repeats_and_another_differs(tmp_path):
    manifest, a = write(tmp_path, 2**31 + 5, "a")
    _, b = write(tmp_path, 2**31 + 5, "b")
    _, c = write(tmp_path, 2**31 + 6, "c")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not any(np.array_equal(x, z) for x, z in zip(a, c))
    with open(manifest) as f:
        assert [os.path.basename(p) for p in json.load(f)] == [
            f"1_{i}_labeled.npy" for i in range(3)]


def test_the_trees_are_the_mix_s_whatever_the_seed():
    first = traffic.skeletons(SPEC)
    again = traffic.skeletons(SPEC)
    for x, y in zip(first, again):
        assert all(np.array_equal(x[k], y[k]) for k in x)
    lo, hi = SPEC["n_branches"]
    for sk in first:
        assert 8 + lo <= len(sk["radius"]) <= 8 + hi


def test_labels_are_exact():
    rng = np.random.default_rng(3)
    sk = traffic.skeletons(SPEC)[0]
    cloud, outlier = traffic.labeled_tree(sk, rng, SPEC)
    assert cloud.shape == (SPEC["points_per_tree"], traffic.LABELED_COLUMNS)
    assert cloud.dtype == np.float32
    length = np.linalg.norm(cloud[:, 3:6], axis=1)
    assert np.array_equal(length > SPEC["noise_distance"], outlier)
    assert 0.02 < outlier.mean() < 0.08


def test_offsets_lead_back_to_the_surface():
    rng = np.random.default_rng(4)
    sk = {"start": np.array([[0.0, 0.0, 0.0]]),
          "end": np.array([[0.0, 0.0, 2.0]]), "radius": np.array([0.3])}
    pts, back, _ = trees.scan(sk, rng, 1000, 0.01, 0.1)
    surface = pts + back
    assert np.allclose(np.hypot(surface[:, 0], surface[:, 1]), 0.3,
                       atol=1e-5)


def test_epoch_order_is_the_loader_s():
    from treemorph_tpu_torch.data.treeset import batch_iterator

    class Fake:
        training = True

        def __len__(self):
            return 9

        def __getitem__(self, i):
            return i

    seen = []
    import treemorph_tpu_torch.data.treeset as ts

    real = ts.make_padded_batch
    ts.make_padded_batch = lambda samples, bucket: list(samples)
    try:
        for batch in batch_iterator(Fake(), 3, 1024, shuffle=True,
                                    rng=traffic.epoch_rng(77, 2)):
            seen.extend(batch)
    finally:
        ts.make_padded_batch = real
    assert seen == list(traffic.epoch_order(77, 2, 9))
