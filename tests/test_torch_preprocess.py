"""The port's labeling ops and preprocessing against the JAX package's.

Projection, KNN, radius counts, the 3x3 eigensolver and features, the
``label`` / ``noise`` / ``split`` / ``qsmset`` / ``select-subset`` steps,
the serialization decoders and the preprocessing CLI, on the CPU, with the
same numpy inputs handed to both packages.

The JAX package's grid search (``ops/neighbors.py``) finds cell ranges with
``ops/sparse.py::searchsorted_unrolled``, an unrolled binary search whose
XLA compile takes ~10 s per jitted caller on the CPU. For this module it
is replaced by ``jnp.searchsorted(method="compare_all")``, which counts the
same keys (:func:`test_searchsorted_stand_in_counts_the_same`) and
compiles in ~1.5 s; the rest of the JAX functions run as they are.
"""

import importlib
import json
import os

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.ops import features as jfeat
from treemorph_tpu.ops import neighbors as jnb
from treemorph_tpu.ops import projection as jproj
from treemorph_tpu.ops import serialization as jser
from treemorph_tpu.preprocess import label_generation as jlabel
from treemorph_tpu.preprocess import splitting as jsplit
from treemorph_tpu_torch import fixtures as tfix
from treemorph_tpu_torch.ops import features as tfeat
from treemorph_tpu_torch.ops import neighbors as tnb
from treemorph_tpu_torch.ops import projection as tproj
from treemorph_tpu_torch.ops import serialization as tser
from treemorph_tpu_torch.preprocess import label_clouds
from treemorph_tpu_torch.preprocess.noise_generation import noise_generation
from treemorph_tpu_torch.preprocess import splitting as tsplit
from treemorph_tpu_torch.scripts import preprocess as cli
from treemorph_tpu_torch.utils.table import Table

from test_torch_ops import fresh_jax_caches, one_torch_thread  # noqa: F401

jsparse = importlib.import_module("treemorph_tpu.ops.sparse")
# the package re-exports the function under the module's name
jnoise = importlib.import_module("treemorph_tpu.preprocess.noise_generation")

#: points of each synthetic tree (equal, so the JAX functions compile once)
TREE_POINTS = 1500


def compare_all_search(sorted_keys, queries):
    return jnp.searchsorted(sorted_keys, queries, side="left",
                            method="compare_all").astype(jnp.int32)


@pytest.fixture(scope="module", autouse=True)
def quick_jax_search():
    unrolled = jsparse.searchsorted_unrolled
    jsparse.searchsorted_unrolled = compare_all_search
    yield unrolled
    jsparse.searchsorted_unrolled = unrolled


def test_searchsorted_stand_in_counts_the_same(quick_jax_search):
    rng = np.random.default_rng(0)
    keys = np.sort(rng.integers(0, 9, 30)).astype(np.int32)
    queries = rng.integers(-3, 12, 50).astype(np.int32)
    want = np.searchsorted(keys, queries, side="left")
    for search in (quick_jax_search, compare_all_search):
        np.testing.assert_array_equal(
            np.asarray(search(jnp.asarray(keys), jnp.asarray(queries))),
            want)


def tree(seed, n=TREE_POINTS):
    """A synthetic tree's first ``n`` raw points and its QSM table."""
    rng = np.random.default_rng(seed)
    qsm = tfix.synthetic_qsm(n_branches=3, rng=rng)
    pts, _ = tfix.synthetic_tree_cloud(qsm=qsm, points_per_m2=500, rng=rng)
    return pts[rng.permutation(len(pts))[:n]], qsm


def test_table_read_csv_types_as_pandas(tmp_path):
    _, qsm = tree(1)
    path = str(tmp_path / "q.csv")
    qsm.to_csv(path)
    with open(path) as f:
        text = f.read().replace("startX", ' "startX" ', 1)
    with open(path, "w") as f:
        f.write(text)
    ours = Table.read_csv(path)
    # pandas' default float parser is not correctly rounded (1 ulp off on
    # some of these 17-digit fields); Python's float() and the round-trip
    # parser are
    theirs = pd.read_csv(path, float_precision="round_trip")
    theirs.columns = theirs.columns.str.strip().str.replace('"', "")
    assert ours.columns == list(theirs.columns)
    for c in ours.columns:
        assert ours[c].dtype == theirs[c].dtype, c
        np.testing.assert_array_equal(ours[c], theirs[c].to_numpy())


@pytest.mark.parametrize("move_to_mantle", [True, False])
def test_closest_cylinder_matches_jax(move_to_mantle):
    """Ids equal, offsets and distances within 1e-5: padded cylinders
    (never chosen), a zero-length cylinder, points beyond both caps and
    points within ``PERP_ATOL`` of a cap plane."""
    rng = np.random.default_rng(2)
    start = np.array([[0, 0, 0], [1, 0, 0], [0, 2, 1], [3, 3, 3]],
                     np.float32)
    end = np.array([[0, 0, 2], [1, 1, 0], [0, 2, 1], [3.5, 3, 4]],
                   np.float32)  # the third has zero length
    radius = np.array([0.3, 0.2, 0.25, 0.4], np.float32)
    pts = [rng.uniform(-1, 4, (300, 3))]
    pts.append(np.c_[rng.uniform(-0.2, 0.2, (20, 2)),
                     rng.choice([-0.5, 2.5], 20)])  # beyond both caps
    pts.append(np.c_[rng.uniform(-0.6, 0.6, (20, 2)),
                     rng.uniform(-5e-4, 5e-4, 20)])  # within PERP_ATOL
    pts.append(np.array([[0, 2.3, 1.0], [0.0, 2.0, 1.0]]))  # at the point
    pts = np.concatenate(pts).astype(np.float32)
    ids = np.array([7, 8, 9, 10], np.int32)
    jcyl = jproj.make_cylinders(start, end, radius, ids, pad_to=16)
    tcyl = tproj.make_cylinders(start, end, radius, ids, pad_to=16)
    ji, jd, jo = jproj.closest_cylinder(jnp.asarray(pts), jcyl,
                                        move_to_mantle=move_to_mantle,
                                        tile=128)
    ti, td, to = tproj.closest_cylinder(torch.from_numpy(pts), tcyl,
                                        move_to_mantle=move_to_mantle,
                                        tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert set(np.unique(ti.numpy())) <= set(ids)
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= 1e-5
    assert np.abs(td.numpy() - np.asarray(jd)).max() <= 1e-5


def test_knn_and_radius_count_match_jax():
    """Overflowing cells (``max_per_cell=2``, so most candidates are
    dropped) and invalid points: the same indices, the same squared
    distances bit for bit, the same counts."""
    pts, _ = tree(3)
    valid = np.ones(len(pts), bool)
    valid[::37] = False
    p, v = jnp.asarray(pts), jnp.asarray(valid)
    ji, jd = jnb.knn(p, p[:400], v, 8, 0.1, max_per_cell=2)
    ti, td = tnb.knn(torch.from_numpy(pts), torch.from_numpy(pts[:400]),
                     torch.from_numpy(valid), 8, 0.1, max_per_cell=2)
    assert np.isinf(np.asarray(jd)).any()  # empty slots
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    jc = jnb.radius_count(p, p, v, 0.05, max_per_cell=2)
    tc = tnb.radius_count(torch.from_numpy(pts), torch.from_numpy(pts),
                          torch.from_numpy(valid), 0.05, max_per_cell=2)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def vector_tolerance(eigvals):
    """Tolerance of a smallest eigenvector of an f32 covariance: 1e-5,
    plus the Davis-Kahan bound ||E|| / gap with a perturbation ||E|| of
    1e-6 of the largest eigenvalue (the rounding of the covariance and of
    the trigonometric eigenvalues) over the gap to the next eigenvalue;
    where the smallest eigenvalue is repeated the vector is not
    determined."""
    scale = np.abs(eigvals).max(axis=1)
    gap = (eigvals[:, 1] - eigvals[:, 0]) / np.maximum(scale, 1e-30)
    return 1e-5 + 1e-6 / np.maximum(gap, 1e-30)


def assert_vectors_close(got, want, eigvals):
    """Eigenvectors (normals) equal up to sign within
    :func:`vector_tolerance`, which is below 1e-4 for 99 % of them."""
    sign = np.where((got * want).sum(axis=1, keepdims=True) < 0, -1, 1)
    err = np.abs(got - sign * want).max(axis=1)
    tol = vector_tolerance(eigvals)
    assert (tol < 1e-4).mean() >= 0.99
    assert (err <= tol).all(), (err / tol).max()
    return tol


def test_eigensolver_matches_jax():
    """Random covariances, repeated eigenvalues, a zero eigenvalue (a
    planar patch), the zero and the isotropic matrix. Eigenvalues within
    1e-5 of scale; where two coincide, within 3.5e-4 (sqrt of f32's
    epsilon: the arccos near +-1 of the trigonometric method); vectors as
    :func:`assert_vectors_close`. JAX's compiled program flushes ``p^3``
    to zero where the matrix is a multiple of the identity (p ~ 1e-15 from
    the clamp), and its eigenvalues there are NaN; the port keeps the
    subnormal, and its eigenvalues there are the mean of the diagonal.
    Both give +z as the eigenvector."""
    rng = np.random.default_rng(4)
    a = rng.normal(size=(200, 3, 5)).astype(np.float32)
    covs = [a @ a.transpose(0, 2, 1) / 4]
    rot = np.linalg.qr(rng.normal(size=(3, 3)))[0]
    exact = [[1, 1, 2], [1, 2, 2], [0, 1, 3], [0, 0, 1], [0, 0, 0],
             [2, 2, 2]]
    covs += [(rot @ np.diag(e) @ rot.T)[None] for e in exact]
    cov = np.concatenate(covs).astype(np.float32)
    jv, je = jax.jit(jfeat._sym3x3_smallest_eig)(jnp.asarray(cov))
    tv, te = tfeat._sym3x3_smallest_eig(torch.from_numpy(cov))
    jv, je, tv, te = map(np.asarray, (jv, je, tv, te))
    flushed = np.isnan(je).any(axis=1)
    np.testing.assert_array_equal(np.flatnonzero(flushed), [204, 205])
    mean = np.trace(cov[flushed], axis1=1, axis2=2)[:, None] / 3
    np.testing.assert_allclose(te[flushed], np.broadcast_to(mean, (2, 3)),
                               atol=1e-6)
    np.testing.assert_array_equal(tv[flushed], jv[flushed])
    np.testing.assert_array_equal(tv[flushed], [[0, 0, 1]] * 2)
    np.testing.assert_allclose(te[200:204], exact[:4], atol=1e-6)
    je, te, jv, tv = je[~flushed], te[~flushed], jv[~flushed], tv[~flushed]
    scale = np.abs(je).max(axis=1)
    repeated = np.isin(np.arange(len(je)), [200, 201, 203])
    tol = np.where(repeated, 3.5e-4, 1e-5) * scale
    assert (np.abs(te - je).max(axis=1) <= tol).all()
    assert_vectors_close(tv[:200], jv[:200], te[:200])
    np.testing.assert_allclose(np.linalg.norm(tv, axis=1), 1, atol=1e-6)


def assert_normals_close(got, want, pts):
    """Normals as :func:`assert_vectors_close` holds eigenvectors, with
    the eigenvalues of the port's k-NN covariance; returns each point's
    tolerance."""
    cov = tfeat._neighbor_covariance(torch.from_numpy(pts), torch.ones(
        len(pts), dtype=torch.bool), 15, 0.25, 16)
    return assert_vectors_close(got, want,
                                tfeat._sym3x3_smallest_eig(cov)[1].numpy())


def test_add_features_match_jax():
    """Every feature column in the reference's order: normals and
    verticality as :func:`assert_normals_close` holds them; curvature,
    density, height and distance to the centre within 1e-5."""
    pts, _ = tree(5)
    cloud = np.c_[pts, np.zeros((len(pts), 4), np.float32)]
    flags = dict(use_normals=True, use_heights=True, use_densities=True,
                 use_verticalities=True, use_distances=True,
                 use_curvatures=True)
    want = jfeat.add_features(cloud, **flags)
    got = tfeat.add_features(cloud, **flags, device="cpu")
    assert got.shape == want.shape == (len(pts), 7 + 8)
    tol = assert_normals_close(got[:, 7:10], want[:, 7:10], pts)
    # verticality |n_z| follows the normal
    assert (np.abs(got[:, 13] - want[:, 13]) <= tol).all()
    got[:, 13] = want[:, 13]
    # curvature: NaN in JAX where a point's 10 neighbours coincide (the
    # flushed p^3 of test_eigensolver_matches_jax); ~0 in the port
    flushed = np.isnan(want[:, 10])
    assert np.abs(got[flushed, 10]).max() <= 1e-6
    assert flushed.mean() < 0.01
    want[flushed, 10] = 0
    np.testing.assert_allclose(got[:, 10:], want[:, 10:], atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_array_equal(got[:, :7], cloud)


def write_raw_trees(root):
    """Two synthetic trees of two plots, raw ``.npy`` clouds beside their
    QSM CSVs (written by the port's ``Table.to_csv``)."""
    os.makedirs(os.path.join(root, "raw"))
    os.makedirs(os.path.join(root, "qsm"))
    for stem, seed in (("1_4", 6), ("2_9", 7)):
        pts, qsm = tree(seed)
        np.save(os.path.join(root, "raw", f"{stem}.npy"), pts)
        qsm.to_csv(os.path.join(root, "qsm", f"{stem}_000000.csv"))


def assert_labels_close(got, want):
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[:, 6], want[:, 6])  # cylinder ids
    assert np.abs(got[:, :6] - want[:, :6]).max() <= 1e-5
    if want.shape[1] == 11:
        assert_normals_close(got[:, 7:10], want[:, 7:10], got[:, :3].copy())
        assert np.abs(got[:, 10] - want[:, 10]).max() <= 1e-5


def test_label_noise_and_split_match_jax(tmp_path):
    """``label_clouds``, ``noise_generation`` (seed 0) and the splits on a
    directory of two trees: arrays within 1e-5 (normals up to sign), the
    same manifests and the same file choices."""
    root = str(tmp_path)
    write_raw_trees(root)
    jpaths = jlabel.label_clouds(f"{root}/raw", f"{root}/qsm", f"{root}/j")
    tpaths = label_clouds(f"{root}/raw", f"{root}/qsm", f"{root}/t",
                          device="cpu")
    assert [os.path.basename(p) for p in tpaths] == [
        os.path.basename(p) for p in jpaths] == ["1_4_labeled.npy",
                                                 "2_9_labeled.npy"]
    for jp, tp in zip(jpaths, tpaths):
        assert_labels_close(np.load(tp), np.load(jp))

    jn = jnoise.noise_generation(f"{root}/qsm", f"{root}/jn", density=40.0)
    tn = noise_generation(f"{root}/qsm", f"{root}/tn", density=40.0,
                          device="cpu")
    assert [os.path.basename(p) for p in tn] == [
        os.path.basename(p) for p in jn]
    for jp, tp in zip(jn, tn):
        assert_labels_close(np.load(tp), np.load(jp))

    # external test clouds pair with QSMs on three name tokens; one of
    # four has no QSM
    os.makedirs(f"{root}/ext_c")
    os.makedirs(f"{root}/ext_q")
    for i in range(4):
        np.save(f"{root}/ext_c/p_{i}_t_scan.npy", np.zeros((1, 3)))
        if i != 2:
            open(f"{root}/ext_q/p_{i}_t_000.csv", "w").close()
    copied = {}
    for pkg, name in ((jsplit, "js"), (tsplit, "ts")):
        pkg.split_dataset(f"{root}/t", f"{root}/{name}", test_size=0.5)
        pkg.create_qsm_test_sets(f"{root}/t", f"{root}/{name}", n_per_plot=1)
        copied[name] = pkg.select_test_subset(
            f"{root}/ext_c", f"{root}/ext_q", f"{root}/{name}_c",
            f"{root}/{name}_q", n=2, seed=3, cloud_suffix=".npy")
    assert len(copied["ts"]) == 2
    assert copied["ts"] == copied["js"]
    names = sorted(os.listdir(f"{root}/js"))
    assert names == sorted(os.listdir(f"{root}/ts")) == [
        "plot_1.json", "plot_2.json", "qsm_set_1.json", "qsm_set_2.json",
        "testset.json", "trainset.json"]
    for name in names:
        with open(f"{root}/js/{name}") as a, open(f"{root}/ts/{name}") as b:
            assert json.load(a) == json.load(b)
    for sub in ("c", "q"):
        assert sorted(os.listdir(f"{root}/js_{sub}")) == sorted(
            os.listdir(f"{root}/ts_{sub}"))


@pytest.mark.parametrize("order", tser.ORDERS)
def test_serialization_decoders_and_order_match_jax(order):
    """``decode`` inverts ``encode`` and gives the JAX decoder's grid;
    ``serialized_order`` is the JAX permutation and its inverse (compared
    on the Hilbert order: the sort is the same for every curve's codes,
    which ``test_torch_ops.py`` and ``test_torch_ptv3.py`` hold to JAX's)."""
    rng = np.random.default_rng(8)
    grid = rng.integers(0, 2**16, (300, 3)).astype(np.int32)
    grid[:40] = grid[40:80]  # equal codes keep input order
    batch = rng.integers(0, 3, 300).astype(np.int32)
    b, code = tser.encode(torch.from_numpy(grid), torch.from_numpy(batch),
                          order=order)
    got, gb = tser.decode(b.numpy(), code.numpy(), order=order)
    np.testing.assert_array_equal(got, grid)
    np.testing.assert_array_equal(gb, batch)
    # the codes themselves match JAX's in test_torch_ops.py
    want, _ = jser.decode(batch, code.numpy() >> 32,
                          code.numpy() & 0xFFFFFFFF, order=order)
    np.testing.assert_array_equal(got, want)
    perm, inv = tser.serialized_order(torch.from_numpy(grid),
                                      torch.from_numpy(batch), order=order)
    np.testing.assert_array_equal(perm[inv].numpy(), np.arange(len(grid)))
    if order != "hilbert":
        return  # the same sort of other codes; JAX compiles each order
    jperm, jinv = jser.serialized_order(jnp.asarray(grid),
                                        jnp.asarray(batch), order=order)
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(inv.numpy(), np.asarray(jinv))


def test_preprocess_cli_help_and_label(tmp_path, capsys):
    """``--help`` lists the JAX CLI's subcommands; ``label --no_features
    --device cpu`` writes the (N, 7) labels and four ones."""
    with pytest.raises(SystemExit) as exit_:
        cli.main(["--help"])
    assert exit_.value.code == 0
    text = capsys.readouterr().out
    for command in ("label", "noise", "rasterize", "split", "qsmset",
                    "select-subset"):
        assert command in text
    root = str(tmp_path)
    write_raw_trees(root)
    written = cli.main(["label", "--cloudDir", f"{root}/raw", "--cylinderDir",
                        f"{root}/qsm", "--labelDir", f"{root}/cloud",
                        "--no_features", "--device", "cpu"])
    assert "labeled 2 clouds" in capsys.readouterr().out
    for path in written:
        labeled = np.load(path)
        assert labeled.shape == (TREE_POINTS, 11)
        np.testing.assert_array_equal(labeled[:, 7:], 1)
    cli.main(["split", "--data_root", root, "--test_size", "0.5"])
    with open(os.path.join(root, "plot_2.json")) as f:
        assert json.load(f) == [written[1]]


def test_labeling_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Without a card the labeling entry points raise unless told to use
    the CPU, as every entry point of the port does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pts, qsm = tree(9, n=50)
    root = str(tmp_path)
    write_raw_trees(root)
    calls = [
        lambda: tproj.generate_offset_cloud(pts, qsm),
        lambda: tfeat.add_features(np.c_[pts, np.zeros((50, 4))]),
        lambda: label_clouds(f"{root}/raw", f"{root}/qsm", f"{root}/out"),
        lambda: noise_generation(f"{root}/qsm", f"{root}/noise"),
        lambda: cli.main(["label", "--cloudDir", f"{root}/raw",
                          "--cylinderDir", f"{root}/qsm", "--labelDir",
                          f"{root}/out"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
