"""The QSM options that the JAX package runs through scikit-learn, in the
port without it: agglomerative shell clustering, euclidean DBSCAN shells
and candidate merging (a DBSCAN with ``min_samples=1`` over the candidate
centers).

The labels are held to scikit-learn's number for number (the label order
sets the candidates' order and so the RANSAC draws), on seeded clouds:
random ones, and clouds on a 0.1 grid, where many distances tie with each
other and with ``eps`` (up to 11 points scikit-learn searches by brute
force, which rounds distances otherwise and not symmetrically). Then each
option's cylinder CSV on the fixture of
``test_torch_pipeline.py::test_fit_qsm_csv_is_byte_identical`` is held
byte for byte to the JAX package's ``fit_qsm``.
"""

import numpy as np
import pytest
from sklearn.cluster import DBSCAN, AgglomerativeClustering
from threadpoolctl import threadpool_limits

from treemorph_tpu import fixtures as jfix
from treemorph_tpu.pipeline.qsm import QSMParams as JParams
from treemorph_tpu.pipeline.qsm import fit_qsm as jfit
from treemorph_tpu_torch.pipeline.qsm import QSMParams, fit_qsm
from treemorph_tpu_torch.pipeline.qsm import geometry

from test_torch_ops import fresh_jax_caches, one_torch_thread  # noqa: F401

EPS = (0.1, 0.2, float(np.sqrt(0.02)), 0.3, 0.7)


@pytest.fixture(autouse=True)
def one_blas_thread():
    """scikit-learn's radius search starts an OpenMP team per call, which
    made 600 small DBSCANs take 15 s instead of 1.5 s in one test
    process."""
    with threadpool_limits(1):
        yield


def cloud(seed):
    """A seeded cloud of 1-60 points: on a 0.1 grid (ties) in float64 or
    float32, or normal in float64 or float32."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))
    if seed % 2:
        x = rng.normal(size=(n, 3))
    else:
        x = rng.integers(0, 6, size=(n, 3)).astype(float) * 0.1
    return x.astype(np.float32) if seed % 4 >= 2 else x


@pytest.mark.parametrize("linkage", ["single", "average", "complete", "ward"])
def test_agglomerative_labels_match_sklearn(linkage):
    for seed in range(60):
        x = cloud(seed)
        if len(x) < 2:
            continue
        for eps in EPS:
            want = AgglomerativeClustering(
                n_clusters=None, distance_threshold=eps, linkage=linkage,
            ).fit_predict(x)
            got = geometry.cluster_labels_agglomerative(x, eps, 1, linkage)
            np.testing.assert_array_equal(got, want, err_msg=f"{seed} {eps}")
    # clusters below min_cluster_size become -1, the others keep their
    # number (the JAX package's rule)
    x = cloud(1)
    want = AgglomerativeClustering(n_clusters=None, distance_threshold=0.7,
                                   linkage=linkage).fit_predict(x)
    got = geometry.cluster_labels_agglomerative(x, 0.7, 3, linkage)
    sizes = np.bincount(want)
    np.testing.assert_array_equal(got, np.where(sizes[want] >= 3, want, -1))


@pytest.mark.parametrize("min_samples", [1, 2, 4, 6])
def test_dbscan_labels_match_sklearn(min_samples):
    for seed in range(120):
        x = cloud(seed)
        for eps in EPS:
            want = DBSCAN(eps=eps, min_samples=min_samples).fit(x).labels_
            got = geometry.dbscan_labels(x, eps, min_samples)
            np.testing.assert_array_equal(got, want, err_msg=f"{seed} {eps}")


@pytest.fixture(scope="module")
def fixture_cloud():
    qsm = jfix.synthetic_qsm(n_branches=3, rng=np.random.default_rng(3))
    points, _ = jfix.synthetic_tree_cloud(
        qsm=qsm, points_per_m2=1500, noise_scale=0.004,
        outlier_fraction=0.02, rng=np.random.default_rng(5),
    )
    return points


@pytest.mark.parametrize("options", [
    dict(clustering_type="euclidian", clustering_algorithm="agglomerative"),
    dict(clustering_type="euclidian", clustering_algorithm="agglomerative",
         clustering_linkage="average", merging_procedure="weighted"),
    dict(clustering_type="euclidian", clustering_algorithm="dbscan"),
    dict(clustering_type="euclidian", clustering_algorithm="dbscan",
         merging_procedure="enclosed"),
    dict(merging_procedure="weighted"),
    dict(merging_procedure="subset"),
], ids=["agglomerative", "average-weighted", "dbscan", "dbscan-enclosed",
        "weighted", "subset"])
def test_fit_qsm_csv_is_byte_identical_with_option(tmp_path, fixture_cloud,
                                                   options):
    df, _, _, _ = jfit(fixture_cloud, params=JParams(seed=0, **options),
                       output_base=str(tmp_path / "jax"))
    table, _, _, _ = fit_qsm(fixture_cloud, params=QSMParams(seed=0,
                                                             **options),
                             output_base=str(tmp_path / "port"))
    assert len(table) == len(df) > 20
    assert (tmp_path / "port_cylinders.csv").read_bytes() == (
        tmp_path / "jax_cylinders.csv"
    ).read_bytes()
