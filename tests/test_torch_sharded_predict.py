"""The port's sharded plot-scale inference against its single-device raster
streaming (the JAX package's ``tests/test_sharded_predict.py``).

``predict_rasterized_sharded`` over a two-device
:class:`~treemorph_tpu_torch.parallel.LocalMesh` (both devices the CPU
here) splits the rasters between its devices, accumulates in f32 on each
and reduces each accumulator once; ``predict_rasterized`` accumulates in
float64 on the host. Per point they agree to f32 accumulation order.
"""

import numpy as np
import pytest

from treemorph_tpu_torch.evaluation.model_loaders import Predictor, build_model
from treemorph_tpu_torch.fixtures import synthetic_qsm, synthetic_tree_cloud
from treemorph_tpu_torch.parallel import make_local_mesh
from treemorph_tpu_torch.pipeline import predict

from test_torch_ops import fresh_jax_caches, one_torch_thread  # noqa: F401

KW = dict(raster_size=2.0, stride=2.0, minibatch_size=4, bucket=128,
          device="cpu")


@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(7)
    qsm = synthetic_qsm(n_branches=2, rng=rng)
    pts, _ = synthetic_tree_cloud(qsm=qsm, points_per_m2=160, rng=rng)
    return pts.astype(np.float32)


@pytest.fixture(scope="module")
def predictor():
    return Predictor("pointnet2", build_model("pointnet2", depth=2,
                                              device="cpu"), "cpu")


@pytest.fixture
def mesh():
    return make_local_mesh(devices=["cpu", "cpu"])


def run_both(cloud, mesh, **kw):
    before = predict.REDUCTIONS["reduce_scatter"]
    single = predict.predict_rasterized(cloud, **KW, **kw)
    sharded = predict.predict_rasterized_sharded(cloud, mesh=mesh, **KW,
                                                 **kw)
    return single, sharded, predict.REDUCTIONS["reduce_scatter"] - before


def test_offsets_match_single_device(cloud, predictor, mesh):
    single, sharded, reductions = run_both(
        cloud, mesh, offset_model=predictor, predict_offset=True,
        denoise=False)
    assert sharded.shape == single.shape
    moved = single - cloud
    np.testing.assert_allclose(sharded, single, rtol=0,
                               atol=1e-5 * np.abs(moved).max())
    assert np.abs(moved).max() > 0
    assert reductions == 2  # the accumulator and the count, once each


def test_denoise_matches_single_device(cloud, predictor, mesh):
    single, sharded, reductions = run_both(
        cloud, mesh, noise_model=predictor, predict_offset=False,
        denoise=True)
    np.testing.assert_array_equal(sharded, single)
    assert reductions == 2


def test_fewer_rasters_than_devices(predictor):
    """One raster over four devices: three hold only padding, and their
    minibatches are not run."""
    rng = np.random.default_rng(3)
    pts = rng.normal(scale=0.3, size=(200, 3)).astype(np.float32)
    cloud = np.concatenate([pts, np.zeros((200, 8), np.float32)], axis=1)
    mesh = make_local_mesh(devices=["cpu"] * 4)
    kw = dict(offset_model=predictor, predict_offset=True, denoise=False,
              raster_size=5.0, stride=5.0, minibatch_size=4, bucket=128,
              device="cpu")
    assert len(predict.raster_assignments(pts, 5.0, 5.0)) < mesh.size
    single = predict.predict_rasterized(cloud, **kw)
    sharded = predict.predict_rasterized_sharded(cloud, mesh=mesh, **kw)
    np.testing.assert_allclose(sharded, single, rtol=0,
                               atol=1e-5 * np.abs(single - pts).max())


def test_mesh_none_is_predict_rasterized(cloud, predictor):
    kw = dict(offset_model=predictor, predict_offset=True, denoise=False,
              **KW)
    np.testing.assert_array_equal(
        predict.predict_rasterized(cloud, **kw),
        predict.predict_rasterized_sharded(cloud, mesh=None, **kw))
