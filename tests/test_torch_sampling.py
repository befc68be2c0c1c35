"""The port's PointNet++ sampling and grouping against the JAX package's
(``treemorph_tpu/ops/sampling.py``), on padded batches of real rasters: 1 m
cubes of a synthetic tree's scan, padded with invalid rows.

The JAX functions run compiled (``jax.jit``), as the model runs them: the
port rounds the distance identity as that program does, so distances are
bit for bit equal and FPS and ball-query indices identical. The ball
query's test still allows a membership flip where a squared distance lies
at the radius to within the identity's f32 rounding: such flips are
counted, each is held to that closeness (float64 distances), and every row
without one must give identical indices.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.ops import sampling as jsamp
from treemorph_tpu_torch.fixtures import synthetic_qsm, synthetic_tree_cloud
from treemorph_tpu_torch.ops import sampling as tsamp
from treemorph_tpu_torch.pipeline.predict import raster_assignments

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, t,
)

#: f32 rounding of the identity ``-2 a.b + |a|^2 + |b|^2``: a few ulps of
#: its largest term
IDENTITY_ULPS = 8 * np.finfo(np.float32).eps


def tree_points(seed=0):
    rng = np.random.default_rng(seed)
    qsm = synthetic_qsm(n_branches=2, rng=rng)
    pts, _ = synthetic_tree_cloud(qsm=qsm, points_per_m2=3000,
                                  noise_scale=0.004, rng=rng)
    return pts.astype(np.float32)


def raster_batch(seed=0, b=3, n=1536, pad=64):
    """(coords (b, n + pad, 3), feats (b, n + pad, 4), valid) of the ``b``
    largest 1 m rasters of a tree's scan, each cut to ``n`` points, a
    different count each, padded with zero rows."""
    pts = tree_points(seed)
    rasters = sorted(raster_assignments(pts, 1.0, 1.0),
                     key=lambda r: -len(r[1]))[:b]
    rng = np.random.default_rng(seed + 7)
    coords = np.zeros((b, n + pad, 3), np.float32)
    feats = np.zeros((b, n + pad, 4), np.float32)
    valid = np.zeros((b, n + pad), bool)
    for i, (_, idx) in enumerate(rasters):
        k = min(len(idx), n - 97 * i)
        coords[i, :k] = pts[idx[:k]]
        feats[i, :k] = rng.normal(size=(k, 4))
        valid[i, :k] = True
    assert valid.sum(axis=1).min() > 1000
    return coords, feats, valid


@pytest.fixture(scope="module")
def batch():
    return raster_batch()


def test_square_distance_matches_jax(batch):
    """Both use the matmul identity in f32 (JAX at 'highest' precision):
    bit for bit equal to the compiled JAX function, a point's distance to
    itself exactly 0, and within the identity's rounding of the float64
    distance. The port's chunks over N (a small chunk size here) change
    nothing."""
    coords, _, _ = batch
    a, b = coords[:, :200], coords
    got = tsamp.square_distance(t(a), t(b)).numpy()
    want = np.asarray(jax.jit(jsamp.square_distance)(jnp.asarray(a),
                                                     jnp.asarray(b)))
    np.testing.assert_array_equal(got, want)
    assert (np.diagonal(got[:, :, :200], axis1=1, axis2=2) == 0).all()
    old = tsamp._CHUNK_ELEMENTS
    try:
        tsamp._CHUNK_ELEMENTS = 7 * b.shape[0] * b.shape[1]
        np.testing.assert_array_equal(
            tsamp.square_distance(t(a), t(b)).numpy(), got)
    finally:
        tsamp._CHUNK_ELEMENTS = old
    big = ((a.astype(np.float64) ** 2).sum(-1)[:, :, None]
           + (b.astype(np.float64) ** 2).sum(-1)[:, None, :])
    exact = ((a[:, :, None, :].astype(np.float64)
              - b[:, None, :, :]) ** 2).sum(-1)
    assert np.all(np.abs(got - exact) <= IDENTITY_ULPS * big)


def test_square_distance_is_full_f32_under_tf32_settings(batch):
    """The product is elementwise, so no TF32 setting of the process can
    reach it (the CPU ignores the flag; this pins the formulation)."""
    coords, _, _ = batch
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        on = tsamp.square_distance(t(coords[:, :64]), t(coords))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    off = tsamp.square_distance(t(coords[:, :64]), t(coords))
    np.testing.assert_array_equal(on.numpy(), off.numpy())


def test_index_points_matches_jax(batch):
    coords, feats, _ = batch
    idx = np.random.default_rng(1).integers(0, coords.shape[1], (3, 7, 5))
    got = tsamp.index_points(t(feats), t(idx)).numpy()
    want = np.asarray(jsamp.index_points(jnp.asarray(feats), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)


def test_index_points_gradient_matches_jax(batch):
    """The deterministic backward of ``index_points`` (repeated indices
    summed in index order) against ``jax.grad`` of JAX's gather."""
    _, feats, _ = batch
    idx = np.random.default_rng(2).integers(0, 40, (3, 60, 8))
    cot = np.random.default_rng(3).normal(
        size=(*idx.shape, feats.shape[-1])).astype(np.float32)
    x = t(feats).requires_grad_()
    (tsamp.index_points(x, t(idx)) * t(cot)).sum().backward()
    want = jax.grad(lambda f: jnp.sum(
        jsamp.index_points(f, jnp.asarray(idx)) * cot))(jnp.asarray(feats))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("npoint", [100, 1700])
def test_farthest_point_sample_matches_jax(batch, npoint):
    """Exact FPS, first valid point first; 1700 exceeds the valid points
    of the smaller rasters, so their selections repeat. Indices
    identical."""
    coords, _, valid = batch
    got = tsamp.farthest_point_sample(t(coords), t(valid), npoint).numpy()
    want = np.asarray(jsamp.farthest_point_sample(
        jnp.asarray(coords), jnp.asarray(valid), npoint))
    np.testing.assert_array_equal(got, want)
    assert valid[np.arange(3)[:, None], got].all()


@pytest.mark.parametrize("buckets", [4, 16])
def test_bucketed_farthest_point_sample_matches_jax(batch, buckets):
    coords, _, valid = batch
    got = tsamp.bucketed_farthest_point_sample(
        t(coords), t(valid), 100, buckets=buckets).numpy()
    want = np.asarray(jsamp.bucketed_farthest_point_sample(
        jnp.asarray(coords), jnp.asarray(valid), 100, buckets=buckets))
    np.testing.assert_array_equal(got, want)


def test_fps_generator_starts_at_a_valid_point(batch):
    """With scores drawn from a generator the first centroid is a random
    valid point (the two packages draw different numbers: only the rule is
    compared)."""
    coords, _, valid = batch
    gen = torch.Generator().manual_seed(3)
    scores = torch.rand(valid.shape, generator=gen)
    got = tsamp.farthest_point_sample(t(coords), t(valid), 20,
                                      scores).numpy()
    assert valid[np.arange(3)[:, None], got].all()
    assert (got[:, 0] != 0).any()


@pytest.mark.parametrize("radius,nsample", [(0.1, 32), (0.2, 32),
                                            (0.04, 16)])
def test_query_ball_point_matches_jax(batch, radius, nsample):
    """The lowest-index in-ball points, empty balls the nearest point.
    Membership can differ between the packages only for a point whose
    float64 squared distance lies within the identity's f32 rounding of
    r^2 (each package rounds its fused ops its own way): every row without
    such a point gives identical indices, and in the rows that differ
    (counted: a few in a hundred) every index either package returns lies
    in the exact ball or within that rounding of its edge."""
    coords, _, valid = batch
    fps = np.asarray(jsamp.farthest_point_sample(
        jnp.asarray(coords), jnp.asarray(valid), 256))
    new_xyz = np.take_along_axis(coords, fps[..., None], axis=1)
    # a few centres far from every point: empty balls
    new_xyz[:, -3:] += 5.0
    got = tsamp.query_ball_point(radius, nsample, t(coords), t(new_xyz),
                                 t(valid)).numpy()
    want = np.asarray(jsamp.query_ball_point(
        radius, nsample, jnp.asarray(coords), jnp.asarray(new_xyz),
        jnp.asarray(valid)))
    r2 = np.float32(radius ** 2)  # as both packages compare in f32
    exact = ((new_xyz[:, :, None, :].astype(np.float64)
              - coords[:, None, :, :]) ** 2).sum(-1)
    big = ((new_xyz.astype(np.float64) ** 2).sum(-1)[:, :, None]
           + (coords.astype(np.float64) ** 2).sum(-1)[:, None, :])
    near = (np.abs(exact - r2) <= IDENTITY_ULPS * big) & valid[:, None, :]
    allowed = ((exact <= r2) & valid[:, None, :]) | near
    differ = (got != want).any(axis=-1)
    assert not (differ & ~near.any(axis=-1)).any()
    assert differ.sum() <= 0.02 * differ.size, differ.sum()
    np.testing.assert_array_equal(got[~differ], want[~differ])
    for out in (got, want):
        assert np.take_along_axis(allowed[:, :-3], out[:, :-3],
                                  axis=-1).all()
    assert (got[:, -3:] == got[:, -3:, :1]).all()  # empty: one point
    assert ((got[:, :-3] != got[:, :-3, :1]).any(axis=-1)).mean() > 0.5


def test_nearest3_breaks_ties_as_top_k():
    """Duplicate distances and invalid (inf) sources: the three first
    minima equal ``lax.top_k(-d, 3)``'s indices, ties toward the lower
    index."""
    rng = np.random.default_rng(5)
    d = rng.integers(0, 4, size=(2, 50, 9)).astype(np.float32)
    d[:, :, 6:] = np.inf
    d[0, 0] = np.inf  # no valid source at all
    d[1, 1, :2] = [0.0, -0.0]
    got = tsamp._nearest3(t(d), 3).numpy()
    want = np.asarray(jax.lax.top_k(-jnp.asarray(d), 3)[1])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("duplicate", [False, True])
def test_three_nn_interpolate_matches_jax(batch, duplicate):
    """Targets every point, sources every 25th point (some invalid, so
    some targets coincide with a source): 1e-5 of the scale against the
    compiled JAX function (sum order of the weighted neighbours).
    ``duplicate``: each source twice, so every neighbour ties with its
    copy."""
    coords, feats, valid = batch
    rng = np.random.default_rng(6)
    src = coords[:, ::25][:, :64]
    src_valid = rng.random(src.shape[:2]) > 0.1
    src_feats = rng.normal(size=(*src.shape[:2], 16)).astype(np.float32)
    if duplicate:
        src = np.concatenate([src, src], axis=1)
        src_valid = np.concatenate([src_valid, src_valid], axis=1)
        src_feats = np.concatenate([src_feats, src_feats], axis=1)
    got = tsamp.three_nn_interpolate(t(coords), t(src), t(src_feats),
                                     t(src_valid)).numpy()
    want = np.asarray(jax.jit(jsamp.three_nn_interpolate)(
        jnp.asarray(coords), jnp.asarray(src), jnp.asarray(src_feats),
        jnp.asarray(src_valid)))
    scale = np.abs(want).max()
    assert scale > 0.5
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_sample_and_group_matches_jax(batch):
    coords, feats, valid = batch
    got = tsamp.sample_and_group(64, 0.1, 32, t(coords), t(feats), t(valid))
    want = jsamp.sample_and_group(64, 0.1, 32, jnp.asarray(coords),
                                  jnp.asarray(feats), jnp.asarray(valid))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
