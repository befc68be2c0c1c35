"""The port's device ops against the JAX package: voxelize, the rulebook,
the stride-2 structure, the gather/down/inverse convs and z-order codes.

Inputs are made from numpy seeds and given to both packages. Structure
(coords, indices, rulebooks, codes) must be exactly equal; f32 features
and convs agree to 1e-6 / 1e-5 relative (sum order differs).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.ops import serialization as jser
from treemorph_tpu.ops import sparse as jsp
from treemorph_tpu_torch.fixtures import synthetic_qsm, synthetic_tree_cloud
from treemorph_tpu_torch.ops import serialization as tser
from treemorph_tpu_torch.ops import sparse as tsp
from treemorph_tpu_torch.ops import voxelize as tvox

# the JAX ops package re-exports a function under the module's name
jvox = importlib.import_module("treemorph_tpu.ops.voxelize")


def surface_cloud(seed: int, n: int) -> np.ndarray:
    """(n, 3) float32 points of a synthetic tree's scanned surface (the
    kind of cloud every voxel level of the pipeline comes from): the
    lowest ``n`` points, so the patch is as dense as a real scan, in
    shuffled order."""
    rng = np.random.default_rng(seed)
    qsm = synthetic_qsm(n_branches=2, rng=rng)
    pts, _ = synthetic_tree_cloud(
        qsm=qsm, points_per_m2=4000, noise_scale=0.004, rng=rng
    )
    pts = pts[np.argsort(pts[:, 2], kind="stable")[:n]]
    return pts[rng.permutation(len(pts))].astype(np.float32)


def padded_inputs(seed: int, n: int, pad: int, dim_feat: int = 4):
    """Flat model inputs: points, features, batch ids, validity, with
    ``pad`` padding rows at the end."""
    rng = np.random.default_rng(seed + 1)
    pts = surface_cloud(seed, n)
    p = len(pts) + pad
    coords = np.zeros((p, 3), np.float32)
    coords[: len(pts)] = pts
    feats = np.zeros((p, dim_feat), np.float32)
    feats[: len(pts)] = rng.normal(size=(len(pts), dim_feat))
    valid = np.arange(p) < len(pts)
    return coords, feats, np.zeros(p, np.int32), valid


def voxel_level(seed: int = 0, n: int = 3000, voxel: float = 0.02):
    """A lex-sorted voxel level voxelized by the JAX package: (coords,
    valid) numpy arrays."""
    c, f, b, v = padded_inputs(seed, n, pad=64)
    vox = jvox.voxelize(
        jnp.asarray(c), jnp.asarray(f), jnp.asarray(b), jnp.asarray(v),
        voxel, 1,
    )
    return np.asarray(vox.voxel_coords), np.asarray(vox.voxel_valid)


def t(x):
    return torch.from_numpy(np.array(x))


def assert_scaled_close(got, want, rtol):
    """max |got - want| within ``rtol`` of max |want|, on real work (a
    scale above 0.1)."""
    got, want = np.asarray(got), np.asarray(want)
    scale = np.abs(want).max()
    assert scale > 0.1
    err = np.abs(got - want).max()
    assert err <= rtol * scale, f"max |err| {err:.3e} > {rtol} x {scale:.3e}"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's tests run torch on one CPU thread. The test lane runs
    six test processes on the host's cores, where a torch thread pool per
    process oversubscribes them: a 1.4 s test took 89 s there, and the
    spinning threads slowed the other processes too. Port test modules
    import this fixture to use it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def fresh_jax_caches():
    """Each port test module starts and ends with empty JAX caches. A test
    process keeps every XLA program it compiled, each with memory maps of
    its own (``tests/test_ptv3.py`` alone leaves ~31,000); one that runs
    several JAX-heavy files in the test lane reaches the kernel's limit of
    65,530 maps and aborts inside the next compile. Clearing drops compiled
    programs only; they are rebuilt when used again. Port test modules
    import this fixture to use it."""
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("capacity", [None, 900])
def test_voxelize_matches_jax(capacity):
    c, f, b, v = padded_inputs(0, 2500, pad=100)
    j = jvox.voxelize_treelearn_features(
        jnp.asarray(c), jnp.asarray(f), jnp.asarray(b), jnp.asarray(v),
        0.02, 1, capacity=capacity,
    )
    p = tvox.voxelize_treelearn_features(
        t(c), t(f), t(b), t(v), 0.02, 1, capacity=capacity
    )
    np.testing.assert_array_equal(p.voxel_coords.numpy(), j.voxel_coords)
    np.testing.assert_array_equal(
        p.point_to_voxel.numpy(), np.asarray(j.point_to_voxel)
    )
    assert int(p.num_voxels) == int(j.num_voxels)
    np.testing.assert_array_equal(p.voxel_valid.numpy(), j.voxel_valid)
    np.testing.assert_array_equal(p.spatial_shape.numpy(), j.spatial_shape)
    np.testing.assert_allclose(
        p.voxel_feats.numpy(), j.voxel_feats, rtol=1e-6, atol=1e-6
    )
    if capacity is not None:  # the capacity really was exceeded
        assert int((p.point_to_voxel == capacity).sum()) > 100


def test_rulebook_matches_jax_exact_lookup():
    coords, valid = voxel_level(0)
    rb_j = np.asarray(
        jsp.build_rulebook(
            jnp.asarray(coords), jnp.asarray(valid), 3, verify_coords=True
        )
    )
    rb_t = tsp.build_rulebook(t(coords), t(valid), 3).numpy()
    np.testing.assert_array_equal(rb_t, rb_j)
    m, k = rb_t.shape
    assert (rb_t[valid] < m).sum() > 5 * valid.sum()  # a dense surface
    # antisymmetry: rb[i, k] == j  <=>  rb[j, K-1-k] == i
    i, kk = np.nonzero(rb_t < m)
    np.testing.assert_array_equal(rb_t[rb_t[i, kk], k - 1 - kk], i)


def test_downsample_matches_jax():
    coords, valid = voxel_level(1)
    cap = len(coords) // 3  # tight enough to drop some coarse voxels
    j = jsp.build_downsample(jnp.asarray(coords), jnp.asarray(valid), cap)
    p = tsp.build_downsample(t(coords), t(valid), cap)
    np.testing.assert_array_equal(p.coarse_coords.numpy(), j.coarse_coords)
    np.testing.assert_array_equal(p.coarse_valid.numpy(), j.coarse_valid)
    assert int(p.num_coarse) == int(j.num_coarse)
    np.testing.assert_array_equal(p.parent.numpy(), np.asarray(j.parent))
    np.testing.assert_array_equal(
        p.child_offset.numpy(), np.asarray(j.child_offset)
    )


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_down_inverse_convs_match_jax(dtype):
    coords, valid = voxel_level(2)
    m = len(coords)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(m, 16)).astype(np.float32)
    w = (rng.normal(size=(27, 16, 24)) / 20).astype(np.float32)
    wd = (rng.normal(size=(8, 16, 24)) / 4).astype(np.float32)
    wu = (rng.normal(size=(8, 24, 16)) / 4).astype(np.float32)
    cj, vj = jnp.asarray(coords), jnp.asarray(valid)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    # f32 agrees to sum order; bf16 rounds the same operands in both, so
    # only sum order and the rare rounding tie of an f32 input differ
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(
        rtol=1e-4, atol=1e-4
    )

    rb = jsp.build_rulebook(cj, vj, 3, verify_coords=True)
    out_j = jsp._subm_conv_impl(jdt, jnp.asarray(feats), jnp.asarray(w),
                                rb, vj)
    out_t = tsp.subm_conv_apply(
        t(feats), t(w), t(np.asarray(rb)).long(), t(valid),
        compute_dtype=tdt,
    )
    np.testing.assert_allclose(out_t.numpy(), out_j, **tol)

    cap = m // 2
    ds_j = jsp.build_downsample(cj, vj, cap)
    ds_t = tsp.build_downsample(t(coords), t(valid), cap)
    down_j = jsp.down_conv_apply(jnp.asarray(feats), jnp.asarray(wd), ds_j,
                                 vj, compute_dtype=jdt)
    down_t = tsp.down_conv_apply(t(feats), t(wd), ds_t, t(valid),
                                 compute_dtype=tdt)
    np.testing.assert_allclose(down_t.numpy(), down_j, **tol)
    up_j = jsp.inverse_conv_apply(down_j, jnp.asarray(wu), ds_j, vj,
                                  compute_dtype=jdt)
    up_t = tsp.inverse_conv_apply(t(np.asarray(down_j)), t(wu), ds_t,
                                  t(valid), compute_dtype=tdt)
    np.testing.assert_allclose(up_t.numpy(), up_j, **tol)


def test_gather_vjp_on_duplicate_voxels():
    """The gather engine's custom VJP (the JAX package's) gathers the
    output gradient through the mirrored rulebook column, which is the
    forward's transpose only when the rulebook is antisymmetric. Rows that
    share a voxel (PTv3's level 0 without dedup) break that: 80 rows, 20 of
    them duplicates, k=3, float64. ``d_feats`` then differs from autograd of
    the same forward by more than a tenth of its scale, while ``d_w`` and
    both gradients on the duplicate-free rows agree. A deviation of the
    JAX reference (ROADMAP.md queue 3); the port keeps its VJP."""
    rng = np.random.default_rng(9)
    cells = rng.choice(6**3, size=60, replace=False)
    vox = np.stack(np.unravel_index(cells, (6, 6, 6)), axis=1)
    for rows in (vox, np.concatenate([vox, vox[rng.choice(60, 20, False)]])):
        coords = t(np.concatenate([np.zeros((len(rows), 1), np.int64), rows],
                                  axis=1)).int()
        valid = torch.ones(len(rows), dtype=torch.bool)
        rb = tsp.build_rulebook(coords, valid, 3)
        feats = torch.from_numpy(rng.normal(size=(len(rows), 4)))
        w = torch.from_numpy(rng.normal(size=(27, 4, 5)))
        g = torch.from_numpy(rng.normal(size=(len(rows), 5)))
        grads = []
        for conv in (
            lambda f, k: tsp.subm_conv_apply(f, k, rb, valid, torch.float64),
            lambda f, k: tsp._subm_conv_impl(torch.float64, f, k, rb, valid),
        ):
            f, k = feats.clone().requires_grad_(), w.clone().requires_grad_()
            grads.append(torch.autograd.grad(conv(f, k), (f, k), g))
        (vjp_f, vjp_w), (true_f, true_w) = grads
        torch.testing.assert_close(vjp_w, true_w, rtol=0, atol=1e-12)
        err = float((vjp_f - true_f).abs().max() / true_f.abs().max())
        if len(rows) == 60:
            assert err < 1e-12
        else:
            assert err > 0.1


def test_z_order_codes_match_jax():
    rng = np.random.default_rng(3)
    grid = rng.integers(0, 1 << 16, size=(4096, 3)).astype(np.int32)
    _, hi, lo = jser.encode(jnp.asarray(grid), None, depth=16, order="z")
    _, code = tser.encode(t(grid), None, depth=16, order="z")
    expect = (np.asarray(hi, np.int64) << 32) | np.asarray(lo, np.int64)
    np.testing.assert_array_equal(code.numpy(), expect)
