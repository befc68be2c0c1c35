"""The port's band conv against the JAX package's: the plan (exactly
equal), the kernel function's plain version against the Pallas kernel run
in interpret mode, and the engine with its residual repair and its gather
route when the plan overflows.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version tested here.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from treemorph_tpu.ops import bandconv as jband
from treemorph_tpu_torch.ops import bandconv as tband
from treemorph_tpu_torch.ops import sparse as tsp
from treemorph_tpu_torch.ops import voxelize as tvox

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, padded_inputs, t,
)


def level(seed=0, n=1500):
    """``test_torch_ops.voxel_level``'s voxel level and its rulebook, as
    numpy, built by the port: its voxelize and rulebook equal the JAX
    package's exactly (test_torch_ops.py), and cost no JAX compile."""
    c, f, b, v = padded_inputs(seed, n, pad=64)
    vox = tvox.voxelize(t(c), t(f), t(b), t(v), 0.02, 1)
    rb = tsp.build_rulebook(vox.voxel_coords, vox.voxel_valid, 3)
    return rb.numpy(), vox.voxel_valid.numpy()


def assert_plans_equal(pt, pj):
    np.testing.assert_array_equal(pt.rb_tiles.numpy(), pj.rb_tiles)
    np.testing.assert_array_equal(pt.starts.numpy(), pj.starts)
    assert bool(pt.ok) == bool(pj.ok)
    np.testing.assert_array_equal(pt.res_rows.numpy(), pj.res_rows)
    np.testing.assert_array_equal(pt.res_rb.numpy(), pj.res_rb)
    np.testing.assert_array_equal(pt.res_valid.numpy(), pj.res_valid)
    assert pt.win == pj.wmark.shape[0]


@pytest.mark.parametrize("window", [tband.WIN, 64])
def test_band_plan_matches_jax(window):
    rb, valid = level(0)
    pj = jband.build_band_plan(jnp.asarray(rb), jnp.asarray(valid), window)
    pt = tband.build_band_plan(t(rb), t(valid), window)
    assert_plans_equal(pt, pj)
    n_res = int(pt.res_valid.sum())
    # the default window leaves few residual rows, the small one many
    assert (n_res < len(rb) // 50) if window == tband.WIN else n_res > 50


@pytest.mark.parametrize("cin", [7, 32, 64])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_band_kernel_matches_pallas_kernel(cin, dtype):
    """JAX packs blk = 1, 4 and 2 window rows per one-hot column at these
    widths. bf16: both multiply the same bf16 features by f32 weights in
    f32, so only sum order differs (1e-5). f32: the Pallas kernel selects
    a bf16 hi/lo split of the features (~1e-5 relative per value), the
    plain version reads f32 (2e-4 absolute on O(1) outputs)."""
    rb, valid = level(1, n=800)
    m = len(rb)
    rng = np.random.default_rng(cin)
    w = (rng.normal(size=(27, cin, 32)) / np.sqrt(27 * cin)).astype(np.float32)
    pj = jband.build_band_plan(jnp.asarray(rb), jnp.asarray(valid))
    mp = pj.rb_tiles.shape[0] * tband.TILE
    feats = np.zeros((mp, cin), np.float32)
    feats[:m] = rng.normal(size=(m, cin)) * valid[:, None]
    nsplit = 1 if dtype == "bfloat16" else 2
    fparts = jband._split_bf16(jnp.asarray(feats), nsplit)
    out_j = np.asarray(jband._band_conv_padded(
        pj.rb_tiles, pj.starts, fparts, jnp.asarray(w), m, nsplit,
        pj.wmark.shape[0],
    ))
    out_t = tband.band_conv_padded(
        t(np.asarray(pj.rb_tiles)), t(np.asarray(pj.starts)),
        t(feats).to(getattr(torch, dtype)), t(w), m, pj.wmark.shape[0],
    )
    tol = 1e-5 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=tol, atol=tol)
    assert np.abs(out_j[:m]).mean() > 0.1  # real work, not zeros


def test_band_subm_conv_matches_jax():
    """Kernel part plus residual repair, bf16; a 192-row window, smaller
    than the default, pushes entries of some 50 rows through the repair
    (1e-5: sum order only)."""
    window = 192
    rb, valid = level(2)
    m = len(rb)
    rng = np.random.default_rng(9)
    feats = rng.normal(size=(m, 32)).astype(np.float32)
    w = (rng.normal(size=(27, 32, 32)) / 30).astype(np.float32)
    pj = jband.build_band_plan(jnp.asarray(rb), jnp.asarray(valid), window)
    pt = tband.build_band_plan(t(rb), t(valid), window)
    assert bool(pt.ok)
    assert int(pt.res_valid.sum()) > 20
    out_j = jband.band_subm_conv_apply(
        jnp.asarray(feats), jnp.asarray(w), pj, jnp.asarray(valid),
        compute_dtype=jnp.bfloat16,
    )
    out_t = tsp.subm_conv_apply(
        t(feats), t(w), pt, t(valid), compute_dtype=torch.bfloat16
    )
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=1e-5, atol=1e-5)


def test_overflowed_plan_takes_the_gather_route():
    """A window too small for the level overflows the residual cap (in
    both packages); the engine must then give the exact gather engine's
    answer, as JAX's ``lax.cond`` does."""
    rb, valid = level(3, n=1200)
    m = len(rb)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(m, 8)).astype(np.float32)
    w = (rng.normal(size=(27, 8, 16)) / 15).astype(np.float32)
    pj = jband.build_band_plan(jnp.asarray(rb), jnp.asarray(valid), 64)
    pt = tband.build_band_plan(t(rb), t(valid), 64)
    assert not bool(pt.ok) and not bool(pj.ok)
    out_t = tsp.subm_conv_apply(t(feats), t(w), pt, t(valid))
    ref = tsp._subm_conv_impl(torch.float32, t(feats), t(w), t(rb), t(valid))
    np.testing.assert_array_equal(out_t.numpy(), ref.numpy())


def test_gate_admits_every_pipeline_conv_shape():
    """The pipeline's TreeLearn (channels 32, 3 levels, 7 input features)
    convolves Cin 7..192 into Cout 32..96; the gather route may then be
    taken only for an overflowed plan."""
    for cin, cout in [(7, 32), (32, 32), (64, 32), (64, 64), (128, 64),
                      (96, 96), (192, 96)]:
        for dtype in (torch.bfloat16, torch.float32):
            assert tband.band_viable(27, cin, cout, dtype)
    assert not tband.band_viable(125, 4, 32, torch.float32)
