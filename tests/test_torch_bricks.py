"""The port's dense-brick engine and brick conv against the JAX package's:
the brick structure, dense layout and halo'd tensor (exactly equal), the
brick engine's two schedules, and ``brick_conv`` (core and full variants,
its custom VJP) against the Pallas kernel run in interpret mode.

Inputs are made from numpy seeds: the random voxel sets of
``tests/test_sparse.py`` and the z-column sets of ``tests/test_bandconv.py``.
Convs agree to 1e-5 of the output's scale (f32, sum order only). The CUDA
kernel runs only on the card, where ``chip_smoke.py`` holds it against the
plain version tested here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.ops import brick_conv as jbc
from treemorph_tpu.ops import bricks as jbr
from treemorph_tpu_torch.ops import brick_conv as tbc
from treemorph_tpu_torch.ops import bricks as tbr
from treemorph_tpu_torch.ops import sparse as tsp

from test_bandconv import column_voxels
from test_sparse import random_voxels
from test_torch_ops import (  # noqa: F401
    assert_scaled_close, fresh_jax_caches, one_torch_thread, t,
)

RTOL = 1e-5  # f32, sum order only


def voxel_set(seed):
    """Random voxels in two batches, padding rows last (not lex-sorted)."""
    return random_voxels(np.random.default_rng(seed), n_active=150,
                         pad_to=192, grid=12)


@pytest.mark.parametrize("cap", [192, 12])
def test_brickize_matches_jax(cap):
    """Every field; bricks of padding rows and unused brick rows carry the
    JAX package's segment-max fills; a cap of 12 drops bricks."""
    coords, valid = voxel_set(0)
    bj = jbr.brickize(jnp.asarray(coords), jnp.asarray(valid), cap=cap)
    bt = tbr.brickize(t(coords), t(valid), cap=cap)
    for field in bj._fields:
        np.testing.assert_array_equal(
            getattr(bt, field).numpy(), np.asarray(getattr(bj, field)),
            err_msg=field)
    assert (int(bt.num_bricks) == cap) == (cap == 12)


def test_dense_layout_and_halo_match_jax():
    coords, valid = voxel_set(1)
    feats = np.random.default_rng(2).normal(size=(192, 8)).astype(np.float32)
    feats[~valid] = 0
    bj = jbr.brickize(jnp.asarray(coords), jnp.asarray(valid), cap=192)
    bt = tbr.brickize(t(coords), t(valid), cap=192)
    dense_j = jbr.to_dense(jnp.asarray(feats), bj)
    dense_t = tbr.to_dense(t(feats), bt)
    np.testing.assert_array_equal(dense_t.numpy(), dense_j)
    np.testing.assert_array_equal(tbr.from_dense(dense_t, bt).numpy(),
                                  jbr.from_dense(dense_j, bj))
    np.testing.assert_array_equal(tbr._halo_pad(dense_t, bt).numpy(),
                                  jbr._halo_pad(dense_j, bj))


@pytest.mark.parametrize("impl,dtype", [
    ("conv", None), ("xslab", None), ("xslab", "bfloat16"),
])
def test_brick_subm_conv_matches_jax(impl, dtype):
    """On a z-column set (the surface shape); f32 also against the port's
    gather engine on the same voxels."""
    coords, valid = column_voxels(np.random.default_rng(3), n_cols=20,
                                  zlen=14, cap=320)
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(len(coords), 8)).astype(np.float32)
    feats[~valid] = 0
    w = (rng.normal(size=(27, 8, 16)) * 0.2).astype(np.float32)
    act = valid.astype(np.float32)[:, None]
    bj = jbr.brickize(jnp.asarray(coords), jnp.asarray(valid), cap=96)
    bt = tbr.brickize(t(coords), t(valid), cap=96)
    out_j = jbr.brick_subm_conv(
        jbr.to_dense(jnp.asarray(feats), bj), jnp.asarray(w), bj,
        jbr.to_dense(jnp.asarray(act), bj), impl=impl,
        compute_dtype=dtype and getattr(jnp, dtype),
    )
    out_t = tbr.brick_subm_conv(
        tbr.to_dense(t(feats), bt), t(w), bt, tbr.to_dense(t(act), bt),
        impl=impl, compute_dtype=dtype and getattr(torch, dtype),
    )
    assert_scaled_close(out_t.numpy(), out_j, RTOL)
    if dtype is None:
        ref = tsp.subm_conv_apply(
            t(feats), t(w), tsp.build_rulebook(t(coords), t(valid)), t(valid))
        flat = tbr.from_dense(out_t, bt)
        assert_scaled_close(flat[t(valid)].numpy(), ref[t(valid)].numpy(),
                            RTOL)


def test_brick_conv_and_vjp_match_jax():
    b, cin, cout = 5, 8, 16
    rng = np.random.default_rng(5)
    padded = rng.normal(size=(b, 6, 6, 6, cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) * 0.2).astype(np.float32)
    cot = rng.normal(size=(b, 4, 4, 4, cout)).astype(np.float32)
    out_j, vjp = jax.vjp(jbc.brick_conv, jnp.asarray(padded), jnp.asarray(w))
    gp_j, gw_j = vjp(jnp.asarray(cot))
    p_t = t(padded).requires_grad_()
    w_t = t(w).requires_grad_()
    out_t = tbc.brick_conv(p_t, w_t)
    out_t.backward(t(cot))
    assert out_t.shape == (b, 4, 4, 4, cout)
    assert_scaled_close(out_t.detach().numpy(), out_j, RTOL)
    assert_scaled_close(p_t.grad.numpy(), gp_j, RTOL)
    assert_scaled_close(w_t.grad.numpy(), gw_j, RTOL)


def test_full_variant_matches_jax_on_any_input():
    """All 216 cells, wraparound terms included, on an input whose halo is
    not zero (the backward only ever feeds it core-masked cotangents)."""
    rng = np.random.default_rng(6)
    h = rng.normal(size=(8, 216, 8)).astype(np.float32)
    w = (rng.normal(size=(27, 8, 16)) * 0.2).astype(np.float32)
    full_j = jbc._conv_call(jnp.asarray(h), jnp.asarray(w), True,
                            core_only=False)
    core_j = jbc._conv_call(jnp.asarray(h), jnp.asarray(w), True)
    full_t = tbc.brick_conv_cells(t(h), t(w), core_only=False)
    core_t = tbc.brick_conv_cells(t(h), t(w))
    assert_scaled_close(full_t.numpy(), full_j, RTOL)
    assert_scaled_close(core_t.numpy(), core_j, RTOL)
    # the core variant is the full variant's core cells
    np.testing.assert_allclose(full_t[:, tbc.core_cells()].numpy(),
                               core_t.numpy(), rtol=1e-6, atol=1e-6)


def tf32(x):
    """x rounded to TF32 as the CUDA kernels round it: to nearest, ties away
    from zero (half a TF32 unit, 0x1000, added to the bits, then the low 13
    mantissa bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def split_tf32(x):
    """The kernels' split of an f32 value into TF32 hi and lo."""
    hi = tf32(x)
    return hi, tf32(np.asarray(x, np.float32) - hi)


def emulate_brick_kernel(h, w, core_only, passes):
    """``csrc/brick_conv.cu``'s arithmetic in numpy: per 16-channel chunk
    and offset, for each of its two 8-channel k-steps the split operands'
    products (lo*hi, hi*lo, hi*hi; ``passes=1``: hi*hi alone) summed one
    mma at a time into a fresh f32 fragment (each product exact, each sum
    rounded to f32), which is then added to the f32 accumulator."""
    cells = (tbc.core_cells() if core_only else torch.arange(216)).numpy()
    acc = np.zeros((h.shape[0], len(cells), w.shape[-1]), np.float32)
    for c0 in range(0, h.shape[-1], 16):
        for k, delta in enumerate(tbc.DELTAS):
            a = h[:, (cells + delta) % 216]
            part = np.zeros_like(acc)
            for ks in (c0, c0 + 8):
                a_hi, a_lo = split_tf32(a[..., ks:ks + 8])
                b_hi, b_lo = split_tf32(w[k, ks:ks + 8])
                terms = ([(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)]
                         if passes == 3 else [(a_hi, b_hi)])
                for x, y in terms:
                    part = (part + x.astype(np.float64)
                            @ y.astype(np.float64)).astype(np.float32)
            acc = acc + part
    return acc


@pytest.mark.parametrize("core_only", [True, False])
def test_three_pass_tf32_precision(core_only):
    """The precision decision of the CUDA kernel, at the plot's level-0
    width (32 -> 32), four bricks, one all zero: three TF32 passes land
    within 1e-6 of the output scale of float64, one pass does not come
    within 1e-5, and the all-zero brick's rows are exactly 0."""
    rng = np.random.default_rng(7)
    h = rng.normal(size=(4, 216, 32)).astype(np.float32)
    h[2] = 0
    w = (rng.normal(size=(27, 32, 32)) / np.sqrt(27 * 32)).astype(np.float32)
    ref = tbc.brick_conv_cells_plain(
        t(h).double(), t(w).double(), core_only).numpy()
    scale = np.abs(ref).max()
    three = emulate_brick_kernel(h, w, core_only, passes=3)
    one = emulate_brick_kernel(h, w, core_only, passes=1)
    assert np.abs(three - ref).max() <= 1e-6 * scale
    assert np.abs(one - ref).max() > 1e-5 * scale
    assert np.all(three[2] == 0) and scale > 1.0


@pytest.mark.parametrize("core_only", [True, False])
def test_plain_zero_brick_gives_exact_zeros(core_only):
    """The plain version on an all-zero brick between non-zero ones: its
    rows are exactly 0, as the kernel writes them without products."""
    rng = np.random.default_rng(8)
    h = rng.normal(size=(3, 216, 8)).astype(np.float32)
    h[1] = 0
    w = (rng.normal(size=(27, 8, 16)) * 0.2).astype(np.float32)
    out = tbc.brick_conv_cells(t(h), t(w), core_only=core_only).numpy()
    assert np.all(out[1] == 0)
    assert np.all(np.abs(out[[0, 2]]).max(axis=(1, 2)) > 0.1)
