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


def level(seed=0, n=1500, kernel_size=3):
    """``test_torch_ops.voxel_level``'s voxel level (lex-sorted) and its
    rulebook, as numpy, built by the port: its voxelize and rulebook equal
    the JAX package's exactly (test_torch_ops.py), and cost no JAX
    compile."""
    c, f, b, v = padded_inputs(seed, n, pad=64)
    vox = tvox.voxelize(t(c), t(f), t(b), t(v), 0.02, 1)
    rb = tsp.build_rulebook(vox.voxel_coords, vox.voxel_valid, kernel_size)
    return rb.numpy(), vox.voxel_valid.numpy()


def assert_plans_equal(pt, pj):
    np.testing.assert_array_equal(pt.rb_tiles.numpy(), pj.rb_tiles)
    np.testing.assert_array_equal(pt.starts.numpy(), pj.starts)
    assert bool(pt.ok) == bool(pj.ok)
    np.testing.assert_array_equal(pt.res_rows.numpy(), pj.res_rows)
    np.testing.assert_array_equal(pt.res_rb.numpy(), pj.res_rb)
    np.testing.assert_array_equal(pt.res_valid.numpy(), pj.res_valid)
    assert pt.win == pj.wmark.shape[0]


@pytest.mark.parametrize("kernel_size,window",
                         [(3, tband.WIN), (3, 64), (5, tband.WIN)])
def test_band_plan_matches_jax(kernel_size, window):
    """At 3x3x3 and at PTv3's 5x5x5 stem (25 groups of 5 dz offsets)."""
    rb, valid = level(0, kernel_size=kernel_size)
    pj = jband.build_band_plan(jnp.asarray(rb), jnp.asarray(valid), window)
    pt = tband.build_band_plan(t(rb), t(valid), window)
    assert_plans_equal(pt, pj)
    assert pt.starts.shape[0] == kernel_size ** 2
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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_plain_band_kernel_matches_pallas_kernel_k5(dtype):
    """PTv3's stem shape, K = 125 (4 -> 32), on a lex-sorted voxel set:
    the plan and the plain version against the Pallas kernel at ksize 5,
    with the tolerances of the 3x3x3 case (bf16 1e-5; f32 2e-4, JAX's bf16
    hi/lo features)."""
    rb, valid = level(4, n=900, kernel_size=5)
    m = len(rb)
    rng = np.random.default_rng(125)
    w = (rng.normal(size=(125, 4, 32)) / np.sqrt(125 * 4)).astype(np.float32)
    pj = jband.build_band_plan(jnp.asarray(rb), jnp.asarray(valid))
    pt = tband.build_band_plan(t(rb), t(valid))
    assert_plans_equal(pt, pj)
    mp = pj.rb_tiles.shape[0] * tband.TILE
    feats = np.zeros((mp, 4), np.float32)
    feats[:m] = rng.normal(size=(m, 4)) * valid[:, None]
    nsplit = 1 if dtype == "bfloat16" else 2
    out_j = np.asarray(jband._band_conv_padded(
        pj.rb_tiles, pj.starts, jband._split_bf16(jnp.asarray(feats), nsplit),
        jnp.asarray(w), m, nsplit, pj.wmark.shape[0],
    ))
    args = (pt.rb_tiles, pt.starts, t(feats).to(getattr(torch, dtype)),
            t(w), m, pt.win)
    out_t = tband.band_conv_padded_plain(*args)
    tol = 1e-5 if dtype == "bfloat16" else 2e-4
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=tol, atol=tol)
    assert np.abs(out_j[:m]).mean() > 0.1  # real work, not zeros
    # the wrapper takes the plain version for a CPU tensor, at K = 125 too
    np.testing.assert_array_equal(tband.band_conv_padded(*args).numpy(),
                                  out_t.numpy())


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
    convolves Cin 7..192 into Cout 32..96, PTv3's xCPEs 32..512 channels
    and its stem 4 -> 32 at K = 125; the gather route may then be taken
    only for an overflowed plan. Other kernel sizes and types are not the
    kernel's."""
    shapes = [(27, 7, 32), (27, 32, 32), (27, 64, 32), (27, 64, 64),
              (27, 128, 64), (27, 96, 96), (27, 192, 96), (125, 4, 32)]
    shapes += [(27, c, c) for c in (32, 64, 128, 256, 512)]
    for k, cin, cout in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            assert tband.band_viable(k, cin, cout, dtype)
    assert not tband.band_viable(343, 4, 32, torch.float32)
    assert not tband.band_viable(27, 32, 32, torch.float64)


def bf16_round(x):
    """x rounded to bf16 as ``__float2bfloat16_rn`` rounds it: to nearest,
    ties to even."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> np.uint32(16)) & 1)) & \
        np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def bf16_pieces(w):
    """The forward kernel's split of f32 weights into three bf16 pieces:
    w1 = bf16(w), w2 = bf16(w - w1), w3 = bf16(w - w1 - w2)."""
    w = np.asarray(w, np.float32)
    w1 = bf16_round(w)
    w2 = bf16_round(w - w1)
    return w1, w2, bf16_round(w - w1 - w2)


def one_tile(seed, cin, cout, bf16, k=27):
    """One 128-row tile whose window holds every row: a random tiled
    rulebook of ``k`` offsets (about a third of the entries missing),
    features (bf16 values in bf16 mode) and weights."""
    rng = np.random.default_rng(seed)
    m = 128
    rb = rng.integers(0, m, size=(1, k, m))
    rb[rng.random(rb.shape) < 0.35] = m
    feats = rng.normal(size=(m, cin)).astype(np.float32)
    if bf16:
        feats = bf16_round(feats)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(
        np.float32)
    return rb, feats, w


def gathered(rb, x, k):
    """Rows rb[:, k] of x, tile after tile, zero where not found (rb ==
    m)."""
    m = x.shape[0]
    pad = np.concatenate([x, np.zeros((1, x.shape[1]), x.dtype)])
    return pad[np.minimum(rb[:, k].reshape(-1), m)]


def mma_sum(c, x, y):
    """One mma's ``c + x @ y`` as the tensor cores give it: the products
    and their sum exact (float64 here), the result rounded to f32 toward
    zero."""
    exact = c.astype(np.float64) + x.astype(np.float64) @ y.astype(np.float64)
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def nearest_sum(c, x, y):
    """``c + x @ y`` with the exact result rounded to nearest f32."""
    return (c.astype(np.float64)
            + x.astype(np.float64) @ y.astype(np.float64)).astype(np.float32)


def forward_terms(a, w, scheme):
    """The (A, B) operand pairs of one k-step's mma passes, in the order
    the forward kernel issues them."""
    from test_torch_bricks import split_tf32, tf32

    if scheme == "bf16 pieces":
        w1, w2, w3 = bf16_pieces(w)
        return [(a, w3), (a, w2), (a, w1)]
    if scheme == "bf16 weights":
        return [(a, bf16_round(w))]
    if scheme == "one tf32 pass":
        return [(tf32(a), tf32(w))]
    a_hi, a_lo = split_tf32(a)
    w_hi, w_lo = split_tf32(w)
    return [(a_lo, w_hi), (a_hi, w_lo), (a_hi, w_hi)]  # 3xTF32


def emulate_band_forward(rb, feats, w, scheme, fresh=True, add=mma_sum):
    """``csrc/band_conv.cu``'s arithmetic in numpy for one tile: per offset
    and 64-byte channel chunk (two k-steps of 16 bf16 or 8 f32 channels,
    zero-padded past Cin), the k-steps' passes summed one mma at a time
    into a fresh f32 fragment (each product exact, each sum rounded toward
    zero, :func:`mma_sum`), which is then added to the f32 accumulator
    (rounded to nearest). ``fresh=False`` chains every mma of the tile into
    one fragment instead; ``add`` is the mma's sum."""
    step = 16 if scheme in ("bf16 pieces", "bf16 weights") else 8
    cin = feats.shape[1]
    pad = -(-cin // (2 * step)) * 2 * step - cin
    f = np.pad(feats, ((0, 0), (0, pad)))
    wp = np.pad(w, ((0, 0), (0, pad), (0, 0)))
    acc = np.zeros((rb.shape[0] * rb.shape[2], w.shape[-1]), np.float32)
    part = np.zeros_like(acc)
    for k in range(rb.shape[1]):
        a = gathered(rb, f, k)
        for c0 in range(0, f.shape[1], 2 * step):
            if fresh:
                part = np.zeros_like(acc)
            for ks in (c0, c0 + step):
                for x, y in forward_terms(a[:, ks:ks + step],
                                          wp[k, ks:ks + step], scheme):
                    part = add(part, x, y)
            if fresh:
                acc = acc + part
    return acc if fresh else part


@pytest.mark.parametrize("cin,k", [(7, 27), (32, 27), (4, 125)])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_forward_kernel_precision(cin, k, mode):
    """The forward kernel's precision decision, at TreeLearn's level-0
    widths (7 -> 32, 32 -> 32) and PTv3's stem (4 -> 32 over 125 offsets,
    one stage of 4 real channels per offset) on one tile: bf16 features by
    three bf16 weight pieces (bf16 mode) and 3xTF32 (f32 mode) land within
    1e-6 of the output scale of float64; a single TF32 pass, or weights
    rounded to bf16, misses 1e-5."""
    rb, feats, w = one_tile(cin, cin, 32, mode == "bf16", k)
    ref = sum(gathered(rb, feats.astype(np.float64), j)
              @ w[j].astype(np.float64) for j in range(k))
    scale = np.abs(ref).max()
    schemes = (["bf16 pieces", "bf16 weights", "one tf32 pass"]
               if mode == "bf16" else ["3xTF32", "one tf32 pass"])
    errs = {s: np.abs(emulate_band_forward(rb, feats, w, s) - ref).max()
            for s in schemes}
    assert errs[schemes[0]] <= 1e-6 * scale
    for s in schemes[1:]:
        assert errs[s] > 1e-5 * scale, s
    # the three pieces carry the whole f32 mantissa
    w1, w2, w3 = bf16_pieces(w)
    np.testing.assert_array_equal(
        (w1.astype(np.float64) + w2 + w3).astype(np.float32), w)


@pytest.mark.parametrize("cin", [7, 32])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_forward_fresh_fragments_are_needed(cin, mode):
    """Why the forward kernel sums each (offset, channel chunk) into a
    fresh fragment: chaining all of a tile's mmas into one fragment, whose
    every sum the tensor cores round toward zero, drifts past 1e-6 of the
    output scale (several times the fresh fragments' error), while the same
    chain rounded to nearest would not."""
    rb, feats, w = one_tile(cin, cin, 32, mode == "bf16")
    ref = sum(gathered(rb, feats.astype(np.float64), k)
              @ w[k].astype(np.float64) for k in range(27))
    scale = np.abs(ref).max()
    scheme = "bf16 pieces" if mode == "bf16" else "3xTF32"
    fresh = np.abs(emulate_band_forward(rb, feats, w, scheme) - ref).max()
    chain = np.abs(emulate_band_forward(rb, feats, w, scheme, fresh=False)
                   - ref).max()
    assert fresh <= 1e-6 * scale
    assert chain > 1e-6 * scale and chain > 4 * fresh
    nearest = np.abs(emulate_band_forward(rb, feats, w, scheme, False,
                                          nearest_sum) - ref).max()
    assert nearest <= 1e-6 * scale
