"""The port's band conv gradient against the JAX package's: the backward's
plain version with its residual repair against ``jax.grad`` of the exact
gather conv (f32), the bf16 backward against JAX's own band VJP (Pallas
kernels in interpret mode), the gather engine's custom VJP, and the routes
of features that need no gradient (the JAX package's
``needs_feats_grad=False``) and of an overflowed plan.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain version tested here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.ops import bandconv as jband
from treemorph_tpu.ops import sparse as jsp
from treemorph_tpu_torch.ops import bandconv as tband
from treemorph_tpu_torch.ops import sparse as tsp

from test_torch_bandconv import (
    bf16_round, gathered, level, mma_sum, one_tile,
)
from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, t,
)


def jax_plan(plan):
    """The port's BandPlan as the JAX package's (every field equals JAX's
    own plan, test_torch_bandconv.py)."""
    return jband.BandPlan(
        rulebook=jnp.asarray(plan.rulebook.numpy(), jnp.int32),
        rb_tiles=jnp.asarray(plan.rb_tiles.numpy()),
        starts=jnp.asarray(plan.starts.numpy()),
        ok=jnp.asarray(plan.ok.numpy()),
        valid=jnp.asarray(plan.valid.numpy()),
        res_rows=jnp.asarray(plan.res_rows.numpy(), jnp.int32),
        res_rb=jnp.asarray(plan.res_rb.numpy(), jnp.int32),
        res_valid=jnp.asarray(plan.res_valid.numpy()),
        wmark=jnp.zeros((plan.win,), jnp.int32),
    )


def operands(m, cin, cout, seed, k=27):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(m, cin)).astype(np.float32)
    w = (rng.normal(size=(k, cin, cout)) / np.sqrt(k * cin)).astype(
        np.float32
    )
    g = rng.normal(size=(m, cout)).astype(np.float32)
    return feats, w, g


def port_grads(feats, w, g, ctx, valid, dtype=torch.float32,
               feats_grad=True):
    """(out, d_feats, d_w) of the port's conv through torch autograd, with
    ``g`` as the output gradient; ``d_feats`` is None unless
    ``feats_grad``."""
    f, wt = t(feats).requires_grad_(feats_grad), t(w).requires_grad_()
    out = tsp.subm_conv_apply(f, wt, ctx, t(valid), compute_dtype=dtype)
    out.backward(t(g))
    d_feats = f.grad.numpy() if feats_grad else None
    return out.detach().numpy(), d_feats, wt.grad.numpy()


@pytest.fixture(scope="module")
def repaired_level():
    """A level whose 64-row band plan is ok and leaves > 200 of its rows to
    the residual repair, so both cotangents lean on it."""
    rb, valid = level(2, 500)
    plan = tband.build_band_plan(t(rb), t(valid), 64)
    assert bool(plan.ok) and int(plan.res_valid.sum()) > 200
    return rb, valid, plan


def test_band_backward_matches_jax_grad_f32(repaired_level):
    """Kernel part (plain version) plus residual repair against
    ``jax.grad`` of the exact f32 gather conv: sum order only (1e-5)."""
    rb, valid, plan = repaired_level
    feats, w, g = operands(len(rb), 16, 24, 0)

    @jax.jit
    @jax.grad
    def grads(args):
        out = jsp._subm_conv(jnp.float32, *args, jnp.asarray(rb),
                             jnp.asarray(valid))
        return jnp.sum(out * g)

    df_j, dw_j = grads((jnp.asarray(feats), jnp.asarray(w)))
    _, df_t, dw_t = port_grads(feats, w, g, plan, valid)
    for got, want in ((df_t, df_j), (dw_t, dw_j)):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    assert np.abs(dw_j).max() > 1.0  # real sums, not zeros


def test_bf16_backward_matches_jax_band_vjp(repaired_level):
    """At one tiny shape (5 tiles, 64-row windows, > 200 residual rows),
    the backward rule of JAX's band VJP (``_band_conv_bwd``: the fused
    Pallas backward kernel in interpret mode, plus its residual repair):
    both round the gradient and the features to bf16 and multiply by f32
    weights in f32, so only sum order differs (1e-5 of the scale). The
    forward is held to JAX in test_torch_bandconv.py."""
    rb, valid, plan = repaired_level
    pj = jax_plan(plan)
    feats, w, g = operands(len(rb), 8, 16, 1)
    saved = (pj.ok, pj.rulebook, pj.rb_tiles, pj.starts, pj.res_rows,
             pj.res_rb, pj.res_valid, pj.wmark, jnp.asarray(feats),
             jnp.asarray(w), jnp.asarray(valid))
    grads_j = jband._band_conv_bwd(1, True, saved, jnp.asarray(g))
    df_j, dw_j = grads_j[8], grads_j[9]
    _, df_t, dw_t = port_grads(feats, w, g, plan, valid, torch.bfloat16)
    for got, want in ((df_t, df_j), (dw_t, dw_j)):
        want = np.asarray(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


def test_bf16_backward_matches_jax_band_vjp_k5():
    """At 5x5x5 (K = 125, 25 groups of 5 dz offsets; 600 points, 8 -> 16
    channels), the backward rule of JAX's band VJP against the port's band
    backward, as at K = 27 above: JAX runs the fused Pallas backward kernel
    in interpret mode (its VMEM gate holds at this shape, so it takes the
    band path, not its gather fallback), the port the plain versions of
    its kernels. Both round the gradient and the features to bf16 and
    multiply by f32 weights in f32: sum order only (1e-5 of the scale)."""
    rb, valid = level(4, n=600, kernel_size=5)
    plan = tband.build_band_plan(t(rb), t(valid))
    assert bool(plan.ok) and plan.rb_tiles.shape[1] == 125
    pj = jax_plan(plan)
    cin, cout = 8, 16
    assert (jband.band_vmem_bytes(125, cin, cout, 1, plan.win)
            + 125 * cin * jband.block_rows(cout) * cout * 4) <= 12 * 2**20
    feats, w, g = operands(len(rb), cin, cout, 6, k=125)
    saved = (pj.ok, pj.rulebook, pj.rb_tiles, pj.starts, pj.res_rows,
             pj.res_rb, pj.res_valid, pj.wmark, jnp.asarray(feats),
             jnp.asarray(w), jnp.asarray(valid))
    grads_j = jband._band_conv_bwd(1, True, saved, jnp.asarray(g))
    _, df_t, dw_t = port_grads(feats, w, g, plan, valid, torch.bfloat16)
    for got, want in ((df_t, grads_j[8]), (dw_t, grads_j[9])):
        want = np.asarray(want)
        scale = np.abs(want).max()
        assert scale > 0.1  # real sums, not zeros
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("window", [tband.WIN, 64])
def test_band_autograd_equals_gather_engine(repaired_level, window):
    """f32: the band engine's gradients equal its gather engine's (exact
    f32 products in both, sum order only). The default window leaves no
    residual row; 64 rows leave > 200."""
    rb, valid, _ = repaired_level
    plan = tband.build_band_plan(t(rb), t(valid), window)
    feats, w, g = operands(len(rb), 12, 20, 2)
    band = port_grads(feats, w, g, plan, valid)
    gather = port_grads(feats, w, g, t(rb), valid)
    for got, want in zip(band, gather):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_needs_feats_grad_false_takes_gather_formulation(
    repaired_level, monkeypatch, dtype
):
    """The stem's route, features that need no gradient (the JAX
    package's ``needs_feats_grad=False``): the band forward, then the
    gather engine's weight gradient (bitwise) without the band backward."""
    rb, valid, plan = repaired_level
    feats, w, g = operands(len(rb), 7, 16, 3)
    gather = port_grads(feats, w, g, t(rb), valid, dtype)
    band_out = port_grads(feats, w, g, plan, valid, dtype)[0]

    def no_band_backward(*args):
        raise AssertionError("the band backward ran")

    monkeypatch.setattr(tband, "band_conv_bwd_padded", no_band_backward)
    out, df, dw = port_grads(feats, w, g, plan, valid, dtype,
                             feats_grad=False)
    assert df is None
    np.testing.assert_array_equal(dw, gather[2])
    np.testing.assert_array_equal(out, band_out)  # the band forward


def test_overflowed_plan_gradients_take_the_gather_route():
    """An overflowed plan sends forward and backward to the gather
    engine, whose gradients are the mirrored-column VJP."""
    rb, valid = level(3, 1200)
    plan = tband.build_band_plan(t(rb), t(valid), 64)
    assert not bool(plan.ok)
    feats, w, g = operands(len(rb), 8, 8, 4)
    band = port_grads(feats, w, g, plan, valid, torch.bfloat16)
    gather = port_grads(feats, w, g, t(rb), valid, torch.bfloat16)
    for got, want in zip(band, gather):
        np.testing.assert_array_equal(got, want)


def test_gather_engine_gradients_match_jax_custom_vjp():
    """The gather engine's backward against JAX's ``_subm_conv_bwd``, bf16:
    the same roundings, f32 sums (1e-5 of the scale)."""
    rb, valid = level(1, 500)
    feats, w, g = operands(len(rb), 8, 12, 5)

    @jax.jit
    def vjp(f, wj, gj):
        return jax.vjp(
            lambda f, wj: jsp._subm_conv(jnp.bfloat16, f, wj,
                                         jnp.asarray(rb), jnp.asarray(valid)),
            f, wj,
        )[1](gj)

    df_j, dw_j = vjp(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(g))
    _, df_t, dw_t = port_grads(feats, w, g, t(rb), valid, torch.bfloat16)
    for got, want in ((df_t, df_j), (dw_t, dw_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_backward_wrapper_raises_on_devices_it_cannot_launch_for():
    meta = torch.empty((128, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tband.band_conv_bwd_padded(
            torch.empty((1, 27, 128), dtype=torch.int32, device="meta"),
            torch.empty((9, 1), dtype=torch.int32, device="meta"),
            meta, meta, torch.empty((27, 8, 8), device="meta"), 100, 64,
        )


def emulate_band_dw(rb, feats, grad, mode, passes=3, fresh=True):
    """``csrc/band_conv_bwd.cu``'s arithmetic in numpy for a 32 x 32 slice
    over the tiles of ``rb`` (T, K, 128): for offset k, ``F^T G_k`` over
    the rows in k-steps of 16 (bf16: one pass) or 8 (f32: lo*hi + hi*lo +
    hi*hi, or hi*hi alone with ``passes=1``) rows, summed one mma at a time
    (each sum rounded toward zero, ``mma_sum``) into a fresh f32 fragment
    per stage (a tile's 128 rows in bf16 mode, 64 in f32 mode), each
    stage's fragment Kahan-added to the running sums. ``fresh=False``
    chains every mma of an offset into one fragment instead. Each offset's
    sums are a warp's own, whichever offsets share its block, so the
    arithmetic is the same at K = 27 and 125. Returns d_w (K, Cin, Cout) in
    the weights' offset order."""
    from test_torch_bricks import split_tf32

    step, stage = (16, 128) if mode == "bf16" else (8, 64)
    n_k = rb.shape[1]
    d_w = np.zeros((n_k, feats.shape[1], grad.shape[1]), np.float32)
    for k in range(n_k):
        g_k = gathered(rb, grad, k)
        total = np.zeros(d_w.shape[1:], np.float32)
        comp = np.zeros_like(total)
        part = np.zeros_like(total)
        for r0 in range(0, feats.shape[0], stage):
            if fresh:
                part = np.zeros_like(total)
            for r in range(r0, r0 + stage, step):
                f, g = feats[r:r + step].T, g_k[r:r + step]
                if mode == "bf16":
                    terms = [(f, g)]
                else:
                    f_hi, f_lo = split_tf32(f)
                    g_hi, g_lo = split_tf32(g)
                    terms = ([(f_lo, g_hi), (f_hi, g_lo), (f_hi, g_hi)]
                             if passes == 3 else [(f_hi, g_hi)])
                for x, y in terms:
                    part = mma_sum(part, x, y)
            if fresh:
                y = part - comp
                t_ = total + y
                comp = (t_ - total) - y
                total = t_
        d_w[n_k - 1 - k] = total - comp if fresh else part
    return d_w


def cancelling_tiles(tiles, mode, seed):
    """A rulebook of ``tiles`` 128-row tiles over all their rows (about a
    third of the entries missing), 32-channel features and a gradient
    whose terms cancel, bf16 values in bf16 mode; and float64 d_w."""
    rng = np.random.default_rng(seed)
    m = 128 * tiles
    rb = rng.integers(0, m, size=(tiles, 27, 128))
    rb[rng.random(rb.shape) < 0.35] = m
    feats = rng.normal(size=(m, 32)).astype(np.float32)
    grad = rng.normal(size=(m, 32)).astype(np.float32)
    grad -= grad.mean(axis=0)
    if mode == "bf16":
        feats, grad = bf16_round(feats), bf16_round(grad)
    ref = np.stack([feats.astype(np.float64).T
                    @ gathered(rb, grad.astype(np.float64), 26 - k)
                    for k in range(27)])
    return rb, feats, grad, ref


@pytest.mark.parametrize(
    "mode,k", [("bf16", 27), ("f32", 27), ("bf16", 125), ("f32", 125)],
    ids=["bf16", "f32", "bf16-k125", "f32-k125"])
def test_weight_gradient_kernel_precision(mode, k):
    """The weight-gradient kernel's precision decision at 32 -> 32 on one
    tile, with a gradient whose terms cancel (zero mean over the rows, as a
    BatchNorm's backward leaves it), at 3x3x3 and 5x5x5 kernels: bf16 x
    bf16 in one pass (exact products) and 3xTF32 in f32 mode land within
    1e-6 of the scale of float64; one TF32 pass of f32 operands misses
    1e-5."""
    rb, feats, _ = one_tile(11, 32, 32, mode == "bf16", k)
    rng = np.random.default_rng(12)
    grad = rng.normal(size=(128, 32)).astype(np.float32)
    grad -= grad.mean(axis=0)
    if mode == "bf16":
        grad = bf16_round(grad)
    ref = np.stack([feats.astype(np.float64).T
                    @ gathered(rb, grad.astype(np.float64), k - 1 - j)
                    for j in range(k)])
    scale = np.abs(ref).max()
    assert np.abs(emulate_band_dw(rb, feats, grad, mode) - ref).max() \
        <= 1e-6 * scale
    if mode == "f32":
        one = emulate_band_dw(rb, feats, grad, mode, passes=1)
        assert np.abs(one - ref).max() > 1e-5 * scale


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_weight_gradient_fresh_fragments_are_needed(mode):
    """Why the weight-gradient kernel sums each stage into a fresh fragment
    and Kahan-adds it: over 16 tiles of a cancelling gradient the scheme
    stays within 1e-6 of the scale of float64, while one mma chain per
    offset, whose every sum the tensor cores round toward zero, drifts
    past it (past 1e-5 in f32 mode's three passes)."""
    rb, feats, grad, ref = cancelling_tiles(16, mode, 13)
    scale = np.abs(ref).max()
    fresh = np.abs(emulate_band_dw(rb, feats, grad, mode) - ref).max()
    chain = np.abs(emulate_band_dw(rb, feats, grad, mode, fresh=False)
                   - ref).max()
    assert fresh <= 1e-6 * scale
    assert chain > 1e-6 * scale and chain > 4 * fresh
    if mode == "f32":
        assert chain > 1e-5 * scale
