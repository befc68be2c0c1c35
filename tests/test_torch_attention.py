"""The port's window attention and its gradient against the JAX package's.

The plain versions (what CPU tensors take) are held to the Pallas kernels
run in interpret mode, on the same numpy inputs: f32 and bf16 inputs, two
or three segments per window and padding rows. Products are the same; sums
run in another order, so outputs agree to 1e-5 of their scale.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.ops import attention as jatt
from treemorph_tpu_torch.ops import attention as tatt

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, t,
)

ATOL = 1e-5


def inputs(seed, w=3, h=2, k=64, d=16, n_segments=2, pad_frac=0.2):
    """q, k, v (W, H, K, D) f32 and seg (W, K) int32: segments in sorted
    runs, as a serialized order groups batch elements, and padding rows
    (seg -1) at random places."""
    rng = np.random.default_rng(seed)
    q, kk, v = (rng.normal(size=(w, h, k, d)).astype(np.float32)
                for _ in range(3))
    seg = np.sort(rng.integers(0, n_segments, size=(w, k)), axis=1)
    seg[rng.uniform(size=(w, k)) < pad_frac] = -1
    return q, kk, v, seg.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel(dtype, monkeypatch):
    """Two chunks of windows in the plain version (its chunk shrunk), one
    window of all padding, one of a single segment."""
    monkeypatch.setattr(tatt, "_PLAIN_CHUNK_ELEMENTS", 2 * 2 * 64 * 64)
    q, k, v, seg = inputs(0, w=4, d=8 if dtype == "float32" else 16)
    seg[2] = -1
    seg[3] = np.where(seg[3] >= 0, 1, -1)
    jdt = jnp.dtype(dtype)
    out_j = np.asarray(jatt.window_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(seg),
        interpret=True,
    ))
    tdt = getattr(torch, dtype)
    out_t = tatt.window_attention(*(t(x).to(tdt) for x in (q, k, v)), t(seg))
    assert out_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=ATOL)
    assert np.abs(out_j[:2]).mean() > 0.1


def test_padding_rows_exactly_zero():
    q, k, v, seg = inputs(1, pad_frac=0.5)
    out = tatt.window_attention(t(q), t(k), t(v), t(seg)).numpy()
    pad = np.broadcast_to((seg < 0)[:, None, :, None], out.shape)
    assert np.all(out[pad] == 0.0)
    assert np.all(np.isfinite(out)) and np.abs(out[~pad]).mean() > 0.1


def test_no_attention_across_segments():
    """Queries of segment 0 are unmoved by the values of segment 1."""
    q, k, v, seg = inputs(2, pad_frac=0.0)
    out_a = tatt.window_attention(t(q), t(k), t(v), t(seg)).numpy()
    v_mod = v.copy()
    v_mod[np.broadcast_to((seg == 1)[:, None, :, None], v.shape)] += 100.0
    out_b = tatt.window_attention(t(q), t(k), t(v_mod), t(seg)).numpy()
    mask0 = np.broadcast_to((seg == 0)[:, None, :, None], out_a.shape)
    np.testing.assert_array_equal(out_a[mask0], out_b[mask0])
    assert not np.allclose(out_a[~mask0], out_b[~mask0])


def test_bias_matches_jax_reference():
    """The score bias (the JAX package's RPE route) adds before the mask."""
    q, k, v, seg = inputs(3, w=2)
    bias = np.random.default_rng(4).normal(size=(2, 2, 64, 64)).astype(
        np.float32)
    out_j = np.asarray(jatt.window_attention_reference(
        *(jnp.asarray(x) for x in (q, k, v, seg)), bias=jnp.asarray(bias)))
    out_t = tatt.window_attention_reference(t(q), t(k), t(v), t(seg),
                                            bias=t(bias))
    np.testing.assert_allclose(out_t.numpy(), out_j, rtol=0, atol=ATOL)


def test_other_devices_raise():
    """A tensor on neither the CPU nor a CUDA device is refused, not sent
    to the plain version."""
    q = torch.zeros((1, 1, 64, 16), device="meta")
    seg = torch.zeros((1, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tatt.window_attention(q, q, q, seg)


def jax_backward(q, k, v, seg, g, dtype):
    """(dq, dk, dv) in f32 of the JAX package's backward: ``jax.vjp`` of
    ``window_attention`` (its Pallas ``_bwd_call`` in interpret mode) in
    f32; in bf16 the same ``_bwd_call`` on the inputs rounded to bf16 and
    widened, as the VJP runs it before casting its results to bf16."""
    if dtype == "float32":
        _, vjp = jax.vjp(
            lambda q, k, v: jatt.window_attention(q, k, v, jnp.asarray(seg),
                                                  True),
            *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(g))
    else:
        grads = jatt._bwd_call(
            *(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)
              for x in (q, k, v)),
            jnp.asarray(seg), jnp.asarray(g), True)
    return [np.asarray(x) for x in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_pallas_kernel(dtype):
    """(W, H, K, D) = (2, 2, 128, 16), three segments and padding rows: the
    plain backward against the JAX package's, dq, dk and dv within 1e-5 of
    their scale, padding rows exactly 0. The CPU path of
    ``window_attention`` has a ``grad_fn``, and autograd through it gives
    the plain backward's gradients cast to the inputs' dtype, as the JAX
    VJP casts them."""
    q, k, v, seg = inputs(5, w=2, k=128, n_segments=3)
    g = np.random.default_rng(6).normal(size=q.shape).astype(np.float32)
    want = jax_backward(q, k, v, seg, g, dtype)
    tdt = getattr(torch, dtype)
    qt, kt, vt = (t(x).to(tdt) for x in (q, k, v))
    plain = tatt.window_attention_bwd_reference(qt, kt, vt, t(seg), t(g))
    leaves = [x.clone().requires_grad_() for x in (qt, kt, vt)]
    out = tatt.window_attention(*leaves, t(seg))
    assert out.grad_fn is not None
    out.backward(t(g))
    pad = np.broadcast_to((seg < 0)[:, None, :, None], q.shape)
    for name, got, leaf, ref in zip(("dq", "dk", "dv"), plain, leaves, want):
        scale = np.abs(ref).max()
        assert scale > 0.1, name
        assert got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                   atol=1e-5 * scale, err_msg=name)
        assert np.all(got.numpy()[pad] == 0.0), name
        assert leaf.grad.dtype == tdt, name
        assert torch.equal(leaf.grad, got.to(tdt)), name


def test_plain_lse_matches_numpy():
    """The plain forward's log-sum-exp of each row's allowed scaled scores
    against numpy's in float64; rows with no allowed key 0; the forward
    with lse gives the same output as the one without."""
    q, k, v, seg = inputs(7, n_segments=3, pad_frac=0.3)
    seg[1] = -1
    out, lse = tatt.window_attention_fwd(t(q), t(k), t(v), t(seg))
    s = np.einsum("whid,whjd->whij", q.astype(np.float64),
                  k.astype(np.float64)) * q.shape[-1] ** -0.5
    ok = (seg[:, :, None] == seg[:, None, :]) & (seg >= 0)[:, :, None]
    s = np.where(ok[:, None], s, -np.inf)
    m = np.max(s, axis=-1, keepdims=True)
    m = np.where(np.isfinite(m), m, 0.0)
    total = np.exp(s - m).sum(-1)
    pad = np.broadcast_to((seg < 0)[:, None, :], total.shape)
    want = np.where(pad, 0.0, np.log(np.where(pad, 1.0, total)) + m[..., 0])
    assert lse.dtype == torch.float32 and lse.shape == want.shape
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    assert np.all(lse.numpy()[pad] == 0.0) and np.abs(want).max() > 1.0
    assert torch.equal(out, tatt.window_attention(t(q), t(k), t(v), t(seg)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_from_saved_lse_matches_pallas_kernel(dtype):
    """The backward on the kernel's route, fed the forward's saved output
    and log-sum-exp (P = exp(s - lse), rowsum(dp * P) = g . out), against
    the JAX package's Pallas backward: dq, dk and dv within 1e-5 of their
    scale, padding rows exactly 0."""
    q, k, v, seg = inputs(8, w=2, k=128, n_segments=3)
    g = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    want = jax_backward(q, k, v, seg, g, dtype)
    tdt = getattr(torch, dtype)
    qt, kt, vt = (t(x).to(tdt) for x in (q, k, v))
    out, lse = tatt.window_attention_fwd(qt, kt, vt, t(seg))
    got = tatt.window_attention_bwd_reference(qt, kt, vt, t(seg), t(g),
                                              out=out, lse=lse)
    pad = np.broadcast_to((seg < 0)[:, None, :, None], q.shape)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        scale = np.abs(ref).max()
        assert scale > 0.1, name
        np.testing.assert_allclose(x.numpy(), ref, rtol=0, atol=1e-5 * scale,
                                   err_msg=name)
        assert np.all(x.numpy()[pad] == 0.0), name


def tf32(x):
    """x rounded to TF32 as the CUDA kernels round it: to nearest, ties away
    from zero (half a TF32 unit, 0x1000, added to the bits, then the low 13
    mantissa bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def mma_sum(c, x, y):
    """One mma's ``c + x @ y`` as the tensor cores give it: the products
    and their sum exact (float64 here), the result rounded to f32 toward
    zero."""
    exact = c.astype(np.float64) + x.astype(np.float64) @ y.astype(np.float64)
    out = exact.astype(np.float32)
    over = np.abs(out.astype(np.float64)) > np.abs(exact)
    out[over] = np.nextafter(out[over], np.float32(0))
    return out


def tf32_terms(x, y, passes, x_lo_raw=False):
    """The (A, B) operand pairs of one k-step's mma passes in the kernels'
    order, each operand split into TF32 hi and lo: ``passes`` 3, lo*hi +
    hi*lo + hi*hi, a pass dropped where that lo is zero; 1, hi*hi alone.
    ``x_lo_raw``: x's remainder goes to the mma unrounded, which reads its
    TF32 bits (the low 13 mantissa bits cleared)."""
    x_hi, y_hi = tf32(x), tf32(y)
    x_lo, y_lo = tf32(x - x_hi), tf32(y - y_hi)
    if x_lo_raw:
        x_lo = ((x - x_hi).view(np.uint32) & np.uint32(0xFFFFE000)).view(
            np.float32)
    terms = [(x_hi, y_hi)]
    if passes == 3:
        terms = [(a, b) for a, b in ((x_lo, y_hi), (x_hi, y_lo))
                 if a.any() and b.any()] + terms
    return terms


def mma_product(x, y, passes, group=1):
    """x @ y as ``csrc/window_attention_bwd.cu`` computes it: per 8 terms
    of the sum the passes of :func:`tf32_terms` one mma at a time into a
    fresh f32 fragment (:func:`mma_sum`), added to the f32 accumulator
    after ``group`` such steps."""
    acc = np.zeros((x.shape[0], y.shape[1]), np.float32)
    for g0 in range(0, x.shape[1], 8 * group):
        part = np.zeros_like(acc)
        for k0 in range(g0, g0 + 8 * group, 8):
            for a, b in tf32_terms(x[:, k0:k0 + 8], y[k0:k0 + 8], passes):
                part = mma_sum(part, a, b)
        acc = acc + part
    return acc


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_pass_tf32_backward_tile(dtype):
    """The precision decision of the backward kernel on one 64-row tile at
    D = 16 (one window and head, two segments, padding rows), from the
    plain forward's f32 output and log-sum-exp: its five products in three
    TF32 passes (bf16 q, k, v have no TF32 remainder, so those passes drop)
    give dq, dk and dv within 1e-6 of their float64 scale; one TF32 pass
    does not come within 1e-5."""
    q, k, v, seg = inputs(10, w=1, h=1, k=64, d=16, n_segments=2,
                          pad_frac=0.1)
    g = np.random.default_rng(11).normal(size=q.shape).astype(np.float32)
    if dtype == "bfloat16":
        q, k, v = (t(x).to(torch.bfloat16).float().numpy()
                   for x in (q, k, v))
        assert not any((x - tf32(x)).any() for x in (q, k, v))
    out, lse = tatt.window_attention_fwd(t(q), t(k), t(v), t(seg))
    want = tatt.window_attention_bwd_reference(
        *(t(x).double() for x in (q, k, v)), t(seg), t(g).double())
    scale = 16**-0.5
    q1, k1, v1, g1 = (x[0, 0] for x in (q, k, v, g))
    ok = tatt.allowed_pairs(t(seg)).numpy()[0]
    delta = (g1 * out.numpy()[0, 0]).sum(-1, keepdims=True)
    for passes, limit in ((3, 1e-6), (1, None)):
        s = mma_product(q1, k1.T, passes, group=2)
        p = np.where(ok, np.exp(s * scale - lse.numpy()[0, 0, :, None]), 0)
        p = p.astype(np.float32)
        dp = mma_product(g1, v1.T, passes, group=2)
        ds = (p * (dp - delta)).astype(np.float32)
        got = (mma_product(ds, k1, passes) * scale,
               mma_product(ds.T, q1, passes) * scale,
               mma_product(p.T, g1, passes))
        errs = [np.abs(x - w.numpy()[0, 0]).max() / np.abs(w.numpy()).max()
                for x, w in zip(got, want)]
        if limit:
            assert max(errs) <= limit, errs
            pad = seg[0] < 0
            assert all(np.all(x[pad] == 0) for x in got)
        else:
            assert max(errs) > 1e-5, errs


def emulate_forward_tile(q, k, v, seg_q, seg_k, passes, fresh=True):
    """(out, lse) of query rows q (R, D) against keys k, v (K, D) as
    ``csrc/window_attention.cu`` computes them, in numpy: per staged tile of
    64 keys the scores S = q K^T (the passes of up to two 8-wide k-steps
    into a fresh fragment, :func:`mma_sum`, then a rounded add), the mask,
    one row max and one rescale of l and O by alpha = 2^(mc_old - mc_new),
    P = 2^(S c - m c) (c = D^-1/2 log2 e, one rounded FMA; ``np.exp2`` in f32
    for ``ex2.approx``), then O += P V with the passes of each 32 keys in a
    fresh fragment (``fresh=False``: every mma chained into O instead), P's
    remainder handed to the mma unrounded (:func:`tf32_terms`). At
    the end out = O / l and lse = m c ln 2 + log l, 0 for a row with no
    allowed key. ``passes`` 3 splits both operands of both products into
    TF32 hi and lo (passes with a zero lo dropped), 1 takes hi*hi alone."""
    rows, d = q.shape
    c = np.float32(np.float32(d ** -0.5) * np.float32(np.log2(np.e)))
    m = np.full(rows, -np.inf, np.float32)
    mc, l = np.zeros(rows, np.float32), np.zeros(rows, np.float32)
    o = np.zeros((rows, d), np.float32)
    for k0 in range(0, k.shape[0], 64):
        kt, vt = k[k0:k0 + 64], v[k0:k0 + 64]
        s = np.zeros((rows, 64), np.float32)
        for g0 in range(0, d, 16):
            part = np.zeros_like(s)
            for ks in range(g0, min(g0 + 16, d), 8):
                for a, b in tf32_terms(q[:, ks:ks + 8], kt[:, ks:ks + 8].T,
                                       passes):
                    part = mma_sum(part, a, b)
            s = s + part
        ok = (seg_q[:, None] == seg_k[None, k0:k0 + 64]) & (seg_q >= 0)[:, None]
        s = np.where(ok, s, np.float32(-np.inf))
        m_new = np.maximum(m, s.max(1))
        live = np.isfinite(m_new)
        mc_new = np.where(live, m_new * c, 0).astype(np.float32)
        alpha = np.where(np.isfinite(m), np.exp2(mc - mc_new), 0).astype(
            np.float32)
        with np.errstate(invalid="ignore"):
            arg = (s.astype(np.float64) * c - mc_new[:, None]).astype(
                np.float32)
        p = np.exp2(arg)
        l = l * alpha + p.sum(1, dtype=np.float32)
        o = o * alpha[:, None]
        for j0 in range(0, 64, 32):
            part = np.zeros_like(o) if fresh else o
            for j in range(j0, j0 + 32, 8):
                for a, b in tf32_terms(p[:, j:j + 8], vt[j:j + 8], passes,
                                       x_lo_raw=True):
                    part = mma_sum(part, a, b)
            o = o + part if fresh else part
        m, mc = np.where(live, m_new, m), np.where(live, mc_new, mc)
    has = l > 0
    out = o * np.where(has, np.float32(1) / np.where(has, l, 1), 0)[:, None]
    lse = np.where(has, mc * np.float32(np.log(2)) + np.log(np.where(has, l, 1)),
                   0)
    return out.astype(np.float32), lse.astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_three_pass_tf32_forward_tile(dtype):
    """The precision decision of the forward kernel on one 64-row query
    tile at D = 16 against a window of 256 keys (four staged tiles, two
    segments, padding rows), emulated in numpy: 3xTF32 products (bf16 q, k,
    v have no TF32 remainder, so S takes one pass and P V two), each mma's
    sum rounded toward zero into a fresh fragment, one rescale per staged
    tile, give the output and the log-sum-exp within 1e-6 of their float64
    scale, padding rows exactly 0. One TF32 pass misses 1e-5; chaining every
    mma of P V into the output sums more than doubles the output's error
    against fresh fragments."""
    q, k, v, seg = inputs(12, w=1, h=1, k=256, d=16, n_segments=2,
                          pad_frac=0.1)
    if dtype == "bfloat16":
        q, k, v = (t(x).to(torch.bfloat16).float().numpy()
                   for x in (q, k, v))
        assert not any((x - tf32(x)).any() for x in (q, k, v))
    want, want_lse = (x.numpy()[0, 0, :64] for x in
                      tatt.window_attention_reference(
                          *(t(x).double() for x in (q, k, v)), t(seg),
                          return_lse=True))
    q1, k1, v1, s1 = q[0, 0], k[0, 0], v[0, 0], seg[0]
    errs = {}
    for label, passes, fresh in (("3 passes", 3, True), ("1 pass", 1, True),
                                 ("chained", 3, False)):
        out, lse = emulate_forward_tile(q1[:64], k1, v1, s1[:64], s1, passes,
                                        fresh)
        errs[label] = (np.abs(out - want).max() / np.abs(want).max(),
                       np.abs(lse - want_lse).max() / np.abs(want_lse).max())
        pad = s1[:64] < 0
        assert pad.any() and np.all(out[pad] == 0) and np.all(lse[pad] == 0)
    assert max(errs["3 passes"]) <= 1e-6, errs
    assert errs["1 pass"][0] > 1e-5, errs
    assert errs["chained"][0] > 2 * errs["3 passes"][0], errs
