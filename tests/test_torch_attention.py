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


def mma_product(x, y, passes, group=1):
    """x @ y as ``csrc/window_attention_bwd.cu`` computes it, each operand
    split into TF32 hi and lo: per 8 terms of the sum the passes (``passes``
    3: lo*hi + hi*lo + hi*hi, a pass dropped where that lo is zero; 1:
    hi*hi alone) one mma at a time into a fresh f32 fragment (each product
    exact, each sum rounded to f32), added to the f32 accumulator after
    ``group`` such steps."""
    x_hi, y_hi = tf32(x), tf32(y)
    x_lo, y_lo = tf32(x - x_hi), tf32(y - y_hi)
    terms = [(x_hi, y_hi)]
    if passes == 3:
        terms = [(a, b) for a, b in ((x_lo, y_hi), (x_hi, y_lo))
                 if a.any() and b.any()] + terms
    acc = np.zeros((x.shape[0], y.shape[1]), np.float32)
    for g0 in range(0, x.shape[1], 8 * group):
        part = np.zeros_like(acc)
        for k0 in range(g0, g0 + 8 * group, 8):
            for a, b in terms:
                part = (part + a[:, k0:k0 + 8].astype(np.float64)
                        @ b[k0:k0 + 8].astype(np.float64)).astype(np.float32)
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
