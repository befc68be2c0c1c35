"""The port's z-packed band conv against the JAX package's: the point dedup
and the z-band plan (exactly equal), the engine (kernel part through its
plain version, the z-band packing and the residual repair) against the
Pallas kernel run in interpret mode, its gradients against ``jax.grad``,
the ``subm_conv_apply`` route and the profile script.

Inputs are the z-column voxel sets of ``tests/test_bandconv.py`` (the
surface-cloud shape the engine targets), made from numpy seeds. In f32 the
JAX kernel selects a bf16 hi/lo split of the features (~16 mantissa bits)
where the port reads f32, so the two agree to 1e-4 of the output's scale;
in bf16 both multiply the same rounded features by f32 weights and differ
only in sum order (1e-5). The CUDA kernel runs only on the card, where
``chip_smoke.py`` holds it against the plain version tested here.
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
from treemorph_tpu_torch.scripts import profile_zband

from test_bandconv import column_voxels
from test_torch_ops import (  # noqa: F401
    assert_scaled_close, fresh_jax_caches, one_torch_thread, surface_cloud,
    t,
)


def columns(seed, **kw):
    """A z-column voxel set (coords, valid) from a numpy seed."""
    return column_voxels(np.random.default_rng(seed), **kw)


def gappy_columns():
    """Two z-columns with alternating gaps: the odd-z voxels of x=2 see the
    x=1 column's even-z voxels only through dz=+-1 entries whose dz=0
    anchor is missing, so the residual repair must carry them."""
    rows = [(0, 1, 1, z) for z in range(0, 40, 2)]
    rows += [(0, 2, 1, z) for z in range(1, 40, 2)]
    coords = np.zeros((256, 4), np.int32)
    coords[: len(rows)] = sorted(rows)
    valid = np.arange(256) < len(rows)
    return coords, valid


def rulebook(coords, valid, k):
    """The port's rulebook as numpy: equal to the JAX package's with
    ``verify_coords=True`` (test_torch_ops.py), and no JAX compile."""
    return tsp.build_rulebook(t(coords), t(valid), k).numpy()


@pytest.mark.parametrize("cap", [None, 400])
def test_build_dedup_matches_jax(cap):
    """Points of a dense scan at 0.02 m voxels share voxels; a cap below
    the unique count drops voxels to the dump row (counted)."""
    pts = surface_cloud(3, 2000)
    n = len(pts) + 48
    coords = np.zeros((n, 4), np.int32)
    coords[: len(pts), 1:] = np.floor((pts - pts.min(0)) / 0.02)
    valid = np.arange(n) < len(pts)
    dj = jsp.build_dedup(jnp.asarray(coords), jnp.asarray(valid), cap=cap)
    dt = tsp.build_dedup(t(coords), t(valid), cap=cap)
    for field in dj._fields:
        np.testing.assert_array_equal(
            getattr(dt, field).numpy(), np.asarray(getattr(dj, field)),
            err_msg=field)
    assert int(dt.num_unique) < len(pts)  # duplicates were merged
    assert (int(dt.overflow) > 0) == (cap is not None)


@pytest.mark.parametrize("k", [3, 5])
def test_zband_plan_matches_jax(k):
    coords, valid = columns(0)
    rb = rulebook(coords, valid, k)
    pj = jband.build_zband_plan(jnp.asarray(rb, jnp.int32), jnp.asarray(valid))
    pt = tband.build_zband_plan(t(rb), t(valid))
    for field in ("anchors", "starts", "zoff", "ok", "res_rows", "res_rb",
                  "res_valid"):
        np.testing.assert_array_equal(
            getattr(pt, field).numpy(), np.asarray(getattr(pj, field)),
            err_msg=field)
    assert pt.win == pj.wmark.shape[0] == tband.WIN
    # the residual cap is max(m // res_divisor, 256) rows
    assert pt.res_rows.shape[0] == max(len(rb) // 4, 256)
    assert 0 < int(pt.res_valid.sum()) and bool(pt.ok)


#: (voxel set, k, Cin, Cout, plan options). A 64-row window leaves
#: hundreds of found anchors outside their windows: the kernel must skip
#: them, as the residual repair owns their entries
CASES = {
    "k3": (lambda: columns(1), 3, 8, 16, {}),
    "k5-stem": (lambda: columns(2), 5, 4, 32, {}),
    "missing-anchors": (gappy_columns, 3, 4, 4, {}),
    "small-window": (lambda: columns(1), 3, 8, 16,
                     dict(window=64, res_divisor=2)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_zband_subm_conv_matches_jax(case, dtype):
    make, k, cin, cout, plan_kw = CASES[case]
    coords, valid = make()
    rb = rulebook(coords, valid, k)
    rng = np.random.default_rng(cin + cout)
    feats = rng.normal(size=(len(rb), cin)).astype(np.float32)
    w = (rng.normal(size=(k**3, cin, cout)) * 0.1).astype(np.float32)
    pj = jband.build_zband_plan(jnp.asarray(rb, jnp.int32),
                                jnp.asarray(valid), **plan_kw)
    pt = tband.build_zband_plan(t(rb), t(valid), **plan_kw)
    assert bool(pt.ok) and int(pt.res_valid.sum()) > 0
    out_j = jband.zband_subm_conv_apply(
        jnp.asarray(feats), jnp.asarray(w), pj, jnp.asarray(valid),
        compute_dtype=getattr(jnp, dtype),
    )
    tband.GATHER_ROUTES.clear()
    out_t = tsp.subm_conv_apply(
        t(feats), t(w), pt, t(valid), compute_dtype=getattr(torch, dtype)
    )
    assert not tband.GATHER_ROUTES  # the z-band route, not the gather one
    assert_scaled_close(out_t.numpy(), out_j,
                        1e-4 if dtype == "float32" else 1e-5)


def test_zband_gradients_match_jax():
    """Both cotangents through autograd against ``jax.grad`` of the JAX
    z-band conv (its custom VJP), f32, on a plan with residual rows."""
    coords, valid = columns(3, n_cols=16, zlen=16, cap=320)
    rb = rulebook(coords, valid, 3)
    rng = np.random.default_rng(5)
    feats = rng.normal(size=(len(rb), 6)).astype(np.float32)
    w = (rng.normal(size=(27, 6, 6)) * 0.1).astype(np.float32)
    tgt = rng.normal(size=(len(rb), 6)).astype(np.float32)
    pj = jband.build_zband_plan(jnp.asarray(rb, jnp.int32), jnp.asarray(valid))
    pt = tband.build_zband_plan(t(rb), t(valid))
    assert int(pt.res_valid.sum()) > 0

    def loss_j(f, w):
        out = jband.zband_subm_conv_apply(f, w, pj, jnp.asarray(valid))
        return jnp.sum((out - tgt) ** 2)

    gf_j, gw_j = jax.grad(loss_j, argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(w))
    f_t = t(feats).requires_grad_()
    w_t = t(w).requires_grad_()
    out = tband.zband_subm_conv_apply(f_t, w_t, pt, t(valid))
    ((out - t(tgt)) ** 2).sum().backward()
    assert_scaled_close(f_t.grad.numpy(), gf_j, 1e-4)
    assert_scaled_close(w_t.grad.numpy(), gw_j, 1e-4)


def test_overflowed_zband_plan_takes_the_counted_gather_route():
    """A residual cap below the residual rows overflows the plan: the
    engine gives the gather engine's answer and counts the route."""
    coords, valid = columns(4)
    rb = rulebook(coords, valid, 3)
    rng = np.random.default_rng(8)
    feats = rng.normal(size=(len(rb), 8)).astype(np.float32)
    w = (rng.normal(size=(27, 8, 8)) * 0.1).astype(np.float32)
    pt = tband.build_zband_plan(t(rb), t(valid), res_divisor=len(rb))
    pt = pt._replace(ok=torch.tensor(False))
    tband.GATHER_ROUTES.clear()
    out = tsp.subm_conv_apply(t(feats), t(w), pt, t(valid))
    assert tband.GATHER_ROUTES == {"zband overflow": 1}
    ref = tsp._subm_conv_impl(torch.float32, t(feats), t(w), t(rb), t(valid))
    np.testing.assert_array_equal(out.numpy(), ref.numpy())


def test_profile_zband_runs_on_cpu(capsys):
    records = profile_zband.main(
        ["--device", "cpu", "--n", "3000", "--cap", "4096", "--reps", "1"])
    text = capsys.readouterr().out
    assert "[stem k=5 4->32] band bf16" in text  # k = 5 has a band kernel
    assert "ms (host clock, cpu)" in text
    assert [(r["k"], r["dtype"]) for r in records] == [
        (k, d) for k, _, _, _ in profile_zband.SHAPES for d in ("bf16", "f32")
    ]
    # the sparse tiny cloud overflows the k=5 plan; k=3 runs the z-band
    assert [r["route"] for r in records[2:]] == ["zband"] * 4
    for r in records:
        assert r["zband_calls"] == 3
        assert r["band_ms"] is not None
        if r["route"] == "zband":
            limit = 1e-5 if r["dtype"] == "f32" else 1e-2
            assert r["max_abs_diff"] <= limit * r["scale"], r
