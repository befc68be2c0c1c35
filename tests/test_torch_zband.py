"""The port's z-packed band conv against the JAX package's: the point dedup
and the z-band plan (exactly equal), the engine (kernel part through its
plain version, the z-band packing and the residual repair) against the
Pallas kernel run in interpret mode, its gradients against ``jax.grad``,
the ``subm_conv_apply`` route and the profile script; and the arithmetic of
the kernel's z-band instance (``csrc/band_conv.cu`` with the groups as its
offsets) emulated in numpy against float64.

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
from test_torch_bandconv import bf16_round, emulate_band_forward
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


def zband_tile(seed, ksize, cin, bf16, cout=32, win=64):
    """One 128-row output tile of the z-band kernel: anchors (1, G, 128)
    into 256 packed rows of which the first 240 are found (a third of the
    anchors missing, many found ones outside their group's window of
    ``win`` rows at ``8 * starts[g]``), starts (G, 1), the packed rows zq
    (bf16 values in bf16 mode) and the group filters w2 (G, e, Cout)."""
    rng = np.random.default_rng(seed)
    g, e, mp, m = ksize * ksize, ksize * cin, 256, 240
    anchors = rng.integers(0, mp, size=(1, g, 128))
    anchors[rng.random(anchors.shape) < 0.33] = m
    starts = rng.integers(0, (mp - win) // tband.ZALIGN + 1, size=(g, 1))
    zq = rng.normal(size=(mp, e)).astype(np.float32)
    if bf16:
        zq = bf16_round(zq)
    w2 = (rng.normal(size=(g, e, cout)) / np.sqrt(g * e)).astype(np.float32)
    return anchors, starts, zq, w2, m, win


def kernel_rows(anchors, starts, m, win, gspan, unit, missing):
    """The rows the kernel's prologue keeps for each (tile, offset, row):
    the entry if it is found (< m) and lies in the window [unit *
    starts[k // gspan, t], + win) of its offset's group, else ``missing``
    (a zero-filled row). gspan = 1, unit = 8 is the z-band instance."""
    k = anchors.shape[1]
    base = (starts[np.arange(k) // gspan] * unit).T[:, :, None]
    local = anchors - base
    ok = (anchors < m) & (local >= 0) & (local < win)
    return np.where(ok, anchors, missing), ok


def zband_reference(rows, zq, w2):
    """float64 sum over groups of the kept packed rows times the group
    filter; ``rows == len(zq)`` adds nothing."""
    pad = np.concatenate([zq, np.zeros((1, zq.shape[1]), zq.dtype)])
    return sum(pad[rows[0, j]].astype(np.float64) @ w2[j].astype(np.float64)
               for j in range(rows.shape[1]))


@pytest.mark.parametrize("ksize,cin", [(3, 32), (5, 4)])
@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_zband_kernel_precision(ksize, cin, mode):
    """The z-band instance's arithmetic on one tile, at the profile's k=3
    32 -> 32 conv (96 packed channels: 3 bf16 or 6 f32 stages a group) and
    PTv3's k=5 stem (4 -> 32: 20 packed channels, one zero-padded stage in
    bf16, two in f32): bf16 rows by three bf16 weight pieces (bf16 mode)
    and 3xTF32 (f32 mode), each stage a fresh fragment added with a rounded
    add, land within 1e-6 of the output scale of float64; a single TF32
    pass, or weights rounded to bf16, misses 1e-5."""
    anchors, starts, zq, w2, m, win = zband_tile(ksize + cin, ksize, cin,
                                                 mode == "bf16")
    rows, ok = kernel_rows(anchors, starts, m, win, 1, tband.ZALIGN,
                           len(zq))
    assert ok.any(axis=2).all()  # every group has work in the tile
    ref = zband_reference(rows, zq, w2)
    scale = np.abs(ref).max()
    schemes = (["bf16 pieces", "bf16 weights", "one tf32 pass"]
               if mode == "bf16" else ["3xTF32", "one tf32 pass"])
    errs = {s: np.abs(emulate_band_forward(rows, zq, w2, s) - ref).max()
            for s in schemes}
    assert errs[schemes[0]] <= 1e-6 * scale
    for s in schemes[1:]:
        assert errs[s] > 1e-5 * scale, s


@pytest.mark.parametrize("mode", ["bf16", "f32"])
def test_zband_kernel_skips_out_of_window_anchors(mode):
    """A found anchor outside its group's 8-row-unit window adds nothing in
    the kernel (the residual repair owns its entries): the emulated tile
    equals the plain version, which skips them, to 1e-6 of scale, and a
    sum that read them would be far off. The prologue's window test with
    the band's constants (groups of ksize offsets, 64-row units) is
    :func:`.bandconv.in_window`'s."""
    anchors, starts, zq, w2, m, win = zband_tile(7, 3, 8, mode == "bf16")
    rows, ok = kernel_rows(anchors, starts, m, win, 1, tband.ZALIGN,
                           len(zq))
    outside = (anchors < m) & ~ok
    assert outside.sum() > 100 and ok.sum() > 100
    scheme = "bf16 pieces" if mode == "bf16" else "3xTF32"
    got = emulate_band_forward(rows, zq, w2, scheme)
    plain = tband.zband_conv_padded_plain(
        t(anchors.astype(np.int32)), t(starts.astype(np.int32)),
        t(zq).to(torch.bfloat16 if mode == "bf16" else torch.float32),
        t(w2), m, win).numpy()[:128]
    scale = np.abs(plain).max()
    assert np.abs(got - plain).max() <= 1e-6 * scale
    found = np.where(anchors < m, anchors, len(zq))
    assert np.abs(zband_reference(found, zq, w2) - plain).max() > 0.1 * scale

    # the same prologue with the band's constants: a 3x3x3 band tile
    rng = np.random.default_rng(3)
    rb = rng.integers(0, 256, size=(1, 27, 128))
    band_starts = rng.integers(0, 3, size=(9, 1))
    _, band_ok = kernel_rows(rb, band_starts, 240, 128, 3, tband.ALIGN, 256)
    _, expected = tband.in_window(t(rb.astype(np.int32)),
                                  t(band_starts.astype(np.int32)), 240, 128)
    np.testing.assert_array_equal(band_ok, expected.numpy())
