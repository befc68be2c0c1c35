"""The port's PTv3 inference path against the JAX package's.

Inputs come from numpy seeds and go to both packages: clouds of two batch
elements whose voxels hold 2-6 points each (PTv3's level 0 is points, not
voxels), padded. Structure (curve codes, orders, rulebooks, pooled
clusters) must be exactly equal; f32 outputs agree to 1e-4 (sum order
only). A tiny model (two stages, patch 64) gets variables in flax's layout
(traced once with ``jax.eval_shape``) with values drawn from numpy, all
perturbed so no bias, norm or statistic is trivial, and goes through the
weight bridge into the port; the JAX side runs on the CPU, where its
attention takes ``window_attention_reference``.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.evaluation.model_loaders import (
    Predictor as JPredictor,
    build_model as jbuild,
)
from treemorph_tpu.models import ptv3 as jptv3
from treemorph_tpu.ops import serialization as jser
from treemorph_tpu.ops import sparse as jsp
from treemorph_tpu.pipeline.predict import predict_single as jpredict_single
from treemorph_tpu_torch.evaluation.model_loaders import Predictor, build_model
from treemorph_tpu_torch.models import flax_to_state_dict
from treemorph_tpu_torch.models import ptv3 as tptv3
from treemorph_tpu_torch.ops import serialization as tser
from treemorph_tpu_torch.ops import sparse as tsp
from treemorph_tpu_torch.pipeline.predict import predict_single

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, surface_cloud, t,
)

TINY = dict(enc_depths=(2, 2), enc_channels=(16, 32), enc_num_head=(2, 2),
            enc_patch_size=(64, 64), dec_depths=(2,), dec_channels=(16,),
            dec_num_head=(2,), dec_patch_size=(64,))
P = 1024  # padded points: predict_single's bucket, 16 windows of 64
VOXEL = 0.02


def duplicated_cloud(seed, n_voxels, shift=(0.0, 0.0, 0.0)):
    """Points of ``n_voxels`` voxels of a scanned tree surface, 2-6 per
    voxel, each inside its voxel's cube."""
    rng = np.random.default_rng(seed)
    vox = np.unique(np.floor(surface_cloud(seed, 4 * n_voxels) / VOXEL)
                    .astype(np.int64), axis=0)
    vox = vox[rng.permutation(len(vox))[:n_voxels]]
    reps = rng.integers(2, 7, size=len(vox))
    cells = np.repeat(vox, reps, axis=0)
    pts = (cells + rng.uniform(0.05, 0.95, cells.shape)) * VOXEL
    return (pts + np.asarray(shift)).astype(np.float32)


def bucket_of(grid4, m):
    """The JAX hash table's bucket of (b, x, y, z) rows in a table over m
    rows (the port's copy of its hash and size)."""
    n_buckets = (1 << max(8 * m - 1, 127).bit_length()) // 16
    return (tsp._spatial_hash(t(np.asarray(grid4, np.int64)))
            & (n_buckets - 1)).numpy()


def overflow_points(pts, rng, m=P):
    """Points to add to element 0 of ``pts`` (its grid: floor((p - min) /
    VOXEL), the min unchanged) so that JAX hash buckets of a table over
    ``m`` rows hold more than 16 rows: 40 points in one occupied voxel, and
    10 points in each of two empty voxels next to the cloud that share a
    bucket."""
    lo = pts.min(axis=0)
    grid = np.floor((pts - lo) / VOXEL).astype(np.int64)
    occupied = {tuple(g) for g in grid}
    crowded = grid[len(grid) // 2]
    empty = sorted({tuple(g + d) for g in grid[::7]
                    for d in ((1, 0, 0), (0, 1, 0), (0, 0, 1))} - occupied)
    buckets = bucket_of([(0,) + e for e in empty], m)
    first = next(i for i in range(len(empty))
                 if (buckets[i + 1:] == buckets[i]).any())
    second = first + 1 + int(np.argmax(buckets[first + 1:] == buckets[first]))
    cells = np.concatenate([np.repeat(crowded[None], 40, 0),
                            np.repeat(np.array([empty[first]]), 10, 0),
                            np.repeat(np.array([empty[second]]), 10, 0)])
    return (lo + (cells + rng.uniform(0.05, 0.95, cells.shape)) * VOXEL
            ).astype(np.float32)


def two_element_batch(seed=0, n=1000):
    """Flat (coords, feats, batch ids, valid) of two overlapping trees, in
    shuffled order, padded to P. Element 0 also holds a voxel of 40 points
    and two voxels of 10 that share a JAX hash bucket
    (:func:`overflow_points`)."""
    rng = np.random.default_rng(seed + 50)
    a = duplicated_cloud(seed, 120)
    b = duplicated_cloud(seed + 1, 120, shift=(0.01, 0.0, 0.0))
    pts = np.concatenate([a, b])[:n - 60]
    ids = np.concatenate([np.zeros(len(a)), np.ones(len(b))])[:n - 60]
    extra = overflow_points(pts[ids == 0], rng)
    pts = np.concatenate([pts, extra])
    ids = np.concatenate([ids, np.zeros(len(extra))])
    perm = rng.permutation(len(pts))
    coords = np.zeros((P, 3), np.float32)
    coords[: len(pts)] = pts[perm]
    feats = np.zeros((P, 4), np.float32)
    feats[: len(pts)] = rng.normal(size=(len(pts), 4))
    batch = np.zeros(P, np.int32)
    batch[: len(pts)] = ids[perm]
    return coords, feats, batch, np.arange(P) < len(pts)


def code64(hi, lo):
    return (np.asarray(hi, np.int64) << 32) | np.asarray(lo, np.int64)


# --- serialization -------------------------------------------------------


@pytest.mark.parametrize("order", ["z", "z-trans", "hilbert", "hilbert-trans"])
def test_curve_codes_match_jax(order):
    """Codes over the whole 16-bit range equal JAX's ``(hi << 32) | lo``."""
    grid = np.random.default_rng(3).integers(0, 1 << 16, size=(4096, 3))
    grid = grid.astype(np.int32)
    _, hi, lo = jser.encode(jnp.asarray(grid), None, depth=16, order=order)
    _, code = tser.encode(t(grid), None, depth=16, order=order)
    np.testing.assert_array_equal(code.numpy(), code64(hi, lo))


def test_pointset_orders_match_jax():
    """Grid coords, codes, orders and inverses of all four curves: voxels
    of 2-6 points tie on their codes, and both sorts keep index order."""
    c, f, b, v = two_element_batch(1)
    ps_j = jax.jit(functools.partial(jptv3.make_pointset, grid_size=VOXEL))(
        jnp.asarray(c), jnp.asarray(f), jnp.asarray(b), jnp.asarray(v))
    ps_t = tptv3.make_pointset(t(c), t(f), t(b), t(v), VOXEL)
    np.testing.assert_array_equal(ps_t.grid_coord.numpy(), ps_j.grid_coord)
    np.testing.assert_array_equal(ps_t.batch.numpy(), ps_j.batch)
    np.testing.assert_array_equal(ps_t.code.numpy(),
                                  code64(ps_j.code_hi, ps_j.code_lo))
    np.testing.assert_array_equal(ps_t.orders.numpy(), ps_j.orders)
    np.testing.assert_array_equal(ps_t.inverses.numpy(), ps_j.inverses)
    grid = ps_t.grid_coord.numpy()[v]
    assert len(np.unique(grid, axis=0)) < 0.6 * v.sum()  # many ties


# --- rulebook over points with duplicates --------------------------------


def duplicate_coords(seed=2, n_voxels=300, pad=40):
    """(b, x, y, z) rows of two batch elements, 2-6 rows per voxel in
    shuffled order, then padding rows (batch 0x7FFF as PTv3 pads)."""
    rng = np.random.default_rng(seed)
    rows = []
    for elem in range(2):
        vox = np.unique(np.floor(surface_cloud(seed + elem, 4 * n_voxels)
                                 / VOXEL).astype(np.int32), axis=0)
        vox = vox[: n_voxels // 2]
        vox -= vox.min(axis=0)
        cells = np.repeat(vox, rng.integers(2, 7, size=len(vox)), axis=0)
        rows.append(np.concatenate(
            [np.full((len(cells), 1), elem, np.int32), cells], axis=1))
    coords = np.concatenate(rows)
    coords = coords[rng.permutation(len(coords))]
    m = len(coords)
    coords = np.concatenate(
        [coords, np.tile(np.array([[0x7FFF, 0, 0, 0]], np.int32), (pad, 1))])
    return coords, np.arange(m + pad) < m


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_rulebook_with_duplicates_matches_jax(kernel_size):
    coords, valid = duplicate_coords()
    cj, vj = jnp.asarray(coords), jnp.asarray(valid)
    # the JAX table keeps 16 lanes per hash bucket: this cloud fills none
    # past that, so both lookups see every row
    rows = jax.jit(jsp.build_table)(cj, vj).rows  # (buckets, 32)
    bucket = np.asarray(jsp._spatial_hash(cj)) & (rows.shape[0] - 1)
    assert np.bincount(bucket[valid]).max() <= jsp.SLOTS_PER_BUCKET
    rb_j = np.asarray(jsp.build_rulebook(cj, vj, kernel_size,
                                         verify_coords=True))
    rb_t = tsp.build_rulebook(t(coords), t(valid), kernel_size).numpy()
    np.testing.assert_array_equal(rb_t, rb_j)
    m = len(coords)
    found = rb_t[valid] < m
    assert found[:, : kernel_size**3 // 2].mean() > 0.1
    if kernel_size == 5:
        cols = tsp.rulebook_subset_columns(5, 3)
        np.testing.assert_array_equal(cols, jsp.rulebook_subset_columns(5, 3))
        np.testing.assert_array_equal(
            rb_t[:, cols], tsp.build_rulebook(t(coords), t(valid), 3).numpy())


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_rulebook_bucket_overflow_matches_jax(kernel_size):
    """Level 0 of a batch whose JAX hash buckets hold more than 16 rows (a
    voxel of 40+ points, two voxels of 10 in one bucket): the JAX table
    keeps the first 16 valid rows of each bucket, and the port's rulebook
    equals its exact lookup (``verify_coords=True``) entry for entry."""
    c, f, b, v = two_element_batch(0)
    ps = tptv3.make_pointset(t(c), t(f), t(b), t(v), VOXEL)
    coords = torch.cat([ps.batch[:, None], ps.grid_coord], 1).int()
    grid = coords.numpy()[v]
    _, per_voxel = np.unique(grid, axis=0, return_counts=True)
    assert per_voxel.max() >= 40
    assert np.bincount(bucket_of(grid, P)).max() > 16
    kept = tsp.table_rows(coords, ps.valid).numpy()
    assert kept.sum() < v.sum() and not kept[~v].any()
    rb_j = np.asarray(jsp.build_rulebook(
        jnp.asarray(coords.numpy()), jnp.asarray(ps.valid.numpy()),
        kernel_size, verify_coords=True))
    rb_t = tsp.build_rulebook(coords, ps.valid, kernel_size).numpy()
    np.testing.assert_array_equal(rb_t, rb_j)


# --- pooling --------------------------------------------------------------


@pytest.mark.parametrize("cap", [512, 128])
def test_pooling_level_matches_jax(cap):
    """One SerializedPooling: clusters, pooled validity, grid coords, batch,
    codes, orders and the overflow count exactly; features to 1e-5. The
    small cap drops clusters."""
    c, f, b, v = two_element_batch(3)
    rng = np.random.default_rng(7)
    feat = rng.normal(size=(P, 8)).astype(np.float32)
    params = {"proj": {"kernel": rng.normal(size=(8, 16)).astype(np.float32),
                       "bias": rng.normal(size=16).astype(np.float32)},
              "norm": {"scale": rng.uniform(0.7, 1.3, 16).astype(np.float32),
                       "bias": rng.normal(0, 0.2, 16).astype(np.float32)}}
    stats = {"norm": {"mean": rng.normal(0, 0.3, 16).astype(np.float32),
                      "var": rng.uniform(0.5, 2.0, 16).astype(np.float32)}}
    jpool = jptv3.SerializedPooling(16, cap=cap)

    @jax.jit
    def jax_pool(c, feat, b, v):
        ps = jptv3.make_pointset(c, feat, b, v, VOXEL)
        return jpool.apply({"params": params, "batch_stats": stats}, ps,
                           False)

    coarse_j, cluster_j, over_j = jax_pool(*map(jnp.asarray, (c, feat, b, v)))
    pool = tptv3.SerializedPooling(8, 16).eval()
    pool.load_state_dict(flax_to_state_dict(
        {"params": params, "batch_stats": stats}), strict=True)
    ps = tptv3.make_pointset(t(c), t(feat), t(b), t(v), VOXEL)
    with torch.inference_mode():
        coarse_t, cluster_t, over_t = pool(ps, cap)
    np.testing.assert_array_equal(cluster_t.numpy(), cluster_j)
    assert int(over_t) == int(over_j)
    assert (int(over_t) > 0) == (cap == 128)
    for name in ("valid", "grid_coord", "batch", "orders", "inverses"):
        np.testing.assert_array_equal(getattr(coarse_t, name).numpy(),
                                      getattr(coarse_j, name), err_msg=name)
    np.testing.assert_array_equal(coarse_t.code.numpy(),
                                  code64(coarse_j.code_hi, coarse_j.code_lo))
    np.testing.assert_allclose(coarse_t.feat.numpy(), coarse_j.feat,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(coarse_t.coord.numpy(), coarse_j.coord,
                               rtol=1e-6, atol=1e-6)


# --- the model ----------------------------------------------------------


def tiny_jax_model():
    return jbuild("pointtransformerv3", **TINY)


@functools.lru_cache(maxsize=None)
def flax_layout():
    """Shapes of the tiny model's flax variables (traced, not compiled)."""
    model = tiny_jax_model()
    return jax.eval_shape(
        lambda key: model.init(
            key, jnp.zeros((P, 3)), jnp.zeros((P, 4)),
            jnp.zeros(P, jnp.int32), jnp.ones(P, bool), train=False,
        ),
        jax.random.key(0),
    )


def flax_values(seed=0, layout=None):
    """Variables in flax's layout (``layout``: the tiny model's by default)
    drawn from numpy: fan-in normals for conv and Dense kernels, the heads'
    final kernels at 0.5 (O(1) outputs), and every bias, norm parameter and
    statistic perturbed."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        shape, name = spec.shape, path[-1]
        if name == "kernel":
            if path[-2] == "Dense_1" and path[-3].endswith("_head"):
                return rng.normal(0, 0.5, shape).astype(np.float32)
            fan_in = np.prod(shape[:-1])
            return (rng.normal(size=shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        return rng.normal(0, 0.2, shape).astype(np.float32)

    def walk(tree, path=()):
        return {
            k: walk(v, path + (k,)) if hasattr(v, "items")
            else leaf(path + (k,), v)
            for k, v in tree.items()
        }

    return walk(layout if layout is not None else flax_layout())


def port_model(variables):
    model = tptv3.PointTransformerWithHeads(dim_feat=4, use_feats=True,
                                            voxel_size=VOXEL, **TINY)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model.eval()


@pytest.fixture(scope="module")
def models():
    """One JAX predictor (one jitted apply serves both model tests: the
    same shapes) and its variables, with the noise head's final bias set
    at the port's median logit margin so both classes occur."""
    variables = flax_values()
    c, f, b, v = two_element_batch(0)
    with torch.inference_mode():
        logits = port_model(variables)(t(c), t(f), t(b), t(v))[
            "semantic_prediction_logits"].numpy()[v]
    margin = float(np.median(logits[:, 1] - logits[:, 0]))
    variables["params"]["semantic_head"]["Dense_1"]["bias"] = np.array(
        [0.0, -margin], np.float32)
    jpred = JPredictor("pointtransformerv3", tiny_jax_model(), variables)
    return jpred, variables


def test_weight_bridge_covers_every_parameter():
    variables = flax_values(1)
    sd = flax_to_state_dict(variables)
    model = tptv3.PointTransformerWithHeads(dim_feat=4, **TINY)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    blk = variables["params"]["backbone"]["enc1_block0"]
    np.testing.assert_array_equal(
        model.backbone.enc1_block0.attn.qkv.weight.detach().numpy(),
        blk["attn"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        model.backbone.enc1_block0.cpe.LayerNorm_0.weight.detach().numpy(),
        blk["cpe"]["LayerNorm_0"]["scale"])
    np.testing.assert_array_equal(
        model.backbone.embedding.kernel.detach().numpy(),
        variables["params"]["backbone"]["embedding"]["kernel"])
    np.testing.assert_array_equal(
        model.backbone.dec0_up.norm_skip.running_var.numpy(),
        variables["batch_stats"]["backbone"]["dec0_up"]["norm_skip"]["var"])


def test_forward_matches_jax(models):
    """f32 forward of two batch elements with duplicates: offsets and
    logits to 1e-4, equal argmax, equal pool overflow."""
    jpred, variables = models
    c, f, b, v = two_element_batch(0)
    out_j = jpred.predict_flat(*map(jnp.asarray, (c, f, b, v)))
    with torch.inference_mode():
        out_t = port_model(variables)(t(c), t(f), t(b), t(v))
    for key in ("offset_predictions", "semantic_prediction_logits"):
        np.testing.assert_allclose(out_t[key].numpy()[v],
                                   np.asarray(out_j[key])[v],
                                   rtol=1e-4, atol=1e-4, err_msg=key)
    lt = out_t["semantic_prediction_logits"].numpy()[v]
    lj = np.asarray(out_j["semantic_prediction_logits"])[v]
    np.testing.assert_array_equal(lt.argmax(1), lj.argmax(1))
    assert 0.2 < lt.argmax(1).mean() < 0.8
    assert int(out_t["pool_overflow"]) == int(out_j["pool_overflow"]) == 0
    assert np.abs(np.asarray(out_j["offset_predictions"])[v]).mean() > 0.05


def test_predict_single_matches_jax(models):
    """Stage 1 with the PTv3 family: offsets applied, then the noise
    head's class-1 points dropped, to 1e-4."""
    jpred, variables = models
    c, f, _, v = two_element_batch(0)
    cloud = np.zeros((int(v.sum()), 11), np.float32)
    cloud[:, :3] = c[v]
    cloud[:, 7:11] = f[v]
    out_j = jpredict_single(cloud, jpred, jpred)
    pred = Predictor("pointtransformerv3", port_model(variables), "cpu")
    out_t = predict_single(cloud, pred, pred, device="cpu")
    assert 0.2 * len(cloud) < len(out_t) < 0.8 * len(cloud)
    assert out_t.shape == out_j.shape
    np.testing.assert_allclose(out_t, out_j, rtol=1e-4, atol=1e-4)


def test_build_model_and_options_off_the_path():
    """``build_model`` gives the pipeline's PTv3 (the family defaults and
    the JAX package's widths) with seeded weights; the options off the
    pipeline's path build and serve on the CPU: the z-pack stem, and
    the reference-partitioning options (their parity tests:
    ``test_torch_ptv3_options.py``, ``test_torch_engines.py``; the dedup
    options and the band stem: ``test_torch_ptv3_bench.py``)."""
    model = build_model("pointtransformerv3", device="cpu", seed=0, **TINY)
    again = build_model("pointtransformerv3", device="cpu", seed=0, **TINY)
    assert not model.training
    assert model.config["use_feats"] and model.config["dim_feat"] == 4
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    kernel = model.backbone.embedding.kernel
    assert abs(float(kernel.detach().std()) * np.sqrt(125 * 4) - 1) < 0.1
    c, f, b, v = two_element_batch(0)
    spec = tptv3.PDNormSpec(bn=True, ln=True, conditions=("TreeSet",))
    for option in (dict(stem_engine="zpack", dedup_divisor=4),
                   dict(enable_rpe=True),
                   dict(pad_per_element=True, num_elements=2),
                   dict(pdnorm=spec)):
        built = build_model("pointtransformerv3", device="cpu", seed=0,
                            **option, **TINY)
        with torch.inference_mode():
            out = built(t(c), t(f), t(b), t(v))
        assert np.isfinite(out["offset_predictions"].numpy()).all(), option
        assert all(built.config[k] == val for k, val in option.items())
    with pytest.raises(ValueError, match="dedup_tokens needs"):
        tptv3.PointTransformerWithHeads(dedup_tokens=True)
    for option in (dict(dedup_divisor=4), dict(stem_engine="band"),
                   dict(dedup_divisor=4, dedup_tokens=True,
                        stem_engine="band")):
        config = tptv3.PointTransformerWithHeads(**option, **TINY).config
        assert all(config[k] == v for k, v in option.items())


def test_bfloat16_block_matches_jax(models):
    """``compute_dtype="bfloat16"`` against the JAX package's: the xCPE,
    the attention and the MLP of one block of the tiny model, each handed
    the same level, rulebook and features. Each rounds to bf16 where JAX
    does, so all but a few f32 sum-order flips of one bf16 step agree to
    1e-5 of the output's scale (readings: 0, 0 and 1 of 15,056 elements
    beyond it); a cast out of place, or a Dense or GELU rounded otherwise,
    moves 47-100 % of them. None differs by more than 1e-2 of the scale."""
    _, variables = models
    block = variables["params"]["backbone"]["enc0_block0"]
    c, _, b, v = two_element_batch(0)
    feat = np.random.default_rng(5).normal(size=(P, 16)).astype(np.float32)
    feat *= v[:, None]
    ps_t = tptv3.make_pointset(t(c), t(feat), t(b), t(v), VOXEL)
    coords = torch.cat([ps_t.batch[:, None], ps_t.grid_coord], 1).int()
    rb = tsp.build_rulebook(coords, ps_t.valid, 3)
    ps_j = jptv3.PointSet(
        *(jnp.asarray(x.numpy()) for x in ps_t[:7]),
        code_hi=None, code_lo=None)
    rb_j, feat_j, valid_j = jnp.asarray(rb.numpy()), jnp.asarray(feat), v
    tblock = tptv3.PTv3Block(16, 2, 64, 0, compute_dtype="bfloat16").eval()
    tblock.load_state_dict(flax_to_state_dict({"params": block}),
                           strict=True)
    bf16 = dict(compute_dtype="bfloat16")
    cases = {
        "cpe": (jptv3.CPE(16, **bf16), (feat_j, rb_j, valid_j),
                lambda: tblock.cpe(t(feat), rb, t(v))),
        "attn": (jptv3.SerializedAttention(16, 2, 64, 0, **bf16),
                 (ps_j, False), lambda: tblock.attn(ps_t)),
        "mlp": (jptv3.FeedForward(16, **bf16), (feat_j,),
                lambda: tblock.mlp(t(feat))),
    }
    for name, (jmod, args, port) in cases.items():
        out_j = np.asarray(jax.jit(jmod.apply)({"params": block[name]},
                                               *args))[v]
        with torch.inference_mode():
            out_t = port().numpy()[v]
        err = np.abs(out_t - out_j) / np.abs(out_j).max()
        assert (err > 1e-5).mean() < 1e-3, name
        assert err.max() < 1e-2, name


def test_bfloat16_compute(models, monkeypatch):
    """``compute_dtype="bfloat16"`` through the whole model: every block's
    attention gets bf16 q, k, v, and the outputs stay within bf16 rounding
    of the f32 forward (2e-2 of their scale). Each block is held to the
    JAX package's bf16 block by ``test_bfloat16_block_matches_jax``."""
    _, variables = models
    c, f, b, v = two_element_batch(0)
    seen = []
    kernel = tptv3.attention.window_attention

    def recording(q, k, val, seg):
        seen.append(q.dtype)
        return kernel(q, k, val, seg)

    model = port_model(variables)
    bf16 = model.clone(compute_dtype="bfloat16").eval()
    monkeypatch.setattr(tptv3.attention, "window_attention", recording)
    with torch.inference_mode():
        ref = model(t(c), t(f), t(b), t(v))["offset_predictions"].numpy()
        seen.clear()
        out = bf16(t(c), t(f), t(b), t(v))["offset_predictions"].numpy()
    assert seen == [torch.bfloat16] * 6
    scale = np.abs(ref[v]).max()
    err = np.abs(out[v] - ref[v]).max()
    assert 1e-5 * scale < err < 2e-2 * scale
