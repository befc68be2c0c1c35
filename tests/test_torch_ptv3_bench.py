"""The port's PTv3 in the configuration ``bench.py`` measures (token dedup,
``dedup_divisor=4``, the band stem at k=5 and band xCPEs, bf16,
``pool_shrink=2``) against the JAX package's, at the JAX tests' tiny widths
(tests/test_ptv3.py:15-23) on clouds of a few hundred voxels of 2-6 points
each.

Both packages get the same numpy inputs and the same variables (drawn from
numpy in flax's layout, through the weight bridge). The JAX side runs on
the CPU, its band kernel in Pallas interpret mode and its attention through
``window_attention_reference``; the port takes the plain versions of its
kernels there. ``chip_smoke.py`` holds the port's CUDA kernels against
those plain versions on the card.
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
from treemorph_tpu.pipeline.predict import predict_single as jpredict_single
from treemorph_tpu_torch.evaluation.model_loaders import Predictor, build_model
from treemorph_tpu_torch.models import flax_to_state_dict
from treemorph_tpu_torch.models import ptv3 as tptv3
from treemorph_tpu_torch.ops import bandconv as tband
from treemorph_tpu_torch.pipeline.predict import _pad_flat, predict_single

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, surface_cloud, t,
)
from test_torch_ptv3 import code64, duplicated_cloud, flax_values

#: the JAX tests' tiny PTv3 (tests/test_ptv3.py:15-23): three stages
TINY = dict(enc_depths=(1, 1, 1), enc_channels=(16, 32, 64),
            enc_num_head=(2, 4, 8), enc_patch_size=(64, 64, 64),
            dec_depths=(1, 1), dec_channels=(16, 32), dec_num_head=(2, 4),
            dec_patch_size=(64, 64), drop_path=0.0)
#: bench.py's PTv3 configuration (bench.py:745-750)
BENCH = dict(pool_shrink=2, dedup_divisor=4, dedup_tokens=True,
             stem_engine="band", compute_dtype="bfloat16")
CONFIGS = {
    "tokens": dict(dedup_divisor=4, dedup_tokens=True),
    "level0_dedup": dict(dedup_divisor=2),
    "band_f32": dict(BENCH, compute_dtype="float32"),
    "bench_bf16": BENCH,
}
P = 1024  # padded points: predict_single's bucket
VOXEL = 0.02


def batch_of(parts, seed):
    """Flat (coords, feats, batch ids, valid) of the clouds ``parts``, one
    batch element each, shuffled and padded to P, with seeded features.
    Element 0 also gets a point at the lowest voxel corner of all of them:
    quantized against the cloud's minimum, each voxel's points then stay
    in one voxel."""
    rng = np.random.default_rng(seed)
    corner = np.floor(np.concatenate(parts).min(axis=0) / VOXEL) * VOXEL
    parts = [np.concatenate([parts[0], corner[None].astype(np.float32)]),
             *parts[1:]]
    pts = np.concatenate(parts)
    ids = np.concatenate([np.full(len(c), i) for i, c in enumerate(parts)])
    perm = rng.permutation(len(pts))
    coords = np.zeros((P, 3), np.float32)
    coords[: len(pts)] = pts[perm]
    feats = np.zeros((P, 4), np.float32)
    feats[: len(pts)] = rng.normal(size=(len(pts), 4))
    batch = np.zeros(P, np.int32)
    batch[: len(pts)] = ids[perm]
    return coords, feats, batch, np.arange(P) < len(pts)


def two_trees(seed=0):
    """Two overlapping elements of 70 voxels each, 2-6 points a voxel: 141
    tokens (the corner point's voxel too), within the token cap of P // 4
    = 256 rows and, pooled, within the pooled levels' caps."""
    return batch_of([duplicated_cloud(seed, 70),
                     duplicated_cloud(seed + 1, 70)], seed)


def as_cloud(c, f, v):
    """The (N, 11) layout ``predict_single`` takes (features in 7:11)."""
    cloud = np.zeros((int(v.sum()), 11), np.float32)
    cloud[:, :3] = c[v]
    cloud[:, 7:11] = f[v]
    return cloud


@functools.lru_cache(maxsize=None)
def layout():
    """Shapes of the tiny model's flax variables in the bench
    configuration (traced, not compiled)."""
    model = jbuild("pointtransformerv3", **TINY, **BENCH)
    return jax.eval_shape(
        lambda key: model.init(
            key, jnp.zeros((P, 3)), jnp.zeros((P, 4)),
            jnp.zeros(P, jnp.int32), jnp.ones(P, bool), train=False,
        ),
        jax.random.key(0),
    )


@pytest.fixture(scope="module")
def variables():
    return flax_values(2, layout())


@pytest.fixture(scope="module")
def jax_predictors(variables):
    """One JAX predictor per configuration, made on first use (each one
    jit-compiles its forward once, whatever test calls it)."""
    cache = {}

    def get(name):
        if name not in cache:
            cache[name] = JPredictor(
                "pointtransformerv3",
                jbuild("pointtransformerv3", **TINY, **CONFIGS[name]),
                variables)
        return cache[name]

    return get


def port_model(variables, **config):
    model = tptv3.PointTransformerWithHeads(dim_feat=4, use_feats=True,
                                            voxel_size=VOXEL, **TINY,
                                            **config)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model.eval()


def counting_band_kernel(monkeypatch):
    """Record the K of every call of the band kernel's wrapper (the CPU
    takes its plain version: no launch is counted there)."""
    seen = []
    kernel = tband.band_conv_padded

    def recording(rb_tiles, *args):
        seen.append(rb_tiles.shape[1])
        return kernel(rb_tiles, *args)

    monkeypatch.setattr(tband, "band_conv_padded", recording)
    return seen


def test_lex_permute_level_matches_jax():
    """A pooled level (orders shuffled, as in training) re-stored in lex
    order: every field, the orders and inverses composed with the
    permutation, and the fine level's cluster map, exactly as the JAX
    package's ``_lex_permute_level``; padding rows stay last and the rows
    come out in lex order."""
    c, f, b, v = two_trees(3)
    rng = np.random.default_rng(8)
    feat = rng.normal(size=(P, 8)).astype(np.float32)
    pool = tptv3.SerializedPooling(8, 16).eval()
    ps = tptv3.make_pointset(t(c), t(feat), t(b), t(v), VOXEL)
    with torch.inference_mode():
        coarse, cluster, over = pool(ps, 256, torch.tensor([2, 0, 3, 1]))
    assert int(over) == 0
    new_t, cl_t = tptv3._lex_permute_level(coarse, cluster)

    code = coarse.code.numpy()
    ps_j = jptv3.PointSet(
        *(jnp.asarray(x.numpy()) for x in coarse[:7]),
        code_hi=jnp.asarray((code >> 32).astype(np.uint32)),
        code_lo=jnp.asarray((code & 0xFFFFFFFF).astype(np.uint32)))
    new_j, cl_j = jptv3._lex_permute_level(ps_j, jnp.asarray(cluster.numpy()))
    np.testing.assert_array_equal(cl_t.numpy(), cl_j)
    for name in ("coord", "grid_coord", "feat", "batch", "valid", "orders",
                 "inverses"):
        np.testing.assert_array_equal(getattr(new_t, name).numpy(),
                                      getattr(new_j, name), err_msg=name)
    np.testing.assert_array_equal(new_t.code.numpy(),
                                  code64(new_j.code_hi, new_j.code_lo))
    valid = new_t.valid.numpy()
    n = int(valid.sum())
    assert valid[:n].all() and not valid[n:].any()
    keys = np.concatenate([new_t.batch.numpy()[:n, None],
                           new_t.grid_coord.numpy()[:n]], axis=1)
    assert [tuple(k) for k in keys] == sorted(tuple(k) for k in keys)
    assert not np.array_equal(new_t.orders.numpy(), coarse.orders.numpy())


#: (offset, logit) tolerance as a share of each output's scale, and the
#: argmax agreement, per configuration. The gather engine in f32 differs
#: from JAX in sum order only (readings 5e-7 and 8e-7; 1e-4, as
#: test_torch_ptv3.py holds the plain forward). JAX's f32 band kernel
#: selects features as a bf16 hi/lo pair (~16 mantissa bits) where the
#: port reads f32 (reading 3e-6; 1e-4, as the port's convs are held). In
#: bf16 both round the same values at the same places, but an f32 sum in
#: another order flips some bf16 roundings, and every flip moves the rest
#: of the network: the JAX readings are 3.3e-3 (offsets) and 3.8e-3
#: (logits), the same as the port against itself with every weight moved
#: by 1e-6 of its value (3.6e-3); 2e-2 keeps five times that, and argmax
#: agrees on >= 99 % of the points.
TOLERANCE = {"tokens": (1e-4, 1.0), "level0_dedup": (1e-4, 1.0),
             "band_f32": (1e-4, 1.0), "bench_bf16": (2e-2, 0.99)}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(name, variables, jax_predictors, monkeypatch):
    """The forward of two batch elements with duplicates in each
    configuration: offsets and logits within the stated share of scale,
    equal overflow counts (0), and, on the band engine, every conv through
    the band kernel's wrapper (the stem at K = 125 once, an xCPE at K = 27
    per block)."""
    c, f, b, v = two_trees(0)
    out_j = jax_predictors(name).predict_flat(*map(jnp.asarray, (c, f, b, v)))
    seen = counting_band_kernel(monkeypatch)
    tband.GATHER_ROUTES.clear()
    with torch.inference_mode():
        out_t = port_model(variables, **CONFIGS[name])(t(c), t(f), t(b), t(v))
    rtol, agreement = TOLERANCE[name]
    for key in ("offset_predictions", "semantic_prediction_logits"):
        got, want = out_t[key].float().numpy()[v], np.asarray(out_j[key])[v]
        scale = np.abs(want).max()
        assert scale > 0.05, key
        assert np.abs(got - want).max() <= rtol * scale, key
    lt = out_t["semantic_prediction_logits"].numpy()[v].argmax(1)
    lj = np.asarray(out_j["semantic_prediction_logits"])[v].argmax(1)
    assert (lt == lj).mean() >= agreement
    for key in ("dedup_overflow", "pool_overflow"):
        assert int(out_t[key]) == int(out_j[key]) == 0, key
    if CONFIGS[name].get("stem_engine") == "band":
        blocks = sum(TINY["enc_depths"]) + sum(TINY["dec_depths"])
        assert sorted(seen) == [27] * blocks + [125]
        assert not tband.GATHER_ROUTES
    else:
        assert seen == []


def overflowing_cloud(seed=5, n_voxels=320):
    """One tree of ``n_voxels`` voxels, 1-3 points each: more voxels than
    the token cap of P // 4 = 256 rows."""
    rng = np.random.default_rng(seed)
    vox = np.unique(np.floor(surface_cloud(seed, 6 * n_voxels) / VOXEL)
                    .astype(np.int64), axis=0)
    assert len(vox) >= n_voxels
    vox = vox[rng.permutation(len(vox))[:n_voxels]]
    cells = np.repeat(vox, rng.integers(1, 4, size=n_voxels), axis=0)
    pts = ((cells + rng.uniform(0.05, 0.95, cells.shape)) * VOXEL).astype(
        np.float32)
    return batch_of([pts], seed)


def test_safe_cap_retry_matches_jax(variables, jax_predictors, caplog):
    """``predict_single`` with token dedup (gather engine, f32) on a cloud
    whose voxels overflow the token cap: both packages count the overflow,
    retry at ``dedup_divisor=1`` (``SAFE_CAP_OVERRIDES``) and return the
    same cloud (f32 tolerance of test_forward_matches_jax)."""
    c, f, b, v = overflowing_cloud()
    jpred = jax_predictors("tokens")
    first = jpred.predict_flat(*map(jnp.asarray, (c, f, b, v)))
    pred = Predictor("pointtransformerv3",
                     port_model(variables, **CONFIGS["tokens"]), "cpu")
    with torch.inference_mode():
        mine = pred.model(t(c), t(f), t(b), t(v))
    assert int(mine["dedup_overflow"]) == int(first["dedup_overflow"]) > 0
    cloud = as_cloud(c, f, v)
    out_j = jpredict_single(cloud, jpred, None)
    with caplog.at_level("WARNING"):
        out_t = predict_single(cloud, pred, None, device="cpu")
    assert "{'dedup_divisor': 1}" in caplog.text
    assert out_t.shape == out_j.shape == (len(cloud), 3)
    offsets = out_j - cloud[:, :3]
    rtol, _ = TOLERANCE["tokens"]
    assert np.abs(out_t - out_j).max() <= rtol * np.abs(offsets).max()
    assert np.abs(offsets).max() > 0.05


def test_predict_single_matches_jax(variables, jax_predictors):
    """Stage 1 in the bench configuration: offsets applied, then the noise
    head's class-1 points dropped (its final bias set at JAX's median
    margin on this cloud, so both classes occur). The kept points agree on
    >= 99 % of the cloud, and the points both keep within the bf16
    tolerance of test_forward_matches_jax."""
    c, f, b, v = two_trees(1)
    cloud = as_cloud(c, f, v)
    padded = [x.numpy() for x in
              _pad_flat(cloud[:, :3], cloud[:, 7:11], device="cpu")[:4]]
    live = padded[3]
    jpred = jax_predictors("bench_bf16")

    def logits(model):
        if isinstance(model, JPredictor):
            out = model.predict_flat(*map(jnp.asarray, padded))
        else:
            with torch.inference_mode():
                out = model.model(*map(t, padded))
        return np.asarray(out["semantic_prediction_logits"])[live]

    first = logits(jpred)
    margin = float(np.median(first[:, 1] - first[:, 0]))
    noise_vars = jax.tree_util.tree_map(np.array, variables)
    noise_vars["params"]["semantic_head"]["Dense_1"]["bias"] = np.array(
        [0.0, -margin], np.float32)
    jnoise = JPredictor("pointtransformerv3", jpred.model, noise_vars)
    # the jitted forward takes the variables as an argument: share it
    jnoise.__dict__["_jit_cache"] = jpred.__dict__["_jit_cache"]
    pred = Predictor("pointtransformerv3", port_model(variables, **BENCH),
                     "cpu")
    noise = Predictor("pointtransformerv3", port_model(noise_vars, **BENCH),
                      "cpu")
    out_j = jpredict_single(cloud, jpred, jnoise)
    out_t = predict_single(cloud, pred, noise, device="cpu")
    keep_j = logits(jnoise).argmax(1) == 0
    keep_t = logits(noise).argmax(1) == 0
    assert len(out_j) == keep_j.sum() and len(out_t) == keep_t.sum()
    assert 0.2 * len(cloud) < len(out_j) < 0.8 * len(cloud)
    assert (keep_j == keep_t).mean() >= 0.99
    both = keep_j & keep_t
    rows_j = np.cumsum(keep_j)[both] - 1
    rows_t = np.cumsum(keep_t)[both] - 1
    offsets = np.abs(out_j - cloud[keep_j, :3]).max()
    rtol, _ = TOLERANCE["bench_bf16"]
    assert offsets > 0.05
    assert np.abs(out_t[rows_t] - out_j[rows_j]).max() <= rtol * offsets


def test_weight_bridge_covers_the_bench_configuration(variables):
    """The bench configuration has the plain model's parameters: the flax
    layout equals the default configuration's, and the bridge fills every
    parameter and statistic of the port's model in this configuration."""
    plain = jbuild("pointtransformerv3", **TINY)
    plain_layout = jax.eval_shape(
        lambda key: plain.init(
            key, jnp.zeros((P, 3)), jnp.zeros((P, 4)),
            jnp.zeros(P, jnp.int32), jnp.ones(P, bool), train=False,
        ),
        jax.random.key(0),
    )
    assert (jax.tree_util.tree_structure(plain_layout)
            == jax.tree_util.tree_structure(layout()))
    sd = flax_to_state_dict(variables)
    model = tptv3.PointTransformerWithHeads(dim_feat=4, **TINY, **BENCH)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        model.backbone.embedding.kernel.detach().numpy(),
        variables["params"]["backbone"]["embedding"]["kernel"])
    assert model.backbone.embedding.kernel.shape == (125, 4, 16)


def test_bench_configuration_serves_at_full_width():
    """``build_model`` in the bench configuration at the pipeline's full
    width runs ``predict_single`` on the CPU; its options survive
    ``clone``; with ``stem_engine="zpack"`` in place of the band stem it
    builds too, and gives the band configuration's predictions within
    2e-2 of their scale (bf16: the engines round the same products,
    summed in another order)."""
    model = build_model("pointtransformerv3", device="cpu", seed=0, **BENCH)
    for key, value in BENCH.items():
        assert model.config[key] == value
    relaxed = model.clone(dedup_divisor=1)
    assert relaxed.config["dedup_tokens"] and relaxed.config[
        "stem_engine"] == "band"
    c, f, b, v = two_trees(2)
    cloud = as_cloud(c, f, v)
    pred = Predictor("pointtransformerv3", model, "cpu")
    out = predict_single(cloud, pred, None, device="cpu")
    assert out.shape == (len(cloud), 3) and np.isfinite(out).all()
    zpack = model.clone(stem_engine="zpack")
    assert zpack.config["stem_engine"] == "zpack"
    out_z = predict_single(cloud, Predictor("pointtransformerv3", zpack,
                                            "cpu"), None, device="cpu")
    np.testing.assert_allclose(out_z, out, rtol=0,
                               atol=2e-2 * np.abs(out).max())
