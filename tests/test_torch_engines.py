"""The port's non-default conv engines against the JAX package's: the z-pack
conv and the pencil conv with their custom VJPs, the TreeLearn ``zpack``,
``pencil`` and ``brick`` engines (forward and one train step), PTv3's z-pack
stem, the dense-tile conv and the octant-run rulebook.

Inputs come from numpy seeds. TreeLearn is the narrow model of
``test_torch_treelearn.py`` (channels 8, two levels) with variables drawn
in flax's layout of each engine (the brick blocks name their parameters
``bn0``, ``conv0``, ...) and carried by ``flax_to_state_dict``; JAX runs
with exact lookups (``verify_coords=True``) where it has the switch. f32
throughout; the engines differ from each other and from JAX by sum order
only, so values agree to 1e-5 of their scale.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.evaluation.model_loaders import build_model as jbuild
from treemorph_tpu.models import ptv3 as jptv3
from treemorph_tpu.ops import pencil as jpencil
from treemorph_tpu.ops import sparse as jsp
from treemorph_tpu.ops import tiles as jtiles
from treemorph_tpu_torch.models import TreeLearn, flax_to_state_dict
from treemorph_tpu_torch.models import ptv3 as tptv3
from treemorph_tpu_torch.ops import pencil as tpencil
from treemorph_tpu_torch.ops import sparse as tsp
from treemorph_tpu_torch.ops import tiles as ttiles
from treemorph_tpu_torch.train import families, harness

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, padded_inputs, surface_cloud, t,
)
from test_torch_ptv3 import TINY, VOXEL, flax_values
from test_torch_ptv3_train import ZERO_GRAD as PTV3_ZERO_GRAD, tree_batch
from test_torch_train import (
    assert_grads_match, jax_train_step, padded_batch, zero_grad,
)
from test_torch_treelearn import SMALL, balance_noise_head, perturb

RTOL = 1e-5  # of a tensor's scale: f32, sum order only


def within_scale(got, want, rtol=RTOL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


def lex_voxels(seed, n=1000, batch=2):
    """Lex-sorted unique (b, x, y, z) voxels of ``batch`` tree surfaces at
    2 cm, padded with 64 invalid rows, as every voxel level holds them."""
    rows = []
    for b in range(batch):
        vox = np.unique(np.floor(surface_cloud(seed + b, n) / 0.02)
                        .astype(np.int64), axis=0)
        vox -= vox.min(axis=0)
        rows.append(np.concatenate(
            [np.full((len(vox), 1), b), vox], axis=1))
    coords = np.concatenate(rows)
    coords = coords[np.lexsort(coords.T[::-1])].astype(np.int32)
    m = len(coords)
    coords = np.concatenate([coords, np.zeros((64, 4), np.int32)])
    return coords, np.arange(m + 64) < m


def conv_inputs(seed, cin=6, cout=5):
    rng = np.random.default_rng(seed)
    coords, valid = lex_voxels(seed)
    feats = rng.normal(size=(len(coords), cin)).astype(np.float32)
    w = (rng.normal(size=(27, cin, cout)) / np.sqrt(27 * cin)).astype(
        np.float32)
    g = rng.normal(size=(len(coords), cout)).astype(np.float32)
    return coords, valid, feats, w, g


# --- the z-pack conv ------------------------------------------------------


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_zplan_matches_jax(kernel_size):
    coords, valid = lex_voxels(1)
    pj = jax.jit(functools.partial(
        jsp.build_zplan, kernel_size=kernel_size, verify_coords=True))(
            jnp.asarray(coords), jnp.asarray(valid))
    pt = tsp.build_zplan(t(coords), t(valid), kernel_size)
    np.testing.assert_array_equal(pt.ext.numpy(), pj.ext)
    np.testing.assert_array_equal(pt.zshift.numpy(), pj.zshift)
    m = len(coords)
    assert (pt.zshift.numpy()[valid] != 0).mean() > 0.2
    assert (pt.ext.numpy()[valid] < (kernel_size) * m).mean() > 0.3


def test_zpack_conv_and_vjp_match_jax():
    """Output, d_feats and d_w of the z-pack conv against JAX's custom VJP;
    and against the port's gather engine on the same voxels."""
    coords, valid, feats, w, g = conv_inputs(2)
    cj, vj = jnp.asarray(coords), jnp.asarray(valid)
    plan_j = jax.jit(functools.partial(jsp.build_zplan, kernel_size=3,
                                       verify_coords=True))(cj, vj)

    def jconv(f, w):
        return jsp.subm_conv_zpack_apply(f, w, plan_j, vj)

    out_j, (df_j, dw_j) = jax.jit(
        lambda f, w, g: (lambda o, vjp: (o, vjp(g)))(*jax.vjp(jconv, f, w))
    )(jnp.asarray(feats), jnp.asarray(w), jnp.asarray(g))
    plan = tsp.build_zplan(t(coords), t(valid), 3)
    f_t, w_t = t(feats).requires_grad_(), t(w).requires_grad_()
    out = tsp.subm_conv_apply(f_t, w_t, plan, t(valid))
    out.backward(t(g))
    within_scale(out.detach().numpy(), out_j)
    within_scale(f_t.grad.numpy(), df_j, name="d_feats")
    within_scale(w_t.grad.numpy(), dw_j, name="d_w")
    rb = tsp.build_rulebook(t(coords), t(valid), 3)
    within_scale(out.detach().numpy(),
                 tsp.subm_conv_apply(t(feats), t(w), rb, t(valid)).numpy())


# --- the pencil conv ------------------------------------------------------


def test_pencils_and_pencil_conv_vjp_match_jax():
    """The pencil structure exactly; the conv's output, d_core and d_w
    against JAX's custom VJP; the flat output against the gather engine."""
    coords, valid, feats, w, g = conv_inputs(3)
    cj, vj = jnp.asarray(coords), jnp.asarray(valid)
    cap = 3 * len(coords)
    ps_j = jpencil.build_pencils(cj, vj, cap, verify_coords=True)
    ps = tpencil.build_pencils(t(coords), t(valid), cap)
    for name in ("keys", "row_valid", "slot", "cell_active", "has_prev",
                 "has_next", "rulebook", "num_pencils", "overflow"):
        np.testing.assert_array_equal(getattr(ps, name).numpy(),
                                      np.asarray(getattr(ps_j, name)),
                                      err_msg=name)
    assert int(ps.overflow) == 0 and ps.has_prev.any()
    small = tpencil.build_pencils(t(coords), t(valid), 256)
    assert int(small.overflow) == int(jpencil.build_pencils(
        cj, vj, 256, verify_coords=True).overflow) > 0

    core_np = np.asarray(jpencil.to_pencil(jnp.asarray(feats) * vj[:, None],
                                           ps_j))
    g_core = np.random.default_rng(5).normal(
        size=(core_np.shape[0], 4 * w.shape[-1])).astype(np.float32)

    def jconv(core, w):
        return jpencil.pencil_conv_apply(core, w, ps_j)

    out_j, (dc_j, dw_j) = jax.jit(
        lambda c, w, g: (lambda o, vjp: (o, vjp(g)))(*jax.vjp(jconv, c, w))
    )(jnp.asarray(core_np), jnp.asarray(w), jnp.asarray(g_core))
    core = tpencil.to_pencil(t(feats) * t(valid)[:, None], ps)
    np.testing.assert_array_equal(core.numpy(), core_np)
    c_t, w_t = core.clone().requires_grad_(), t(w).requires_grad_()
    out = tpencil.pencil_conv_apply(c_t, w_t, ps)
    out.backward(t(g_core))
    within_scale(out.detach().numpy(), out_j)
    within_scale(c_t.grad.numpy(), dc_j, name="d_core")
    within_scale(w_t.grad.numpy(), dw_j, name="d_w")
    flat = tpencil.from_pencil(out.detach(), ps) * t(valid)[:, None]
    rb = tsp.build_rulebook(t(coords), t(valid), 3)
    within_scale(flat.numpy(),
                 tsp.subm_conv_apply(t(feats), t(w), rb, t(valid)).numpy())


# --- TreeLearn's engines --------------------------------------------------


@functools.lru_cache(maxsize=None)
def engine_layout(engine):
    """Shapes of the narrow TreeLearn's flax variables on ``engine`` (the
    brick blocks' names are their own)."""
    model = jbuild("treelearn", engine=engine, verify_coords=True,
                   channels=SMALL["channels"], num_blocks=2)
    n = 256
    return jax.eval_shape(
        lambda key: model.init(
            key, jnp.zeros((n, 3)), jnp.zeros((n, 4)),
            jnp.zeros(n, jnp.int32), jnp.ones(n, bool), train=False),
        jax.random.key(0))


def engine_variables(engine, seed=0):
    """Variables of :func:`engine_layout` drawn from numpy as flax's
    initializers draw them, BN parameters and statistics perturbed."""
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        shape, name = spec.shape, path[-1]
        if name == "kernel" and path[-2].startswith("Dense_"):
            if path[-2] == "Dense_0":
                lim = np.sqrt(6.0 / (shape[0] + shape[1]))
                return rng.uniform(-lim, lim, shape).astype(np.float32)
            return rng.normal(0, 0.01, shape).astype(np.float32)
        if name in ("kernel", "shortcut", "down_kernel", "up_kernel",
                    "conv0", "conv1"):
            return (rng.normal(size=shape) / np.sqrt(np.prod(shape[:-1]))
                    ).astype(np.float32)
        fill = 1.0 if name in ("scale", "var") else 0.0
        return np.full(shape, fill, np.float32)

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if hasattr(v, "items")
                else leaf(path + (k,), v) for k, v in tree.items()}

    return perturb(walk(engine_layout(engine)), seed)


ENGINE_CASES = [("zpack", "conv"), ("pencil", "conv"), ("brick", "conv"),
                ("brick", "xslab")]


@pytest.mark.parametrize("engine,impl", ENGINE_CASES)
def test_treelearn_engine_forward_matches_jax(engine, impl):
    """Forward of the engine against JAX's same engine with carried
    weights: offsets and logits to 1e-5 of their scale, the noise head's
    argmax, and the engine's cap counts (none dropped here; a pencil cap
    of 1/8 drops some, counted)."""
    variables = engine_variables(engine)
    c, f, b, v = padded_inputs(7, 2900, 172)
    kw = dict(SMALL, engine=engine, brick_impl=impl, num_blocks=2)
    model = TreeLearn(**kw)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.eval()
    with torch.inference_mode():
        logits = model(t(c), t(f), t(b), t(v))[
            "semantic_prediction_logits"].numpy()[v]
    balance_noise_head(variables, logits)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    jmodel = jbuild("treelearn", engine=engine, brick_impl=impl,
                    verify_coords=True, channels=SMALL["channels"],
                    num_blocks=2)
    args = [jnp.asarray(x) for x in (c, f, b, v)]
    out_j = jax.jit(lambda var, *a: jmodel.apply(var, *a, train=False))(
        variables, *args)
    with torch.inference_mode():
        out_t = model(t(c), t(f), t(b), t(v))
    for key in ("offset_predictions", "semantic_prediction_logits"):
        within_scale(out_t[key].numpy(), out_j[key], name=key)
    agree = (out_t["semantic_prediction_logits"].numpy()[v].argmax(1)
             == np.asarray(out_j["semantic_prediction_logits"])[v].argmax(1))
    assert agree.mean() >= 0.999
    assert int(out_t["dropped_voxels"]) == int(out_j["dropped_voxels"]) == 0
    if engine == "pencil":  # a tight cap drops voxels, and says so
        with torch.inference_mode():
            tight = model.clone(pencil_divisor=8)(t(c), t(f), t(b), t(v))
        assert int(tight["dropped_voxels"]) > 0


@pytest.mark.parametrize("engine", ["zpack", "pencil", "brick"])
def test_treelearn_engine_train_step_matches_jax(engine):
    """One train step (2 x 512 points, the family's x50-scaled loss, BN in
    train mode) on the engine against ``jax.grad`` of JAX's step on the
    same engine: the loss terms to 1e-5, every gradient to 1e-5 of its
    leaf's scale (the entries zero but for rounding below 1e-6 of the
    largest), the BN running statistics to 1e-5 of their scale."""
    variables = engine_variables(engine, seed=1)
    jmodel = jbuild("treelearn", engine=engine, verify_coords=True,
                    channels=SMALL["channels"], num_blocks=2, batch_size=2)
    batch = padded_batch([3, 4], 512)
    grads_j, metrics_j, after_j = jax_train_step(jmodel, variables, batch,
                                                 1e-2)
    grads_j = flax_to_state_dict({"params": grads_j})
    model = TreeLearn(**dict(SMALL, engine=engine, batch_size=2))
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    model.train()
    forward_fn, loss_fn = families.treelearn_family()
    tbatch = harness.to_device(batch, "cpu")
    loss, terms = loss_fn(forward_fn(model, tbatch, True), tbatch)
    (loss * harness.LOSS_BACKWARD_SCALE).backward()
    for key in ("semantic_loss", "offset_loss"):
        np.testing.assert_allclose(float(terms[key].detach()),
                                   float(metrics_j[key]),
                                   rtol=1e-5)
    assert_grads_match({n: p.grad.numpy() for n, p in
                        model.named_parameters()}, grads_j, zero_grad())
    stats_j = flax_to_state_dict(after_j)
    for name, buf in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            within_scale(buf.numpy(), stats_j[name].numpy(), name=name)


# --- PTv3's z-pack stem ---------------------------------------------------


ZPACK = dict(dedup_divisor=4, stem_engine="zpack", drop_path=0.0)


def ptv3_step(model, batch, perms, monkeypatch):
    """Loss terms and gradients of one train step of the port's PTv3
    family, the order shuffles ``perms``."""
    monkeypatch.setattr(tptv3, "draw_order_perms",
                        lambda gen, n: [t(p) for p in perms])
    forward_fn, loss_fn = families.ptv3_family()
    tbatch = harness.to_device(batch, "cpu")
    loss, terms = loss_fn(forward_fn(model, tbatch, True,
                                     torch.Generator().manual_seed(0)),
                          tbatch)
    (loss * harness.LOSS_BACKWARD_SCALE).backward()
    return ({k: float(v) for k, v in terms.items()},
            {n: p.grad.numpy() for n, p in model.named_parameters()})


def assert_ptv3_grads(grads, want):
    top = max(np.abs(g).max() for g in want.values())
    for name, g in want.items():
        if name in PTV3_ZERO_GRAD:
            assert np.abs(grads[name]).max() <= 1e-6 * top, name
            continue
        within_scale(grads[name], g, name=name)


def port_ptv3(variables, **options):
    model = tptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, **options, **TINY)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def test_ptv3_zpack_stem_train_step_matches_jax(monkeypatch):
    """PTv3 with ``stem_engine="zpack"`` and ``dedup_divisor=4`` (the k=5
    stem and level 0's xCPEs once per unique voxel on z-pack plans, the
    pooled level re-stored in lex order and on its plan), tiny widths, f32,
    ``drop_path`` 0: one train step with the JAX step's order shuffles, the
    loss terms and every gradient against JAX's zpack model to 1e-5 of
    their scale; and an eval forward against the port's gather stem."""
    from test_torch_ptv3_train import jax_perms, jax_train_step as jstep

    batch = tree_batch()
    jmodel = jptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, **ZPACK, **TINY)
    variables = flax_values(4)
    key = jax.random.key(5)
    perms = jax_perms(key, len(TINY["enc_depths"]))
    grads_j, metrics_j, _ = jstep(jmodel, variables, batch, key)
    terms, grads = ptv3_step(port_ptv3(variables, **ZPACK), batch, perms,
                             monkeypatch)
    for k in ("semantic_loss", "offset_loss"):
        np.testing.assert_allclose(terms[k], float(metrics_j[k]), rtol=1e-5)
    assert_ptv3_grads(grads, {k: v.numpy() for k, v in flax_to_state_dict(
        {"params": grads_j}).items()})

    flat = harness.to_device(batch, "cpu")
    args = (flat.coords.reshape(-1, 3), flat.feats.reshape(-1, 4),
            torch.arange(2).repeat_interleave(flat.coords.shape[1]),
            flat.mask_valid.reshape(-1))
    with torch.inference_mode():
        out = port_ptv3(variables, **ZPACK).eval()(*args)
        gather = port_ptv3(variables, dedup_divisor=4,
                           drop_path=0.0).eval()(*args)
    for k in ("offset_predictions", "semantic_prediction_logits"):
        within_scale(out[k].numpy(), gather[k].numpy(), name=k)
    assert int(out["dedup_overflow"]) == 0


def test_ptv3_zpack_stem_tokens_matches_gather(monkeypatch):
    """The same in token mode (``dedup_tokens``: the whole backbone on one
    token per voxel, level 0 on z-pack plans too): the zpack step's loss
    terms and gradients against the port's gather step (each held to the
    JAX package's in ``test_torch_ptv3_bench.py`` and above) to 1e-5 of
    their scale."""
    batch = tree_batch()
    variables = flax_values(6)
    perms = [np.array([2, 0, 3, 1]), np.array([1, 3, 0, 2])]
    options = dict(ZPACK, dedup_tokens=True)
    terms, grads = ptv3_step(port_ptv3(variables, **options), batch, perms,
                             monkeypatch)
    terms_g, grads_g = ptv3_step(
        port_ptv3(variables, **dict(options, stem_engine="gather")), batch,
        perms, monkeypatch)
    for k in ("semantic_loss", "offset_loss"):
        np.testing.assert_allclose(terms[k], terms_g[k], rtol=1e-5)
    assert_ptv3_grads(grads, grads_g)


# --- the dense tiles and the octant-run rulebook --------------------------


@pytest.mark.parametrize("impl", ["conv", "slice"])
def test_tile_conv_matches_jax_and_gather(impl):
    """The tile structure exactly (neighbors, active cells); the tile conv
    against JAX's and, read back to voxels, against the gather engine."""
    coords, valid, feats, w, _ = conv_inputs(4)
    cj, vj = jnp.asarray(coords), jnp.asarray(valid)
    cap = 256
    ts_j = jtiles.build_tiles(cj, vj, cap, tile=8)
    ts = ttiles.build_tiles(t(coords), t(valid), cap, tile=8)
    for name in ("tile_of_voxel", "cell_of_voxel", "tile_coords",
                 "tile_valid", "nbr", "active", "num_tiles", "overflow"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(ts_j, name)),
                                      err_msg=name)
    dense_j = jtiles.to_dense(jnp.asarray(feats) * vj[:, None], ts_j, 8)
    out_j = jtiles.tile_subm_conv(dense_j, jnp.asarray(w), ts_j, impl=impl)
    dense = ttiles.to_dense(t(feats) * t(valid)[:, None], ts, 8)
    np.testing.assert_array_equal(dense.numpy(), dense_j)
    out = ttiles.tile_subm_conv(dense, t(w), ts, impl=impl)
    within_scale(out.numpy(), out_j)
    rb = tsp.build_rulebook(t(coords), t(valid), 3)
    within_scale(ttiles.from_dense(out, ts, t(valid)).numpy(),
                 tsp.subm_conv_apply(t(feats), t(w), rb, t(valid)).numpy())


@pytest.mark.parametrize("kernel_size", [3, 5])
def test_run_table_rulebook_equals_rulebook(kernel_size):
    """``build_rulebook_runs`` gives ``build_rulebook``'s rulebook on
    lex-sorted unique voxels (that one is held to JAX's in
    ``test_torch_ops.py`` and ``test_torch_ptv3.py``); the octant-run
    table's rows equal JAX's."""
    coords, valid = lex_voxels(6)
    rb = tsp.build_rulebook(t(coords), t(valid), kernel_size)
    runs = tsp.build_rulebook_runs(t(coords), t(valid), kernel_size)
    np.testing.assert_array_equal(runs.numpy(), rb.numpy())
    assert (rb.numpy()[valid] < len(coords)).mean() > 0.1
    if kernel_size == 3:
        table = tsp.build_run_table(t(coords), t(valid))
        table_j = jax.jit(jsp.build_run_table)(jnp.asarray(coords),
                                               jnp.asarray(valid))
        np.testing.assert_array_equal(table.rows.numpy(), table_j.rows)
        assert table.mask == table_j.mask


def test_pipeline_config_engine_reaches_load_model(monkeypatch):
    """``stage1.engine`` of a pipeline config builds the loaded models on
    that engine: TreeLearn's ``engine``, PTv3's ``stem_engine`` (``pencil``
    meaning gather, as in the training CLI)."""
    from treemorph_tpu_torch.pipeline import run

    seen = []
    monkeypatch.setattr(run, "load_model",
                        lambda *a, **kw: seen.append(kw) or {})
    for family, engine, key, want in (
            ("treelearn", "pencil", "engine", "pencil"),
            ("treelearn", "brick", "engine", "brick"),
            ("pointtransformerv3", "pencil", "stem_engine", "gather"),
            ("pointtransformerv3", "zpack", "stem_engine", "zpack")):
        cfg = {"stage1": {"predict_offset": True, "denoise": False,
                          "model_type": family, "engine": engine},
               "model_dirs": {family: ["offset", "noise"]}}
        run.load_pipeline_models(cfg, family, device="cpu")
        assert seen[-1][key] == want
    cfg["stage1"].pop("engine")
    run.load_pipeline_models(cfg, "pointtransformerv3", device="cpu")
    assert "stem_engine" not in seen[-1]
