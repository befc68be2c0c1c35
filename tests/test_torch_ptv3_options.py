"""PTv3's reference-partitioning options in the port against the JAX
package: the per-element window layout (``pad_per_element``), the RPE
score bias (``enable_rpe``) and the conditional norms (``pdnorm``), each
module alone and the tiny model with all three (one train step and a
forward).

Inputs come from numpy seeds; weights in flax's layout (traced with
``jax.eval_shape``) are drawn from numpy and carried by
``flax_to_state_dict``. f32 throughout: values agree to 1e-5 of their
scale (sum order only). The JAX side runs on the CPU, where attention takes
its plain version; so does the port's here (the hand kernels run on the
card, ``chip_smoke.py`` phase 16a).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from treemorph_tpu.models import ptv3 as jptv3
from treemorph_tpu.train import families as jfamilies
from treemorph_tpu_torch.models import flax_to_state_dict
from treemorph_tpu_torch.models import ptv3 as tptv3
from treemorph_tpu_torch.train import families, harness

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, t,
)
from test_torch_ptv3 import TINY, VOXEL, flax_values
from test_torch_ptv3_train import ZERO_GRAD, jax_perms, tree_batch

RTOL = 1e-5  # of a tensor's scale: f32, sum order only
CONDITIONS = ("TreeSet", "Other")


def within_scale(got, want, rtol=RTOL, name=""):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * np.abs(want).max(), err_msg=name)


# --- the per-element layout -----------------------------------------------


LAYOUT_CASES = {
    "aligned": [16, 8, 24],
    "unaligned": [13, 21, 19],
    "short": [3, 8, 6],  # n_b <= K: tails stay dead
    "empty": [10, 0, 17],
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_element_pad_layout_matches_jax(case):
    """``pad_src``, ``slot_seg`` and ``unpad`` equal JAX's exactly, rows in
    serialized order (each element's valid rows contiguous, padding last,
    K = 8, three elements)."""
    k, p = 8, 72
    counts = LAYOUT_CASES[case]
    batch = np.full(p, 0x7FFF, np.int32)
    batch[: sum(counts)] = np.repeat(np.arange(3), counts)
    valid = np.arange(p) < sum(counts)
    want = jax.jit(functools.partial(
        jptv3.element_pad_layout, num_elements=3, patch=k))(
            jnp.asarray(batch), jnp.asarray(valid))
    got = tptv3.element_pad_layout(t(batch).long(), t(valid), 3, k)
    for name, g, w in zip(("pad_src", "slot_seg", "unpad"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    seg = got[1].numpy()
    assert seg.dtype == np.int32 and len(seg) == p + 3 * k
    if case == "unaligned":  # tails past n_b copy the previous window
        src, _, unpad = (x.numpy() for x in got)
        tail = np.flatnonzero(seg == 0)[13:16]
        np.testing.assert_array_equal(src[tail], [5, 6, 7])
        np.testing.assert_array_equal(unpad[:13], np.arange(13))
    if case == "short":
        assert (seg[:8] == 0).sum() == 3 and (seg == -1).sum() > 3 * k


# --- attention: per-element windows and RPE ------------------------------


def attention_inputs(seed=0, n=(300, 180), p=512, c=16):
    """A PointSet of two elements (unaligned to K = 64, one longer than
    two windows) in both packages, and random features."""
    rng = np.random.default_rng(seed)
    coords = np.zeros((p, 3), np.float32)
    m = sum(n)
    coords[:m] = rng.uniform(0, 0.6, (m, 3))
    batch = np.zeros(p, np.int32)
    batch[n[0]:m] = 1
    valid = np.arange(p) < m
    feat = rng.normal(size=(p, c)).astype(np.float32)
    ps_j = jptv3.make_pointset(*(jnp.asarray(x) for x in (
        coords, feat, batch, valid)), VOXEL)
    ps_t = tptv3.make_pointset(t(coords), t(feat), t(batch), t(valid), VOXEL)
    return ps_j, ps_t, rng


@pytest.mark.parametrize("rpe", [False, True])
def test_serialized_attention_per_element_matches_jax(rpe):
    """``SerializedAttention(pad_per_element=True, num_elements=2)``, with
    and without RPE: the output, the input gradient (the copied tail slots'
    gradients add into their source rows, as JAX's gather transpose does)
    and every parameter gradient, ``rpe_table``'s included, to 1e-5 of
    their scale, for a random output cotangent."""
    ps_j, ps_t, rng = attention_inputs()
    kw = dict(pad_per_element=True, num_elements=2, enable_rpe=rpe)
    jattn = jptv3.SerializedAttention(16, 2, 64, 1, **kw)
    params = jax.tree.map(
        lambda s: rng.normal(0, 0.3, s.shape).astype(np.float32),
        jax.eval_shape(jattn.init, jax.random.key(0), ps_j, False))["params"]
    g = rng.normal(size=(ps_t.feat.shape[0], 16)).astype(np.float32)

    @jax.jit
    def jgrads(params, feat):
        def f(params, feat):
            out = jattn.apply({"params": params}, ps_j._replace(feat=feat),
                              False)
            return jnp.sum(out * g), out

        return jax.grad(f, argnums=(0, 1), has_aux=True)(params, feat)

    (dp_j, dx_j), out_j = jgrads(params, ps_j.feat)
    attn = tptv3.SerializedAttention(16, 2, 64, 1, **kw)
    attn.load_state_dict(flax_to_state_dict({"params": params}), strict=True)
    x = ps_t.feat.clone().requires_grad_()
    out = attn(ps_t._replace(feat=x))
    (out * t(g)).sum().backward()
    within_scale(out.detach().numpy(), out_j)
    within_scale(x.grad.numpy(), dx_j, name="d_feat")
    dp_j = flax_to_state_dict({"params": dp_j})
    for name, p in attn.named_parameters():
        within_scale(p.grad.numpy(), dp_j[name].numpy(), name=name)
    if rpe:
        assert attn.rpe_table.shape == (3 * (2 * 12 + 1), 2)


def test_rpe_bound_is_the_reference_expression():
    """``int((4 * k) ** (1 / 3) * 2)``: 31 at K = 1024 (float rounding,
    not 32), so the table has 3 * 63 rows there; both packages' tables
    share the shape."""
    assert tptv3.rpe_bound(1024) == 31 and tptv3.rpe_bound(64) == 12
    attn = tptv3.SerializedAttention(32, 2, 1024, 0, enable_rpe=True)
    assert attn.rpe_table.shape == (189, 2)
    ps_j, _, _ = attention_inputs(p=1024, c=32)
    shapes = jax.eval_shape(
        jptv3.SerializedAttention(32, 2, 1024, 0, enable_rpe=True).init,
        jax.random.key(0), ps_j, False)
    assert shapes["params"]["rpe_table"].shape == (189, 2)


# --- PDNorm ---------------------------------------------------------------


@pytest.mark.parametrize("kind", ["bn", "ln"])
def test_pdnorm_matches_jax(kind):
    """``PDNorm`` with three decoupled conditions, condition 1, train mode:
    the output and the gradients to 1e-5 of their scale; every ``norm{i}``
    in the state dict, only ``norm1`` used (its running statistics updated
    as JAX's, the others' untouched, their gradients zero); and adaptive,
    the ``modulation`` Linear on ``silu(context)`` for a (C,) and a (P, C)
    context."""
    rng = np.random.default_rng(3)
    p, c, cc = 200, 8, 6
    x = rng.normal(1.0, 2.0, (p, c)).astype(np.float32)
    valid = np.arange(p) < 170
    g = rng.normal(size=(p, c)).astype(np.float32)
    conds = ("a", "b", "c")
    for context in (None, rng.normal(size=cc).astype(np.float32),
                    rng.normal(size=(p, cc)).astype(np.float32)):
        adaptive = context is not None
        jnorm = jptv3.PDNorm(c, kind, conds, True, adaptive, cc)
        args = (jnp.asarray(x), jnp.asarray(valid), True, 1,
                None if context is None else jnp.asarray(context))
        shapes = jax.eval_shape(lambda key: jnorm.init(key, *args),
                                jax.random.key(0))
        variables = jax.tree.map(
            lambda s: rng.normal(0.5, 0.3, s.shape).astype(np.float32),
            shapes)
        if kind == "bn":
            variables["batch_stats"] = jax.tree.map(
                np.abs, variables["batch_stats"])

        def f(params):
            out, mut = jnorm.apply(
                {**variables, "params": params}, *args,
                mutable=["batch_stats"])
            return jnp.sum(out * g), (out, mut)

        dp_j, (out_j, mut_j) = jax.jit(jax.grad(f, has_aux=True))(
            variables["params"])
        norm = tptv3.PDNorm(c, kind, conds, True, adaptive, cc).train()
        norm.load_state_dict(flax_to_state_dict(variables), strict=True)
        before = {k: v.clone() for k, v in norm.state_dict().items()}
        xt = t(x).requires_grad_()
        out = norm(xt, t(valid), 1, None if context is None else t(context))
        (out * t(g)).sum().backward()
        within_scale(out.detach().numpy(), out_j)
        dp_j = flax_to_state_dict({"params": dp_j})
        for name, prm in norm.named_parameters():
            grad = prm.grad.numpy() if prm.grad is not None else 0 * dp_j[
                name].numpy()
            within_scale(grad, dp_j[name].numpy(), name=name)
            if not name.startswith(("norm1.", "modulation.")):
                assert prm.grad is None and not dp_j[name].numpy().any()
        if kind == "bn":
            after = norm.state_dict()
            stats_j = flax_to_state_dict(
                {"params": variables["params"], **mut_j})
            for name in after:
                if "running" not in name:
                    continue
                if name.startswith("norm1."):
                    within_scale(after[name].numpy(),
                                 stats_j[name].numpy(), name=name)
                    assert not torch.equal(after[name], before[name])
                else:
                    assert torch.equal(after[name], before[name]), name
    with pytest.raises(ValueError, match="condition 3"):
        tptv3.PDNorm(c, kind, conds)(t(x), t(valid), 3)


# --- the model with every option ------------------------------------------


OPTIONS = dict(
    pad_per_element=True, num_elements=2, enable_rpe=True,
    pdnorm=tptv3.PDNormSpec(bn=True, ln=True, conditions=CONDITIONS,
                            adaptive=True, context_channels=8),
    drop_path=0.0,
)


def jax_options():
    return dict(OPTIONS, pdnorm=jptv3.PDNormSpec(*OPTIONS["pdnorm"]))


@functools.lru_cache(maxsize=None)
def options_layout():
    n = 1024
    model = jptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, **jax_options(),
        **TINY)
    return jax.eval_shape(
        lambda key: model.init(
            key, jnp.zeros((n, 3)), jnp.zeros((n, 4)),
            jnp.zeros(n, jnp.int32), jnp.ones(n, bool), train=False,
            condition=1, context=jnp.zeros(8)),
        jax.random.key(0))


def test_model_with_options_matches_jax(monkeypatch):
    """The tiny PTv3 with ``pad_per_element``, RPE and adaptive PDNorm on
    BatchNorms and LayerNorms (conditions TreeSet / Other, condition 1, a
    context vector), f32, ``drop_path`` 0, on two trees: one train step
    with the JAX step's order shuffles (the loss terms, every gradient and
    the updated running statistics to 1e-5 of their scale; the other
    condition's norms get no gradient) and then an eval forward (offsets
    and logits to 1e-5 of their scale)."""
    batch = tree_batch()
    variables = flax_values(8, options_layout())
    context = np.random.default_rng(9).normal(size=8).astype(np.float32)
    key = jax.random.key(7)
    perms = jax_perms(key, len(TINY["enc_depths"]))
    jmodel = jptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, **jax_options(),
        **TINY)
    flat_j = jax.tree.map(jnp.asarray, jfamilies._flatten_padded(batch))
    args_j = (flat_j["coords"], flat_j["feats"], flat_j["batch_ids"],
              flat_j["mask_valid"])

    @jax.jit
    def jstep(params, batch_stats, flat_j, context):
        args_j = (flat_j["coords"], flat_j["feats"], flat_j["batch_ids"],
                  flat_j["mask_valid"])

        def loss(params):
            shuffle, drop = jax.random.split(key)
            out, mut = jmodel.apply(
                {"params": params, "batch_stats": batch_stats}, *args_j,
                train=True, shuffle_rng=shuffle, condition=1,
                context=context, mutable=["batch_stats"],
                rngs={"droppath": drop})
            value, terms = jptv3.ptv3_loss(out, flat_j)
            return value * 50.0, (mut["batch_stats"], terms)

        return jax.grad(loss, has_aux=True)(params)

    grads_j, (stats_j, terms_j) = jstep(
        variables["params"], variables["batch_stats"], flat_j,
        jnp.asarray(context))
    model = tptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, **OPTIONS, **TINY)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    flat = families._flatten_padded(harness.to_device(batch, "cpu"))
    args = (flat["coords"], flat["feats"], flat["batch_ids"],
            flat["mask_valid"])
    out = model.train()(*args, order_perms=[t(p) for p in perms],
                        generator=torch.Generator().manual_seed(0),
                        condition=1, context=t(context))
    loss, terms = tptv3.ptv3_loss(out, flat)
    (loss * 50.0).backward()
    for k in ("semantic_loss", "offset_loss"):
        np.testing.assert_allclose(float(terms[k].detach()),
                                   float(terms_j[k]), rtol=1e-5)
    grads_j = flax_to_state_dict({"params": grads_j})
    top = max(np.abs(g.numpy()).max() for g in grads_j.values())
    unused = 0
    for name, p in model.named_parameters():
        want = grads_j[name].numpy()
        if p.grad is None:  # the other condition's norms
            assert ".norm0." in name and not want.any(), name
            unused += 1
        elif name in ZERO_GRAD:
            assert np.abs(p.grad.numpy()).max() <= 1e-6 * top, name
        else:
            within_scale(p.grad.numpy(), want, name=name)
    assert unused > 0
    stats_j = flax_to_state_dict({"params": variables["params"],
                                  "batch_stats": stats_j})
    for name, buf in model.state_dict().items():
        if "running" in name:
            within_scale(buf.numpy(), stats_j[name].numpy(), name=name)

    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.inference_mode():
        out = model.eval()(*args, condition=1, context=t(context))
    out_j = jax.jit(lambda v, args, ctx: jmodel.apply(
        v, *args, train=False, condition=1, context=ctx))(
            variables, args_j, jnp.asarray(context))
    for k in ("offset_predictions", "semantic_prediction_logits"):
        within_scale(out[k].numpy(), out_j[k], name=k)


def test_options_build_serve_and_clone():
    """``build_model`` takes the options and seeds ``rpe_table`` as flax
    draws it (a normal of std 0.02 truncated at 2 std); ``clone`` keeps
    them; ``pad_per_element`` needs ``num_elements`` and excludes
    ``dedup_tokens``, as in the JAX package."""
    from treemorph_tpu_torch.evaluation.model_loaders import build_model

    model = build_model("pointtransformerv3", device="cpu", seed=0,
                        **OPTIONS, **TINY)
    table = model.backbone.enc0_block0.attn.rpe_table.detach()
    assert 0.015 < float(table.std()) < 0.02
    assert float(table.abs().max()) <= 0.04
    assert "backbone.enc0_block0.norm1.norm1.weight" in model.state_dict()
    assert "backbone.embedding.MaskedBatchNorm_0.modulation.weight" in (
        model.state_dict())
    again = model.clone(pool_shrink=1)
    assert again.config["pdnorm"] == OPTIONS["pdnorm"]
    with pytest.raises(ValueError, match="num_elements"):
        tptv3.PointTransformerWithHeads(pad_per_element=True, **TINY)
    with pytest.raises(ValueError, match="dedup_tokens"):
        tptv3.PointTransformerWithHeads(
            pad_per_element=True, num_elements=2, dedup_divisor=4,
            dedup_tokens=True, **TINY)
