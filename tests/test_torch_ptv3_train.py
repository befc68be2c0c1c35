"""The port's PTv3 training against the JAX package's: one full train step
(loss terms, every gradient, the BN running statistics, every updated
parameter) with the JAX step's own order shuffles, stochastic depth, and
the training CLI's pointtransformerv3 family on the CPU.

The tiny model of ``test_torch_ptv3.py`` (two stages, channels 16 and 32,
patch 64) gets the same numpy-drawn variables in both packages. The batch
holds two trees of ~480 points in voxels of 2-6 points each (PTv3's level
0 is points, so the gather engine's custom VJP sees duplicate voxels),
padded to 512, with no JAX hash bucket above 16 rows. The JAX side runs on
the CPU, where its attention takes the plain reference.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from treemorph_tpu.models import ptv3 as jptv3
from treemorph_tpu.train import families as jfamilies
from treemorph_tpu.train import harness as jharness
from treemorph_tpu_torch.data import treeset as ttreeset
from treemorph_tpu_torch.evaluation.model_loaders import load_model
from treemorph_tpu_torch.models import flax_to_state_dict
from treemorph_tpu_torch.models import ptv3 as tptv3
from treemorph_tpu_torch.train import cli, families, harness

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, t,
)
from test_torch_ptv3 import (
    TINY, VOXEL, bucket_of, duplicated_cloud, flax_values,
)
from test_torch_train import write_plots

N = 512  # padded points per tree
LR, EPS = 1e-2, 1e-8
#: parameters whose gradient is zero but for rounding in both packages
#: (below 1e-7 of the largest in the JAX step), because a BatchNorm that
#: follows removes any constant shift: each head's hidden Dense bias, the
#: biases of the Dense layers that feed the pooling's and the unpooling's
#: BatchNorms (a max over a cluster moves with a constant shift too), and
#: the MLP output bias of each stage's last block, which shifts every row
#: of a level that only Dense + BatchNorm pairs read next
ZERO_GRAD = (
    "semantic_head.Dense_0.bias", "offset_head.Dense_0.bias",
    "backbone.enc1_down.proj.bias", "backbone.dec0_up.proj.bias",
    "backbone.dec0_up.proj_skip.bias",
    "backbone.enc0_block1.mlp.Dense_1.bias",
    "backbone.enc1_block1.mlp.Dense_1.bias",
    "backbone.dec0_block1.mlp.Dense_1.bias",
)


def tree_batch():
    """A PaddedBatch of two labeled trees: duplicate voxels, N(0, 0.02)
    offsets, random features, padding rows."""
    rng = np.random.default_rng(11)
    clouds = [duplicated_cloud(s, 100) for s in (21, 22)]
    b = len(clouds)
    coords = np.zeros((b, N, 3), np.float32)
    feats = np.zeros((b, N, 4), np.float32)
    offsets = np.zeros((b, N, 3), np.float32)
    valid = np.zeros((b, N), bool)
    for i, c in enumerate(clouds):
        n = min(len(c), N)
        coords[i, :n] = c[:n]
        feats[i, :n] = rng.normal(size=(n, 4))
        offsets[i, :n] = rng.normal(0, 0.02, (n, 3))
        valid[i, :n] = True
    norm = np.linalg.norm(offsets, axis=-1)
    return ttreeset.PaddedBatch(
        coords=coords, feats=feats, offset_labels=offsets,
        semantic_labels=(norm > 0.05).astype(np.int32), mask_valid=valid,
        mask_off=norm <= 0.05,
    )


def jax_perms(key, num_stages):
    """The order permutations the JAX family's train step draws from its
    step key (``ptv3_family`` splits it; the backbone splits the shuffle
    key once per stage)."""
    shuffle, _ = jax.random.split(key)
    return [np.asarray(jax.random.permutation(k, 4))
            for k in jax.random.split(shuffle, num_stages)]


def jax_train_step(jmodel, variables, batch, key):
    """The JAX harness's step in one jit that also returns the gradients:
    ``jax.grad`` of the family's x50-scaled loss, the new BN statistics, the
    loss terms, and the parameters after the optax chain at LR."""
    forward_fn, loss_fn = jfamilies.ptv3_family(jmodel)
    tx = jharness.make_optimizer()

    @jax.jit
    def step(params, batch_stats, batch):
        def scaled_loss(params):
            out, new_bs = forward_fn(params, batch_stats, batch, True, key)
            loss, loss_dict = loss_fn(out, batch)
            return (loss * jharness.LOSS_BACKWARD_SCALE,
                    (new_bs, {"loss": loss, **loss_dict}))

        grads, (new_bs, metrics) = jax.grad(scaled_loss, has_aux=True)(
            params)
        updates, _ = tx.update(grads, tx.init(params), params)
        new_params = optax.apply_updates(
            params, jax.tree.map(lambda u: u * LR, updates))
        return grads, metrics, {"params": new_params, "batch_stats": new_bs}

    return jax.device_get(step(*(jax.tree.map(jnp.asarray, x) for x in (
        variables["params"], variables["batch_stats"], batch))))


def port_model(drop_path=0.0):
    return tptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, drop_path=drop_path,
        **TINY)


def test_train_step_matches_jax(monkeypatch):
    """One ``make_train_step`` of the port's PTv3 family against the JAX
    package's step at ``drop_path`` 0, the port handed the order
    permutations the JAX step key draws: the loss terms to 1e-5; every
    gradient, taken before the clip, to 1e-5 of its own leaf's scale (the
    gather engine's VJP over duplicate voxels included, held to JAX's);
    the BN running statistics to 1e-5 of their scale; every updated
    parameter against the optax chain, as far as the gradients determine
    it (an Adam entry whose gradient is near eps moves by up to
    lr * eps * dg / (|g| + eps)^2 more for a gradient error dg: at most
    1 % of the entries). The ZERO_GRAD leaves are held below 1e-6 of the
    largest gradient."""
    batch = tree_batch()
    grid = np.floor((batch.coords[batch.mask_valid]
                     - batch.coords[batch.mask_valid].min(0)) / VOXEL)
    grid4 = np.concatenate([np.repeat([[0], [1]], batch.mask_valid.sum(1),
                                      axis=0), grid], axis=1)
    assert np.bincount(bucket_of(grid4, 2 * N)).max() <= 16
    assert len(np.unique(grid4, axis=0)) < 0.5 * len(grid4)
    variables = flax_values(2)
    key = jax.random.key(3)
    perms = jax_perms(key, len(TINY["enc_depths"]))
    assert any((p != np.arange(4)).any() for p in perms)
    jmodel = jptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, drop_path=0.0, **TINY)
    grads_j, metrics_j, after_j = jax_train_step(jmodel, variables, batch,
                                                 key)
    grads_j = flax_to_state_dict({"params": grads_j})
    after_j = flax_to_state_dict(after_j)

    model = port_model()
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    monkeypatch.setattr(tptv3, "draw_order_perms",
                        lambda gen, n: [t(p) for p in perms])
    grads = {}
    clip_and_step = harness.optimizer_step

    def recording_step(optimizer, lr):
        grads.update({n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})
        clip_and_step(optimizer, lr)

    monkeypatch.setattr(harness, "optimizer_step", recording_step)
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(*families.ptv3_family())
    _, metrics_t = step(state, harness.to_device(batch, "cpu"), LR,
                        torch.Generator().manual_seed(0))

    for name in ("loss", "semantic_loss", "offset_loss"):
        np.testing.assert_allclose(float(metrics_t[name]),
                                   float(metrics_j[name]), rtol=1e-5)
    assert set(grads) == set(grads_j)
    top = max(np.abs(g).max() for g in grads_j.values())
    for name, want in grads_j.items():
        want = want.numpy()
        if name in ZERO_GRAD:
            assert np.abs(want).max() <= 1e-6 * top, name
            assert np.abs(grads[name]).max() <= 1e-6 * top, name
            continue
        np.testing.assert_allclose(grads[name], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)

    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in grads.values()))
    clip = min(1.0, harness.GRAD_CLIP_NORM / norm)
    after_t = model.state_dict()
    slack_entries = total = n_stats = 0
    for name, want in after_j.items():
        got, want = after_t[name].numpy(), want.numpy()
        atol = 1e-5 * np.abs(want).max()
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
        elif name in ZERO_GRAD:  # Adam moves them by at most lr
            atol = atol + 2 * LR
        else:
            g = np.abs(grads[name]) * clip
            slack = np.minimum(LR * EPS * 1e-5 * g.max() / (g + EPS) ** 2,
                               2 * LR)
            slack_entries += int((slack > atol).sum())
            total += g.size
            atol = atol + slack
        assert (np.abs(got - want) <= atol).all(), name
    assert n_stats > 0 and 0 < total and slack_entries <= 1e-2 * total
    moved = after_t["backbone.embedding.kernel"] - torch.from_numpy(
        variables["params"]["backbone"]["embedding"]["kernel"])
    assert float(moved.abs().max()) > 0.5 * LR  # the step really moved


def test_drop_path():
    """Identity in eval mode and at rate 0; in train mode each row is 0 or
    x / keep, about a ``rate`` share of them 0, and one generator seed
    gives one mask."""
    x = torch.randn(4000, 8)
    drop = tptv3.DropPath(0.3)
    assert drop.eval()(x) is x
    assert tptv3.DropPath(0.0).train()(x) is x
    drop.train()
    with pytest.raises(ValueError, match="generator"):
        drop(x)
    out = drop(x, torch.Generator().manual_seed(5))
    kept = (out != 0).all(dim=1)
    assert torch.equal(out[~kept], torch.zeros_like(out[~kept]))
    torch.testing.assert_close(out[kept], x[kept] / 0.7, rtol=0, atol=0)
    assert abs(float(kept.float().mean()) - 0.7) < 0.03
    again = drop(x, torch.Generator().manual_seed(5))
    assert torch.equal(out, again)
    assert not torch.equal(out, drop(x, torch.Generator().manual_seed(6)))


def test_train_step_draws_from_the_step_generator():
    """With stochastic depth on, one step generator seed gives one loss and
    another seed another; eval mode draws nothing."""
    batch = harness.to_device(tree_batch(), "cpu")
    forward_fn, loss_fn = families.ptv3_family()
    model = families.init_ptv3(port_model(drop_path=0.5), 4)
    losses = [
        float(loss_fn(forward_fn(model, batch, True,
                                 torch.Generator().manual_seed(s)),
                      batch)[0].detach())
        for s in (1, 1, 2)
    ]
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="generator"):
        forward_fn(model, batch, True)
    with torch.no_grad():
        a, b = (loss_fn(forward_fn(model, batch, False), batch)[0]
                for _ in range(2))
    assert float(a) == float(b)


def test_cli_trains_ptv3_on_cpu(tmp_path, monkeypatch):
    """One epoch of the pointtransformerv3 family (one 2-tree step, one
    validation batch) writes a checkpoint whose metadata ``load_model``
    rebuilds the model from, and that serves one ``predict_single``. The
    CLI builds the pipeline's full-width model; here both it and
    ``load_model`` build the tiny one (the full width's plain attention
    takes ~30 s a step on one CPU thread; ``chip_smoke.py`` runs it)."""
    import functools

    from treemorph_tpu_torch.evaluation import model_loaders
    from treemorph_tpu_torch.pipeline.predict import predict_single

    monkeypatch.setattr(tptv3, "PointTransformerWithHeads", functools.partial(
        tptv3.PointTransformerWithHeads, **TINY))
    monkeypatch.setitem(model_loaders.FAMILY_DEFAULTS, "pointtransformerv3",
                        dict(model_loaders.FAMILY_DEFAULTS[
                            "pointtransformerv3"], **TINY))
    write_plots(tmp_path, trees=1, n=300)
    histories = cli.main([
        "pointtransformerv3", "--data_root", str(tmp_path), "--test_plots",
        "1", "--epochs", "1", "--batch_size", "2", "--bucket", "512",
        "--save_dir", str(tmp_path / "saves"), "--device", "cpu",
    ])
    (record,) = histories[1]
    assert np.isfinite([record["train_loss"], record["val_loss"]]).all()
    ckpt = tmp_path / "saves" / "pointtransformerv3_CV"
    meta = json.loads((ckpt / "P1.metadata.json").read_text())
    assert meta["use_feats"] and meta["dim_feat"] == 4
    predictors = load_model("pointtransformerv3", str(ckpt), device="cpu")
    assert list(predictors) == ["O_P1"]
    saved = torch.load(ckpt / "P1" / "model.pt")
    for name, value in predictors["O_P1"].model.state_dict().items():
        assert torch.equal(value, saved[name]), name
    cloud = np.load(tmp_path / "1_0_labeled.npy")
    out = predict_single(cloud, predictors["O_P1"], None, device="cpu")
    assert out.shape == (len(cloud), 3) and np.isfinite(out).all()
    assert not np.array_equal(out, cloud[:, :3])


#: the training CLI's band configuration (``--engine band
#: --dedup_divisor 4``, scripts/train.py:130-143): level-0 convs once per
#: unique voxel, the k=5 stem and the xCPEs over lex-sorted rows on the
#: band engine
BAND_DEDUP = dict(dedup_divisor=4, stem_engine="band")


def test_band_dedup_train_step_matches_jax(monkeypatch):
    """One ``make_train_step`` in the CLI's band configuration (the port's
    kernels take their plain versions on the CPU) against the JAX
    package's step with the same level-0 dedup on its gather engine, the
    same function, with the JAX step key's order permutations: the loss
    terms to 1e-5, every gradient to 1e-5 of its leaf's scale, every
    parameter of the state after the step (BN running statistics
    included) as :func:`test_train_step_matches_jax` holds them. JAX's
    own band step, its kernels in Pallas interpret mode, is not the
    reference here: it rounds otherwise than its gather step (their
    gradients differ by up to 3.5e-5 of a leaf's scale, the port's band
    step and JAX's gather step by 5.4e-6), and compiling it takes ~90 s."""
    batch = tree_batch()
    variables = flax_values(2)
    key = jax.random.key(5)
    perms = jax_perms(key, len(TINY["enc_depths"]))
    jmodel = jptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, drop_path=0.0,
        dedup_divisor=BAND_DEDUP["dedup_divisor"], **TINY)
    grads_j, metrics_j, after_j = jax_train_step(jmodel, variables, batch,
                                                 key)
    grads_j = flax_to_state_dict({"params": grads_j})
    after_j = flax_to_state_dict(after_j)

    model = tptv3.PointTransformerWithHeads(
        dim_feat=4, use_feats=True, voxel_size=VOXEL, drop_path=0.0,
        **BAND_DEDUP, **TINY)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    monkeypatch.setattr(tptv3, "draw_order_perms",
                        lambda gen, n: [t(p) for p in perms])
    grads = {}
    clip_and_step = harness.optimizer_step

    def recording_step(optimizer, lr):
        grads.update({n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})
        clip_and_step(optimizer, lr)

    monkeypatch.setattr(harness, "optimizer_step", recording_step)
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(*families.ptv3_family())
    _, metrics_t = step(state, harness.to_device(batch, "cpu"), LR,
                        torch.Generator().manual_seed(0))
    for name in ("loss", "semantic_loss", "offset_loss"):
        np.testing.assert_allclose(float(metrics_t[name]),
                                   float(metrics_j[name]), rtol=1e-5)
    top = max(np.abs(g.numpy()).max() for g in grads_j.values())
    for name, want in grads_j.items():
        want = want.numpy()
        if name in ZERO_GRAD:
            assert np.abs(want).max() <= 1e-6 * top, name
            assert np.abs(grads[name]).max() <= 1e-6 * top, name
            continue
        np.testing.assert_allclose(grads[name], want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in grads.values()))
    clip = min(1.0, harness.GRAD_CLIP_NORM / norm)
    after_t = model.state_dict()
    slack_entries = total = 0
    for name, want in after_j.items():
        got, want = after_t[name].numpy(), want.numpy()
        atol = 1e-5 * np.abs(want).max()
        if name in ZERO_GRAD:
            atol += 2 * LR
        elif not name.endswith(("running_mean", "running_var")):
            g = np.abs(grads[name]) * clip
            slack = np.minimum(
                LR * EPS * 1e-5 * g.max() / (g + EPS) ** 2, 2 * LR)
            slack_entries += int((slack > atol).sum())
            total += g.size
            atol = atol + slack
        assert (np.abs(got - want) <= atol).all(), name
    assert 0 < total and slack_entries <= 1e-2 * total


def test_cli_trains_ptv3_band_dedup_on_cpu(tmp_path, monkeypatch):
    """The CLI's ``--engine band --dedup_divisor 4`` (tiny widths, as
    :func:`test_cli_trains_ptv3_on_cpu`) builds the model in that
    configuration and trains one epoch; ``pencil`` means gather, ``zpack``
    is the z-pack stem, and ``brick`` trains on the gather path, as the
    JAX package's PTv3 takes every other engine name."""
    built = []
    model_cls = tptv3.PointTransformerWithHeads

    def tiny(**kwargs):
        built.append(kwargs)
        return model_cls(**kwargs, **TINY)

    monkeypatch.setattr(tptv3, "PointTransformerWithHeads", tiny)
    write_plots(tmp_path, trees=1, n=300)
    base = ["pointtransformerv3", "--data_root", str(tmp_path),
            "--test_plots", "1", "--epochs", "1", "--batch_size", "2",
            "--bucket", "512", "--save_dir", str(tmp_path / "saves"),
            "--device", "cpu"]
    histories = cli.main(base + ["--engine", "band", "--dedup_divisor",
                                 "4"])
    (record,) = histories[1]
    assert np.isfinite([record["train_loss"], record["val_loss"]]).all()
    assert built[-1]["stem_engine"] == "band"
    assert built[-1]["dedup_divisor"] == 4
    assert (tmp_path / "saves" / "pointtransformerv3_CV" / "P1"
            / "model.pt").exists()
    cli.build(cli.parse_args(base + ["--engine", "pencil"]), 2, VOXEL,
              None)
    assert built[-1]["stem_engine"] == "gather"
    for engine in ("zpack", "brick"):
        cli.build(cli.parse_args(base + ["--engine", engine]), 2, VOXEL,
                  None)
        assert built[-1]["stem_engine"] == engine
    histories = cli.main(base + ["--engine", "zpack", "--dedup_divisor",
                                 "4"])
    assert np.isfinite(histories[1][0]["train_loss"])
