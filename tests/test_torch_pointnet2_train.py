"""The port's PointNet2 training against the JAX package's: one full train
step and one gradient-accumulation group (loss terms, gradients, BN running
statistics, updated parameters), the clip on the accumulated gradient,
``run_training``'s group mode, and the training CLI's raster modes on the
CPU.

The model is depth 2 at tiny widths (both packages' ``SA_CONFIGS`` /
``FP_CONFIGS`` entry patched alike) with variables drawn from numpy in
flax's layout, every BatchNorm off the identity. Batches are 0.5 m rasters
of a synthetic tree's scan. The JAX steps run under ``jax.jit``, where
sampling indices are bit for bit the port's (``test_torch_sampling.py``);
the port is handed the FPS start draws of the JAX step keys through
``models.pointnet2.draw_fps_scores``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from treemorph_tpu.models import pointnet2 as jpn2
from treemorph_tpu.train import families as jfamilies
from treemorph_tpu.train import harness as jharness
from treemorph_tpu_torch.data import treeset as ttreeset
from treemorph_tpu_torch.evaluation.model_loaders import load_model
from treemorph_tpu_torch.models import flax_to_state_dict
from treemorph_tpu_torch.models import pointnet2 as tpn2
from treemorph_tpu_torch.pipeline.predict import raster_assignments
from treemorph_tpu_torch.preprocess import rasterize_clouds
from treemorph_tpu_torch.train import cli, families, harness

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, t,
)
from test_torch_sampling import tree_points
from test_torch_train import write_plots

DEPTH = 2
TINY_SA = [(32, 0.1, 8, (8, 8, 16)), (8, 0.3, 8, (16, 16, 32))]
TINY_FP = [(32, 16), (16, 16, 16)]
LR, EPS = 1e-2, 1e-8
#: gradients against JAX's, of each leaf's scale: f32 sum order through
#: BatchNorms in train mode, whose batch statistics and their backward
#: amplify it. The port against itself with the batch's two rasters
#: swapped (the same function, other sum orders) moves a leaf by up to
#: 7.3e-6 of its scale, and the train-mode outputs differ from JAX's by
#: ~7e-6 of theirs; the gradients then by up to 3.2e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True)
def tiny_widths(monkeypatch):
    for mod in (jpn2, tpn2):
        monkeypatch.setitem(mod.SA_CONFIGS, DEPTH, TINY_SA)
        monkeypatch.setitem(mod.FP_CONFIGS, DEPTH, TINY_FP)


def flax_variables(seed=0):
    """The tiny model's variables in flax's layout: Dense kernels N(0,
    1/fan_in), biases N(0, 0.1), BatchNorm scale U(0.7, 1.3), bias N(0,
    0.2), running mean N(0, 0.3), variance U(0.5, 2)."""
    layout = jax.eval_shape(
        lambda key: jpn2.PointNet2(depth=DEPTH, dim_feat=4).init(
            key, jnp.zeros((1, 64, 3)), jnp.zeros((1, 64, 4)),
            jnp.ones((1, 64), bool), train=False),
        jax.random.key(0))
    rng = np.random.default_rng(seed)

    def leaf(path, spec):
        shape, name = spec.shape, path[-1]
        if name == "kernel":
            return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(
                np.float32)
        if name == "scale":
            return rng.uniform(0.7, 1.3, shape).astype(np.float32)
        if name == "bias":
            std = 0.2 if path[-2].startswith("BatchNorm") else 0.1
            return rng.normal(0, std, shape).astype(np.float32)
        if name == "mean":
            return rng.normal(0, 0.3, shape).astype(np.float32)
        return rng.uniform(0.5, 2.0, shape).astype(np.float32)  # var

    def walk(tree, path=()):
        return {k: walk(v, path + (k,)) if hasattr(v, "items")
                else leaf(path + (k,), v) for k, v in tree.items()}

    return walk(layout)


def minibatches(k=3, b=2, n=256):
    """``k`` PaddedBatches of ``b`` 0.5 m rasters each (a different point
    count per raster, padding rows), N(0, 0.03) offsets, random
    features."""
    pts = tree_points(3)
    rasters = [idx for _, idx in raster_assignments(pts, 0.5, 0.5)
               if len(idx) >= n]
    assert len(rasters) >= k * b
    rng = np.random.default_rng(5)
    out = []
    for m in range(k):
        coords = np.zeros((b, n, 3), np.float32)
        feats = np.zeros((b, n, 4), np.float32)
        offsets = np.zeros((b, n, 3), np.float32)
        valid = np.zeros((b, n), bool)
        for i in range(b):
            c = n - 17 * (m * b + i) - 9
            coords[i, :c] = pts[rasters[m * b + i][:c]]
            feats[i, :c] = rng.normal(size=(c, 4))
            offsets[i, :c] = rng.normal(0, 0.03, (c, 3))
            valid[i, :c] = True
        norm = np.linalg.norm(offsets, axis=-1)
        out.append(ttreeset.PaddedBatch(
            coords=coords, feats=feats, offset_labels=offsets,
            semantic_labels=(norm > 0.05).astype(np.int32),
            mask_valid=valid, mask_off=norm <= 0.05))
    return out


def zero_grad(name: str) -> bool:
    """Parameters whose gradient is zero but for rounding in both
    packages: every Dense bias that a BatchNorm follows (all but each
    head's output Dense)."""
    return name.endswith(".bias") and ".Dense_" in name and not (
        "head.Dense_1" in name)


def fps_draws(monkeypatch, current):
    """Hand the port the FPS start draws of the JAX step key
    ``current[0]``: level ``l``'s ``jax.random.uniform`` of the key's
    ``l``-th split (the JAX model splits ``fps_rng`` over its levels)."""
    n_levels = len(TINY_SA)

    def draw(generator, level, shape, device):
        key = jax.random.split(current[0], n_levels)[level]
        return t(np.asarray(jax.random.uniform(key, shape))).to(device)

    monkeypatch.setattr(tpn2, "draw_fps_scores", draw)


def port_model(variables):
    model = tpn2.PointNet2(depth=DEPTH, dim_feat=4)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    return model


def record_grads(monkeypatch, model):
    """Keep a copy of the gradients each ``optimizer_step`` sees (before
    its clip)."""
    seen = []
    clip_and_step = harness.optimizer_step

    def recording_step(optimizer, lr):
        seen.append({n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()})
        clip_and_step(optimizer, lr)

    monkeypatch.setattr(harness, "optimizer_step", recording_step)
    return seen


def jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


def assert_grads_close(got, want):
    """Every gradient within GRAD_RTOL of its own leaf's scale; the
    zero-grad leaves below 1e-6 of the largest gradient in both."""
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for name, w in want.items():
        if zero_grad(name):
            assert np.abs(w).max() <= 1e-6 * top, name
            assert np.abs(got[name]).max() <= 1e-6 * top, name
            continue
        np.testing.assert_allclose(got[name], w, rtol=0,
                                   atol=GRAD_RTOL * np.abs(w).max(),
                                   err_msg=name)


def assert_state_close(after_t, after_j, grads):
    """BN running statistics within 1e-5 of their scale; every parameter
    against the optax chain as far as the gradients determine it (an Adam
    entry whose gradient is near eps moves by up to lr * eps * dg / (|g| +
    eps)^2 more for a gradient error dg: at most 1 % of the entries; the
    zero-grad leaves by at most 2 lr)."""
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in grads.values()))
    clip = min(1.0, harness.GRAD_CLIP_NORM / norm)
    slack_entries = total = n_stats = 0
    for name, want in after_j.items():
        got, want = after_t[name].numpy(), want.numpy()
        atol = 1e-5 * np.abs(want).max()
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
        elif zero_grad(name):
            atol = atol + 2 * LR
        else:
            g = np.abs(grads[name]) * clip
            slack = np.minimum(
                LR * EPS * GRAD_RTOL * g.max() / (g + EPS) ** 2, 2 * LR)
            slack_entries += int((slack > atol).sum())
            total += g.size
            atol = atol + slack
        assert (np.abs(got - want) <= atol).all(), name
    assert n_stats > 0 and 0 < total and slack_entries <= 1e-2 * total


def test_train_step_matches_jax(monkeypatch):
    """One ``make_train_step`` of the port's PointNet2 family against the
    JAX package's jitted step on the same key: loss terms to 1e-5, BN running
    statistics and updated parameters (:func:`assert_state_close`); every
    gradient (before the clip) to GRAD_RTOL of its leaf's scale."""
    (batch,) = minibatches(k=1)
    variables = flax_variables()
    key = jax.random.key(7)
    jmodel = jpn2.PointNet2(depth=DEPTH, dim_feat=4)
    forward_fn, loss_fn = jfamilies.pointnet2_family(jmodel)
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

    grads_j, metrics_j, after_j = jax.device_get(step(
        *(jax.tree.map(jnp.asarray, x) for x in (
            variables["params"], variables["batch_stats"], batch))))
    grads_j = {k: v.numpy() for k, v in
               flax_to_state_dict({"params": grads_j}).items()}

    fps_draws(monkeypatch, [key])
    model = port_model(variables)
    seen = record_grads(monkeypatch, model)
    state = harness.TrainState(model, harness.make_optimizer(model))
    train_step = harness.make_train_step(*families.pointnet2_family())
    _, metrics_t = train_step(state, harness.to_device(batch, "cpu"), LR,
                              torch.Generator().manual_seed(0))
    for name in ("loss", "semantic_loss", "offset_loss"):
        np.testing.assert_allclose(float(metrics_t[name]),
                                   float(metrics_j[name]), rtol=1e-5)
    (grads,) = seen
    assert_grads_close(grads, grads_j)
    assert_state_close(model.state_dict(), flax_to_state_dict(after_j),
                       grads)
    assert state.step == 1


def test_accum_group_matches_jax(monkeypatch):
    """One accumulation group of two minibatches, each on its own step
    key, against JAX's ``make_accum_steps`` and ``apply_step``: each
    minibatch's loss terms to 1e-5; the accumulated gradient the optimizer
    sees to GRAD_RTOL of each leaf's scale; the BN running statistics after
    two minibatch updates and every updated parameter
    (:func:`assert_state_close`); one optimizer step."""
    batches = minibatches(k=2)
    variables = flax_variables(1)
    keys = list(jax.random.split(jax.random.key(11), len(batches)))
    jmodel = jpn2.PointNet2(depth=DEPTH, dim_feat=4)
    tx = jharness.make_optimizer()
    accum_j, apply_j = jharness.make_accum_steps(
        *jfamilies.pointnet2_family(jmodel), tx)
    state_j = jharness.create_train_state(
        jax.tree.map(jnp.asarray, variables), tx)
    acc = jax.tree.map(jnp.zeros_like, state_j.params)
    metrics_j = []
    for batch, key in zip(batches, keys):
        state_j, acc, m = accum_j(state_j, jax_batch(batch), key, acc)
        metrics_j.append(jax.device_get(m))
    state_j = apply_j(state_j, acc, jnp.float32(LR))
    acc_j = {k: np.asarray(v) for k, v in flax_to_state_dict(
        {"params": jax.device_get(acc)}).items()}
    after_j = flax_to_state_dict(jax.device_get(
        {"params": state_j.params, "batch_stats": state_j.batch_stats}))
    assert int(state_j.step) == 1

    current = [None]
    fps_draws(monkeypatch, current)
    model = port_model(variables)
    seen = record_grads(monkeypatch, model)
    state = harness.TrainState(model, harness.make_optimizer(model))
    accum_t, apply_t = harness.make_accum_steps(*families.pointnet2_family())
    model.zero_grad(set_to_none=True)
    for batch, key, want in zip(batches, keys, metrics_j):
        current[0] = key
        state, got = accum_t(state, harness.to_device(batch, "cpu"),
                             torch.Generator().manual_seed(0))
        for name in ("loss", "semantic_loss", "offset_loss"):
            np.testing.assert_allclose(float(got[name]), float(want[name]),
                                       rtol=1e-5)
    assert not seen and state.step == 0
    state = apply_t(state, LR)
    (grads,) = seen
    assert_grads_close(grads, acc_j)
    assert_state_close(model.state_dict(), after_j, grads)
    assert state.step == 1
    assert all(p.grad is None for p in model.parameters())


class Linear(torch.nn.Module):
    """offsets = coords @ w (no BatchNorm: accumulation is exact)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.zeros(3, 3))


def linear_family():
    """The port's counterpart of ``tests/test_grad_accum.py``'s analytic
    family: a masked-mean squared-error loss of ``coords @ w``."""

    def forward_fn(model, batch, train, generator=None):
        return {"offset_predictions": batch.coords @ model.w}

    def loss_fn(output, batch):
        diff = output["offset_predictions"] - batch.offset_labels
        w = batch.mask_valid.float()
        loss = ((diff ** 2).sum(-1) * w).sum() / w.sum().clamp(min=1.0)
        return loss, {"offset_loss": loss, "semantic_loss": loss * 0}

    return forward_fn, loss_fn


def linear_minibatches(k, n=64, seed=0):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=(3, 3)).astype(np.float32)
    out = []
    for _ in range(k):
        pts = rng.normal(size=(1, n, 3)).astype(np.float32)
        out.append(ttreeset.PaddedBatch(
            coords=pts, feats=np.zeros((1, n, 4), np.float32),
            offset_labels=pts @ w_true,
            semantic_labels=np.zeros((1, n), np.int32),
            mask_valid=np.ones((1, n), bool),
            mask_off=np.ones((1, n), bool)))
    return out


def test_clip_sees_accumulated_gradient(monkeypatch):
    """The global-norm clip sees the sum of the minibatches' gradients
    (norm far above 1): the optimizer's gradient is that sum, and the
    parameters after the one step are the JAX chain's on the same sum
    (``tests/test_grad_accum.py::test_clip_applies_to_accumulated_
    gradient``)."""
    batches = linear_minibatches(4)
    model = Linear()
    seen = record_grads(monkeypatch, model)
    state = harness.TrainState(model, harness.make_optimizer(model))
    accum_step, apply_step = harness.make_accum_steps(*linear_family())
    per_mb = []
    for batch in batches:
        tb = harness.to_device(batch, "cpu")
        fwd, loss = linear_family()
        single = Linear()
        (loss(fwd(single, tb, True), tb)[0]
         * harness.LOSS_BACKWARD_SCALE).backward()
        per_mb.append(single.w.grad.numpy())
        state, _ = accum_step(state, tb)
    apply_step(state, 1.0)
    (grads,) = seen
    total = np.sum(per_mb, axis=0)
    np.testing.assert_allclose(grads["w"], total, rtol=1e-6)
    assert np.linalg.norm(total) > 1.0
    assert all(np.linalg.norm(g) > 0 for g in per_mb)

    tx = jharness.make_optimizer()
    params = {"w": jnp.zeros((3, 3), jnp.float32)}
    updates, _ = tx.update({"w": jnp.asarray(total)}, tx.init(params), params)
    want = np.asarray(optax.apply_updates(params, updates)["w"])
    np.testing.assert_allclose(model.w.detach().numpy(), want, rtol=1e-5,
                               atol=1e-7)
    assert np.abs(want).max() > 0.5


def test_run_training_group_mode_counts_steps(monkeypatch):
    """``run_training(accum_steps=...)`` takes groups: one optimizer step
    per group that held a minibatch (an empty group takes none), a fresh
    generator per minibatch, and the loss falls
    (``tests/test_grad_accum.py::test_run_training_group_mode_counts_
    steps``)."""
    batches = linear_minibatches(6, seed=1)
    model = Linear()
    seen = record_grads(monkeypatch, model)
    state = harness.TrainState(model, harness.make_optimizer(model))
    forward_fn, loss_fn = linear_family()
    generators = []

    def counting_forward(model, batch, train, generator=None):
        if train:
            generators.append(generator)
        return forward_fn(model, batch, train, generator)

    accum_steps = harness.make_accum_steps(counting_forward, loss_fn)

    def train_batches(epoch):
        yield iter(batches[:3])
        yield iter(())
        yield iter(batches[3:])

    state, history = harness.run_training(
        state, None, harness.make_eval_step(forward_fn, loss_fn),
        train_batches=train_batches,
        val_batches=lambda epoch: iter(batches[:1]),
        epochs=3, lr_schedule=lambda e: 1e-1, accum_steps=accum_steps)
    assert state.step == len(seen) == 3 * 2
    assert len(generators) == 3 * 6
    assert len({id(g) for g in generators}) == len(generators)
    assert history[-1]["val_loss"] < history[0]["val_loss"]


@pytest.fixture
def raster_data(tmp_path):
    """Three plots of two labeled trees, rasterized: the metadata JSON
    (``--hierarchical_json``) and the raster files (``--raster_dir``)."""
    write_plots(tmp_path, trees=2, n=300)
    paths = sorted(str(p) for p in tmp_path.glob("*_labeled.npy"))
    meta = rasterize_clouds(paths, output_dir=str(tmp_path / "rasters"),
                            json_path=str(tmp_path / "rasters.json"),
                            raster_size=0.3, stride=0.15,
                            store_metadata=True, min_points=20)
    raster_dir = tmp_path / "rasters" / "rasterized_R0.3_S0.15"
    return tmp_path, meta, raster_dir


@pytest.mark.parametrize("mode", ["hierarchical", "per_minibatch", "raster"])
def test_cli_trains_pointnet2_on_cpu(raster_data, monkeypatch, mode):
    """One epoch of the ``pointnet2`` family holding out plot 1 (depth 2,
    tiny widths): hierarchical with accumulation takes one optimizer step
    per tree batch (``--batch_size 2`` trees: two steps for four trees),
    ``--per_minibatch_steps`` one per raster minibatch, ``--raster_dir``
    one per batch of rasters; losses finite; the checkpoint's metadata
    holds the depth, and ``load_model`` rebuilds the model from it."""
    root, meta, raster_dir = raster_data
    steps = []
    clip_and_step = harness.optimizer_step

    def counting_step(optimizer, lr):
        steps.append(lr)
        clip_and_step(optimizer, lr)

    monkeypatch.setattr(harness, "optimizer_step", counting_step)
    argv = ["pointnet2", "--depth", str(DEPTH), "--test_plots", "1",
            "--epochs", "1", "--batch_size", "2", "--bucket", "64",
            "--save_dir", str(root / "saves"), "--device", "cpu"]
    train_keys = [k for k in meta if not k.startswith("1_")]
    if mode == "raster":
        argv += ["--raster_dir", str(raster_dir)]
        n_train = sum(len(meta[k]["rasters"]) for k in train_keys)
        want_steps = -(-n_train // 2)
    else:
        argv += ["--hierarchical_json", str(root / "rasters.json"),
                 "--minibatch_size", "4"]
        per_tree = [-(-len(meta[k]["rasters"]) // 4) for k in train_keys]
        if mode == "per_minibatch":
            argv.append("--per_minibatch_steps")
            want_steps = sum(per_tree)
        else:
            want_steps = -(-len(train_keys) // 2)
    assert len(train_keys) == 4 and want_steps >= 2
    histories = cli.main(argv)
    (record,) = histories[1]
    assert np.isfinite([record["train_loss"], record["val_loss"],
                        record["train_offset_loss"]]).all()
    assert len(steps) == want_steps
    ckpt = root / "saves" / "pointnet2_CV"
    saved = json.loads((ckpt / "P1.metadata.json").read_text())
    assert saved["model"] == "pointnet2" and saved["depth"] == DEPTH
    predictors = load_model("pointnet2", str(ckpt), device="cpu")
    assert list(predictors) == ["O_P1"]
    weights = torch.load(ckpt / "P1" / "model.pt")
    for name, value in predictors["O_P1"].model.state_dict().items():
        assert torch.equal(value, weights[name]), name


def test_cli_fold_without_training_rasters_exits(raster_data):
    """Hierarchical metadata that holds only the held-out plot's trees
    leaves no training rasters: SystemExit, as in the JAX CLI."""
    root, meta, _ = raster_data
    only = root / "plot1.json"
    only.write_text(json.dumps({k: v for k, v in meta.items()
                                if k.startswith("1_")}))
    with pytest.raises(SystemExit, match="no training rasters"):
        cli.main(["pointnet2", "--hierarchical_json", str(only),
                  "--test_plots", "1", "--device", "cpu"])
