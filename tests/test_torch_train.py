"""The port's TreeLearn training against the JAX package's: one full train
step (loss, every gradient, every updated parameter, the BN running
statistics), the optimizer chain, the loss, the schedule, early stopping,
the data layer, the augmentations, checkpoints through ``load_model``, and
the CLI on the CPU.

Inputs come from numpy seeds and weights from the flax layout through
``flax_to_state_dict``. The JAX model runs the gather engine with exact
lookups (``verify_coords=True``); the port runs the band engine, whose
kernels take their plain versions on the CPU.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from treemorph_tpu.data import augmentations as jaug
from treemorph_tpu.data import treeset as jtreeset
from treemorph_tpu.models.loss import point_wise_loss as jloss
from treemorph_tpu.train import families as jfamilies
from treemorph_tpu.train import harness as jharness
from treemorph_tpu.train.schedule import (
    cosine_annealing_warm_restarts as jschedule,
)
from treemorph_tpu.utils.early_stopping import EarlyStopper as JStopper
from treemorph_tpu_torch.data import augmentations as taug
from treemorph_tpu_torch.data import treeset as ttreeset
from treemorph_tpu_torch.evaluation.model_loaders import load_model
from treemorph_tpu_torch.models import TreeLearn, flax_to_state_dict
from treemorph_tpu_torch.models.loss import point_wise_loss as tloss
from treemorph_tpu_torch.train import cli, families, harness
from treemorph_tpu_torch.train.checkpoints import (
    restore_checkpoint,
    save_checkpoint,
)
from treemorph_tpu_torch.train.schedule import (
    cosine_annealing_warm_restarts as tschedule,
)
from treemorph_tpu_torch.utils.early_stopping import EarlyStopper

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, surface_cloud,
)
from test_torch_treelearn import SMALL, jax_model_and_variables

def zero_grad(kernel_size=3):
    """Parameter entries whose gradient is zero but for rounding, in both
    packages, because a BatchNorm that follows removes any constant shift:
    each head's hidden Dense bias, and the stem's center-offset filter rows
    (offset K // 2) on the three constant voxel-feature channels (every
    voxel is its own center neighbor). Adam's first update of them,
    g / (|g| + 1e-8), is rounding noise."""
    return {
        "semantic_head.Dense_0.bias": np.s_[:],
        "offset_head.Dense_0.bias": np.s_[:],
        "backbone.input_conv.kernel": np.s_[kernel_size ** 3 // 2,
                                            SMALL["dim_feat"]:, :],
    }


ZERO_GRAD = zero_grad()


def labeled_cloud(seed, n):
    """(n, 11) labeled tree cloud: surface points, N(0, 0.02) offsets,
    random features."""
    rng = np.random.default_rng(seed + 50)
    cloud = np.zeros((n, 11), np.float32)
    cloud[:, :3] = surface_cloud(seed, n)
    cloud[:, 3:6] = rng.normal(0, 0.02, (n, 3))
    cloud[:, 7:11] = rng.normal(size=(n, 4))
    return cloud


def padded_batch(seeds, n):
    clouds = [labeled_cloud(s, n) for s in seeds]
    norm = [np.linalg.norm(c[:, 3:6], axis=1) for c in clouds]
    return ttreeset.PaddedBatch(
        coords=np.stack([c[:, :3] for c in clouds]),
        feats=np.stack([c[:, 7:] for c in clouds]),
        offset_labels=np.stack([c[:, 3:6] for c in clouds]),
        semantic_labels=np.stack([(x > 0.05).astype(np.int32)
                                  for x in norm]),
        mask_valid=np.ones((len(seeds), n), bool),
        mask_off=np.stack([x <= 0.05 for x in norm]),
    )


def write_plots(root, plots=(1, 2, 3), trees=2, n=300, noise_root=None):
    """``plot_{n}.json`` manifests of labeled clouds of varying length,
    and optionally a noise cloud per tree under ``noise_root``."""
    for plot in plots:
        paths = []
        for tree in range(trees):
            path = root / f"{plot}_{tree}_labeled.npy"
            np.save(path, labeled_cloud(10 * plot + tree, n + 37 * tree))
            paths.append(str(path))
            if noise_root is not None:
                np.save(noise_root / f"{plot}_{tree}.npy",
                        labeled_cloud(99 + 10 * plot + tree, n // 2))
        (root / f"plot_{plot}.json").write_text(json.dumps(paths))


def assert_batches_equal(a, b):
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def jax_train_step(jmodel, variables, batch, lr):
    """The JAX harness's step (``make_train_step``'s body, gather engine)
    in one jit that also returns the gradients: ``jax.grad`` of the family's
    x50-scaled loss, the new BN statistics, the loss terms, and the
    parameters after the optax chain at ``lr``."""
    forward_fn, loss_fn = jfamilies.treelearn_family(jmodel)
    tx = jharness.make_optimizer()

    @jax.jit
    def step(params, batch_stats, batch):
        def scaled_loss(params):
            out, new_bs = forward_fn(params, batch_stats, batch, True,
                                     jax.random.key(0))
            loss, loss_dict = loss_fn(out, batch)
            return (loss * jharness.LOSS_BACKWARD_SCALE,
                    (new_bs, {"loss": loss, **loss_dict}))

        grads, (new_bs, metrics) = jax.grad(scaled_loss, has_aux=True)(
            params)
        updates, _ = tx.update(grads, tx.init(params), params)
        new_params = optax.apply_updates(
            params, jax.tree.map(lambda u: u * lr, updates))
        return grads, metrics, {"params": new_params, "batch_stats": new_bs}

    out = step(*(jax.tree.map(jnp.asarray, x) for x in (
        variables["params"], variables["batch_stats"], batch)))
    return jax.device_get(out)


def assert_grads_match(grads, want_grads, zero_entries=ZERO_GRAD):
    """Every gradient leaf to 1e-5 of its own scale; the ``zero_entries``
    below 1e-6 of the largest gradient."""
    assert set(grads) == set(want_grads)
    top = max(np.abs(g).max() for g in want_grads.values())
    for name, want in want_grads.items():
        got, want = grads[name], want.numpy()
        if name in zero_entries:
            zero = zero_entries[name]
            assert np.abs(got[zero]).max() <= 1e-6 * top, name
            assert np.abs(want[zero]).max() <= 1e-6 * top, name
            got, want = got.copy(), want.copy()
            got[zero] = want[zero] = 0.0
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=name)


def check_train_step(monkeypatch, kernel_size, slack_share=1e-2):
    """One ``make_train_step`` of the port's band engine against the JAX
    gather engine's step (f32, channels 8, two levels, 2 x 512 points):
    the loss terms to 1e-5; every parameter gradient, taken before the
    clip, against ``jax.grad`` to 1e-5 of its own leaf's scale; the BN
    running statistics to 1e-5 of their scale; and every updated
    parameter against the optax chain on JAX's gradients, as far as the
    gradients determine it. The port's gather engine in float64 (the
    reference chip_smoke.py holds the card's f32 steps to) gives the same
    loss and gradients. Adam's first step moves an entry by
    lr * g / (|g| + eps) (g clipped), insensitive to g unless |g| is near
    eps = 1e-8, where a gradient error dg moves it by up to
    lr * eps * dg / (|g| + eps)^2 more; that slack matters for at most
    ``slack_share`` of the entries (None: not bounded). The entries whose gradient is zero but for rounding
    (:func:`zero_grad`) are held below 1e-6 of the largest gradient."""
    zero_entries = zero_grad(kernel_size)
    jmodel, variables = jax_model_and_variables("gather", "float32",
                                                kernel_size=kernel_size)
    jmodel = jmodel.clone(batch_size=2)
    batch = padded_batch([3, 4], 512)
    lr, eps = 1e-2, 1e-8
    grads_j, metrics_j, after_j = jax_train_step(jmodel, variables, batch,
                                                 lr)
    grads_j = flax_to_state_dict({"params": grads_j})
    after_j = flax_to_state_dict(after_j)

    small = dict(SMALL, kernel_size=kernel_size)
    model = TreeLearn(engine="band", conv_dtype="float32", batch_size=2,
                      **small)
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    grads = {}
    clip_and_step = harness.optimizer_step

    def recording_step(optimizer, lr):
        grads.update({n: p.grad.numpy().copy()
                      for n, p in model.named_parameters()})
        clip_and_step(optimizer, lr)

    monkeypatch.setattr(harness, "optimizer_step", recording_step)
    tstate = harness.TrainState(model, harness.make_optimizer(model))
    tstep = harness.make_train_step(*families.treelearn_family())
    _, metrics_t = tstep(tstate, harness.to_device(batch, "cpu"), lr)

    for key in ("loss", "semantic_loss", "offset_loss"):
        np.testing.assert_allclose(float(metrics_t[key]),
                                   float(metrics_j[key]), rtol=1e-5)
    assert_grads_match(grads, grads_j, zero_entries)

    ref = TreeLearn(engine="gather", conv_dtype="float64", batch_size=2,
                    **small)
    ref.load_state_dict(flax_to_state_dict(variables), strict=True)
    ref = ref.to(torch.float64)
    forward_fn, loss_fn = families.treelearn_family()
    tbatch = harness.to_device(batch, "cpu")
    loss, _ = loss_fn(forward_fn(ref, tbatch, True), tbatch)
    (loss * harness.LOSS_BACKWARD_SCALE).backward()
    assert loss.dtype == torch.float64
    np.testing.assert_allclose(float(loss.detach()),
                               float(metrics_j["loss"]), rtol=1e-5)
    assert_grads_match({n: p.grad.numpy() for n, p in ref.named_parameters()},
                       grads_j, zero_entries)
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                       for g in grads.values()))
    clip = min(1.0, harness.GRAD_CLIP_NORM / norm)
    after_t = model.state_dict()
    slack_entries = total = 0
    for name, want in after_j.items():
        got, want = after_t[name].numpy(), want.numpy()
        atol = 1e-5 * np.abs(want).max()
        if name in grads:
            g = np.abs(grads[name]) * clip
            dg = 1e-5 * g.max()
            slack = np.minimum(lr * eps * dg / (g + eps) ** 2, 2 * lr)
            if name in zero_entries:  # rounding noise: outside the budget
                slack[zero_entries[name]] = 0.0
            slack_entries += int((slack > atol).sum())
            total += g.size
            if name in zero_entries:  # Adam moves them by at most lr
                slack[zero_entries[name]] = 2 * lr
            atol = atol + slack
        assert (np.abs(got - want) <= atol).all(), name
    assert 0 < total
    if slack_share is not None:
        assert slack_entries <= slack_share * total, slack_entries
    moved = after_t["backbone.input_conv.kernel"] - torch.from_numpy(
        np.asarray(variables["params"]["backbone"]["input_conv"]["kernel"])
    )
    assert float(moved.abs().max()) > 0.5 * lr  # the step really moved


def test_train_step_matches_jax(monkeypatch):
    """3x3x3 convs (K = 27), as the pipeline's TreeLearn."""
    check_train_step(monkeypatch, 3)


def test_train_step_matches_jax_k5(monkeypatch):
    """``TreeLearn(kernel_size=5, engine="band")``: every conv 5x5x5 (K =
    125), so the port's backward runs the K = 125 band backward (its plain
    versions on the CPU) on every conv but the stem. The loss, every
    gradient and the float64 reference are held as at K = 27. On 2 x 512
    points most of a 5x5x5 filter's outer offsets find few neighbours, so
    about a quarter of the filter entries have gradients near Adam's eps,
    where the update is rounding-sensitive: each updated entry is still
    held within its slack, but the share of entries that need it is not
    bounded here (the K = 27 case bounds it at 1 %)."""
    check_train_step(monkeypatch, 5, slack_share=None)


@pytest.mark.parametrize("fixed", [(), ("offset_head",)])
def test_optimizer_matches_optax_chain(fixed):
    """Three steps on the same gradients (one clipped, two not) with
    varying learning rates: parameters to 1e-6 of their scale, fixed
    modules untouched."""
    rng = np.random.default_rng(0)

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = torch.nn.Linear(4, 3)
            self.offset_head = torch.nn.Linear(3, 2)

    net = Net()
    params = {
        mod: {name: rng.normal(size=tuple(p.shape)).astype(np.float32)
              for name, p in getattr(net, mod).named_parameters()}
        for mod in ("backbone", "offset_head")
    }
    with torch.no_grad():
        for mod, leaves in params.items():
            for name, value in leaves.items():
                getattr(getattr(net, mod), name).copy_(torch.from_numpy(value))
    tx = jharness.make_optimizer(1e-3, fixed_modules=fixed)
    jparams = jax.tree.map(jnp.asarray, params)
    opt_state = tx.init(jparams)
    update = jax.jit(tx.update)
    opt = harness.make_optimizer(net, 1e-3, fixed_modules=fixed)
    for scale, lr in ((5.0, 1e-2), (0.05, 5e-3), (0.1, 2e-3)):
        grads = jax.tree.map(
            lambda p: (scale * rng.normal(size=p.shape)).astype(np.float32),
            params,
        )
        updates, opt_state = update(jax.tree.map(jnp.asarray, grads),
                                    opt_state, jparams)
        jparams = optax.apply_updates(
            jparams, jax.tree.map(lambda u: u * lr, updates)
        )
        for mod, leaves in grads.items():
            for name, value in leaves.items():
                getattr(getattr(net, mod), name).grad = torch.from_numpy(
                    value)
        harness.optimizer_step(opt, lr)
    for mod, leaves in jparams.items():
        for name, want in leaves.items():
            got = getattr(getattr(net, mod), name).detach().numpy()
            want = np.asarray(want)
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=1e-6 * np.abs(want).max())
            if mod in fixed:
                np.testing.assert_array_equal(got, params[mod][name])


def test_point_wise_loss_matches_jax():
    rng = np.random.default_rng(2)
    n = 1000
    logits = rng.normal(size=(n, 2)).astype(np.float32)
    preds = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.int32)
    offs = rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    sem_mask = rng.uniform(size=n) < 0.9
    off_mask = sem_mask & (rng.uniform(size=n) < 0.7)
    got = tloss(*(torch.from_numpy(a) for a in (
        logits, preds, labels, offs, sem_mask, off_mask)))
    want = jloss(*(jnp.asarray(a) for a in (
        logits, preds, labels, offs, sem_mask, off_mask)))
    np.testing.assert_allclose([float(x) for x in got],
                               [float(x) for x in want], rtol=1e-6)
    # thinning keeps exactly n_points of the set weights (the draws differ
    # between jax.random and torch.Generator)
    from treemorph_tpu_torch.models.loss import _thin_mask

    gen = torch.Generator().manual_seed(0)
    kept = _thin_mask(torch.from_numpy(sem_mask).float(), 100, gen)
    assert int(kept.sum()) == 100
    assert bool((kept <= torch.from_numpy(sem_mask).float()).all())


def test_schedule_matches_jax():
    for kw in (dict(t_0=50), dict(t_0=10, t_mult=2)):
        want = [jschedule(1e-2, **kw)(e) for e in range(1, 160)]
        got = [tschedule(1e-2, **kw)(e) for e in range(1, 160)]
        assert got == want
    assert tschedule(1e-2)(0) == 1e-2 and tschedule(1e-2)(50) == 1e-2


def test_early_stopper_matches_jax():
    losses = [(1.0, 0.9), (0.8, 0.7), (0.7, 0.75), (0.6, 0.71),
              (0.5, 0.65), (0.4, 0.8), (0.3, 0.9), (0.2, 0.95)]
    records = []
    for cls in (JStopper, EarlyStopper):
        saved = []
        stopper = cls(patience=3, save_fn=saved.append)
        trace = []
        for epoch, (train, val) in enumerate(losses):
            stopper(epoch, train, val)
            trace.append((stopper.counter, stopper.early_stop))
        records.append((saved, trace, stopper.get_scores()))
    assert records[0] == records[1]
    assert records[1][0] == [0, 1, 4] and records[1][1][-1] == (3, True)


def test_plot_split_and_batches_match_jax(tmp_path):
    """The same manifests and noise clouds: the same splits, samples and
    padded batches (exact), shuffled by the same numpy seed."""
    noise = tmp_path / "noise"
    noise.mkdir()
    write_plots(tmp_path, noise_root=noise)
    (tmp_path / "trainset.json").write_text(
        (tmp_path / "plot_1.json").read_text())
    (tmp_path / "testset.json").write_text(
        (tmp_path / "plot_2.json").read_text())
    for split, args in (("get_plot_split", (2,)), ("get_random_split", ())):
        sets_j = getattr(jtreeset, split)(str(tmp_path), *args,
                                          noise_root=str(noise))
        sets_t = getattr(ttreeset, split)(str(tmp_path), *args,
                                          noise_root=str(noise))
        for ds_j, ds_t in zip(sets_j, sets_t):
            assert ds_t.data_paths == ds_j.data_paths
            assert ds_t.training == ds_j.training
            it_j = jtreeset.batch_iterator(ds_j, 3, 128,
                                           rng=np.random.default_rng(5))
            it_t = ttreeset.batch_iterator(ds_t, 3, 128,
                                           rng=np.random.default_rng(5))
            pairs = list(zip(it_j, it_t, strict=True))
            assert pairs
            for b_j, b_t in pairs:
                assert b_t.noise_coords is not None
                assert_batches_equal(b_t, b_j)
    sample = ttreeset.TreeDataset(str(tmp_path / "plot_3.json"), True)[1]
    assert sample.points.shape == (337, 3) and sample.noise_points is None
    assert ttreeset.pad_to_bucket(337, 128) == 384


def test_augmentations_match_jax():
    cloud = labeled_cloud(1, 400)
    pts, offs = cloud[:, :3], cloud[:, 3:6]
    for make in ("default_augmentations", "random_dropout"):
        out_j = getattr(jaug, make)()(pts, offs, np.random.default_rng(7))
        out_t = getattr(taug, make)()(pts, offs, np.random.default_rng(7))
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a, b)
    moved = taug.default_augmentations()(pts, offs, np.random.default_rng(7))
    # the target surface point moves with the cloud: |offsets| keep their
    # scale up to the jitter
    assert not np.allclose(moved[0], pts)


def small_trained_state():
    model = TreeLearn(engine="band", conv_dtype="bfloat16", batch_size=2,
                      **dict(SMALL, num_blocks=1))
    families.init_treelearn(model, 3)
    state = harness.TrainState(model, harness.make_optimizer(model))
    step = harness.make_train_step(*families.treelearn_family())
    batch = harness.to_device(padded_batch([5, 6], 256), "cpu")
    step(state, batch, 1e-2)
    return state, batch


def test_checkpoint_round_trip_through_load_model(tmp_path):
    """A trained state saved, restored into a fresh state (model and
    optimizer, exactly), and loaded as the pipeline's predictor, which
    predicts as the trained model does."""
    state, batch = small_trained_state()
    path = tmp_path / "treelearn_CV" / "P3"
    meta = {"model": "treelearn", "plot": 3, "voxel_size": 0.02,
            "num_blocks": 1, "channels": 8, "dim_feat": 4}
    save_checkpoint(str(path), state, meta)
    fresh_model = TreeLearn(engine="band", conv_dtype="bfloat16",
                            batch_size=2, **dict(SMALL, num_blocks=1))
    fresh = harness.TrainState(fresh_model,
                               harness.make_optimizer(fresh_model))
    restore_checkpoint(str(path), fresh)
    assert fresh.step == state.step == 1
    for k, v in state.model.state_dict().items():
        np.testing.assert_array_equal(fresh.model.state_dict()[k], v)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        for key in ("exp_avg", "exp_avg_sq"):
            np.testing.assert_array_equal(
                fresh.optimizer.state[q][key], state.optimizer.state[p][key])

    predictors = load_model("treelearn", str(tmp_path / "treelearn_CV"),
                            device="cpu")
    assert list(predictors) == ["O_P3"]
    flat = families._flatten_padded(batch)
    args = (flat["coords"], flat["feats"], flat["batch_ids"],
            flat["mask_valid"])
    loaded = predictors["O_P3"]
    loaded.model = loaded.model.clone(engine="band", conv_dtype="bfloat16",
                                      batch_size=2)
    got = loaded.predict_flat(*args)
    with torch.no_grad():
        want = state.model.eval()(*args)
    for key in ("offset_predictions", "semantic_prediction_logits"):
        np.testing.assert_array_equal(got[key].numpy(), want[key].numpy())


def test_cli_trains_one_epoch_on_cpu(tmp_path):
    """One epoch of the noise-cloud family (the semantic head reads a
    second backbone pass over each tree's noise cloud)."""
    noise = tmp_path / "noise"
    noise.mkdir()
    write_plots(tmp_path, trees=2, n=400, noise_root=noise)
    histories = cli.main([
        "treelearn", "--data_root", str(tmp_path), "--test_plots", "1",
        "--epochs", "1", "--batch_size", "2", "--bucket", "512",
        "--channels", "8", "--num_blocks", "2", "--engine", "band",
        "--conv_dtype", "bfloat16", "--save_dir", str(tmp_path / "saves"),
        "--noise_root", str(noise), "--device", "cpu",
    ])
    (record,) = histories[1]
    assert np.isfinite([record["train_loss"], record["val_loss"]]).all()
    ckpt = tmp_path / "saves" / "treelearn_CV"
    assert (ckpt / "P1" / "model.pt").exists()
    meta = json.loads((ckpt / "P1.metadata.json").read_text())
    assert meta["num_blocks"] == 2 and meta["channels"] == 8


def test_training_entry_points_default_to_cuda_and_raise_without_it(
    monkeypatch, tmp_path
):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    write_plots(tmp_path, trees=1, n=100)
    for family in ("treelearn", "pointtransformerv3", "pointnet2"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([family, "--data_root", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_model("treelearn", str(tmp_path))


def test_training_paths_not_ported_raise(tmp_path):
    """What used to raise and no longer does: data-parallel training (the
    three step builders take a mesh; ``test_torch_parallel.py`` runs them
    over two ranks) and PTv3's z-pack and brick stems in the CLI (the CLI
    builds PTv3 on the z-pack stem, and on the gather path for brick, as
    the JAX package's PTv3 takes any other engine name); and what still
    raises: a broken JAX orbax checkpoint directory (an empty
    ``manifest.ocdbt``, no ``model.pt``) in the pipeline's ``model_dirs``
    raises the orbax reader's ``ValueError`` naming the manifest."""
    from treemorph_tpu_torch.parallel import Mesh
    from treemorph_tpu_torch.pipeline.run import load_pipeline_models

    for engine in ("zpack", "brick"):
        args = cli.parse_args(["pointtransformerv3", "--data_root",
                               str(tmp_path), "--engine", engine,
                               "--device", "cpu"])
        model, _, _ = cli.build(args, 2, 0.02, None)
        assert model.config["stem_engine"] == engine
    mesh = Mesh(0, 1, torch.device("cpu"))
    fwd, loss = families.treelearn_family(group=mesh)
    assert callable(harness.make_train_step(fwd, loss, mesh=mesh))
    assert callable(harness.make_eval_step(fwd, loss, mesh=mesh))
    accum_step, apply_step = harness.make_accum_steps(fwd, loss, mesh=mesh)
    assert callable(accum_step) and callable(apply_step)
    orbax = tmp_path / "offset" / "P3"
    (orbax / "ocdbt.process_0" / "d").mkdir(parents=True)
    (orbax / "manifest.ocdbt").write_bytes(b"")
    (orbax / "_METADATA").write_text("{}")
    cfg = {"stage1": {"predict_offset": True, "denoise": False},
           "model_dirs": {"treelearn": [str(tmp_path / "offset"), None]}}
    with pytest.raises(ValueError, match="manifest.ocdbt: 0 bytes"):
        load_pipeline_models(cfg, "treelearn", device="cpu")
