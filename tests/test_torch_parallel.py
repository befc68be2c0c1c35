"""Data-parallel training on the CPU: two gloo ranks, each a process
spawned through a file store under the test's temporary directory,
against the JAX package's mesh step on two of the conftest's eight virtual
devices; the per-rank input pipeline against ``data/multihost.py``; and the
training CLI with ``--n_devices``.

The model is the tiny TreeLearn of ``tests/test_sharding_specs.py``
(channels 8, two levels) with perturbed flax variables, 4 trees x 256
points, two a rank. The JAX mesh step takes ``jax.grad`` through the loss's
``psum`` and so gets twice the global loss's gradient; the port's is the
global loss's gradient itself, so its gradients are JAX's halved (to
1e-5 of each leaf's scale: fp summation order). The global-norm clip bites
in this step (asserted), so both take the same clipped gradient and the
updated parameters and BatchNorm statistics match JAX's
``make_train_step(mesh=...)``.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from treemorph_tpu.data import TreeDataset as JTreeDataset
from treemorph_tpu.data import multihost as jmultihost
from treemorph_tpu.parallel.mesh import make_mesh as jmake_mesh
from treemorph_tpu.parallel.mesh import pad_batch_to_multiple as jpad
from treemorph_tpu.parallel.mesh import replicate as jreplicate
from treemorph_tpu.parallel.mesh import shard_batch as jshard
from treemorph_tpu.train import families as jfamilies
from treemorph_tpu.train import harness as jharness
from treemorph_tpu_torch.data import TreeDataset, multihost
from treemorph_tpu_torch.data.treeset import make_padded_batch
from treemorph_tpu_torch.models import flax_to_state_dict
from treemorph_tpu_torch.parallel import (
    Mesh,
    pad_batch_to_multiple,
    shard_batch,
    spawn_ranks,
)
from treemorph_tpu_torch.train import cli, harness

import torch_parallel_ranks
from test_torch_ops import fresh_jax_caches, one_torch_thread  # noqa: F401
from test_torch_train import (
    assert_grads_match,
    padded_batch,
    write_plots,
    zero_grad,
)
from test_torch_treelearn import SMALL, jax_model_and_variables

TREES, POINTS, LR = 4, 256, 1e-2


@pytest.fixture(scope="module")
def setup():
    jmodel, variables = jax_model_and_variables("gather", "float32")
    batch = padded_batch(list(range(3, 3 + TREES)), POINTS)
    return jmodel.clone(batch_size=TREES // 2), variables, batch


@pytest.fixture(scope="module")
def port_run(setup, tmp_path_factory):
    """Each rank's results of one eval step and one train step over two
    gloo ranks on the CPU, then of the training CLI's per-rank entry
    (``torch_parallel_ranks.treelearn_step``)."""
    _, variables, batch = setup
    out = tmp_path_factory.mktemp("ranks")
    plots = out / "plots"
    plots.mkdir()
    write_plots(plots, trees=2, n=100)
    argv = ["treelearn", "--data_root", str(plots), "--test_plots", "1",
            "--epochs", "2", "--batch_size", "2", "--bucket", "128",
            "--channels", "8", "--num_blocks", "2", "--device", "cpu",
            "--n_devices", "2", "--save_dir", str(out / "saves")]
    model_kwargs = dict(SMALL, engine="band", conv_dtype="float32",
                        batch_size=TREES // 2)
    spawn_ranks(torch_parallel_ranks.treelearn_step, 2, model_kwargs,
                flax_to_state_dict(variables), tuple(batch), LR, str(out),
                argv, backend="gloo", devices=["cpu", "cpu"],
                store_dir=str(out))
    return [torch.load(out / f"rank{r}.pt") for r in range(2)], out


def capture_grads():
    """An optax transformation that passes the gradients on unchanged and
    keeps them in its state, so that the JAX mesh step's own gradients
    (psum'd, before the clip) come out of its optimizer state."""
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))


@pytest.fixture(scope="module")
def jax_mesh_runs(setup):
    """JAX on a two-device mesh: the eval metrics of
    ``make_eval_step(mesh=...)``, then one ``make_train_step(mesh=...)``
    whose optimizer is the harness's chain behind :func:`capture_grads`:
    its gradients, metrics and state after the step."""
    import optax

    jmodel, variables, batch = setup
    mesh = jmake_mesh(2)
    forward_fn, loss_fn = jfamilies.treelearn_family(jmodel,
                                                     axis_name="data")
    sharded = jshard(batch, mesh)
    tx = optax.chain(capture_grads(), jharness.make_optimizer())

    def fresh_state():
        return jreplicate(jharness.create_train_state(
            jax.tree.map(jnp.asarray, variables), tx), mesh)

    eval_metrics = jharness.make_eval_step(forward_fn, loss_fn, mesh=mesh)(
        fresh_state(), sharded)
    step = jharness.make_train_step(forward_fn, loss_fn, tx, mesh=mesh)
    state, metrics = step(fresh_state(), sharded, jnp.float32(LR),
                          jax.random.key(1))
    return jax.device_get((state.opt_state[0], eval_metrics, metrics, {
        "params": state.params, "batch_stats": state.batch_stats}))


def test_two_rank_gradients_are_jax_mesh_gradients_halved(port_run,
                                                         jax_mesh_runs):
    ranks = port_run[0]
    for name, g in ranks[0]["grads"].items():  # every rank takes the same
        assert torch.equal(g, ranks[1]["grads"][name]), name
    want = {k: v / 2 for k, v in flax_to_state_dict(
        {"params": jax_mesh_runs[0]}).items()}
    assert_grads_match({k: v.numpy() for k, v in ranks[0]["grads"].items()},
                       want, zero_grad())
    # one all-reduce each: the loss's four sums, the gradients, the BN
    # running statistics
    issued = {k: v for k, v in ranks[0]["step_collectives"].items() if v}
    assert issued == {"all_reduce": 3}


def test_two_rank_step_matches_jax_mesh_step(port_run, jax_mesh_runs):
    """Parameters and BN running statistics after one step: the clip bites
    (the port's gradient norm is above 1, JAX's twice that), so both steps
    apply the same clipped gradient. Adam's first update of an entry
    whose gradient is near its eps is rounding-sensitive, so such entries
    get the slack of ``test_torch_train.py::check_train_step``."""
    rank = port_run[0][0]
    grads = {k: v.numpy().astype(np.float64) for k, v in
             rank["grads"].items()}
    norm = np.sqrt(sum(np.sum(g ** 2) for g in grads.values()))
    assert norm > harness.GRAD_CLIP_NORM
    for key in ("loss", "semantic_loss", "offset_loss"):
        np.testing.assert_allclose(rank["metrics"][key],
                                   float(jax_mesh_runs[2][key]), rtol=1e-5)
    zero_entries = zero_grad()
    eps = 1e-8
    for name, want in flax_to_state_dict(jax_mesh_runs[3]).items():
        got, want = rank["after"][name].numpy(), want.numpy()
        atol = 1e-5 * np.abs(want).max()
        if name in grads:
            g = np.abs(grads[name]) / norm
            slack = np.minimum(LR * eps * 1e-5 * g.max() / (g + eps) ** 2,
                               2 * LR)
            if name in zero_entries:
                slack[zero_entries[name]] = 2 * LR
            atol = atol + slack
        assert (np.abs(got - want) <= atol).all(), name


def test_eval_metrics_are_global_means(port_run, jax_mesh_runs):
    """Two-rank eval metrics against JAX's mesh eval step (rtol 5e-4, as in
    ``tests/test_sharding_specs.py``), the same on both ranks."""
    ranks = port_run[0]
    for key, want in jax_mesh_runs[1].items():
        np.testing.assert_allclose(ranks[0]["eval"][key], float(want),
                                   rtol=5e-4)
        assert ranks[1]["eval"][key] == ranks[0]["eval"][key]


def test_pad_batch_to_multiple_with_three_ranks(setup):
    """Padding to a multiple of 3 adds all-invalid trees, as the JAX
    package's does; each of three ranks takes its contiguous rows."""
    _, _, batch = setup
    padded = pad_batch_to_multiple(batch, 3)
    want = jpad(batch, 3)
    assert padded.batch_size == 6
    for got, ref in zip(padded, want):
        if ref is None:
            assert got is None
            continue
        np.testing.assert_array_equal(got, ref)
    assert not padded.mask_valid[TREES:].any()
    for rank in range(3):
        mesh = Mesh(rank, 3, torch.device("cpu"))
        local = shard_batch(padded, mesh)
        np.testing.assert_array_equal(local.coords.numpy(),
                                      padded.coords[2 * rank:2 * rank + 2])
    assert pad_batch_to_multiple(batch, 2) is batch


def write_clouds(tmp_path, sizes):
    paths = []
    for i, n in enumerate(sizes):
        cloud = np.random.default_rng(i).normal(size=(n, 3))
        path = tmp_path / f"tree_{i:02d}.npy"
        np.save(path, cloud.astype(np.float32))
        paths.append(str(path))
    return paths


def test_rank_shards_are_disjoint_and_covering():
    paths = [f"plot_{i}.npy" for i in range(11)]
    shards = [multihost.host_shard_paths(paths, rank=r, world_size=4)
              for r in range(4)]
    flat = [p for s in shards for p in s]
    assert sorted(flat) == sorted(paths)
    assert len(set(flat)) == len(flat)
    for r in range(4):
        assert shards[r] == jmultihost.host_shard_paths(
            paths, process_index=r, process_count=4)
        assert shards[r] == multihost.host_shard_paths(
            list(reversed(paths)), rank=r, world_size=4)
    assert multihost.host_shard_paths(paths[:5]) == sorted(paths[:5])


def test_ranks_load_their_slice_of_one_global_permutation(tmp_path):
    """Each rank's batch is its rows of the global batch the JAX iterator
    draws with the same seed; as tensors on the mesh's device."""
    paths = write_clouds(tmp_path, [96] * 8)
    ds = TreeDataset(paths, training=True, process_json=False)
    jds = JTreeDataset(paths, training=True, process_json=False)
    jmesh = jmake_mesh(2)
    for rank in range(2):
        got = next(multihost.multihost_batch_iterator(
            ds, 4, bucket=128, seed=7, shuffle=True, rank=rank,
            world_size=2))
        want = next(jmultihost.multihost_batch_iterator(
            jds, 4, jmesh, bucket=128, seed=7, shuffle=True,
            process_index=rank, process_count=2))
        np.testing.assert_array_equal(got.coords, np.asarray(want.coords))
        mesh = Mesh(rank, 2, torch.device("cpu"))
        on_device = next(multihost.multihost_batch_iterator(
            ds, 4, mesh, bucket=128, seed=7, shuffle=True))
        assert isinstance(on_device.coords, torch.Tensor)
        np.testing.assert_array_equal(on_device.coords.numpy(), got.coords)


def test_ranks_pad_to_the_global_batch(tmp_path):
    """A rank whose trees are small pads to the global batch's largest
    tree, read from the .npy headers, so every rank's batch has one
    shape; trailing partial batches are dropped."""
    paths = write_clouds(tmp_path, (200, 300, 1500, 400, 100))
    ds = TreeDataset(paths, training=False, process_json=False)
    shapes = []
    for rank in range(2):
        batches = list(multihost.multihost_batch_iterator(
            ds, 4, bucket=256, shuffle=False, rank=rank, world_size=2))
        assert len(batches) == 1
        shapes.append(batches[0].coords.shape)
    assert shapes[0] == shapes[1] and shapes[0][1] >= 1500
    local = make_padded_batch([ds[0], ds[1]], bucket=256)
    assert local.coords.shape[1] < shapes[0][1]
    with pytest.raises(ValueError, match="divide"):
        next(multihost.multihost_batch_iterator(ds, 3, rank=0,
                                                world_size=2))


def test_cli_trains_on_two_ranks(port_run):
    """The training CLI's per-rank entry (what ``main`` spawns for
    ``--n_devices 2``) on two gloo ranks: both ranks train every batch's
    halves to the same history, rank 0 writes the checkpoint and the
    histories for the caller."""
    ranks, out = port_run
    (history,) = ranks[0]["cli"].values()
    for a, b in zip(history, ranks[1]["cli"][1]):  # all but the seconds
        assert {**a, "time": 0} == {**b, "time": 0}
    assert len(history) == 2
    assert all(np.isfinite(r["train_loss"]) for r in history)
    saved = out / "saves" / "treelearn_CV"
    assert (saved / "P1" / "model.pt").exists()
    assert json.loads((saved / "P1.metadata.json").read_text())["model"] == (
        "treelearn")
    assert json.loads((out / "histories.json").read_text())["1"] == history


def test_cli_starts_one_rank_a_device(monkeypatch, tmp_path):
    """``--device cpu --n_devices 2`` asks ``spawn_ranks`` for two ranks of
    the CLI's per-rank entry and returns rank 0's histories; without
    ``--n_devices`` the CLI trains in its own process."""
    import treemorph_tpu_torch.parallel as parallel

    calls = []

    def fake_spawn(fn, n, args, out_path, store_dir=None, devices=None):
        calls.append((fn, n, args.n_devices, devices))
        with open(out_path, "w") as f:
            json.dump({"1": [{"epoch": 0}]}, f)

    monkeypatch.setattr(parallel, "spawn_ranks", fake_spawn)
    argv = ["treelearn", "--data_root", str(tmp_path), "--device", "cpu"]
    assert cli.main(argv + ["--n_devices", "2"]) == {1: [{"epoch": 0}]}
    assert calls == [(cli._rank_main, 2, 2, ["cpu", "cpu"])]
    assert cli.world_size(cli.parse_args(argv)) == 1
