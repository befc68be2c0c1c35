"""Rank functions of ``test_torch_parallel.py``: each runs in a process of
its own, started by ``treemorph_tpu_torch.parallel.spawn_ranks``, so this
module imports torch and the port only (no JAX)."""

import os

import torch

from treemorph_tpu_torch.data.treeset import PaddedBatch
from treemorph_tpu_torch.models import TreeLearn
from treemorph_tpu_torch.parallel import mesh as pmesh
from treemorph_tpu_torch.train import cli, families, harness


def treelearn_step(mesh, model_kwargs, state_dict, batch, lr, out_dir,
                   cli_argv):
    """One TreeLearn data-parallel eval step and train step on this rank's
    rows of ``batch`` (a PaddedBatch of numpy arrays, padded to the world
    size here), then the training CLI's per-rank entry on ``cli_argv``;
    saves the eval metrics, the step's metrics, the gradients after the
    all-reduce (before the clip), the state after the step, the
    collectives the step issued and the CLI's histories to
    ``out_dir/rank{r}.pt``."""
    torch.set_num_threads(1)
    model = TreeLearn(**model_kwargs)
    model.load_state_dict(state_dict, strict=True)
    forward_fn, loss_fn = families.treelearn_family(group=mesh)
    state = harness.TrainState(model, harness.make_optimizer(model))
    pmesh.replicate(state, mesh)
    local = pmesh.shard_batch(
        pmesh.pad_batch_to_multiple(PaddedBatch(*batch), mesh.size), mesh)
    eval_metrics = harness.make_eval_step(forward_fn, loss_fn, mesh)(
        state, local)
    grads = {}
    clip_and_step = harness.optimizer_step

    def recording_step(optimizer, step_lr):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters()})
        clip_and_step(optimizer, step_lr)

    harness.optimizer_step = recording_step
    before = dict(pmesh.COLLECTIVES)
    step = harness.make_train_step(forward_fn, loss_fn, mesh=mesh)
    _, metrics = step(state, local, lr, torch.Generator().manual_seed(1))
    step_collectives = {k: v - before.get(k, 0)
                        for k, v in pmesh.COLLECTIVES.items()}
    harness.optimizer_step = clip_and_step
    args = cli.parse_args(cli_argv)
    histories = cli._rank_main(mesh, args,
                               os.path.join(out_dir, "histories.json"))
    torch.save({
        "eval": {k: float(v) for k, v in eval_metrics.items()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "grads": grads,
        "after": model.state_dict(),
        "rows": int(local.coords.shape[0]),
        "step_collectives": step_collectives,
        "cli": histories,
    }, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
