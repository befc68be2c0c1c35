"""Synthetic-fixture sanity check: overfit a model on a procedural cylinder.

    python -m treemorph_tpu_torch.scripts.sanity_check [treelearn|pointnet2|
        pointtransformerv3] [--n_points 10000] [--epochs 200] [--lr 1e-3]
        [--out sanity_check.png] [--device cpu]

The port's counterpart of the JAX package's ``scripts/sanity_check.py``
(reference ``ModelTestingScripts/SanityCheckPointNet2.py``) with the same
model settings: a noisy cylinder with known ground-truth offsets is
overfit through the training harness (:mod:`treemorph_tpu_torch.train.
harness`), the semantic loss off, and the predicted offsets are drawn
against the ground truth in slices (``--out ''`` draws no figure). PTv3's
attention runs the window-attention kernels forward and backward on the
card; TreeLearn takes its default gather engine, as in the JAX script.
Runs on the CUDA device unless ``--device`` names another, and raises
without one. Prints the first and last epochs' train loss and the hand
kernels' launches; returns the history.
"""

from __future__ import annotations

import argparse
import json
import logging


def build(model_name: str):
    """The family's model (initialized from seed 0, on the CPU) and its
    (forward_fn, loss_fn) pair, with the JAX script's settings."""
    from ..train import families

    if model_name == "pointnet2":
        from ..models.pointnet2 import PointNet2

        return (families.init_pointnet2(PointNet2(depth=5), 0),
                families.pointnet2_family(loss_multiplier_semantic=0.0))
    if model_name == "treelearn":
        from ..models.treelearn import TreeLearn

        model = TreeLearn(channels=16, num_blocks=3, dim_feat=4,
                          voxel_size=0.02, batch_size=1)
        return (families.init_treelearn(model, 0),
                families.treelearn_family(loss_multiplier_semantic=0.0))
    from ..models.ptv3 import PointTransformerWithHeads

    model = PointTransformerWithHeads(dim_feat=4, use_feats=True,
                                      drop_path=0.0)
    return (families.init_ptv3(model, 0),
            families.ptv3_family(loss_multiplier_semantic=0.0))


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "model",
        choices=["treelearn", "pointnet2", "pointtransformerv3"],
        nargs="?",
        default="pointnet2",
    )
    parser.add_argument("--n_points", type=int, default=10000)
    parser.add_argument("--epochs", type=int, default=200)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--out", type=str, default="sanity_check.png")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; "
                             "raises without one)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    import numpy as np
    import torch

    from ..data import make_padded_batch
    from ..data.treeset import TreeSample
    from ..fixtures import synthetic_cylinder_cloud
    from ..ops.cuda import LAUNCHES
    from ..train import (
        TrainState,
        make_eval_step,
        make_optimizer,
        make_train_step,
        run_training,
    )
    from ..train.harness import to_device
    from ..utils.device import resolve_device

    device = resolve_device(args.device)
    rng = np.random.default_rng(0)
    labeled = synthetic_cylinder_cloud(args.n_points, rng=rng)
    norm = np.linalg.norm(labeled[:, 3:6], axis=1)
    sample = TreeSample(
        points=labeled[:, :3],
        feats=labeled[:, 7:],
        offsets=labeled[:, 3:6],
        semantic_label=(norm > 0.05).astype(np.int32),
        offset_mask=norm <= 0.05,
        path="synthetic_cylinder",
    )
    batch = make_padded_batch([sample], bucket=1024)

    model, (forward_fn, loss_fn) = build(args.model)
    model = model.to(device)
    state = TrainState(model, make_optimizer(model))
    launched = dict(LAUNCHES)
    state, history = run_training(
        state,
        make_train_step(forward_fn, loss_fn),
        make_eval_step(forward_fn, loss_fn),
        train_batches=lambda e: iter([batch]),
        val_batches=lambda e: iter([batch]),
        epochs=args.epochs,
        lr_schedule=lambda e: args.lr,
        verbose=True,
        seed=1,
    )
    print(
        f"loss: {history[0]['train_loss']:.4f} -> "
        f"{history[-1]['train_loss']:.4f}"
    )
    print("hand kernel launches: " + json.dumps(
        {k: v - launched.get(k, 0) for k, v in LAUNCHES.items()
         if v != launched.get(k, 0)}))

    if args.out:
        from ..plotting import plot_offset_slices

        with torch.no_grad():
            out = forward_fn(state.model, to_device(batch, device), False)
        pred = out["offset_predictions"].float().cpu().numpy().reshape(
            -1, 3)[: args.n_points]
        plot_offset_slices(
            labeled[:, :3],
            labeled[:, 3:6],
            pred,
            args.out,
            slices=((0.0, 0.5), (1.0, 1.5), (2.0, 2.5), (3.5, 4.0),
                    (4.5, 5.0)),
        )
        print(f"slice plot -> {args.out}")
    return history


if __name__ == "__main__":
    main()
