"""Training CLI, the port's counterpart of ``scripts/train.py`` for
TreeLearn and PTv3:

    python -m treemorph_tpu_torch.train.cli treelearn --data_root DIR \\
        [--test_plots 3 4 6 8] [--engine band --conv_dtype bfloat16] \\
        [--device cpu]
    python -m treemorph_tpu_torch.train.cli pointtransformerv3 \\
        --data_root DIR [--batch_size 4] [--device cpu]

Per-plot cross-validation over ``--test_plots`` (leave-one-plot-out over
the ``plot_{n}.json`` manifests in ``--data_root``), AdamW (weight decay
1e-3) with CosineAnnealingWarmRestarts(T_0=50, eta_min=1e-4), the x50 loss
scale and global-norm clip 1.0, early stopping with best-checkpoint saves
to ``{save_dir}/{name}_CV/P{plot}/``, loss multipliers and noise-cloud
training. TreeLearn's level-0 voxel capacity is worked out from the
fold's clouds (:func:`level0_capacity`). PTv3 is the pipeline's model at
full width (``scripts/train.py:130-143``: features on, ``--dim_feat``,
``--voxel_size``, ``--conv_dtype`` as its compute dtype, the gather stem),
each step drawing its order shuffles and drop-path masks from a generator
derived from ``--seed``. It runs on the CUDA device unless ``--device``
names another, and raises without one. No YAML parser is needed.

Not ported yet, and raising ``NotImplementedError``: training the
``pointnet2`` family (its model serves, :mod:`..models.pointnet2`), raster
training (``--raster_dir``, ``--hierarchical_json``), and PTv3's
``--dedup_divisor`` and non-gather stems. It trains on one device.
"""

from __future__ import annotations

import argparse
import logging
import os

import numpy as np
import torch

_NOT_PORTED = {
    "pointnet2": "training the pointnet2 family is not ported yet "
                 "(ROADMAP.md queue 1 item 12b)",
    "ptv3_stem": "PTv3 training with its dedup (--dedup_divisor) or its "
                 "band and z-pack stems (--engine) is not wired into the "
                 "CLI yet (ROADMAP.md queue 1 item 11c)",
    "raster": "raster training (--raster_dir, --hierarchical_json) comes "
              "with PointNet2's training (ROADMAP.md queue 1 item 12b)",
}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a tree-morphology model")
    p.add_argument("model", choices=["treelearn", "pointnet2",
                                     "pointtransformerv3"])
    p.add_argument("--data_root", type=str, default=None,
                   help="directory with plot_{n}.json manifests")
    p.add_argument("--save_dir", type=str, default="ModelSaves")
    p.add_argument("--name", type=str, default=None,
                   help="checkpoint run name (default: model family)")
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--bucket", type=int, default=1024,
                   help="pad point counts to multiples of this")
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--weight_decay", type=float, default=1e-3)
    p.add_argument("--t0", type=int, default=50)
    p.add_argument("--eta_min", type=float, default=1e-4)
    p.add_argument("--patience", type=int, default=20)
    p.add_argument("--noise_distance", type=float, default=0.05)
    p.add_argument("--noise_root", type=str, default=None)
    p.add_argument("--loss_multiplier_semantic", type=float, default=1.0)
    p.add_argument("--loss_multiplier_offset", type=float, default=1.0)
    p.add_argument("--test_plots", type=int, nargs="+", default=[3, 4, 6, 8])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--raster_dir", type=str, default=None)
    p.add_argument("--hierarchical_json", type=str, nargs="+", default=None)
    p.add_argument("--fixed_modules", type=str, nargs="+", default=None,
                   help="freeze named top-level submodules for transfer "
                   "learning (reference TreeLearn fixed_modules)")
    p.add_argument("--debug_nans", action="store_true",
                   help="autograd anomaly detection: fail at the first "
                   "backward op that yields NaN")
    p.add_argument("--augment", action="store_true",
                   help="apply the default training augmentations "
                        "(z-rotation, xy-flip, scale, target-preserving "
                        "jitter)")
    # family hyperparameters
    p.add_argument("--voxel_size", type=float, default=None)
    p.add_argument("--num_blocks", type=int, default=3)
    p.add_argument("--channels", type=int, default=32)
    p.add_argument("--dim_feat", type=int, default=4)
    p.add_argument("--engine", default="gather",
                   choices=["gather", "band", "zpack", "pencil", "brick"],
                   help="TreeLearn conv engine (band = the band conv "
                   "kernels; engines share one parameter layout, so "
                   "checkpoints are interchangeable); PTv3 stem engine "
                   "(gather only, pencil meaning gather)")
    p.add_argument("--conv_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="conv compute dtype (f32 accumulation); PTv3's "
                        "compute dtype")
    p.add_argument("--dedup_divisor", type=int, default=None,
                   help="PTv3 level-0 dedup (not ported yet)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default: the CUDA device; raises "
                        "without one)")
    p.add_argument("--verbose", action="store_true")
    return p.parse_args(argv)


def _unique_voxels(points, voxel_size: float) -> int:
    """Occupied voxels of one cloud, as the voxelizer grids it (from the
    cloud's own minimum corner)."""
    grid = np.floor((points - points.min(axis=0)) / voxel_size)
    return len(np.unique(grid.astype(np.int64), axis=0))


def level0_capacity(datasets, batch_size: int, voxel_size: float,
                    margin: float = 1.02) -> int:
    """The honest level-0 voxel capacity of a batch
    (scripts/bench_training.py:116-124): unique voxels x ``margin``, rounded
    up to 8192, for the ``batch_size`` clouds of ``datasets`` with the most
    voxels, so that no batch drops one. A tree's noise cloud counts where it
    has more voxels than the tree (the noise pass has the same capacity)."""
    counts = []
    for ds in datasets:
        for i in range(len(ds)):
            s = ds[i]
            clouds = [s.points] + (
                [s.noise_points] if s.noise_points is not None else [])
            counts.append(max(_unique_voxels(c, voxel_size) for c in clouds))
    worst = sum(sorted(counts)[-batch_size:])
    return -(-int(worst * margin) // 8192) * 8192


def build(args, batch_size: int, voxel_size: float, capacity):
    """The family's model (initialized from ``--seed``, on the CPU), its
    (forward_fn, loss_fn) and the checkpoint metadata ``load_model``
    rebuilds the model from (``scripts/train.py::build``)."""
    from ..models.ptv3 import PointTransformerWithHeads
    from ..models.treelearn import TreeLearn
    from . import families

    losses = (args.loss_multiplier_semantic, args.loss_multiplier_offset)
    metadata = {"model": args.model, "voxel_size": voxel_size,
                "dim_feat": args.dim_feat}
    if args.model == "pointtransformerv3":
        model = PointTransformerWithHeads(
            dim_feat=args.dim_feat, use_feats=True, voxel_size=voxel_size,
            compute_dtype=args.conv_dtype,
        )
        metadata["use_feats"] = True
        return (families.init_ptv3(model, args.seed),
                families.ptv3_family(*losses), metadata)
    model = TreeLearn(
        channels=args.channels,
        num_blocks=args.num_blocks,
        dim_feat=args.dim_feat,
        voxel_size=voxel_size,
        batch_size=batch_size,
        engine=args.engine,
        conv_dtype=args.conv_dtype,
        voxel_capacity=capacity,
    )
    family_fn = (families.treelearn_noise_family if args.noise_root
                 else families.treelearn_family)
    metadata.update(num_blocks=args.num_blocks, channels=args.channels)
    return (families.init_treelearn(model, args.seed), family_fn(*losses),
            metadata)


def main(argv=None) -> dict:
    """Train every CV fold; returns ``{plot: history}``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..data import batch_iterator, get_plot_split
    from ..utils.device import resolve_device
    from ..utils.early_stopping import EarlyStopper
    from .checkpoints import save_checkpoint
    from .harness import (
        TrainState,
        make_eval_step,
        make_optimizer,
        make_train_step,
        run_training,
    )
    from .schedule import cosine_annealing_warm_restarts

    if args.model in _NOT_PORTED:
        raise NotImplementedError(_NOT_PORTED[args.model])
    if args.raster_dir is not None or args.hierarchical_json is not None:
        raise NotImplementedError(_NOT_PORTED["raster"])
    if args.model == "pointtransformerv3" and (
        args.dedup_divisor is not None
        or args.engine not in ("gather", "pencil")
    ):
        raise NotImplementedError(_NOT_PORTED["ptv3_stem"])
    if args.data_root is None:
        raise SystemExit("--data_root is required")
    device = resolve_device(args.device)

    name = args.name or args.model
    histories = {}
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        for plot in args.test_plots:
            logging.info("=== CV fold: test plot %s ===", plot)
            trainset, valset = get_plot_split(
                args.data_root,
                plot,
                noise_distance=args.noise_distance,
                noise_root=args.noise_root,
            )
            voxel_size = args.voxel_size or 0.02
            capacity = None
            if args.model == "treelearn":
                # random_scale grows a cloud by up to 5 %, its voxels by up
                # to 1.05^3
                capacity = level0_capacity(
                    (trainset, valset), args.batch_size, voxel_size,
                    1.02 * (1.05**3 if args.augment else 1.0),
                )
                logging.info("level-0 voxel capacity %d", capacity)
            if args.augment:
                from ..data.augmentations import default_augmentations

                trainset.augment = default_augmentations()
            rng_np = np.random.default_rng(args.seed)
            example = next(
                batch_iterator(
                    trainset, args.batch_size, args.bucket, shuffle=False
                )
            )

            def train_batches(epoch):
                return batch_iterator(
                    trainset, args.batch_size, args.bucket, rng=rng_np
                )

            def val_batches(epoch):
                return batch_iterator(
                    valset, args.batch_size, args.bucket, shuffle=False
                )

            model, (forward_fn, loss_fn), metadata = build(
                args, example.batch_size, voxel_size, capacity)
            model = model.to(device)
            fixed = tuple(args.fixed_modules or ())
            state = TrainState(
                model, make_optimizer(model, args.weight_decay, fixed)
            )
            train_step = make_train_step(forward_fn, loss_fn, fixed)
            eval_step = make_eval_step(forward_fn, loss_fn)

            ckpt_path = os.path.join(args.save_dir, f"{name}_CV", f"P{plot}")
            metadata.update(plot=plot, noise_distance=args.noise_distance)
            stopper = EarlyStopper(
                patience=args.patience,
                verbose=args.verbose,
                save_fn=lambda s: save_checkpoint(ckpt_path, s, metadata),
            )
            state, history = run_training(
                state,
                train_step,
                eval_step,
                train_batches=train_batches,
                val_batches=val_batches,
                epochs=args.epochs,
                lr_schedule=cosine_annealing_warm_restarts(
                    args.lr, t_0=args.t0, eta_min=args.eta_min
                ),
                early_stopper=stopper,
                verbose=args.verbose,
                seed=args.seed,
            )
            logging.info(
                "fold P%s done: best val %.4f", plot, stopper.best_loss
            )
            histories[plot] = history
    return histories


if __name__ == "__main__":
    main()
