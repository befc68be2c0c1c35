"""Training CLI, the port's counterpart of ``scripts/train.py`` for all
three families:

    python -m treemorph_tpu_torch.train.cli treelearn --data_root DIR \\
        [--test_plots 3 4 6 8] [--engine band --conv_dtype bfloat16] \\
        [--engine zpack|pencil|brick] [--device cpu]
    python -m treemorph_tpu_torch.train.cli pointtransformerv3 \\
        --data_root DIR [--batch_size 4] \\
        [--engine band --dedup_divisor 4 --conv_dtype bfloat16]
    python -m treemorph_tpu_torch.train.cli pointnet2 \\
        --hierarchical_json R.json [...] [--minibatch_size 20] \\
        [--per_minibatch_steps] [--depth 5]
    python -m treemorph_tpu_torch.train.cli pointnet2 --raster_dir DIR

Per-plot cross-validation over ``--test_plots``: leave-one-plot-out over
the ``plot_{n}.json`` manifests in ``--data_root``, over the raster files
of ``--raster_dir`` (split by their ``{plot}_`` prefix, each raster a
sample), or over the trees of ``--hierarchical_json`` (the rasterizer's
AABB metadata, trees split by their key's plot prefix). In hierarchical
mode the gradients of each tree batch's raster minibatches accumulate into
one optimizer step (``--batch_size`` trees a step, the reference's
semantics); ``--per_minibatch_steps`` steps once per minibatch instead.
AdamW (weight decay 1e-3) with CosineAnnealingWarmRestarts(T_0=50,
eta_min=1e-4), the x50 loss scale and global-norm clip 1.0, early stopping
with best-checkpoint saves to ``{save_dir}/{name}_CV/P{plot}/``, loss
multipliers and noise-cloud training. TreeLearn's level-0 voxel capacity is
worked out from the fold's clouds (:func:`level0_capacity`). PTv3 is the
pipeline's model at full width (``scripts/train.py:130-143``: features on,
``--dim_feat``, ``--voxel_size``, ``--conv_dtype`` as its compute dtype,
``--engine`` as its stem engine, ``pencil`` meaning gather, and
``--dedup_divisor``; any engine but ``band`` and ``zpack`` trains PTv3 on
the gather path, as the JAX package's PTv3 takes it), each step drawing
its order shuffles and drop-path masks from a generator derived from
``--seed``; PointNet2 draws its FPS starts from it. It runs on the CUDA device unless ``--device`` names
another, and raises without one. No YAML parser is needed.

Data parallelism (``scripts/train.py:48, :190``): where more than one CUDA
card is visible the CLI trains on ``--n_devices`` of them (all by default),
one rank a card: a single command starts the ranks itself
(``torch.multiprocessing`` over a file store), and under ``torchrun``
(``RANK`` and ``WORLD_SIZE`` set) it takes the ranks it is given. Each
global batch is split over the ranks (:mod:`treemorph_tpu_torch.parallel`),
TreeLearn's level-0 voxel capacity is worked out for a rank's share of a
batch, and only rank 0 logs and writes checkpoints. ``--device cpu
--n_devices N`` runs N ranks on the CPU over gloo.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import tempfile

import numpy as np
import torch

def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a tree-morphology model")
    p.add_argument("model", choices=["treelearn", "pointnet2",
                                     "pointtransformerv3"])
    p.add_argument("--data_root", type=str, default=None,
                   help="directory with plot_{n}.json manifests "
                        "(required unless --raster_dir or "
                        "--hierarchical_json)")
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
    p.add_argument("--n_devices", type=int, default=None,
                   help="data-parallel devices (default: every visible "
                        "CUDA card; with --device cpu, 1)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--raster_dir", type=str, default=None,
                   help="train on rasterized crops (flattened mode, each "
                        "raster a sample) from this rasterizer output "
                        "directory")
    p.add_argument("--hierarchical_json", type=str, nargs="+", default=None,
                   help="train on trees cut into rasters by these AABB "
                        "metadata JSONs: each tree batch's raster "
                        "minibatches accumulate into one optimizer step")
    p.add_argument("--minibatch_size", type=int, default=20,
                   help="rasters per minibatch in hierarchical mode")
    p.add_argument("--per_minibatch_steps", action="store_true",
                   help="hierarchical mode: one optimizer step per raster "
                        "minibatch instead of one per tree batch")
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
    p.add_argument("--depth", type=int, default=5, help="pointnet2 depth")
    p.add_argument("--dim_feat", type=int, default=4)
    p.add_argument("--engine", default="gather",
                   choices=["gather", "band", "zpack", "pencil", "brick"],
                   help="TreeLearn conv engine (band = the band conv "
                   "kernels; gather, band, zpack and pencil share one "
                   "parameter layout, so their checkpoints are "
                   "interchangeable; brick names its blocks' own); PTv3 "
                   "stem engine (band or zpack; pencil and brick mean "
                   "gather)")
    p.add_argument("--conv_dtype", default="float32",
                   choices=["float32", "bfloat16"],
                   help="conv compute dtype (f32 accumulation); PTv3's "
                        "compute dtype")
    p.add_argument("--dedup_divisor", type=int, default=None,
                   help="PTv3: run level-0 convs once per unique voxel "
                        "(cap = points // divisor; overflow is reported); "
                        "None = off")
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


def build(args, batch_size: int, voxel_size: float, capacity, group=None):
    """The family's model (initialized from ``--seed``, on the CPU), its
    (forward_fn, loss_fn), whose loss reduces over ``group`` (a data-parallel
    mesh, or ``None``), and the checkpoint metadata ``load_model`` rebuilds
    the model from (``scripts/train.py::build``)."""
    from ..models.pointnet2 import PointNet2
    from ..models.ptv3 import PointTransformerWithHeads
    from ..models.treelearn import TreeLearn
    from . import families

    losses = (args.loss_multiplier_semantic, args.loss_multiplier_offset,
              group)
    metadata = {"model": args.model, "voxel_size": voxel_size,
                "dim_feat": args.dim_feat}
    if args.model == "pointnet2":
        model = PointNet2(depth=args.depth, dim_feat=args.dim_feat)
        metadata["depth"] = args.depth
        return (families.init_pointnet2(model, args.seed),
                families.pointnet2_family(*losses), metadata)
    if args.model == "pointtransformerv3":
        model = PointTransformerWithHeads(
            dim_feat=args.dim_feat, use_feats=True, voxel_size=voxel_size,
            dedup_divisor=args.dedup_divisor,
            stem_engine="gather" if args.engine == "pencil" else args.engine,
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


def _plot_of(name: str) -> str:
    """The plot prefix of a raster file or tree key ('3_12_raster4.npy',
    '3_12' -> '3')."""
    return os.path.basename(name).split("_")[0]


def fold_datasets(args, plot):
    """The CV fold holding out ``plot``: ``(trainset, valset)``."""
    from ..data import (
        HierarchicalRasterDataset,
        RasterDataset,
        get_plot_split,
    )

    if args.hierarchical_json is not None:
        def make_ds(training):
            ds = HierarchicalRasterDataset(
                args.hierarchical_json, training=training,
                noise_distance=args.noise_distance,
                minibatch_size=args.minibatch_size,
            )
            ds.tree_keys = [k for k in ds.tree_keys
                            if (_plot_of(k) == str(plot)) != training]
            return ds

        trainset, valset = make_ds(True), make_ds(False)
    elif args.raster_dir is not None:
        paths = sorted(os.path.join(args.raster_dir, f)
                       for f in os.listdir(args.raster_dir)
                       if f.endswith(".npy"))
        test_paths = [q for q in paths if _plot_of(q) == str(plot)]
        held_out = set(test_paths)
        trainset = RasterDataset([q for q in paths if q not in held_out],
                                 True, noise_distance=args.noise_distance)
        valset = RasterDataset(test_paths, False,
                               noise_distance=args.noise_distance)
    else:
        trainset, valset = get_plot_split(
            args.data_root, plot, noise_distance=args.noise_distance,
            noise_root=args.noise_root,
        )
    return trainset, valset


def fold_batches(args, plot, trainset, valset):
    """``(example, train_batches, val_batches, grouped)`` of the fold:
    ``train_batches(epoch)`` yields groups of minibatches when ``grouped``
    (hierarchical mode with accumulation), else batches."""
    from ..data import (
        batch_iterator,
        hierarchical_batch_iterator,
        hierarchical_group_iterator,
    )

    rng_np = np.random.default_rng(args.seed)
    if args.hierarchical_json is None:
        if len(trainset) == 0:
            raise SystemExit(f"no training samples for plot {plot}")
        example = next(batch_iterator(trainset, args.batch_size, args.bucket,
                                      shuffle=False))
        return (
            example,
            lambda epoch: batch_iterator(trainset, args.batch_size,
                                         args.bucket, rng=rng_np),
            lambda epoch: batch_iterator(valset, args.batch_size,
                                         args.bucket, shuffle=False),
            False,
        )
    try:
        example = next(hierarchical_batch_iterator(trainset, args.bucket))
    except StopIteration:
        raise SystemExit(
            f"no training rasters for plot {plot}: the hierarchical "
            "metadata contains no trees outside the held-out plot (check "
            "--hierarchical_json against --test_plots)"
        ) from None
    if args.per_minibatch_steps:
        def train_batches(epoch):
            return hierarchical_batch_iterator(trainset, args.bucket,
                                               rng=rng_np)
    else:
        def train_batches(epoch):
            return hierarchical_group_iterator(
                trainset, args.bucket, rng=rng_np,
                trees_per_step=args.batch_size)
    return (
        example, train_batches,
        lambda epoch: hierarchical_batch_iterator(valset, args.bucket),
        not args.per_minibatch_steps,
    )


def world_size(args) -> int:
    """The number of data-parallel ranks: ``--n_devices`` (default: all)
    of the visible CUDA cards where more than one is visible, else one;
    ``--n_devices`` ranks on the CPU."""
    from ..utils.device import resolve_device

    if resolve_device(args.device).type != "cuda":
        return args.n_devices or 1
    count = torch.cuda.device_count()
    if count <= 1:
        return 1
    n = args.n_devices or count
    if n > count:
        raise SystemExit(f"--n_devices {n}: only {count} CUDA cards visible")
    return n


def _rank_main(mesh, args, out_path):
    """One rank of a training that :func:`main` started: train as that
    rank; rank 0 writes the histories to ``out_path`` for the caller."""
    histories = train_folds(args, mesh)
    if mesh.is_main:
        with open(out_path, "w") as f:
            json.dump({str(k): v for k, v in histories.items()}, f)
    return histories


def main(argv=None) -> dict:
    """Train every CV fold; returns ``{plot: history}``."""
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if (args.data_root is None and args.raster_dir is None
            and args.hierarchical_json is None):
        raise SystemExit("one of --data_root / --raster_dir / "
                         "--hierarchical_json is required")
    from ..parallel import make_mesh, spawn_ranks
    from ..utils.device import resolve_device

    # the ranks' devices: their cards (LOCAL_RANK or the rank), or the CPU
    on_cpu = resolve_device(args.device).type != "cuda"
    if int(os.environ.get("WORLD_SIZE", 1)) > 1:  # under torchrun
        return train_folds(args, make_mesh(
            args.n_devices, device="cpu" if on_cpu else None))
    n = world_size(args)
    if n == 1:
        return train_folds(args, None)
    with tempfile.TemporaryDirectory() as tmp:
        out_path = os.path.join(tmp, "histories.json")
        spawn_ranks(_rank_main, n, args, out_path, store_dir=tmp,
                    devices=["cpu"] * n if on_cpu else None)
        with open(out_path) as f:
            return {int(k): v for k, v in json.load(f).items()}


def train_folds(args, mesh=None) -> dict:
    """Train every CV fold on this process's device, or as this rank of
    ``mesh``; returns ``{plot: history}``."""
    from ..data import RasterDataset, TreeDataset
    from ..utils.device import resolve_device
    from ..utils.early_stopping import EarlyStopper
    from .checkpoints import save_checkpoint
    from .harness import (
        TrainState,
        make_accum_steps,
        make_eval_step,
        make_optimizer,
        make_train_step,
        run_training,
    )
    from .schedule import cosine_annealing_warm_restarts

    main_rank = mesh is None or mesh.is_main
    if not main_rank:
        logging.getLogger().setLevel(logging.WARNING)
    device = mesh.device if mesh is not None else resolve_device(args.device)
    ranks = 1 if mesh is None else mesh.size

    name = args.name or args.model
    histories = {}
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        for plot in args.test_plots:
            logging.info("=== CV fold: test plot %s ===", plot)
            trainset, valset = fold_datasets(args, plot)
            voxel_size = args.voxel_size or 0.02
            capacity = None
            if args.model == "treelearn" and isinstance(
                    trainset, (TreeDataset, RasterDataset)):
                # random_scale grows a cloud by up to 5 %, its voxels by up
                # to 1.05^3; a rank voxelizes its own share of a batch
                capacity = level0_capacity(
                    (trainset, valset), -(-args.batch_size // ranks),
                    voxel_size, 1.02 * (1.05**3 if args.augment else 1.0),
                )
                logging.info("level-0 voxel capacity %d", capacity)
            if args.augment:
                from ..data.augmentations import default_augmentations

                trainset.augment = default_augmentations()
            example, train_batches, val_batches, grouped = fold_batches(
                args, plot, trainset, valset)

            model, (forward_fn, loss_fn), metadata = build(
                args, -(-example.batch_size // ranks), voxel_size, capacity,
                group=mesh)
            model = model.to(device)
            fixed = tuple(args.fixed_modules or ())
            state = TrainState(
                model, make_optimizer(model, args.weight_decay, fixed)
            )
            train_step = make_train_step(forward_fn, loss_fn, fixed, mesh)
            eval_step = make_eval_step(forward_fn, loss_fn, mesh)
            accum_steps = (make_accum_steps(forward_fn, loss_fn, fixed, mesh)
                           if grouped else None)

            ckpt_path = os.path.join(args.save_dir, f"{name}_CV", f"P{plot}")
            metadata.update(plot=plot, noise_distance=args.noise_distance)
            stopper = EarlyStopper(
                patience=args.patience,
                verbose=args.verbose and main_rank,
                save_fn=((lambda s: save_checkpoint(ckpt_path, s, metadata))
                         if main_rank else None),
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
                mesh=mesh,
                verbose=args.verbose,
                accum_steps=accum_steps,
                seed=args.seed,
            )
            logging.info(
                "fold P%s done: best val %.4f", plot, stopper.best_loss
            )
            histories[plot] = history
    return histories


if __name__ == "__main__":
    main()
