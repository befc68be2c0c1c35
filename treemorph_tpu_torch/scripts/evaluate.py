"""Evaluation CLI: NN-distance eval, QSM-projection eval, predictions,
QSM-comparison and slice figures.

    python -m treemorph_tpu_torch.scripts.evaluate nn treelearn \
        --data_root DATA --test_plot 3 --offset_model_dir SAVES/treelearn_CV \
        [--engine band --conv_dtype bfloat16] [--device cpu]
    python -m treemorph_tpu_torch.scripts.evaluate predict treelearn \
        --manifest qsm_set_3.json --offset_model_dir O --outputDir OUT
    python -m treemorph_tpu_torch.scripts.evaluate qsm-distance \
        --cloud C.npy --pred_cloud P.npy --qsm_csv Q.csv
    python -m treemorph_tpu_torch.scripts.evaluate qsm-comp \
        --orig_dir ORIG --model_dirs M1 M2 --plot_path comp.png
    python -m treemorph_tpu_torch.scripts.evaluate slices \
        --pred_cloud P.npy --plot_path slices.png

The port's counterpart of the JAX package's ``scripts/evaluate.py`` (the
reference ModelTestingScripts: ``test_{model}.py`` -> ``nn``;
``predict_qsm_trees_{model}.py`` / ``predict_all_trees_{model}.py`` ->
``predict``; ``project_preds_on_qsm.py`` + ``Evaluate_preds_on_qsm.py`` ->
``qsm-distance``; the ``qsm_comp_new*`` and ``slice_plotting.py`` figures
-> ``qsm-comp`` and ``slices``), with the same flags. ``nn``, ``predict``
and ``qsm-distance`` run on the CUDA device unless ``--device`` names
another, and raise without one; ``nn`` and ``predict`` also take the
training CLI's ``--engine`` and ``--conv_dtype``, which a checkpoint does
not record (TreeLearn's conv engine and type, PTv3's stem engine and
compute type; unset, the family defaults). ``qsm-comp`` and ``slices``
are host work. QSM CSVs are read with
:meth:`treemorph_tpu_torch.utils.table.Table.read_csv`, whose header names
come stripped and unquoted.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

FAMILIES = ["treelearn", "pointnet2", "pointtransformerv3"]


def parser() -> argparse.ArgumentParser:
    p0 = argparse.ArgumentParser(description="Evaluation tools")
    sub = p0.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA device; "
                            "raises without one)")

    def engine_flags(p):
        p.add_argument("--engine", default=None, choices=["gather", "band"],
                       help="TreeLearn conv engine, PTv3 stem engine "
                       "(default: the family's)")
        p.add_argument("--conv_dtype", default=None,
                       choices=["float32", "bfloat16"],
                       help="TreeLearn conv dtype, PTv3 compute dtype "
                       "(default: the family's)")

    p = sub.add_parser("nn", help="NN-distance shrinkage eval")
    p.add_argument("model", choices=FAMILIES)
    p.add_argument("--data_root", required=True)
    p.add_argument("--test_plot", type=int, default=3)
    p.add_argument("--offset_model_dir", required=True)
    p.add_argument("--rasterized", action="store_true")
    p.add_argument("--max_trees", type=int, default=None)
    p.add_argument("--plot_path", default=None)
    p.add_argument(
        "--scaled_plot_path", default=None,
        help="piecewise-scaled NND comparison with per-plot scatter and "
        "power-law fit (reference NN_eval.py:297-688)",
    )
    engine_flags(p)
    device_flag(p)

    p = sub.add_parser("predict", help="export refined clouds for a manifest")
    p.add_argument("model", choices=FAMILIES)
    p.add_argument("--manifest", required=True,
                   help="JSON list of cloud paths (e.g. qsm_set_3.json)")
    p.add_argument("--offset_model_dir", required=True)
    p.add_argument("--noise_model_dir", default=None)
    p.add_argument("--outputDir", required=True)
    p.add_argument("--save_type", default="txt")
    engine_flags(p)
    device_flag(p)

    p = sub.add_parser("qsm-distance", help="cloud vs fitted-QSM distances")
    p.add_argument("--cloud", required=True)
    p.add_argument("--pred_cloud", required=True)
    p.add_argument("--qsm_csv", required=True)
    p.add_argument("--plot_path", default=None)
    device_flag(p)

    p = sub.add_parser(
        "qsm-comp",
        help="QSM comparison figures over projected-cloud directories "
        "(reference qsm_comp_new.py / _testset_proportion.py)",
    )
    p.add_argument("--orig_dir", required=True,
                   help="directory of original projected clouds")
    p.add_argument("--model_dirs", required=True, nargs="+",
                   help="one directory of projected clouds per model")
    p.add_argument("--model_labels", nargs="+", default=None)
    p.add_argument("--suffix", default="_projected.npy")
    p.add_argument(
        "--orig_suffix", default=None,
        help="trainset/old-dataset pairing: match model files to "
        "'{id}{orig_suffix}' originals by the first two name tokens "
        "(reference qsm_comp_new.py:91-152)",
    )
    p.add_argument("--plot_path", required=True)
    p.add_argument("--per_tree_plot_path", default=None)

    p = sub.add_parser(
        "slices",
        help="original/transformed slice grid of a predicted cloud "
        "(reference slice_plotting.py)",
    )
    p.add_argument("--pred_cloud", required=True,
                   help="cloud with xyz in cols 0:3 and offsets in 3:6")
    p.add_argument("--plot_path", required=True)
    p.add_argument("--bounds", default=None,
                   help="JSON list of [xmin,xmax,ymin,ymax,zmin,zmax]")
    p.add_argument("--views", default=None,
                   help="JSON list of view dirs ('z'|'y') per bound")
    p.add_argument("--orig_qsm", default=None,
                   help="original QSM CSV: render the cylinder-overlay "
                   "comparison instead (qsm_comp_new_visual.py)")
    p.add_argument("--enhanced_qsm", default=None,
                   help="pipeline QSM CSV (with --orig_qsm)")
    return p0


def build_overrides(args) -> dict:
    """``load_model`` overrides of ``--engine`` / ``--conv_dtype``."""
    names = {"treelearn": ("engine", "conv_dtype"),
             "pointtransformerv3": ("stem_engine", "compute_dtype")}
    if args.model not in names:
        return {}
    engine, dtype = names[args.model]
    out = {}
    if args.engine is not None:
        out[engine] = args.engine
    if args.conv_dtype is not None:
        out[dtype] = args.conv_dtype
    return out


def run_nn(args) -> dict:
    import numpy as np

    from ..data import get_plot_split
    from ..evaluation.model_loaders import load_model
    from ..evaluation.nn_eval import (
        nn_eval,
        plot_nn_distances,
        plot_nn_distances_scaled,
        plot_of_path,
        summarize_nn_records,
    )
    from ..ops.cuda import LAUNCHES

    _, testset = get_plot_split(args.data_root, args.test_plot)
    models = load_model(args.model, offset_model_dir=args.offset_model_dir,
                        device=args.device, **build_overrides(args))
    launched = dict(LAUNCHES)
    records = nn_eval(
        models,
        testset,
        model_type=args.model,
        rasterized=args.rasterized or args.model == "pointnet2",
        max_trees=args.max_trees,
        device=args.device,
    )
    summary = summarize_nn_records(records)
    print(json.dumps(summary, indent=2))
    launches = {k: v - launched.get(k, 0) for k, v in LAUNCHES.items()
                if v != launched.get(k, 0)}
    print("hand kernel launches: " + json.dumps(
        {"trees": len(records), "launches": launches}))
    if args.plot_path:
        plot_nn_distances(records, args.plot_path)
        print(f"plot written to {args.plot_path}")
    if args.scaled_plot_path:
        before = np.concatenate([r["nn_before"] for r in records])
        after = np.concatenate([r["nn_after"] for r in records])
        plots = np.concatenate(
            [
                np.full(len(r["nn_before"]), plot_of_path(r["path"]))
                for r in records
            ]
        )
        plot_nn_distances_scaled(
            before, after, args.scaled_plot_path,
            title=f"NND Comparison {args.model}",
            tree_plots=list(plots), color_by_plot=True,
            show_scatter=True, show_fit=True,
        )
        print(f"plot written to {args.scaled_plot_path}")
    return summary


def run_predict(args) -> list[str]:
    from ..evaluation.model_loaders import load_model
    from ..pipeline.predict import make_predictions
    from ..utils.io import load_cloud, save_cloud

    models = load_model(
        args.model,
        offset_model_dir=args.offset_model_dir,
        noise_model_dir=args.noise_model_dir,
        device=args.device,
        **build_overrides(args),
    )
    offset_model = next(
        (models[k] for k in sorted(models) if k.startswith("O")), None
    )
    noise_model = next(
        (models[k] for k in sorted(models) if k.startswith("N")), None
    )
    with open(args.manifest) as f:
        paths = json.load(f)
    os.makedirs(args.outputDir, exist_ok=True)
    written = []
    for path in paths:
        cloud = load_cloud(path, all_columns=True)
        if cloud is None:
            continue
        base = os.path.splitext(os.path.basename(path))[0]
        pred = make_predictions(
            cloud, args.model, offset_model, None,
            predict_offset=True, denoise=False, device=args.device,
        )
        written.append(save_cloud(
            pred, os.path.join(args.outputDir, base + "_pred"),
            args.save_type,
        ))
        if noise_model is not None:
            denoised = make_predictions(
                cloud, args.model, offset_model, noise_model,
                predict_offset=True, denoise=True, device=args.device,
            )
            written.append(save_cloud(
                denoised,
                os.path.join(args.outputDir, base + "_pred_denoised"),
                args.save_type,
            ))
    print(f"predicted {len(paths)} clouds -> {args.outputDir}")
    return written


def run_qsm_distance(args) -> dict:
    from ..evaluation.qsm_eval import (
        compare_distance_distributions,
        plot_qsm_distance_comparison,
        project_on_qsm,
    )
    from ..utils.device import resolve_device
    from ..utils.io import load_cloud
    from ..utils.table import Table

    device = resolve_device(args.device)
    orig = load_cloud(args.cloud)
    pred = load_cloud(args.pred_cloud)
    qsm = Table.read_csv(args.qsm_csv)
    d_orig = project_on_qsm(orig, qsm, device=device)
    d_pred = project_on_qsm(pred, qsm, device=device)
    stats = compare_distance_distributions(d_orig, d_pred)
    print(json.dumps(stats, indent=2))
    if args.plot_path:
        plot_qsm_distance_comparison(d_orig, d_pred, args.plot_path)
        print(f"plot written to {args.plot_path}")
    return stats


def run_qsm_comp(args) -> dict:
    from ..plotting.qsm_comparison import (
        load_pointwise_distance_pairs,
        mean_distance_and_error,
        per_tree_mean_distances,
        plot_per_tree_mean_distances,
        plot_qsm_comparison,
    )

    labels = args.model_labels or [
        os.path.basename(os.path.normpath(d)) for d in args.model_dirs
    ]
    means, errs, imps, imp_errs = [], [], [], []
    scatter_o = scatter_m = None
    for d in args.model_dirs:
        d_o, d_m = load_pointwise_distance_pairs(
            args.orig_dir, d, args.suffix, orig_suffix=args.orig_suffix,
        )
        if scatter_o is None:  # scatter panel = first model's pairs
            scatter_o, scatter_m = d_o, d_m
        mean, err, _ = mean_distance_and_error(d_m)
        imp, imp_err, _ = mean_distance_and_error(d_o - d_m)
        means.append(mean)
        errs.append(err)
        imps.append(imp)
        imp_errs.append(imp_err)
    plot_qsm_comparison(
        scatter_o, scatter_m, means, errs, imps, imp_errs, labels,
        args.plot_path,
    )
    record = {"models": labels, "mean_dists": means, "improvements": imps}
    print(json.dumps(record))
    print(f"plot written to {args.plot_path}")
    if args.per_tree_plot_path:
        m_o, m_n, _ = per_tree_mean_distances(
            args.orig_dir, args.model_dirs[0], args.suffix
        )
        plot_per_tree_mean_distances(m_o, m_n, args.per_tree_plot_path)
        print(f"plot written to {args.per_tree_plot_path}")
    return record


def run_slices(args) -> str:
    from ..plotting.qsm_comparison import (
        REFERENCE_SLICE_BOUNDS,
        REFERENCE_SLICE_VIEWS,
        plot_qsm_comparison_slices,
        plot_transformation_slices,
    )
    from ..utils.io import load_cloud
    from ..utils.table import Table

    cloud = load_cloud(args.pred_cloud, all_columns=True)
    bounds = (
        json.loads(args.bounds) if args.bounds else REFERENCE_SLICE_BOUNDS
    )
    views = json.loads(args.views) if args.views else REFERENCE_SLICE_VIEWS
    if args.orig_qsm and args.enhanced_qsm:
        tables = [Table.read_csv(p) for p in (args.orig_qsm,
                                              args.enhanced_qsm)]
        plot_qsm_comparison_slices(
            cloud[:, :3], tables[0], tables[1], args.plot_path,
            bounds=bounds, views=views,
        )
    else:
        plot_transformation_slices(
            cloud[:, :3], cloud[:, 3:6], args.plot_path,
            bounds=bounds, views=views,
        )
    print(f"plot written to {args.plot_path}")
    return args.plot_path


COMMANDS = {"nn": run_nn, "predict": run_predict,
            "qsm-distance": run_qsm_distance, "qsm-comp": run_qsm_comp,
            "slices": run_slices}


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    main()
