"""Preprocessing CLI: label generation, noise generation, rasterizing,
dataset splits.

    python -m treemorph_tpu_torch.scripts.preprocess label \
        --cloudDir RAW --cylinderDir QSM --labelDir DATA/cloud [--device cpu]
    python -m treemorph_tpu_torch.scripts.preprocess noise \
        --cylinderDir QSM --labelDir DATA/noise
    python -m treemorph_tpu_torch.scripts.preprocess split --data_root DATA

The port's counterpart of the JAX package's ``scripts/preprocess.py``
(reference ``LabelGenerationCuda.py``, ``NoiseDataGeneration.py``,
``RasterizeClouds.py``, ``DataSplitting.py``, ``CreateQSMTestData.py``,
``SelectTestData.py``), with the same subcommands and flags. Labeling runs
on the CUDA device unless ``--device`` names another, and raises without
one; the other subcommands are host work.
"""

from __future__ import annotations

import argparse
import logging
import os


def parser() -> argparse.ArgumentParser:
    p0 = argparse.ArgumentParser(description="Preprocessing tools")
    sub = p0.add_subparsers(dest="command", required=True)

    def device_flag(p):
        p.add_argument("--device", default=None,
                       help="torch device (default: the CUDA device; "
                            "raises without one)")

    p = sub.add_parser("label", help="project clouds onto QSMs -> labels")
    p.add_argument("--cloudDir", required=True)
    p.add_argument("--cylinderDir", required=True)
    p.add_argument("--labelDir", required=True)
    p.add_argument("--no_features", action="store_true")
    device_flag(p)

    p = sub.add_parser("noise", help="generate synthetic noise clouds")
    p.add_argument("--cylinderDir", required=True)
    p.add_argument("--labelDir", required=True)
    p.add_argument("--density", type=float, default=50.0)
    device_flag(p)

    p = sub.add_parser("rasterize", help="cut clouds into cubic rasters")
    p.add_argument("--dataDir", required=True)
    p.add_argument("--outputDir", default=None)
    p.add_argument("--jsonPath", default=None)
    p.add_argument("--raster_size", type=float, default=1.0)
    p.add_argument("--stride", type=float, default=None)
    p.add_argument("--store_metadata", action="store_true")

    p = sub.add_parser("split", help="train/test + per-plot CV manifests")
    p.add_argument("--data_root", required=True)
    p.add_argument("--test_size", type=float, default=0.15)
    p.add_argument("--raster_metadata", action="store_true")

    p = sub.add_parser("qsmset", help="sample QSM test sets per plot")
    p.add_argument("--dataDir", required=True)
    p.add_argument("--outputDir", required=True)
    p.add_argument("--n_per_plot", type=int, default=10)

    p = sub.add_parser(
        "select-subset",
        help="copy a random external-testset subset with matching QSMs "
        "(reference SelectTestData.py)")
    p.add_argument("--cloudDir", required=True)
    p.add_argument("--qsmDir", required=True)
    p.add_argument("--outCloudDir", required=True)
    p.add_argument("--outQsmDir", required=True)
    p.add_argument("--n", type=int, default=40)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--cloud_suffix", default=".laz")
    return p0


def main(argv=None):
    args = parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from .. import preprocess
    from ..preprocess.noise_generation import noise_generation

    if args.command == "label":
        written = preprocess.label_clouds(
            args.cloudDir, args.cylinderDir, args.labelDir,
            use_features=not args.no_features, device=args.device)
        print(f"labeled {len(written)} clouds")
        return written
    if args.command == "noise":
        written = noise_generation(
            args.cylinderDir, args.labelDir, density=args.density,
            device=args.device)
        print(f"generated {len(written)} noise clouds")
        return written
    if args.command == "rasterize":
        paths = sorted(
            os.path.join(args.dataDir, f)
            for f in os.listdir(args.dataDir)
            if f.endswith((".npy", ".las", ".laz", ".txt")))
        meta = preprocess.rasterize_clouds(
            paths, output_dir=args.outputDir, json_path=args.jsonPath,
            raster_size=args.raster_size, stride=args.stride,
            store_metadata=args.store_metadata)
        print(f"rasterized {len(paths)} clouds")
        return meta
    if args.command == "split":
        name = ("rasters_metadata.json" if args.raster_metadata
                else "cloud")
        out = preprocess.split_dataset(
            os.path.join(args.data_root, name), args.data_root,
            test_size=args.test_size, raster_metadata=args.raster_metadata)
        print("split complete")
        return out
    if args.command == "qsmset":
        sets = preprocess.create_qsm_test_sets(
            args.dataDir, args.outputDir, n_per_plot=args.n_per_plot)
        print(f"created {len(sets)} qsm sets")
        return sets
    copied = preprocess.select_test_subset(
        args.cloudDir, args.qsmDir, args.outCloudDir, args.outQsmDir,
        n=args.n, seed=args.seed, cloud_suffix=args.cloud_suffix)
    print(f"copied {len(copied)} cloud/QSM pairs")
    return copied


if __name__ == "__main__":
    main()
