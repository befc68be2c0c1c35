"""Repeat ``chip_smoke.py``'s PointNet2 training (13b) and pipeline run (13d)
several times, to see how far the cylinder count of one seeded training
spreads, and keep what a spread needs to be examined on another machine.

    python3 pn2_cylinder_repeats.py --out DIR [--runs 16] [--parallel 4]

Writes ``chip_smoke.py``'s training plots, rasterizes them as 13b does, then
trains 13b's hierarchical PointNet2 checkpoint (``--seed 0``, the same
arguments) ``--runs`` times, ``--parallel`` training processes at a time on
the one card. Each checkpoint then serves 13d's pipeline CLI on plot 1's
first tree (stage 2's target at ``PIPELINE_CLI_MIN_POINTS``), with the
stage-1 and stage-2 clouds saved. Under ``--out`` it leaves, per run, the
stage-1 and stage-2 clouds, the cylinder CSV and the SHA-256 of
``model.pt``; the checkpoints of the runs that fitted no cylinder and of
the first run that fitted some are copied beside them. Prints one line ``REPEATS {json}`` with each run's
cylinder count and checkpoint digest. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))


def run_all(cmds: list, parallel: int) -> list:
    """Each command from the repository root, ``parallel`` at a time;
    returns each one's completed process, in order. Raises if one fails."""
    done = [None] * len(cmds)
    for start in range(0, len(cmds), parallel):
        procs = [(i, subprocess.Popen(cmds[i], cwd=REPO, text=True,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
                 for i in range(start, min(start + parallel, len(cmds)))]
        for i, proc in procs:
            out, err = proc.communicate(timeout=900)
            if proc.returncode != 0:
                print(err[-4000:], file=sys.stderr)
                raise SystemExit(f"{' '.join(cmds[i][1:4])} exited "
                                 f"{proc.returncode}")
            done[i] = (out, err)
    return done


def sha256(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--runs", type=int, default=16)
    p.add_argument("--parallel", type=int, default=4)
    p.add_argument("--out", required=True,
                   help="directory for the clouds, CSVs and checkpoints")
    args = p.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch

    import chip_smoke as cs
    from treemorph_tpu_torch.preprocess import rasterize_clouds

    if not torch.cuda.is_available():
        print("pn2_cylinder_repeats: no CUDA device", file=sys.stderr)
        return 2
    print(cs.card_line(), flush=True)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        cs.write_training_plots(root)
        paths = sorted(glob.glob(os.path.join(root, "*_labeled.npy")))
        meta_path = os.path.join(root, "rasters.json")
        rasterize_clouds(paths, output_dir=root, json_path=meta_path,
                         raster_size=cs.PN2_RASTER, stride=cs.PN2_STRIDE,
                         store_metadata=True)
        train = []
        for i in range(args.runs):
            train.append([
                sys.executable, "-m", "treemorph_tpu_torch.train.cli",
                "pointnet2", "--test_plots", "1", "--depth",
                str(cs.PN2_DEPTH), "--bucket", "1024", "--save_dir",
                os.path.join(root, f"saves_{i}"), "--device", "cuda",
                "--hierarchical_json", meta_path, "--minibatch_size",
                str(cs.PN2_MINIBATCH), "--batch_size",
                str(cs.PN2_TREES_PER_STEP), "--epochs",
                str(cs.PN2_HIER_EPOCHS), "--name", "pointnet2"])
        run_all(train, args.parallel)
        print(f"[{time.perf_counter() - t0:.1f}] {args.runs} trainings done",
              flush=True)

        with open(os.path.join(root, "plot_1.json")) as f:
            tree = json.load(f)[0]
        inp = os.path.join(root, "pipeline_in")
        os.makedirs(inp)
        np.save(os.path.join(inp, "tree.npy"), np.load(tree))
        serve = []
        for i in range(args.runs):
            ckpt = os.path.join(root, f"saves_{i}", "pointnet2_CV")
            cfg = cs.pipeline_config(inp, os.path.join(root, f"out_{i}"),
                                     "pointnet2")
            cfg["general"]["save_upsampling"] = True
            cfg["stage2"]["min_points"] = cs.PIPELINE_CLI_MIN_POINTS
            cfg["model_dirs"] = {"pointnet2": [ckpt, ckpt]}
            path = os.path.join(root, f"pipeline_{i}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            serve.append([sys.executable, "-m",
                          "treemorph_tpu_torch.scripts.exec_pipeline",
                          "--config", path, "--device", "cuda"])
        outs = run_all(serve, args.parallel)
        print(f"[{time.perf_counter() - t0:.1f}] {args.runs} pipeline runs "
              "done", flush=True)

        runs, kept_nonzero = [], False
        for i, (stdout, _) in enumerate(outs):
            m = re.search(r"tree\.npy: (\d+) pts, (\d+) cylinders", stdout)
            cylinders = int(m.group(2)) if m else 0
            ckpt = os.path.join(root, f"saves_{i}", "pointnet2_CV")
            digest = sha256(os.path.join(ckpt, "P1", "model.pt"))
            dest = os.path.join(args.out, f"run_{i}")
            os.makedirs(dest, exist_ok=True)
            for f in glob.glob(os.path.join(root, f"out_{i}", "pointnet2",
                                            "*")):
                shutil.copy(f, dest)
            if cylinders == 0 or not kept_nonzero:
                shutil.copytree(ckpt, os.path.join(dest, "pointnet2_CV"))
                kept_nonzero = kept_nonzero or cylinders > 0
            runs.append({"run": i, "cylinders": cylinders,
                         "points": int(m.group(1)) if m else 0,
                         "model_sha256": digest[:16]})
            print(f"run {i}: {cylinders} cylinders, model.pt "
                  f"{digest[:16]}", flush=True)
    print("REPEATS " + json.dumps({
        "runs": runs, "seconds": time.perf_counter() - t0,
        "distinct_checkpoints": len({r["model_sha256"] for r in runs})}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
