"""Run the end-to-end pipeline from a config file.

    python -m treemorph_tpu_torch.scripts.exec_pipeline \
        --config configs/pipeline_config.yaml [--device cpu]

The port's counterpart of the JAX package's ``scripts/exec_pipeline.py``
(reference ``PipelineExecution/exec_pipeline.py``), with the same config
schema (``configs/pipeline_config.yaml``). The config is YAML, read by
:func:`treemorph_tpu_torch.utils.config.load_config` (the subset the
shipped config uses; no YAML library is needed), or JSON for a ``.json``
path. The stage-1 models are the checkpoints under the config's
``model_dirs``: the port's training CLI's, or the JAX package's orbax
directories. Every stage runs on the CUDA device unless ``--device``
names another, and raises without one. Prints one line per cloud and
returns the per-cloud records.
"""

from __future__ import annotations

import argparse
import logging
import os


def main(argv=None) -> list:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--config", type=str,
        default=os.path.join("configs", "pipeline_config.yaml"),
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device; "
                             "raises without one)")
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    from ..pipeline.run import run_pipeline
    from ..utils.config import load_config

    cfg = load_config(args.config)
    results = run_pipeline(cfg, device=args.device)
    for r in results:
        print(
            f"{os.path.basename(r['cloud'])}: {r['points']} pts, "
            f"{r['cylinders']} cylinders, {r['seconds']:.1f}s"
        )
    return results


if __name__ == "__main__":
    main()
