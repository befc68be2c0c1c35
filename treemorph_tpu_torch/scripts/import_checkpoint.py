"""Convert a reference PyTorch checkpoint (.pt) into the port's layout.

    python -m treemorph_tpu_torch.scripts.import_checkpoint pointnet2 \
        model_P3.pt out_dir/model_P3 [--depth 5] [--dim_feat 4]
    python -m treemorph_tpu_torch.scripts.import_checkpoint treelearn \
        model_P3.pt out_dir/model_P3 [--channels 32] [--num_blocks 3] \
        [--flip_kernel] [--device cpu]

The port's counterpart of the JAX package's ``scripts/import_checkpoint.py``
with the same families and flags. It writes ``{output_path}/model.pt`` (the
port model's ``state_dict``) and the metadata manifest
``{output_path}.metadata.json``, so the output's parent directory loads
through :func:`treemorph_tpu_torch.evaluation.model_loaders.load_model`
(name the output with the reference's ``_P{plot}`` convention). The model
is built and the converted weights loaded into it on the CUDA device
unless ``--device`` names another (raises without one). PTv3 checkpoints
convert through :func:`treemorph_tpu_torch.train.import_torch.convert_ptv3`,
but, as in the JAX package, this script does not take them: activation
parity with the reference needs its per-element window padding, which the
port does not have yet.
"""

from __future__ import annotations

import argparse
import json
import os


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("family", choices=["pointnet2", "treelearn"])
    ap.add_argument("torch_checkpoint")
    ap.add_argument("output_path")
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--dim_feat", type=int, default=4)
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--num_blocks", type=int, default=3)
    ap.add_argument("--voxel_size", type=float, default=0.02)
    ap.add_argument("--flip_kernel", action="store_true",
                    help="reverse spconv kernel-offset order (see the "
                    "import_torch module docstring)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device; raises "
                         "without one)")
    args = ap.parse_args(argv)

    import torch

    from ..evaluation.model_loaders import build_model
    from ..train.checkpoints import MODEL_FILE
    from ..train.import_torch import (
        convert_pointnet2,
        convert_treelearn,
        load_state_dict,
    )

    if args.family == "pointnet2":
        meta = {"model_type": "pointnet2", "depth": args.depth,
                "dim_feat": args.dim_feat}
        model = build_model("pointnet2", device=args.device,
                            depth=args.depth, dim_feat=args.dim_feat)
        sd = load_state_dict(args.torch_checkpoint)
        state = convert_pointnet2(sd, model)
    else:
        meta = {
            "model_type": "treelearn", "channels": args.channels,
            "num_blocks": args.num_blocks, "dim_feat": args.dim_feat,
            "voxel_size": args.voxel_size,
        }
        model = build_model(
            "treelearn", device=args.device, channels=args.channels,
            num_blocks=args.num_blocks, dim_feat=args.dim_feat,
            voxel_size=args.voxel_size,
        )
        sd = load_state_dict(args.torch_checkpoint)
        state = convert_treelearn(sd, model, flip_kernel=args.flip_kernel)
    model.load_state_dict(state)

    out = os.path.abspath(args.output_path)
    os.makedirs(out, exist_ok=True)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               os.path.join(out, MODEL_FILE))
    meta["imported_from"] = os.path.abspath(args.torch_checkpoint)
    with open(out + ".metadata.json", "w") as f:
        json.dump(meta, f, indent=2)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"imported {n_params:,} params -> {out}")
    return out


if __name__ == "__main__":
    main()
