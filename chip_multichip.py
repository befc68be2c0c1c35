#!/usr/bin/env python3
"""Data parallelism of treemorph_tpu_torch over the CUDA cards of one host.

    python3 chip_multichip.py [--n_devices N] [--device cuda:0]

The port's counterpart of ``__graft_entry__.py::dryrun_multichip``: one
process a card (NCCL, ``N`` ranks, all visible cards by default; at least
two), each running one data-parallel train step of each family on its rows
of the family's training batch, built as ``chip_smoke.py`` builds it:

- TreeLearn (the training CLI's, band engine, f32 and bf16) on the first
  30-tree x 16,384-point batch of the training plots, padded to a multiple
  of the world size (32 on four cards);
- PTv3 (the CLI's, full width, f32) on the first 4 trees, one a card on
  four;
- PointNet2 (depth 5, f32) on 60 rasters x 4,096 points.

Each rank must launch the family's hand kernels (``KERNELS``: the band
kernels in TreeLearn's step, both attention kernels in PTv3's; PointNet2
has none). Each rank's first step (from the seeded weights) is held to the plain
emulation of the data-parallel step on one card (``chip_smoke.
dp_emulated_step``: each shard's forward, its numerators over the global
denominators, autograd's sum, BN statistics averaged) at
``chip_smoke.DP_GATES``; then each rank times ``REPS`` more steps, set
beside the one-card step on the whole batch (``dp_plain_step``, after the
ranks have exited). Last, ``predict_rasterized_sharded`` runs the
PointNet2 plot over every card (``chip_smoke.phase_sharded_predict``).
Prints the card's name and power limit, every check, and as its last line
``MULTICHIP {json}`` (step seconds, launches per rank, errors). Builds the
kernels from the checkout (``chip_smoke.phase_card_and_build``). Exits
non-zero when a check fails or fewer than two cards are visible.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
#: timed steps after each rank's compared first step, and of the one-card
#: step
REPS = 3
#: (family, compute dtypes) of the run
FAMILIES = (("treelearn", ("float32", "bfloat16")),
            ("pointtransformerv3", ("float32",)),
            ("pointnet2", ("float32",)))
#: one rank a card, as ``torchrun`` would start them
BACKEND = "nccl"
#: the hand kernels each family's step must launch in every rank
KERNELS = {"treelearn": ("band_conv", "band_conv_bwd"),
           "pointtransformerv3": ("window_attention", "window_attention_bwd"),
           "pointnet2": ()}


def rank_main(mesh, root, capacity):
    """One rank: every family's steps (``chip_smoke.dp_rank_main``), each
    into ``root/{family}/rank{r}.pt``."""
    import chip_smoke as cs

    for family, dtypes in FAMILIES:
        cs.dp_rank_main(mesh, family, root, capacity, dtypes,
                        os.path.join(root, family), REPS)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n_devices", type=int, default=None)
    p.add_argument("--device", default="cuda:0",
                   help="the device of the one-card references")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("chip_multichip: needs at least two CUDA cards",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "treemorph_tpu_torch")):
        print("chip_multichip: treemorph_tpu_torch/ not found beside the "
              "script", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from treemorph_tpu_torch.parallel import make_local_mesh, spawn_ranks

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    world = args.n_devices or torch.cuda.device_count()
    device = torch.device(args.device)
    t0 = time.perf_counter()
    cs.phase_card_and_build()
    record = {"card": cs.card_line(), "world": world, "steps": {}}
    with tempfile.TemporaryDirectory() as root:
        cs.write_training_plots(root)
        capacity = cs.dp_capacity(root, world)
        outs = {family: os.path.join(root, family) for family, _ in FAMILIES}
        for out in outs.values():
            os.makedirs(out)
        t1 = time.perf_counter()
        spawn_ranks(rank_main, world, root, capacity, backend=BACKEND,
                    store_dir=root)
        cs.log(f"{world} {BACKEND} ranks: {time.perf_counter() - t1:.1f} s "
               "with their start")
        ok = True
        for family, dtypes in FAMILIES:
            batch = cs.dp_batch(root, family)
            cap = cs.dp_capacity(root, 1) if family == "treelearn" else None
            ranks = [torch.load(os.path.join(outs[family], f"rank{r}.pt"))
                     for r in range(world)]
            for dtype in dtypes:
                emulated = cs.dp_emulated_step(family, batch, world,
                                               capacity, dtype, device)
                plain = cs.dp_plain_step(family, batch, cap, dtype, device,
                                         REPS)
                label = f"{family} {dtype}, {world} cards"
                errors = []
                for r, res in enumerate(ranks):
                    try:
                        errors.append(cs.dp_compare(
                            f"{label}, rank {r}", family, res[dtype],
                            emulated, dtype))
                    except AssertionError as err:
                        cs.log(f"FAIL {err}")
                        ok = False
                    missing = [k for k in KERNELS[family]
                               if not res[dtype]["launches"].get(k)]
                    if missing:
                        cs.log(f"FAIL {label}, rank {r}: no launch of "
                               f"{missing}")
                        ok = False
                per_rank = [statistics.median(res[dtype]["step_seconds"])
                            for res in ranks]
                step = {
                    "rows_per_rank": ranks[0][dtype]["rows"],
                    "step_seconds_per_rank": per_rank,
                    "step_seconds": max(per_rank),
                    "one_card_step_seconds": statistics.median(plain[3]),
                    "one_card_rows": batch.batch_size,
                    "launches_per_rank": [res[dtype]["launches"]
                                          for res in ranks],
                    "peak_memory_gb_per_rank": [
                        res[dtype]["peak_memory_gb"] for res in ranks],
                    "errors": errors}
                record["steps"][f"{family}_{dtype}"] = step
                cs.log(f"{label}: step {step['step_seconds']:.4f} s over "
                       f"{world} cards ({step['rows_per_rank']} rows a "
                       f"rank), one card {step['one_card_step_seconds']:.4f}"
                       f" s ({batch.batch_size} rows); launches per rank "
                       f"{json.dumps(step['launches_per_rank'][0])}")
        points = cs.e2e_cloud()
        record["sharded_predict"] = cs.phase_sharded_predict(
            points, device, make_local_mesh(world))
    record["seconds"] = time.perf_counter() - t0
    cs.log(f"total {record['seconds']:.1f} s")
    print("MULTICHIP " + json.dumps(record))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
