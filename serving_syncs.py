"""Hand-kernel launches and host synchronizations of one serving forward of
one checkout.

    python3 serving_syncs.py [ROOT]

ROOT (default: the checkout that holds this file) must hold
``chip_smoke.py`` and ``treemorph_tpu_torch/``. The forward is the one that
``chip_smoke.py`` phases 2-4 serve: the pipeline's TreeLearn (band engine,
bf16, seeded weights, ROOT's ``chip_smoke.pipeline_models``) on the e2e
plot (``chip_smoke.e2e_cloud``), after one warm-up forward. Counts the
launches that ROOT's wrappers add to ``ops.cuda.LAUNCHES`` and the
``cudaStreamSynchronize`` / ``cudaDeviceSynchronize`` calls in a
``torch.profiler`` trace of the forward, each twice. Run on two checkouts
in one command, it shows whether a change adds a launch or a host
synchronization to the serving path (``chip_smoke.py`` phase 15e holds the
port to the counts this script took on a checkout of the parent of the
kernel-FLOP log, ``PARENT_SERVING_COUNTS``). Needs a CUDA card. Prints the
card's name and power limit, then one line ``SYNCS {json}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

#: the runtime calls that block the host until the device is done
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")


def forward_counts(predictor, args) -> dict:
    """Launches and host synchronizations of one ``predict_flat`` call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from treemorph_tpu_torch.ops.cuda import LAUNCHES

    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        predictor.predict_flat(*args)
        torch.cuda.synchronize()
    syncs = {name: 0 for name in SYNC_CALLS}
    for event in prof.events():
        if event.name in syncs:
            syncs[event.name] += 1
    # the profiled block's own closing synchronize is not the forward's
    syncs["cudaDeviceSynchronize"] -= 1
    return {"launches": {k: v - before.get(k, 0) for k, v in LAUNCHES.items()
                         if v != before.get(k, 0)}, "syncs": syncs}


def main(root: str) -> list:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    points = cs.e2e_cloud()
    offset, _ = cs.pipeline_models(dev)
    args = _pad_flat(points, np.zeros((len(points), 4), np.float32),
                     device=dev)[:4]
    offset.predict_flat(*args)
    counts = [forward_counts(offset, args) for _ in range(2)]
    print("SYNCS " + json.dumps({"root": os.path.abspath(root),
                                 "forwards": counts}), flush=True)
    return counts


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else os.path.dirname(os.path.abspath(__file__)))
