#!/usr/bin/env python3
"""Smoke run of treemorph_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the script exits non-zero:

1. Card and build: the card's name and power limit, torch and CUDA
   versions; every CUDA kernel of the port is built from ``csrc/`` (one
   ``nvcc`` per source, in parallel) and the QSM core with ``g++``.
2. Kernel against plain: ``band_conv_padded`` against its plain PyTorch
   version on the card, bf16 and f32, at the level shapes of the e2e cloud
   (level 0 ~P/2 rows: 7->32, 32->32, 64->32; level 1: 64->64, 128->64;
   level 2: 96->96), with CUDA-event times and the bound for each.
3. Stage 1 on the card against the CPU: the same model and weights on a
   ~20k-point cut of the e2e cloud; offsets and noise argmax must agree.
4. End to end at full width: the pipeline's TreeLearn (channels 32, three
   levels, band engine, bf16, voxel_capacity_divisor 2, seeded weights) on
   the ~500k-point synthetic plot, through ``run_pipeline`` (counting the
   kernel's launches) and once more stage by stage with per-stage seconds.

The last two lines are the ``kernels`` JSON record and
``{"ok": true, "device": {...}}``. Float32 matmuls and convolutions run
without TF32 (set below) so f32 comparisons are full precision.
"""

from __future__ import annotations

import json
import logging
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

#: H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s, and float32
#: FMA rate outside the tensor cores — the kernel's operations are f32
#: products of (bf16 or f32) features with f32 weights
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12

#: (level, Cin, Cout, launches per forward) of every band conv of the
#: pipeline's TreeLearn (channels 32, num_blocks 3): level 0 has the input
#: conv, 7 C->C convs and the tail's 2C->C; level 1 likewise; level 2
#: (deepest) its two residual blocks
LEVEL_CONVS = [
    (0, 7, 32, 1), (0, 32, 32, 7), (0, 64, 32, 1),
    (1, 64, 64, 7), (1, 128, 64, 1),
    (2, 96, 96, 4),
]
#: kernel vs plain: products are exact in both and summed in f32 in
#: another order, so |err| stays near 1e-6 of the output scale
KERNEL_RTOL = 1e-5
#: card vs CPU stage 1: bf16 roundings that flip under another f32 sum
#: order (and atomic voxel means) move outputs by ~1e-3 of their scale
STAGE1_OFFSET_RTOL = 1e-2
STAGE1_ARGMAX_AGREEMENT = 0.999
#: stage 2's target size (configs/pipeline_config.yaml)
MIN_POINTS = 1_000_000


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    import torch

    fn()
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def e2e_cloud():
    """The e2e workload's raw cloud (the JAX package's bench workload)."""
    import numpy as np

    from treemorph_tpu_torch.fixtures import (
        synthetic_qsm,
        synthetic_tree_cloud,
    )

    rng = np.random.default_rng(17)
    qsm = synthetic_qsm(n_branches=4, rng=rng)
    points, _ = synthetic_tree_cloud(
        qsm=qsm, points_per_m2=50000, noise_scale=0.004,
        outlier_fraction=0.02, rng=rng,
    )
    return points


def pipeline_models(device):
    """Offset and noise predictors of the pipeline's TreeLearn. The noise
    model shares the weights except its semantic head's final bias, which
    prefers class 0 (keep): a random head would drop ~96% of the cloud and
    starve stages 2-3, unlike a trained one."""
    import torch

    from treemorph_tpu_torch.evaluation.model_loaders import (
        Predictor,
        build_model,
    )

    model = build_model(
        "treelearn", voxel_capacity_divisor=2, engine="band",
        conv_dtype="bfloat16", device=device, seed=0,
    )
    noise = model.clone()
    with torch.no_grad():
        noise.semantic_head.Dense_1.bias.copy_(torch.tensor([5.0, -5.0]))
    return (
        Predictor("treelearn", model, device),
        Predictor("treelearn", noise, device),
    )


def phase_card_and_build():
    import torch

    from treemorph_tpu_torch import native
    from treemorph_tpu_torch.ops.cuda import build_all

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    secs = build_all()
    t0 = time.perf_counter()
    native.load()
    log(f"phase 1 ok: nvcc build {secs:.2f} s, g++ build "
        f"{time.perf_counter() - t0:.2f} s")


def level_plans(points, device):
    """Band plans of the three levels the e2e cloud's stage 1 builds."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import build_band_plan
    from treemorph_tpu_torch.ops.sparse import (
        build_downsample,
        build_rulebook,
    )
    from treemorph_tpu_torch.ops.voxelize import voxelize_treelearn_features
    from treemorph_tpu_torch.pipeline.predict import pad_to_bucket

    p = pad_to_bucket(len(points))
    coords = torch.zeros((p, 3), dtype=torch.float32, device=device)
    coords[: len(points)] = torch.from_numpy(points).to(device)
    valid = torch.arange(p, device=device) < len(points)
    vox = voxelize_treelearn_features(
        coords, torch.zeros((p, 4), device=device),
        torch.zeros(p, dtype=torch.int32, device=device), valid, 0.02, 1,
        capacity=p // 2,
    )
    c, v = vox.voxel_coords, vox.voxel_valid
    plans = []
    for level in range(3):
        plans.append(build_band_plan(build_rulebook(c, v), v))
        if level < 2:
            m = c.shape[0]
            ds = build_downsample(c, v, min(max(m // 2, 256), m))
            c, v = ds.coarse_coords, ds.coarse_valid
    return plans


def in_window_entries(plan) -> int:
    """Rulebook entries the kernel applies: found and inside the window of
    their (tile, group)."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import ALIGN

    idx = plan.rb_tiles.long()  # (n_tiles, 27, TILE)
    group = torch.arange(27, device=idx.device) // 3
    base = (plan.starts.long() * ALIGN)[group].T[:, :, None]
    m = plan.rulebook.shape[0]
    live = (idx < m) & (idx >= base) & (idx < base + plan.win)
    return int(live.sum())


def phase_kernel_vs_plain(points, device):
    """Returns the per-forward kernel record (bf16, the main path's type)
    and the per-shape rows."""
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        TILE,
        band_conv_padded,
        band_conv_padded_plain,
    )

    plans = level_plans(points, device)
    gen = torch.Generator(device=device).manual_seed(0)
    rows, worst = [], 0.0
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0,
              "bytes": 0.0, "flops": 0.0}
    for level, cin, cout, count in LEVEL_CONVS:
        plan = plans[level]
        m = plan.rulebook.shape[0]
        mp = plan.rb_tiles.shape[0] * TILE
        # found in-window entries: the kernel's multiply-adds per
        # (input, output) channel pair on this level's data
        nnz = in_window_entries(plan)
        w = torch.randn((27, cin, cout), device=device, generator=gen)
        w /= (27 * cin) ** 0.5
        for dtype in (torch.bfloat16, torch.float32):
            feats = torch.zeros((mp, cin), device=device)
            feats[:m] = torch.randn((m, cin), device=device, generator=gen)
            feats = (feats * torch.nn.functional.pad(
                plan.valid, (0, mp - m))[:, None]).to(dtype)
            args = (plan.rb_tiles, plan.starts, feats, w, m, plan.win)
            out = band_conv_padded(*args)
            torch.cuda.synchronize()
            ref = band_conv_padded_plain(*args)
            err = float((out - ref).abs().max())
            scale = float(ref.abs().max())
            if not (err <= KERNEL_RTOL * scale and torch.isfinite(out).all()):
                raise AssertionError(
                    f"band_conv L{level} {cin}->{cout} {dtype}: max |err| "
                    f"{err:.3e} > {KERNEL_RTOL} x {scale:.3e}"
                )
            worst = max(worst, err)
            ms = cuda_ms(lambda: band_conv_padded(*args), 20)
            plain_ms = cuda_ms(lambda: band_conv_padded_plain(*args), 5)
            nbytes = (mp * 27 * 4 + mp * cin * feats.element_size()
                      + 27 * cin * cout * 4 + mp * cout * 4)
            flops = 2.0 * nnz * cin * cout
            bound_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                 flops / F32_FLOPS)
            row = dict(level=level, cin=cin, cout=cout, dtype=str(dtype),
                       m=m, nnz=nnz, launches_per_forward=count,
                       max_abs_err=err, ms=ms, plain_ms=plain_ms,
                       bound_ms=bound_ms,
                       bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                       > flops / F32_FLOPS else "operations")
            rows.append(row)
            log("kernel " + json.dumps(row))
            if dtype == torch.bfloat16:
                for key, val in (("ms", ms), ("plain_ms", plain_ms),
                                 ("bound_ms", bound_ms), ("bytes", nbytes),
                                 ("flops", flops)):
                    totals[key] += count * val
    shape = "; ".join(
        f"L{level} ({plans[level].rb_tiles.shape[0] * TILE}, {cin})->"
        f"({plans[level].rb_tiles.shape[0] * TILE}, {cout}) x{count}"
        for level, cin, cout, count in LEVEL_CONVS
    )
    record = {
        "name": "band_conv",
        "route": "cuda",
        "source": "treemorph_tpu_torch/csrc/band_conv.cu",
        "replaces": "treemorph_tpu/ops/bandconv.py:190",
        "shape": shape,
        "max_abs_err": worst,
        "ms": totals["ms"],
        "plain_ms": totals["plain_ms"],
        "bound_ms": totals["bound_ms"],
        "bound_by": "bytes" if totals["bytes"] / HBM_BYTES_PER_S
        > totals["flops"] / F32_FLOPS else "operations",
        "library_ms": None,
    }
    log(f"phase 2 ok: band_conv within {KERNEL_RTOL} x scale of plain at "
        f"{len(rows)} shape/type cases; one forward's 21 launches (bf16): "
        f"kernel {totals['ms']:.3f} ms, plain {totals['plain_ms']:.3f} ms, "
        f"bound {totals['bound_ms']:.3f} ms")
    return record, rows


def phase_stage1_card_vs_cpu(points, device):
    import numpy as np

    from treemorph_tpu_torch.pipeline.predict import _pad_flat

    rng = np.random.default_rng(3)
    cut = points[rng.choice(len(points), min(20_000, len(points)),
                            replace=False)]
    feats = np.zeros((len(cut), 4), np.float32)
    outs = []
    for dev in (device, "cpu"):
        offset_model, _ = pipeline_models(dev)
        coords, f, b, v, n = _pad_flat(cut, feats, device=dev)
        res = offset_model.predict_flat(coords, f, b, v)
        outs.append({
            k: res[k][:n].float().cpu().numpy()
            for k in ("offset_predictions", "semantic_prediction_logits")
        })
    card, cpu = outs
    off_err = float(np.abs(card["offset_predictions"]
                           - cpu["offset_predictions"]).max())
    off_scale = float(np.abs(cpu["offset_predictions"]).max())
    agree = float((card["semantic_prediction_logits"].argmax(1)
                   == cpu["semantic_prediction_logits"].argmax(1)).mean())
    finite = all(np.isfinite(o[k]).all() for o in outs for k in o)
    log(f"stage 1 card vs cpu on {len(cut)} points: offsets max |err| "
        f"{off_err:.3e} (scale {off_scale:.3e}, limit "
        f"{STAGE1_OFFSET_RTOL} x scale), noise argmax agreement {agree:.5f} "
        f"(limit {STAGE1_ARGMAX_AGREEMENT})")
    if not (finite and off_err <= STAGE1_OFFSET_RTOL * off_scale
            and agree >= STAGE1_ARGMAX_AGREEMENT):
        raise AssertionError("stage 1 on the card disagrees with the CPU")
    log("phase 3 ok")


class _RetryCounter(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.retries = 0

    def emit(self, record):
        if "retrying" in record.getMessage():
            self.retries += 1


def phase_end_to_end(points, device):
    import numpy as np
    import torch

    from treemorph_tpu_torch.ops import bandconv
    from treemorph_tpu_torch.ops.cuda import LAUNCHES, reset_launches
    from treemorph_tpu_torch.pipeline.predict import predict_single
    from treemorph_tpu_torch.pipeline.qsm import QSMParams, fit_qsm
    from treemorph_tpu_torch.pipeline.run import run_pipeline
    from treemorph_tpu_torch.pipeline.upsample import upsample

    offset_model, noise_model = pipeline_models(device)
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "input")
        os.makedirs(inp)
        np.save(os.path.join(inp, "plot.npy"), points)
        cfg = pipeline_config(inp, os.path.join(tmp, "output"))

        retries = _RetryCounter()
        logging.getLogger("treemorph_tpu_torch.pipeline.predict").addHandler(
            retries
        )
        bandconv.GATHER_ROUTES.clear()
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        results = run_pipeline(cfg, offset_model, noise_model, device=device)
        e2e_s = time.perf_counter() - t0
        launches = LAUNCHES["band_conv"]
        expected = 21 * (2 + retries.retries) - sum(
            bandconv.GATHER_ROUTES.values()
        )
        log(f"run_pipeline: {e2e_s:.2f} s, results {results}")
        log(f"band_conv launches {launches}, expected {expected} (42 per "
            f"predict_single; retries {retries.retries}, overflowed-plan "
            f"gather routes {sum(bandconv.GATHER_ROUTES.values())})")
        out_dir = os.path.join(tmp, "output", "treelearn")
        stage1 = np.load(os.path.join(out_dir, "plot_pred_denoised.npy"))
        csv = os.path.join(out_dir, "plot_qsm_depth_cylinders.csv")
        checks = {
            "one result": len(results) == 1,
            "kept points > 0": len(stage1) > 0,
            "finite stage 1": bool(np.isfinite(stage1).all()),
            f">= {MIN_POINTS} upsampled points": len(results) == 1
            and results[0]["points"] >= MIN_POINTS,
            "cylinders > 0": len(results) == 1
            and results[0]["cylinders"] > 0,
            "CSV written": os.path.exists(csv),
            "launch count": launches == expected and launches > 0,
        }
        for name, ok in checks.items():
            log(f"  {'ok ' if ok else 'FAIL'} {name}")
        if not all(checks.values()):
            raise AssertionError("end-to-end checks failed")

        t0 = time.perf_counter()
        refined = predict_single(points, offset_model, noise_model,
                                 device=device)
        t1 = time.perf_counter()
        upsampled = upsample(refined, min_points=MIN_POINTS, device=device)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        df, _, _, _ = fit_qsm(upsampled, params=QSMParams(seed=0),
                              output_base=os.path.join(tmp, "staged"))
        t3 = time.perf_counter()
        log(json.dumps({
            "e2e_raw_points": len(points),
            "e2e_stage1_kept_points": len(refined),
            "e2e_upsampled_points": len(upsampled),
            "e2e_cylinders": len(df),
            "e2e_stage1_seconds": t1 - t0,
            "e2e_upsample_seconds": t2 - t1,
            "e2e_qsm_seconds": t3 - t2,
            "e2e_plot_seconds": t3 - t0,
            "run_pipeline_seconds": e2e_s,
        }))
    log("phase 4 ok")
    return launches


def pipeline_config(input_dir: str, output_dir: str) -> dict:
    """``configs/pipeline_config.yaml`` as a dict (no YAML parser needed),
    with the smoke run's directories and the stage-1 cloud saved."""
    return {
        "general": {
            "input_dir": input_dir, "output_dir": output_dir,
            "save_model_predictions": True, "save_upsampling": False,
            "save_qsm_cyl_ply": False, "save_qsm_sphere_ply": False,
            "save_qsm_cyl_csv": True, "cloud_save_type": "npy",
        },
        "stage1": {"predict_offset": True, "denoise": True,
                   "model_type": "treelearn"},
        "stage2": {"upsampling": True, "k_init": 10, "max_iterations": 10,
                   "min_height": 0.0, "use_only_original_points": True,
                   "min_points": MIN_POINTS},
        "stage3": {
            "qsm_fitting": True, "qsm_verbose": False, "qsm_debug": False,
            "qsm_params": {
                "eps_deg": 20, "min_samples": 5, "sphere_factor": 2.0,
                "radius_min": 0.15, "radius_max": 0.4,
                "min_growth_points": 10, "min_points_threshold": 4,
                "max_spread_growth": 1.05, "min_spread_growth": 0.33,
                "smallest_search_radius": 0.1, "search_radius_step": 0.1,
                "max_search_radius": 0.3, "max_dist": 0.4, "max_angle": 30,
                "distance_type": "center", "sphere_radius": 0.15,
                "sphere_thickness": 0.1,
                "sphere_thickness_type": "absolute",
                "clustering_algorithm": "agglomerative",
                "merging_procedure": "none",
                "clustering_linkage": "single",
                "clustering_type": "angular", "eps_cylinder": 0.1,
                "segmentation_type": "cylinder",
                "only_correct_connections": True, "priority_alpha": 0.5,
                "ransac_iterations": 10, "ransac_subset_percentage": 0.8,
            },
        },
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "treemorph_tpu_torch")):
        print("chip_smoke: treemorph_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN: f32 comparisons are full f32")
    logging.basicConfig(level=logging.WARNING)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    phase_card_and_build()
    points = e2e_cloud()
    log(f"e2e cloud: {len(points)} raw points")
    record, _ = phase_kernel_vs_plain(points, device)
    phase_stage1_card_vs_cpu(points, device)
    launches = phase_end_to_end(points, device)
    log(f"total {time.perf_counter() - t0:.1f} s")
    head = ("name", "route", "source", "replaces")
    record = {**{k: record[k] for k in head}, "launches": launches,
              **{k: v for k, v in record.items() if k not in head}}
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
