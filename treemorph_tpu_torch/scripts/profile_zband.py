"""Profile the z-packed band engine against the band and gather engines.

    python -m treemorph_tpu_torch.scripts.profile_zband [--device cpu]

The port's counterpart of the JAX package's ``scripts/profile_zband.py``,
with its workload: the bench voxel set (131,072 jittered points of a
synthetic tree at 0.02 m voxels, seed 0) deduplicated to at most 32,768
unique voxels, then three conv shapes (the PTv3 stem k=5 4->32, an xCPE
k=3 32->32, k=3 64->64) with random features and weights (seed 1). Per
shape it builds the rulebook, a band plan and a z-band plan
(``res_divisor=2``), then runs the gather, band and z-band engines in bf16
and f32 and prints each one's time and the z-band engine's max |diff|
from the gather engine.

On the card (the default) times are CUDA events, median of ``--reps``
runs after two warm-ups; with ``--device cpu`` they are host-clock times of
the CPU's plain versions and say so. :func:`main` returns one record per
(shape, dtype).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from ..fixtures import synthetic_qsm, synthetic_tree_cloud
from ..ops.bandconv import (
    band_subm_conv_apply,
    band_viable,
    build_band_plan,
    build_zband_plan,
    zband_subm_conv_apply,
    zband_viable,
)
from ..ops.sparse import build_dedup, build_rulebook, subm_conv_apply
from ..utils.device import resolve_device

#: (kernel size, Cin, Cout, label) of the profiled convs
SHAPES = (
    (5, 4, 32, "stem k=5 4->32"),
    (3, 32, 32, "xcpe k=3 32->32"),
    (3, 64, 64, "k=3 64->64"),
)
DTYPES = (("bf16", torch.bfloat16), ("f32", torch.float32))


def bench_points(n: int = 131072) -> np.ndarray:
    """(n, 3) float32 points of the bench cloud (the JAX package's
    bench.py:86-100, its first tree): a synthetic tree's scan (numpy seed
    0, 40,000 points/m^2, noise 0.004) tiled to ``n`` points and jittered
    by 5 mm."""
    rng = np.random.default_rng(0)
    qsm = synthetic_qsm(rng=rng)
    pts, _ = synthetic_tree_cloud(
        qsm=qsm, points_per_m2=40000, noise_scale=0.004, rng=rng
    )
    reps = -(-n // len(pts))
    return np.tile(pts, (reps, 1))[:n] + rng.normal(
        0, 0.005, (n, 3)).astype(np.float32)


def bench_coords(n: int = 131072) -> np.ndarray:
    """(n, 4) int32 voxel coords (b, x, y, z) of the bench cloud's points
    (:func:`bench_points`) at 0.02 m."""
    pts = bench_points(n)
    g = np.floor((pts - pts.min(0)) / 0.02).astype(np.int32)
    return np.concatenate([np.zeros((n, 1), np.int32), g], 1)


class Timer:
    """Median milliseconds of a call: CUDA events on the card, the host
    clock on the CPU (``unit`` says which)."""

    def __init__(self, device: torch.device, reps: int):
        self.cuda = device.type == "cuda"
        self.reps = reps
        self.unit = "ms (CUDA events)" if self.cuda else "ms (host clock, cpu)"

    def __call__(self, name: str, fn):
        """Runs ``fn`` 2 + reps times; prints and returns (its last output,
        the median ms)."""
        fn()
        out = fn()
        times = []
        for _ in range(self.reps):
            if self.cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = fn()
                end.record()
                torch.cuda.synchronize()
                times.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                out = fn()
                times.append((time.perf_counter() - t0) * 1e3)
        ms = statistics.median(times)
        print(f"{name:52s} {ms:10.3f} {self.unit}", flush=True)
        return out, ms


def main(argv=None) -> list[dict]:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA device)")
    parser.add_argument("--n", type=int, default=131072,
                        help="points of the bench cloud")
    parser.add_argument("--cap", type=int, default=32768,
                        help="unique-voxel capacity of the dedup")
    parser.add_argument("--reps", type=int, default=10,
                        help="timed runs per engine")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    timer = Timer(device, args.reps)

    coords = torch.from_numpy(bench_coords(args.n)).to(device)
    dd = build_dedup(coords, torch.ones(len(coords), dtype=torch.bool,
                                        device=device), cap=args.cap)
    cj, vj = dd.coords, dd.valid
    m = cj.shape[0]
    print(f"bench cloud: {args.n} points, {int(dd.num_unique)} unique voxels "
          f"(cap {args.cap}, overflow {int(dd.overflow)}) on {device}")
    rng = np.random.default_rng(1)
    records = []
    for k, cin, cout, label in SHAPES:
        feats = torch.from_numpy(
            rng.normal(size=(m, cin)).astype(np.float32)).to(device)
        w = torch.from_numpy(
            rng.normal(size=(k**3, cin, cout)).astype(np.float32) * 0.1
        ).to(device)
        rb, _ = timer(f"[{label}] build_rulebook",
                      lambda: build_rulebook(cj, vj, k))
        plan_b, _ = timer(f"[{label}] build_band_plan",
                          lambda: build_band_plan(rb, vj))
        plan_z, _ = timer(f"[{label}] build_zband_plan",
                          lambda: build_zband_plan(rb, vj, res_divisor=2))
        residual = int(plan_z.res_valid.sum())
        print(f"  zband ok={bool(plan_z.ok)} residual rows={residual} / {m}")
        for dt_name, dt in DTYPES:
            o_g, gather_ms = timer(
                f"[{label}] gather {dt_name}",
                lambda: subm_conv_apply(feats, w, rb, vj, compute_dtype=dt))
            band_ms = None
            if band_viable(k**3, cin, cout, dt):
                _, band_ms = timer(
                    f"[{label}] band {dt_name}",
                    lambda: band_subm_conv_apply(feats, w, plan_b, vj,
                                                 compute_dtype=dt))
            calls = [0]

            def zband():
                calls[0] += 1
                return zband_subm_conv_apply(feats, w, plan_z, vj,
                                             compute_dtype=dt)

            o_z, zband_ms = timer(f"[{label}] zband {dt_name}", zband)
            err = float((o_z - o_g).abs().max())
            scale = float(o_g.abs().max())
            print(f"  zband vs gather max|diff| = {err:.2e} "
                  f"(scale {scale:.2f})", flush=True)
            records.append(dict(
                label=label, k=k, cin=cin, cout=cout, dtype=dt_name, m=m,
                residual_rows=residual, plan_ok=bool(plan_z.ok),
                route="zband" if bool(plan_z.ok) and zband_viable(k**3, dt)
                else "gather", zband_calls=calls[0], gather_ms=gather_ms,
                band_ms=band_ms, zband_ms=zband_ms, max_abs_diff=err,
                scale=scale, unit=timer.unit,
            ))
    return records


if __name__ == "__main__":
    main()
