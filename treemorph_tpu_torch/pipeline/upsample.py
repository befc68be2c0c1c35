"""Stage 2: KNN-midpoint super-sampling.

Capability parity with the reference upsampler
(``/root/reference/Modules/Pipeline/Upsampling.py:22-168``): iteratively
insert midpoints between each point and a randomly chosen near neighbor
until the cloud reaches ``min_points``; points below ``min_height`` above
the cloud base are left untouched; the ``use_only_original_points`` mode
queries k * 2^i neighbors of the *original* points only, the standard mode
doubles the full set each iteration.

Unlike the reference's per-point Python loop (:100-151), each iteration is
ONE vectorized batch: a parallel cKDTree k-NN over the current set, a
random-neighbor choice, and a vectorized midpoint. (The reference visits
points in random order, but its search tree is fixed within an iteration,
so order never affects the distribution — the vectorized form is
behavior-equivalent.)

Two engines:

- **host** (exact k-NN, parallel cKDTree) — the parity engine; fast on
  multi-core hosts, minutes-slow on single-core sandboxes.
- **device** (:func:`upsample_device`) — the engine the pipeline uses
  on the card for the standard ``use_only_original_points`` mode: the
  corpus is kept sorted along a depth-16 z-order curve, each (fixed)
  query point's candidates are a contiguous window of curve-sorted rows
  around its insertion position (the same lex-locality invariant the
  banded conv engine exploits), and the random neighbor is chosen among
  the k nearest candidates. The k-NN is therefore approximate (true
  neighbors across a curve jump can fall outside the window) — the
  CHOICE distribution differs slightly from the exact engine, which is
  immaterial for a random-midpoint densifier; the midpoint math, the
  d > 1e-9 duplicate exclusion, the k * 2^i schedule and the output
  layout are identical. Earlier grid-bucket k-NN attempts overflowed
  any static per-cell cap at upsampling densities (>=50k pts/m^2);
  windowed curve candidates have no per-cell cap at all. The random
  choice draws from a ``torch.Generator`` seeded from the caller's numpy
  generator, so it differs from the JAX engine's ``jax.random`` draws.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.spatial import cKDTree

from ..ops.serialization import encode
from ..utils.device import resolve_device


def _midpoint_iteration(
    points: np.ndarray,
    query_points: np.ndarray,
    rng: np.random.Generator,
    k: int,
):
    """One round: each query point pairs with a random one of its k nearest
    (excluding self / zero-distance duplicates, reference: d > 1e-9) and
    emits the midpoint."""
    tree = cKDTree(points)
    k_eff = min(k + 1, len(points))
    d, idx = tree.query(query_points, k=k_eff, workers=-1)
    if k_eff == 1:
        d = d[:, None]
        idx = idx[:, None]
    usable = np.isfinite(d) & (d > 1e-9)
    scores = np.where(usable, rng.random(idx.shape), -1.0)
    choice = scores.argmax(axis=1)
    rows = np.arange(len(query_points))
    has_neighbor = scores[rows, choice] > 0
    neighbor = points[np.clip(idx[rows, choice], 0, len(points) - 1)]
    midpoints = (query_points + neighbor) * 0.5
    return midpoints, has_neighbor


def _host_knn_work(n0: int, k_init: int, max_iterations: int,
                   min_points: int) -> float:
    """Estimated host-engine k-NN cost for the only-original-points
    schedule: sum over rounds of n0 queries x (k_i+1) neighbors x
    log2(corpus). The host cost is dominated by the k_i = k * 2^i growth,
    not the cloud size — a 20k cloud needing 10 rounds costs ~100x a 540k
    cloud needing one. The 3e7 auto-route threshold is the JAX package's,
    calibrated on its host; the port keeps it so both packages route the
    same jobs to the same engine."""
    if n0 <= 0:
        return 0.0
    needed, count = 0, n0
    while count < min_points:
        count += n0
        needed += 1
    rounds = min(max_iterations, needed)
    work = 0.0
    for i in range(rounds):
        k_i = min(k_init * (2 ** i) + 1, n0 * (i + 1))
        work += n0 * k_i * max(np.log2(n0 * (i + 1)), 1.0)
    return work


def upsample(
    cloud_data: np.ndarray,
    k_init: int = 10,
    max_iterations: int = 10,
    min_height: float = 0.0,
    use_only_original_points: bool = True,
    min_points: int = 1_000_000,
    rng: np.random.Generator | None = None,
    cell_size: float = 0.2,  # kept for API compatibility; unused
    engine: str = "auto",  # 'auto' | 'host' | 'device'
    device=None,
) -> np.ndarray:
    """Super-sample a cloud to at least ``min_points`` points.

    Returns the concatenation [below-threshold originals, above-threshold
    originals, new midpoints], matching the reference output layout
    (``Upsampling.py:154-159``). ``engine='auto'`` routes large
    only-original-points jobs to the device engine on ``device``
    (module docstring) and everything else to the exact host k-NN.
    ``device`` defaults to the CUDA device and raises without one.
    """
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    if engine == "device" or (
        engine == "auto"
        and use_only_original_points
        and cloud_data is not None
        and _host_knn_work(
            len(cloud_data), k_init, max_iterations, min_points
        ) > 3e7
    ):
        return upsample_device(
            cloud_data,
            k_init=k_init,
            max_iterations=max_iterations,
            min_height=min_height,
            min_points=min_points,
            rng=rng,
            device=device,
        )
    if cloud_data is None or len(cloud_data) == 0:
        return cloud_data
    pts = np.asarray(cloud_data, np.float32)[:, :3]

    min_z = pts[:, 2].min()
    above = pts[pts[:, 2] >= min_z + min_height]
    below = pts[pts[:, 2] < min_z + min_height]
    n0 = len(above)
    if n0 < k_init:
        return pts

    # how many iterations until the target is reached (reference :74-85)
    needed, count = 0, n0
    while count < min_points:
        count = count + n0 if use_only_original_points else count * 2
        needed += 1
    if needed == 0:
        return pts
    iters = min(max_iterations, needed)

    new_points = []
    current = above
    originals = above
    for i in range(iters):
        if use_only_original_points:
            k_i = min(k_init * (2**i), len(current) - 1)
            if k_i < 1:
                break
            midpoints, ok = _midpoint_iteration(
                current, originals, rng, k_i
            )
        else:
            midpoints, ok = _midpoint_iteration(
                current, current, rng, min(k_init, len(current) - 1)
            )
        mids = midpoints[ok].astype(np.float32)
        if len(mids) == 0:
            break
        new_points.append(mids)
        current = np.concatenate([current, mids])

    parts = [below, above] + new_points
    return np.vstack(parts).astype(np.float32)


def _device_upsample_rounds(
    queries: torch.Tensor,  # (Q, 3) float32, padded
    q_valid: torch.Tensor,  # (Q,) bool
    generator: torch.Generator,
    ks: tuple,  # per-iteration neighbor counts (k_i schedule)
    window: int = 64,  # candidate rows each side of the insert position
    depth: int = 16,
):
    """All midpoint rounds. Returns (mids, mid_valid) of shape
    (len(ks), Q, 3) / (len(ks), Q): iteration-major, matching the host
    engine's output layout."""
    dev = queries.device
    q = queries.shape[0]
    cap = q * (len(ks) + 1)
    corpus = torch.zeros((cap, 3), dtype=torch.float32, device=dev)
    corpus[:q] = queries
    c_valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    c_valid[:q] = q_valid

    # quantization for curve codes: fixed 1 mm grid against the query
    # min (extent < 2^depth mm = 65 m at depth 16)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    mins = torch.where(q_valid[:, None], queries, big).amin(dim=0)
    mins = torch.where(torch.isfinite(mins), mins, 0.0)
    scale = 1000.0
    top = float((1 << depth) - 1)
    qg = ((queries - mins) * scale).clamp(0, top).to(torch.int32)
    _, qcode = encode(qg, None, depth=depth, order="z")
    sentinel = torch.iinfo(torch.int64).max  # above every 48-bit code
    rows = torch.arange(q, device=dev)

    mids_out = []
    ok_out = []
    for it, k in enumerate(ks):
        # the k_i = k_init * 2^i schedule quickly exceeds any fixed
        # candidate window; grow the window with the round (bounded —
        # the (Q, 2W, 3) candidate gather is the memory cost) and cap k
        # at the candidate count. Beyond the cap the choice is "uniform
        # among the nearest 2W in-window" instead of "uniform among the
        # k nearest in the corpus" — a distributional approximation the
        # engine already makes (module docstring), immaterial for a
        # random-midpoint densifier.
        w = min(max(window, -(-k // 2)), 256, cap // 2)
        k_eff = min(k, 2 * w)
        n_live = q * (it + 1)
        grid = ((corpus - mins) * scale).clamp(0, top).to(torch.int32)
        _, code = encode(grid, None, depth=depth, order="z")
        code = torch.where(c_valid, code, sentinel)
        s_code, s_idx = torch.sort(code, stable=True)

        pos = torch.searchsorted(s_code, qcode)  # lower bound, (Q,)
        base = (pos - w).clamp(0, cap - 2 * w)
        cand_rows = base[:, None] + torch.arange(2 * w, device=dev)
        cand_idx = s_idx[cand_rows]  # (Q, 2W) original corpus rows
        cand = corpus[cand_idx]  # (Q, 2W, 3)
        cand_ok = c_valid[cand_idx]

        d2 = ((cand - queries[:, None, :]) ** 2).sum(dim=-1)
        # reference usability rule: finite, non-duplicate (d > 1e-9)
        usable = cand_ok & (d2 > 1e-18)
        d2 = torch.where(usable, d2, torch.inf)
        # k nearest among candidates, then a uniform random usable one
        neg, top_i = torch.topk(-d2, k_eff, dim=1)
        top_usable = torch.isfinite(neg)
        draws = torch.rand(
            top_i.shape, generator=generator, device=dev
        )
        scores = torch.where(top_usable, draws, -1.0)
        choice = scores.argmax(dim=1)
        has = (scores[rows, choice] > 0) & q_valid
        nbr = cand[rows, top_i[rows, choice]]
        mids = (queries + nbr) * 0.5
        mids = torch.where(has[:, None], mids, 0.0)
        mids_out.append(mids)
        ok_out.append(has)
        corpus[n_live : n_live + q] = mids
        c_valid[n_live : n_live + q] = has
    return torch.stack(mids_out), torch.stack(ok_out)


def upsample_device(
    cloud_data: np.ndarray,
    k_init: int = 10,
    max_iterations: int = 10,
    min_height: float = 0.0,
    min_points: int = 1_000_000,
    rng: np.random.Generator | None = None,
    window: int = 64,
    bucket: int = 8192,
    device=None,
) -> np.ndarray:
    """Device engine for the ``use_only_original_points`` mode (see module
    docstring), on ``device`` (the CUDA device unless named). Query
    shapes are bucketed like the JAX engine's."""
    device = resolve_device(device)
    rng = rng or np.random.default_rng(0)
    if cloud_data is None or len(cloud_data) == 0:
        return cloud_data
    pts = np.asarray(cloud_data, np.float32)[:, :3]
    min_z = pts[:, 2].min()
    above = pts[pts[:, 2] >= min_z + min_height]
    below = pts[pts[:, 2] < min_z + min_height]
    n0 = len(above)
    if n0 < k_init:
        return pts

    needed, count = 0, n0
    while count < min_points:
        count += n0
        needed += 1
    if needed == 0:
        return pts
    iters = min(max_iterations, needed)
    ks = tuple(
        min(k_init * (2**i), n0 - 1) for i in range(iters)
    )
    if any(k < 1 for k in ks):
        return pts

    qp = -(-n0 // bucket) * bucket
    queries = np.zeros((qp, 3), np.float32)
    queries[:n0] = above
    q_valid = np.arange(qp) < n0

    seed = int(rng.integers(0, 2**31 - 1))
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    mids, ok = _device_upsample_rounds(
        torch.from_numpy(queries).to(device),
        torch.from_numpy(q_valid).to(device),
        generator, ks, window=window,
    )
    mids = mids.cpu().numpy()
    ok = ok.cpu().numpy()
    parts = [below, above]
    for i in range(len(ks)):
        parts.append(mids[i][ok[i]].astype(np.float32))
    return np.vstack(parts).astype(np.float32)
