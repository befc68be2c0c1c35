"""Stage 2, k-NN midpoint upsampling, as the reference upsampler
(``Modules/Pipeline/Upsampling.py``) defines it, in plain PyTorch and NumPy
with an exact k-NN.

The upsampler leaves the points below ``min_height`` above the cloud's
base as they are. For the points above it (the originals) it adds, round
by round, the midpoint between each original and a random one of its
``k_i = k_init * 2^i`` nearest neighbours among the points so far (the
originals and the earlier rounds' midpoints; a neighbour within 1e-9 of
the original does not count), until the cloud holds ``min_points`` or
``max_iterations`` rounds are done. The output is ``[below, originals,
round 0's midpoints, round 1's, ...]``, a round's midpoints in the order
of their originals.

:func:`readings` judges an upsampled cloud by that definition and has no
engine of its own: it finds each midpoint's partner by an exact search
and ranks a sample of them among their originals' neighbours by brute
force. :func:`upsample` runs the definition itself (an exact k-NN by
brute force on the device): it is the control, one precision lower, and
the tests' witness.
"""

from __future__ import annotations

import math

import numpy as np
import torch

#: ``run_pipeline`` leaves clouds of more points than this as they are
SKIP_ABOVE = 1_500_000
#: a neighbour this close to its original (squared, 1e-9 m) does not count
DUPLICATE_D2 = 1e-18


def schedule(n0: int, k_init: int, max_iterations: int,
             min_points: int) -> tuple:
    """The rounds' neighbour counts ``k_i`` for ``n0`` originals; empty
    where the cloud is left as it is."""
    if n0 < k_init:
        return ()
    needed, count = 0, n0
    while count < min_points:
        count += n0
        needed += 1
    ks = tuple(min(k_init * 2**i, n0 - 1)
               for i in range(min(max_iterations, needed)))
    return () if any(k < 1 for k in ks) else ks


def split(cloud: np.ndarray, min_height: float):
    """``(below, originals)`` of ``cloud``'s points."""
    pts = np.asarray(cloud, np.float32)[:, :3]
    base = pts[:, 2].min()
    return (pts[pts[:, 2] < base + min_height],
            pts[pts[:, 2] >= base + min_height])


def readings(refined: np.ndarray, dense: np.ndarray, seed: int, device,
             k_init: int = 10, max_iterations: int = 10,
             min_height: float = 0.0, min_points: int = 1_000_000,
             sample: int = 512) -> dict:
    """The numbers that hold ``dense``, the program's stage 2 of
    ``refined``, to the definition:

    - ``upsampled``: the largest gap of ``dense``'s first points against
      the points below and the originals as they are; inf where ``dense``
      does not hold one midpoint per original in each round the schedule
      asks for (every original has a neighbour over 1e-9 away unless all
      points so far coincide with it);
    - ``midpoints``: the share of midpoints that are not, to the last bit,
      the float32 mean of their original and a point of the points so far
      over 1e-9 from the original (its partner);
    - ``partner_rank``: over ``sample`` originals a round, drawn from
      ``seed``, the median of ``(r + 1) / k_i``, where ``r`` counts the
      points so far nearer to the original than its partner (the point
      nearest to ``2 * midpoint - original``): at most 1 where half the
      partners lie among the exact ``k_i`` nearest; the worst round's."""
    pts = np.asarray(refined, np.float32)[:, :3]
    dense = np.asarray(dense, np.float32)
    below, originals = split(pts, min_height) if len(pts) else (pts, pts)
    n0 = len(originals)
    ks = ()
    if 0 < len(pts) <= SKIP_ABOVE:
        ks = schedule(n0, k_init, max_iterations, min_points)
    kept = np.vstack([below, originals])
    if dense.shape != (len(kept) + n0 * len(ks), 3):
        return {"upsampled": math.inf, "midpoints": 1.0,
                "partner_rank": math.inf}
    out = {"upsampled": float(np.abs(dense[:len(kept)] - kept).max(
        initial=0.0)), "midpoints": 0.0, "partner_rank": 0.0}
    if not ks:
        return out
    # the points so far at round i are corpus[:n0 * (i + 1)]: the
    # originals as the refined cloud holds them, then the midpoints
    corpus = np.vstack([originals, dense[len(kept):]])
    out["midpoints"] = float(1.0 - exact_partners(corpus, originals,
                                                  len(ks), device).mean())
    rng = np.random.default_rng([seed % (1 << 63), 11])
    for i, k in enumerate(ks):
        rows = rng.choice(n0, min(sample, n0), replace=False)
        mids = corpus[n0 * (i + 1):n0 * (i + 2)]
        ranks = partner_ranks(corpus[:n0 * (i + 1)], originals[rows],
                              mids[rows], device)
        out["partner_rank"] = max(out["partner_rank"],
                                  float(np.median((ranks + 1) / k)))
    return out


def exact_partners(corpus: np.ndarray, originals: np.ndarray, rounds: int,
                   device) -> np.ndarray:
    """``(rounds, n0)``: whether each midpoint has a partner, a point of
    the points so far at that round, over 1e-9 from the original, whose
    float32 mean with the original is the midpoint to the last bit. That
    holds where the float32 sum of the two is twice the midpoint, so the
    partner lies within one rounding of ``2 * midpoint - original``: the
    points so far whose x lies that close are tried, from a sort by x."""
    c = torch.as_tensor(corpus, device=device)
    p = torch.as_tensor(originals, device=device)
    n0 = len(p)
    found = []
    for i in range(rounds):
        live = c[:n0 * (i + 1)]
        twice = 2.0 * c[n0 * (i + 1):n0 * (i + 2)]
        target = twice[:, 0].double() - p[:, 0].double()
        reach = (twice[:, 0].double().abs() + 1e-30) * 2.0**-22
        xs, order = torch.sort(live[:, 0].double())
        lo = torch.searchsorted(xs, target - reach)
        hi = torch.searchsorted(xs, target + reach, right=True)
        hit = torch.zeros(n0, dtype=torch.bool, device=device)
        for t in range(int((hi - lo).max())):
            q = live[order[(lo + t).clamp(max=len(live) - 1)]]
            hit |= ((lo + t < hi) & ((p + q) == twice).all(1)
                    & (((q.double() - p.double()) ** 2).sum(1)
                       > DUPLICATE_D2))
        found.append(hit)
    return torch.stack(found).cpu().numpy()


def squared_distances(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(len(a), len(b))`` squared distances, in ``a``'s type."""
    d2 = (a[:, None, 0] - b[None, :, 0]) ** 2
    for dim in (1, 2):
        d2 += (a[:, None, dim] - b[None, :, dim]) ** 2
    return d2


def partner_ranks(corpus: np.ndarray, originals: np.ndarray,
                  mids: np.ndarray, device, block: int = 32) -> np.ndarray:
    """For each original and its midpoint, how many points of ``corpus``
    lie nearer to the original than its partner, the point of ``corpus``
    nearest to ``2 * midpoint - original`` (points within 1e-9 of the
    original left out); in float64, by brute force."""
    c = torch.as_tensor(corpus, device=device).double()
    p = torch.as_tensor(originals, device=device).double()
    target = 2.0 * torch.as_tensor(mids, device=device).double() - p
    ranks = [torch.zeros(0, dtype=torch.int64, device=device)]
    for s in range(0, len(p), block):
        q = c[squared_distances(target[s:s + block], c).argmin(1)]
        dq = ((q - p[s:s + block]) ** 2).sum(1, keepdim=True)
        d2 = squared_distances(p[s:s + block], c)
        ranks.append(((d2 < dq) & (d2 > DUPLICATE_D2)).sum(1))
    return torch.cat(ranks).cpu().numpy()


def upsample(cloud: np.ndarray, generator: torch.Generator, device,
             dtype=torch.float32, k_init: int = 10, max_iterations: int = 10,
             min_height: float = 0.0, min_points: int = 1_000_000,
             block: int = 256) -> np.ndarray:
    """The definition run: each round's exact ``k_i`` nearest by brute
    force, a uniform choice among those over 1e-9 away, every point held
    in ``dtype`` (the control: bfloat16, below the float32 the pipeline
    states); float32 out."""
    pts = np.asarray(cloud, np.float32)[:, :3]
    if not 0 < len(pts) <= SKIP_ABOVE:
        return pts
    below, originals = (torch.as_tensor(x, device=device).to(dtype)
                        for x in split(pts, min_height))
    corpus, parts = originals, [below, originals]
    for k in schedule(len(originals), k_init, max_iterations, min_points):
        mids = []
        for s in range(0, len(originals), block):
            q = originals[s:s + block]
            d2 = squared_distances(q, corpus).float()
            d2 = torch.where(d2 > DUPLICATE_D2, d2, math.inf)
            near, idx = torch.topk(d2, k, dim=1, largest=False)
            draws = torch.rand(idx.shape, generator=generator,
                               device=device)
            scores = torch.where(torch.isfinite(near), draws, -1.0)
            pick = scores.argmax(1, keepdim=True)
            has = scores.gather(1, pick)[:, 0] > 0
            nbr = corpus[idx.gather(1, pick)[:, 0]]
            mids.append(((q + nbr) * 0.5)[has])
        parts.append(torch.cat(mids))
        corpus = torch.cat([corpus, parts[-1]])
    return torch.cat(parts).float().cpu().numpy()
