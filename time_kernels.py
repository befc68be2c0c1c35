"""CUDA-event times of the band kernels, the z-band conv and the
window-attention forward of one checkout, at the shapes that
``chip_smoke.py`` phases 2, 5, 7a, 9a and 11a use.

    python3 time_kernels.py [ROOT]

ROOT (default: the checkout that holds this file) must hold
``chip_smoke.py`` and ``treemorph_tpu_torch/``; the kernels are built from
its own ``csrc/``, the band shapes come from its own ``chip_smoke.py`` and
the attention inputs are captured from one forward of its own PTv3 (seeded
weights, the e2e cloud). Run on two checkouts in one command, it compares
two versions of the kernels on one card (``chip_smoke.SIMT_HISTORICAL_MS``
holds the times of the SIMT band kernels of commit ddf01be taken this
way). Needs a CUDA card. Prints the card's name and power limit, then one
line ``TIMES {json}`` of ms per call (median of 20).

Band keys are ``(part, level, Cin, Cout, type)``: ``fwd`` is the forward
on the e2e plot's levels; ``train_fwd`` the forward, ``bwd`` the whole
``band_conv_bwd_padded`` and ``bwd_d_feats`` its forward launch on the
training batch's levels. ``(bench_fwd, K, rows, Cin, Cout, type)`` is the
forward at each shape of one forward of the bench PTv3 configuration on
the bench tree (its own features in bf16, the same cast to f32), and
``bench_calls`` that shape's launches per forward. ``(zband, conv, type)``
is ``zband_conv_padded`` at 9a's convs (the z-band profile workload's three
and the e2e plot's level convs, z-band plans with 9a's residual divisor,
seeded features and weights). Attention keys are ``(part, W, H, K, D, type)``:
``attn_fwd`` is ``window_attention`` (inference, no log-sum-exp),
``attn_sdpa`` ``scaled_dot_product_attention`` with the same boolean mask
(median of 5), and ``attn_calls`` the launches of that shape per forward;
where some windows hold no row, ``attn_fwd_live`` times the launch on the
windows that hold one alone and ``attn_fwd_padding`` on the whole shape
with every row padding.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile


def band_times(cs, dev, points) -> dict:
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        TILE,
        band_conv_bwd_padded,
        band_conv_padded,
    )
    from treemorph_tpu_torch.train.families import _flatten_padded

    gen = torch.Generator(device=dev).manual_seed(0)

    def rows_of(plan, width, dtype):
        m = plan.rulebook.shape[0]
        x = torch.zeros((plan.rb_tiles.shape[0] * TILE, width), device=dev)
        x[:m] = torch.randn((m, width), device=dev, generator=gen)
        x[:m] *= plan.valid[:, None]
        return x.to(dtype).contiguous()

    def weights(cin, cout):
        return torch.randn((27, cin, cout), device=dev,
                           generator=gen) / (27 * cin) ** 0.5

    times = {}
    plans = cs.e2e_level_plans(points, dev)
    for level, cin, cout, _ in cs.LEVEL_CONVS:
        p, w = plans[level], weights(cin, cout)
        m = p.rulebook.shape[0]
        for dt in (torch.bfloat16, torch.float32):
            f = rows_of(p, cin, dt)
            times[str(("fwd", level, cin, cout, str(dt)))] = cs.cuda_ms(
                lambda: band_conv_padded(p.rb_tiles, p.starts, f, w, m,
                                         p.win), 20)
    with tempfile.TemporaryDirectory() as data:
        cs.write_training_plots(data)
        batch, capacity = cs.first_training_batch(data, dev)
    flat = _flatten_padded(batch)
    plans, _ = cs.level_plans(flat["coords"], flat["batch_ids"],
                              flat["mask_valid"], cs.TRAIN_TREES, capacity)
    for level, cin, cout, _ in cs.LEVEL_CONVS:
        p, w = plans[level], weights(cin, cout)
        m = p.rulebook.shape[0]
        w_bwd = w.flip(0).transpose(1, 2).contiguous()
        for dt in (torch.bfloat16, torch.float32):
            f = rows_of(p, cin, dt)
            key = (level, cin, cout, str(dt))
            times[str(("train_fwd",) + key)] = cs.cuda_ms(
                lambda: band_conv_padded(p.rb_tiles, p.starts, f, w, m,
                                         p.win), 20)
            if cin == 7:  # the stem's gradient takes the gather formulation
                continue
            g = rows_of(p, cout, dt)
            times[str(("bwd",) + key)] = cs.cuda_ms(
                lambda: band_conv_bwd_padded(p.rb_tiles, p.starts, g, f,
                                             w_bwd, m, p.win), 20)
            times[str(("bwd_d_feats",) + key)] = cs.cuda_ms(
                lambda: band_conv_padded(p.rb_tiles, p.starts, g, w_bwd, m,
                                         p.win), 20)
    return times


def bench_band_times(cs, dev) -> dict:
    import torch

    from treemorph_tpu_torch.ops.bandconv import band_conv_padded

    model, _ = cs.ptv3_bench_models(dev)
    captured, _, _ = cs.capture_band_inputs(model, cs.bench_tree_cloud())
    times = {}
    for (k, mp, cin, cout), (args, count) in sorted(captured.items()):
        rb_tiles, starts, feats, w, m, win = args
        times[str(("bench_calls", k, mp, cin, cout))] = count
        for dt in (torch.bfloat16, torch.float32):
            f = feats.to(dt).contiguous()
            times[str(("bench_fwd", k, mp, cin, cout, str(dt)))] = cs.cuda_ms(
                lambda: band_conv_padded(rb_tiles, starts, f, w, m, win), 20)
    return times


def zband_times(cs, dev, points) -> dict:
    import torch

    from treemorph_tpu_torch.ops.bandconv import (
        TILE,
        build_zband_plan,
        zband_conv_padded,
        zband_pack,
    )
    from treemorph_tpu_torch.ops.sparse import build_rulebook

    cases = list(cs.profile_rulebooks(dev))
    for level, (c, v) in enumerate(cs.e2e_levels(points, dev)):
        rb = build_rulebook(c, v)
        cases += [(f"L{level} {cin}->{cout}", rb, v, cin, cout)
                  for lvl, cin, cout, _ in cs.LEVEL_CONVS if lvl == level]
    gen = torch.Generator(device=dev).manual_seed(9)
    times = {}
    for label, rb, valid, cin, cout in cases:
        m, k = rb.shape
        ksize = round(k ** (1 / 3))
        plan = build_zband_plan(rb, valid, res_divisor=cs.ZBAND_RES_DIVISOR)
        mp = plan.anchors.shape[0] * TILE
        w2 = torch.randn((ksize * ksize, ksize * cin, cout), device=dev,
                         generator=gen) / (k * cin) ** 0.5
        feats = torch.randn((m, cin), device=dev, generator=gen)
        feats *= valid[:, None]
        for dt in (torch.bfloat16, torch.float32):
            zq = zband_pack(feats.to(dt), plan.zoff, ksize, mp)
            args = (plan.anchors, plan.starts, zq, w2, m, plan.win)
            times[str(("zband", label, str(dt)))] = cs.cuda_ms(
                lambda: zband_conv_padded(*args), 20)
    return times


def attention_times(cs, dev, points) -> dict:
    import torch
    import torch.nn.functional as F

    from treemorph_tpu_torch.ops.attention import (
        allowed_pairs,
        window_attention,
    )

    model, _ = cs.ptv3_models(dev)
    captured, _ = cs.capture_attention_inputs(model, cs.ptv3_cloud(points))
    times = {}
    for shape, ((q, k, v, seg), count) in sorted(captured.items()):
        mask = allowed_pairs(seg)[:, None]
        live = (seg >= 0).any(1)
        for dt in (torch.float32, torch.bfloat16):
            args = (q.to(dt), k.to(dt), v.to(dt), seg)
            key = shape + (str(dt),)
            times[str(("attn_calls",) + key)] = count
            times[str(("attn_fwd",) + key)] = cs.cuda_ms(
                lambda: window_attention(*args), 20)
            times[str(("attn_sdpa",) + key)] = cs.cuda_ms(
                lambda: F.scaled_dot_product_attention(*args[:3],
                                                       attn_mask=mask), 5)
            if live.all():
                continue
            # the two parts of a launch with padding windows: its windows
            # that hold a row alone, and its shape with every row padding
            part = tuple(a[live] for a in args)
            times[str(("attn_fwd_live",) + key)] = cs.cuda_ms(
                lambda: window_attention(*part), 20)
            empty = args[:3] + (torch.full_like(seg, -1),)
            times[str(("attn_fwd_padding",) + key)] = cs.cuda_ms(
                lambda: window_attention(*empty), 20)
    return times


def main(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import torch

    import chip_smoke as cs
    from treemorph_tpu_torch.ops.cuda import build_all

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    print(f"nvcc build {build_all():.2f} s", flush=True)
    dev = torch.device("cuda", 0)
    points = cs.e2e_cloud()
    times = {**band_times(cs, dev, points), **bench_band_times(cs, dev),
             **zband_times(cs, dev, points),
             **attention_times(cs, dev, points)}
    print("TIMES " + json.dumps(times), flush=True)
    return times


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else os.path.dirname(os.path.abspath(__file__)))
