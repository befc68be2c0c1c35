"""CUDA-event times of the band kernels and the window-attention forward of
one checkout, at the shapes that ``chip_smoke.py`` phases 2, 5 and 7a use.

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
training batch's levels. Attention keys are ``(part, W, H, K, D, type)``:
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


def band_times(cs, dev) -> dict:
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
    plans = cs.e2e_level_plans(cs.e2e_cloud(), dev)
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


def attention_times(cs, dev) -> dict:
    import torch
    import torch.nn.functional as F

    from treemorph_tpu_torch.ops.attention import (
        allowed_pairs,
        window_attention,
    )

    model, _ = cs.ptv3_models(dev)
    captured, _ = cs.capture_attention_inputs(
        model, cs.ptv3_cloud(cs.e2e_cloud()))
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
    times = {**band_times(cs, dev), **attention_times(cs, dev)}
    print("TIMES " + json.dumps(times), flush=True)
    return times


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1
         else os.path.dirname(os.path.abspath(__file__)))
