"""The port's profiling, debug and FLOP-accounting tools (``utils/
profiling.py``, ``utils/debug.py``, ``utils/flops.py``) on the CPU.

The kernel log's count of each hand-kernel wrapper, on its CPU path, is held
to a count made here from the call's inputs with numpy: the in-window
rulebook entries of a band plan, the found in-window anchors of a z-band
plan, the allowed (query, key) pairs of attention windows, the bricks whose
input is not all zero. Outside a counting context nothing is logged.
"""

import json

import numpy as np
import pytest
import torch

from treemorph_tpu_torch.ops import attention, bandconv, brick_conv, cuda
from treemorph_tpu_torch.ops import voxelize as tvox
from treemorph_tpu_torch.ops.sparse import build_rulebook
from treemorph_tpu_torch.utils import debug, flops, profiling

from test_torch_ops import (  # noqa: F401
    fresh_jax_caches, one_torch_thread, surface_cloud,
)


def voxel_level(kernel_size=3, n=1500):
    """(rulebook, valid, m) of a lex-sorted voxel level of a scanned
    surface, voxelized by the port."""
    pts = surface_cloud(0, n)
    p = len(pts) + 64
    coords = torch.zeros((p, 3))
    coords[:len(pts)] = torch.from_numpy(pts)
    valid = torch.arange(p) < len(pts)
    vox = tvox.voxelize(coords, torch.zeros((p, 4)),
                        torch.zeros(p, dtype=torch.int32), valid, 0.02, 1)
    rb = build_rulebook(vox.voxel_coords, vox.voxel_valid, kernel_size)
    return rb, vox.voxel_valid, rb.shape[0]


def band_entries(plan, m) -> int:
    """In-window found rulebook entries of a band plan, counted in numpy
    from its tiled rulebook and window anchors."""
    rb = plan.rb_tiles.numpy().astype(np.int64)  # (T, K, TILE)
    starts = plan.starts.numpy().astype(np.int64)  # (G, T)
    ksize = round(rb.shape[1] ** (1 / 3))
    count = 0
    for t in range(rb.shape[0]):
        for k in range(rb.shape[1]):
            base = starts[k // ksize, t] * bandconv.ALIGN
            row = rb[t, k]
            count += int(((row < m) & (row >= base)
                          & (row < base + plan.win)).sum())
    return count


def pair_count(seg: np.ndarray) -> int:
    """Allowed (query, key) pairs per head: each window's segment sizes
    squared, padding (-1) left out."""
    total = 0
    for window in seg:
        _, counts = np.unique(window[window >= 0], return_counts=True)
        total += int((counts ** 2).sum())
    return total


def attention_inputs(seed=0, w=3, h=2, k=64, d=8):
    rng = np.random.default_rng(seed)
    q, kk, v = (torch.from_numpy(rng.normal(size=(w, h, k, d)).astype(
        np.float32)) for _ in range(3))
    seg = np.sort(rng.integers(-1, 3, size=(w, k)), axis=1).astype(np.int32)
    return q, kk, v, torch.from_numpy(seg)


def test_band_wrappers_log_their_in_window_entries():
    rb, valid, m = voxel_level()
    plan = bandconv.build_band_plan(rb, valid)
    nnz = band_entries(plan, m)
    assert nnz > 0
    mp = plan.rb_tiles.shape[0] * bandconv.TILE
    gen = torch.Generator().manual_seed(0)
    cin, cout = 4, 6
    feats = torch.randn((mp, cin), generator=gen)
    grad = torch.randn((mp, cout), generator=gen)
    w = torch.randn((27, cin, cout), generator=gen)
    args = (plan.rb_tiles, plan.starts)
    with flops.count_kernel_flops() as log:
        bandconv.band_conv_padded(*args, feats, w, m, plan.win)
    assert log == {"band_conv": 2.0 * nnz * cin * cout}
    with flops.count_kernel_flops() as log:
        bandconv.band_conv_bwd_padded(
            *args, grad, feats, w.flip(0).transpose(1, 2).contiguous(), m,
            plan.win)
    # d_feats (the forward kernel on the gradient) and d_w: one term each
    assert log == {"band_conv": 2.0 * nnz * cout * cin,
                   "band_conv_bwd": 2.0 * nnz * cin * cout}


def test_zband_wrapper_logs_its_in_window_anchors():
    rb, valid, m = voxel_level()
    plan = bandconv.build_zband_plan(rb, valid, res_divisor=1)
    anchors = plan.anchors.numpy().astype(np.int64)  # (T, G, TILE)
    base = (plan.starts.numpy().astype(np.int64) * bandconv.ZALIGN).T
    local = anchors - base[:, :, None]
    found = int(((anchors < m) & (local >= 0) & (local < plan.win)).sum())
    assert found > 0
    mp = plan.anchors.shape[0] * bandconv.TILE
    cin, cout = 4, 5
    zq = torch.randn((mp, 3 * cin))
    w2 = torch.randn((9, 3 * cin, cout))
    with flops.count_kernel_flops() as log:
        bandconv.zband_conv_padded(plan.anchors, plan.starts, zq, w2, m,
                                   plan.win)
    assert log == {"zband_conv": 2.0 * found * 3 * cin * cout}


def test_attention_wrappers_log_their_allowed_pairs():
    q, k, v, seg = attention_inputs()
    pairs = pair_count(seg.numpy())
    h, d = q.shape[1], q.shape[3]
    with flops.count_kernel_flops() as log:
        attention.window_attention(q, k, v, seg)
        attention.window_attention_fwd(q, k, v, seg)
    assert log == {"window_attention": 2 * 4.0 * d * h * pairs}
    q.requires_grad_(True)
    with flops.count_kernel_flops() as log:
        attention.window_attention(q, k, v, seg).sum().backward()
    assert log == {"window_attention": 4.0 * d * h * pairs,
                   "window_attention_bwd": 5.0 * d * h * pairs}


def test_brick_wrapper_logs_its_live_bricks():
    rng = np.random.default_rng(0)
    h = rng.normal(size=(5, 216, 3)).astype(np.float32)
    h[[1, 3]] = 0.0  # two bricks with an all-zero input
    w = torch.from_numpy(rng.normal(size=(27, 3, 4)).astype(np.float32))
    for core_only, cells in ((True, 64), (False, 216)):
        with flops.count_kernel_flops() as log:
            brick_conv.brick_conv_cells(torch.from_numpy(h), w, core_only)
        assert log == {"brick_conv": 2.0 * 3 * cells * 27 * 3 * 4}


def test_nothing_is_logged_outside_the_context(monkeypatch):
    def refuse(*args):
        raise AssertionError("logged outside a counting context")

    monkeypatch.setattr(flops, "log_kernel_flops", refuse)
    rb, valid, m = voxel_level(n=600)
    plan = bandconv.build_band_plan(rb, valid)
    mp = plan.rb_tiles.shape[0] * bandconv.TILE
    bandconv.band_conv_padded(plan.rb_tiles, plan.starts,
                              torch.randn((mp, 2)), torch.randn((27, 2, 2)),
                              m, plan.win)
    q, k, v, seg = attention_inputs()
    attention.window_attention(q, k, v, seg)
    brick_conv.brick_conv_cells(torch.randn((2, 216, 2)),
                                torch.randn((27, 2, 2)))
    assert not flops.counting()


def test_analytic_flops_adds_the_kernel_log_to_the_torch_count():
    """``torch_flops`` is FlopCounterMode's count of the ATen ops outside
    the wrappers (the plain versions a CPU wrapper runs are not counted
    twice), ``kernel_flops`` the log's."""
    from torch.utils.flop_counter import FlopCounterMode

    rb, valid, m = voxel_level(n=600)
    plan = bandconv.build_band_plan(rb, valid)
    mp = plan.rb_tiles.shape[0] * bandconv.TILE
    feats, w = torch.randn((mp, 3)), torch.randn((27, 3, 5))
    x, y = torch.randn((40, 30)), torch.randn((30, 20))

    def fn(x, y):
        out = bandconv.band_conv_padded(plan.rb_tiles, plan.starts, feats, w,
                                        m, plan.win)
        return out.sum() + (x @ y).sum()

    with FlopCounterMode(display=False) as counter:
        x @ y
    got = flops.analytic_flops(fn, x, y)
    kernel = 2.0 * band_entries(plan, m) * 3 * 5
    assert got["torch_flops"] == counter.get_total_flops() == 2 * 40 * 30 * 20
    assert got["kernel_flops"] == kernel
    assert got["total_flops"] == got["torch_flops"] + kernel
    assert not flops.counting()


def test_chip_peak_is_looked_up_by_name_and_unknown_cards_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA H100 80GB HBM3")
    assert flops.chip_peak_flops_bf16() == 989.4e12
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "Some Other Card")
    with pytest.raises(KeyError, match="Some Other Card"):
        flops.chip_peak_flops_bf16()


def test_stage_timer_records(caplog):
    record = {}
    with profiling.stage_timer("stage one", record, device="cpu"):
        sum(range(1000))
    assert list(record) == ["stage one"] and record["stage one"] >= 0.0


def test_annotate_spans_appear_in_the_trace(tmp_path):
    x = torch.randn((64, 64))
    with profiling.device_trace(str(tmp_path)) as prof:
        with profiling.annotate("treemorph_span"):
            x @ x
    assert "treemorph_span" in {e.name for e in prof.events()}
    with open(tmp_path / "trace.json") as f:
        names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
    assert "treemorph_span" in names


def test_enable_nan_checks_catches_a_nan_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    debug.enable_nan_checks(True)
    try:
        with pytest.raises(RuntimeError, match="nan"), pytest.warns(
                UserWarning, match="Error detected in SqrtBackward0"):
            x.sqrt().sum().backward()
    finally:
        debug.enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()


def test_synchronous_mode_synchronizes_after_each_launch_only_inside(
        monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: calls.append(1))
    cuda.check_launch("band_conv", 0)
    assert calls == []
    with debug.debug_mode():
        assert torch.is_anomaly_enabled()
        cuda.check_launch("band_conv", 0)
        with debug.synchronous_mode():
            cuda.check_launch("band_conv", 0)
        cuda.check_launch("band_conv", 0)
    assert calls == [1, 1, 1] and not cuda.SYNCHRONOUS
    assert not torch.is_anomaly_enabled()
    with pytest.raises(RuntimeError, match="CUDA error 7"):
        cuda.check_launch("band_conv", 7)
