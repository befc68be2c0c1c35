"""The operation and byte counts that the MFU and roofline metrics read,
on inputs small enough to count by hand."""

import pytest
import torch

from benchmark.reference import treelearn as R
from benchmark.reference import work
from benchmark.reference.peaks import HBM_BYTES_PER_S, PEAK_FLOPS

CFG = dict(channels=2, num_blocks=2, kernel_size=3, dim_feat=1,
           voxel_size=1.0)


def two_voxels():
    """Three points: two in voxel (0, 0, 0), one in its +z neighbor."""
    coords = torch.tensor([[0.1, 0.1, 0.1], [0.2, 0.3, 0.4],
                           [0.1, 0.1, 1.5]])
    feats = torch.tensor([[1.0], [3.0], [5.0]])
    return R.structure(coords, feats, torch.zeros(3, dtype=torch.int64),
                       1.0, 2)


def test_levels_by_hand():
    st = two_voxels()
    # level 0: voxels z=0 and z=1, each its own neighbor, each the other's
    # under dz = +1 / -1: 4 pairs; level 1: one voxel, its own neighbor
    assert R.level_counts(st) == [(2, 4), (1, 1)]
    assert st.voxel_feats.tolist() == [[2.0, 1, 1, 1], [5.0, 1, 1, 1]]
    assert st.octants[0].tolist() == [0, 1]
    assert st.parents[0].tolist() == [0, 0]


def test_layers_and_flops_by_hand():
    layers = R.conv_layers(CFG, [(2, 4), (1, 1)], points=3)
    kinds = [(l["kind"], l["level"], l["cin"], l["cout"]) for l in layers]
    assert kinds == [
        ("stem", 0, 4, 2),
        ("linear", 0, 4, 2), ("down", 0, 2, 4), ("up", 0, 4, 2),
        ("subm", 0, 2, 2), ("subm", 0, 2, 2), ("subm", 0, 2, 2),
        ("subm", 0, 2, 2), ("subm", 0, 4, 2), ("subm", 0, 2, 2),
        ("subm", 0, 2, 2), ("subm", 0, 2, 2),
        ("subm", 1, 4, 4), ("subm", 1, 4, 4), ("subm", 1, 4, 4),
        ("subm", 1, 4, 4),
        ("linear", None, 2, 2), ("linear", None, 2, 2),
        ("linear", None, 2, 2), ("linear", None, 2, 3),
    ]
    # stem 2*4*4*2; shortcut 2*2*4*2; down and up 2*2*2*4 each; level 0's
    # seven 2->2 convs 2*4*2*2 and its 4->2 one 2*4*4*2; level 1's four
    # 2*1*4*4; heads 3 points: 3 x 2*3*2*2 and 2*3*2*3
    expected = (64 + 32 + 32 + 32 + 7 * 32 + 64 + 4 * 32
                + 3 * 24 + 36)
    assert work.forward_flops(layers) == expected


def test_band_calls_by_hand():
    layers = [dict(kind="stem", level=0, rows=10, pairs=40, cin=4, cout=8,
                   k=27),
              dict(kind="subm", level=0, rows=10, pairs=40, cin=8, cout=8,
                   k=27),
              dict(kind="down", level=0, rows=10, pairs=10, cin=8, cout=16,
                   k=8)]
    calls = work.band_conv_calls(layers, train=True, dtype="bfloat16")
    assert len(calls) == 4  # stem forward; subm forward, d_feats, d_w
    w_stem, w = 4 * 27 * 4 * 8, 4 * 27 * 8 * 8
    rb = 4 * 10 * 27
    assert calls[0] == (2 * 40 * 4 * 8, 10 * 4 * 2 + w_stem + rb + 10 * 8 * 4)
    assert calls[1] == (2 * 40 * 8 * 8, 10 * 8 * 2 + w + rb + 10 * 8 * 4)
    assert calls[2] == (2 * 40 * 8 * 8, 10 * 8 * 2 + w + rb + 10 * 8 * 4)
    assert calls[3] == (2 * 40 * 8 * 8, 10 * 16 * 2 + rb + w)
    serve = work.band_conv_calls(layers, train=False, dtype="float32")
    assert len(serve) == 2 and serve[1][1] == 10 * 8 * 4 + w + rb + 320
    ops, nbytes = calls[1]
    assert work.least_seconds(ops, nbytes, "bfloat16") == pytest.approx(
        max(ops / PEAK_FLOPS["bfloat16"], nbytes / HBM_BYTES_PER_S))


def test_batch_counts_add_up_over_clouds():
    assert R.summed([[(2, 4), (1, 1)], [(5, 9), (2, 2)]]) == [
        (7, 13), (3, 3)]
