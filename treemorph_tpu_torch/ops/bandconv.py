"""Banded-window submanifold conv: a hand-written CUDA kernel over windows
of lex-sorted feature rows.

Port of the main-path part of ``treemorph_tpu/ops/bandconv.py``. Every voxel
level is lex-sorted (:mod:`.voxelize`, :func:`.sparse.build_downsample`), so
adding a fixed kernel offset preserves order and every rulebook COLUMN is
monotone over its found entries. For a tile of 128 consecutive output rows,
all found neighbors of one (dx, dy) group (its ksize dz offsets) lie in
a narrow window of feature rows. :func:`build_band_plan` anchors one
``win``-row window per (tile, group); the kernel (``csrc/band_conv.cu``,
through :func:`band_conv_padded`) applies each offset's filter to the rows
of its window that the tile's rulebook finds, as a gathered GEMM on the
tensor cores. The kernel takes 3x3x3 convs (every TreeLearn conv and PTv3
xCPE) and 5x5x5 ones (PTv3's stem, ``Embedding(engine="band")``, and
``TreeLearn(kernel_size=5)``), and so does the backward.

Exactness: found neighbors that fall outside their window (the tail of the
band-width distribution) are repaired by a mini gather pass
(:func:`_residual_repair`) over the output rows that own them. If those rows
overflow their cap (``max(m // 32, 256)``), the plan is not ``ok`` and
:func:`band_subm_conv_apply` takes the exact gather engine instead, so the
engine is exact either way.

Gradients: :class:`_BandConv` is the ``torch.autograd.Function`` of the
JAX package's ``_band_conv_vjp``. Its backward runs
:func:`band_conv_bwd_padded` over the same plan (``csrc/band_conv_bwd.cu``
for the weight gradient, the forward kernel for the feature gradient) and
repairs the residual entries in f32. A conv whose features need no
gradient (the stem, on raw voxel features) takes the gather formulation for
its weight gradient, as the JAX package's ``needs_feats_grad=False`` convs
do.

The z-packed variant (:class:`ZBandPlan`, :func:`zband_subm_conv_apply`,
the z-band instances of ``csrc/band_conv.cu`` through
:func:`zband_conv_padded`) packs each row's ksize z-neighbors into one row,
so a (dx, dy) group is one row read and one (ksize*Cin, Cout) product.
Nothing builds a ``ZBandPlan`` on its own
(:func:`choose_band_plan` never does); a caller passes one to
:func:`.sparse.subm_conv_apply`, as
``python -m treemorph_tpu_torch.scripts.profile_zband`` does. Types, in
both band engines: bf16 mode rounds the features to bf16, keeps the
weights f32 and sums exact products in f32 (the band kernels split each
weight into three bf16 pieces, or multiply bf16 by bf16 for the weight
gradient); f32 mode reads f32 features (3xTF32 in the band kernels). The JAX
package's kernels instead select f32 features as a bf16 hi/lo pair (about
16 mantissa bits), so in f32 mode the port sits nearer the exact sum than
the JAX package does, and is held to it at 1e-4 of the output's scale
rather than 1e-5.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from ..utils import flops
from .cuda import LAUNCHES, check_launch, load_library, stream_handle

TILE = 128  # output rows per kernel block
WIN = 448  # feature-window rows per (dx, dy) group
ALIGN = 64  # window anchors are stored in units of 64 rows

#: kernel sizes (offsets) the band kernels take, forward and backward:
#: 3x3x3 convs, and 5x5x5 ones (PTv3's stem, TreeLearn(kernel_size=5))
KERNEL_SIZES = (27, 125)
#: the (Cin, Cout) channel slices of csrc/band_conv_bwd.cu
_BWD_SLICE = 32

#: convs :func:`band_subm_conv_apply` sent to the gather engine, by reason
GATHER_ROUTES: Counter = Counter()


class BandPlan(NamedTuple):
    """Banded conv schedule for one voxel level (any number of convs)."""

    rulebook: torch.Tensor  # (M, K) int64, M = missing
    rb_tiles: torch.Tensor  # (n_tiles, K, TILE) int32 tiled rulebook
    starts: torch.Tensor  # (G, n_tiles) int32 window anchor, ALIGN units
    ok: torch.Tensor  # () bool: rows with out-of-window entries fit the cap
    valid: torch.Tensor  # (M,) bool
    res_rows: torch.Tensor  # (R,) int64 output rows owning such entries
    res_rb: torch.Tensor  # (R, K) int64 rulebook restricted to them
    res_valid: torch.Tensor  # (R,) bool live residual rows
    win: int  # window rows (a multiple of ALIGN)


def build_band_plan(
    rulebook: torch.Tensor,
    valid: torch.Tensor,
    window: int = WIN,
) -> BandPlan:
    """Window schedule from an existing rulebook (monotone columns).

    Offsets are grouped by their (dx, dy) plane column — ksize consecutive
    rulebook columns in kernel-offset order (dz fastest) share one
    ``window``-row feature window anchored at the ALIGN-row floor of the
    group's first found neighbor."""
    m, k = rulebook.shape
    dev = rulebook.device
    ksize = round(k ** (1 / 3))
    g = ksize * ksize
    win = -(-window // ALIGN) * ALIGN
    mp = max(-(-m // TILE), -(-win // TILE), -(-win // ALIGN)) * TILE
    mp = -(-mp // ALIGN) * ALIGN
    n_tiles = mp // TILE
    pad = mp - m

    rb = torch.cat(
        [rulebook, torch.full((pad, k), m, dtype=rulebook.dtype, device=dev)]
    )  # (Mp, K); found entries stay < m
    tiles = rb.reshape(n_tiles, TILE, k).transpose(1, 2)  # (n_tiles, K, T)
    grouped = tiles.reshape(n_tiles, g, ksize, TILE)
    found = grouped < m
    min_idx = torch.where(found, grouped, mp).amin(dim=(2, 3))  # (n_tiles, G)
    has = found.any(dim=3).any(dim=2)
    base8 = torch.div(
        torch.where(has, min_idx, 0).clamp(0, mp - win), ALIGN,
        rounding_mode="floor",
    )
    local = grouped - (base8 * ALIGN)[:, :, None, None]
    viol = found & ((local < 0) | (local >= win))
    # compact the output ROWS owning any out-of-window entry; each carries
    # its rulebook restricted to just those entries. Fill rows use m-1 so
    # the list stays ascending (fill contributions are zero).
    rcap = max(m // 32, 256)
    row_viol = viol.any(dim=2).any(dim=1)  # (n_tiles, TILE)
    count = row_viol.sum()
    rows = torch.nonzero(row_viol.reshape(-1)).squeeze(1)[:rcap]
    res_rows = torch.full((rcap,), m - 1, dtype=torch.int64, device=dev)
    res_rows[: rows.shape[0]] = rows
    res_valid = torch.arange(rcap, device=dev) < count
    res_rows = torch.where(res_valid, res_rows, m - 1)
    # (Mp, K) rulebook masked to out-of-window entries, sliced per row
    viol_mk = viol.reshape(n_tiles, k, TILE).transpose(1, 2).reshape(mp, k)
    rb_masked = torch.where(viol_mk, rb, m)
    res_rb = torch.where(res_valid[:, None], rb_masked[res_rows], m)
    return BandPlan(
        rulebook=rulebook,
        rb_tiles=tiles.to(torch.int32).contiguous(),
        starts=base8.T.to(torch.int32).contiguous(),
        ok=count <= rcap,
        valid=valid,
        res_rows=res_rows,
        res_rb=res_rb,
        res_valid=res_valid,
        win=win,
    )


def in_window(rb_tiles: torch.Tensor, starts: torch.Tensor, m: int,
              win: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(idx, ok)``: the tiled rulebook as int64 and the mask of its found
    entries that lie inside the window of their (tile, group), both
    (n_tiles, K, TILE) — the entries the kernels apply."""
    k = rb_tiles.shape[1]
    ksize = round(k ** (1 / 3))
    idx = rb_tiles.to(torch.int64)
    group = torch.arange(k, device=idx.device) // ksize
    base = (starts.to(torch.int64) * ALIGN)[group].T  # (n_tiles, K)
    local = idx - base[:, :, None]
    return idx, (idx < m) & (local >= 0) & (local < win)


def band_conv_padded_plain(
    rb_tiles: torch.Tensor,  # (n_tiles, K, TILE) int32
    starts: torch.Tensor,  # (G, n_tiles) int32, ALIGN units
    feats: torch.Tensor,  # (Mp, Cin) bf16 or f32, Mp = n_tiles * TILE
    weights: torch.Tensor,  # (K, Cin, Cout) f32
    m: int,
    win: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_conv_padded`: the same function
    as K masked gathers and matmuls in f32. (Mp, Cout) float32."""
    n_tiles, k, tile = rb_tiles.shape
    idx, ok = in_window(rb_tiles, starts, m, win)
    f32 = feats.float()
    out = torch.zeros(
        (n_tiles * tile, weights.shape[-1]), dtype=torch.float32,
        device=feats.device,
    )
    for j in range(k):
        rows = idx[:, j, :].reshape(-1)
        keep = ok[:, j, :].reshape(-1)
        gathered = f32[torch.where(keep, rows, 0)] * keep[:, None]
        out = out + gathered @ weights[j]
    return out


def band_conv_padded(
    rb_tiles: torch.Tensor,
    starts: torch.Tensor,
    feats: torch.Tensor,
    weights: torch.Tensor,
    m: int,
    win: int,
) -> torch.Tensor:
    """For every 128-row output tile t and row i, the sum over found
    in-window rulebook entries of ``feats[rb[t, k, i]] @ W[k]`` (see
    :func:`band_conv_padded_plain`); (Mp, Cout) float32.

    On a CUDA tensor this launches the kernel of ``csrc/band_conv.cu`` (its
    weight split, then its GEMM) or raises; a CPU tensor takes the plain
    version."""
    if flops.counting():
        flops.log_kernel_flops("band_conv", _band_flops(
            rb_tiles, starts, m, win, feats.shape[1], weights.shape[-1]))
    if feats.device.type == "cpu":
        return band_conv_padded_plain(rb_tiles, starts, feats, weights, m, win)
    if feats.device.type != "cuda":
        raise ValueError(f"band_conv_padded: unsupported device {feats.device}")
    n_tiles, k, _ = rb_tiles.shape
    mp, cin = feats.shape
    kw, cin_w, cout = weights.shape
    if kw != k or cin_w != cin:
        raise ValueError(
            f"band_conv_padded: shapes feats {tuple(feats.shape)}, weights "
            f"{tuple(weights.shape)}, rb_tiles {tuple(rb_tiles.shape)}"
        )
    _check_plan_args("band_conv_padded", rb_tiles, starts, mp, win)
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"band_conv_padded: feats dtype {feats.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"band_conv_padded: weights dtype {weights.dtype}")
    tensors = (rb_tiles, starts, feats, weights)
    if any(t.device != feats.device for t in tensors):
        raise ValueError("band_conv_padded: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("band_conv_padded: tensors must be contiguous")

    lib = _library()
    bf16 = int(feats.dtype == torch.bfloat16)
    out = torch.empty((mp, cout), dtype=torch.float32, device=feats.device)
    workspace = torch.empty(
        lib.band_conv_workspace_bytes(k, cin, cout, bf16), dtype=torch.uint8,
        device=feats.device,
    )
    with torch.cuda.device(feats.device):
        rc = lib.band_conv_launch(
            rb_tiles.data_ptr(), starts.data_ptr(), feats.data_ptr(), bf16,
            weights.data_ptr(), out.data_ptr(), workspace.data_ptr(),
            n_tiles, k, cin, cout, m, win, stream_handle(feats.device),
        )
    check_launch("band_conv", rc)
    LAUNCHES["band_conv"] += 1
    LAUNCHES[f"band_conv_k{k}"] += 1  # the same launches, by kernel size
    return out


def _band_flops(rb_tiles, starts, m, win, cin, cout) -> torch.Tensor:
    """The band kernels' analytic FLOPs on a plan (:mod:`..utils.flops`):
    2 x the in-window rulebook entries x Cin x Cout, a device tensor."""
    return 2 * in_window(rb_tiles, starts, m, win)[1].sum() * (cin * cout)


def _check_plan_args(name, rb_tiles, starts, mp, win):
    """Raise unless the tiled rulebook and anchors are a band plan's (int32)
    over ``mp`` rows with K in :data:`KERNEL_SIZES` offsets and a window
    the kernels take."""
    n_tiles, k, tile = rb_tiles.shape
    ksize = round(k ** (1 / 3))
    if k not in KERNEL_SIZES or starts.shape != (ksize * ksize, n_tiles):
        raise ValueError(f"{name} takes K in {KERNEL_SIZES} only (rb_tiles "
                         f"{tuple(rb_tiles.shape)}, starts "
                         f"{tuple(starts.shape)})")
    if tile != TILE or mp != n_tiles * TILE:
        raise ValueError(f"{name}: rb_tiles {tuple(rb_tiles.shape)} over "
                         f"{mp} rows")
    if win % ALIGN or not 0 < win <= mp:
        raise ValueError(f"{name}: window {win}")
    if rb_tiles.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError(f"{name}: rb_tiles and starts must be int32")


def _library():
    lib = load_library("band_conv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        # the band conv and its z-band instances take the same arguments
        for launch in (lib.band_conv_launch, lib.zband_conv_launch):
            launch.argtypes = [p, p, p, i, p, p, p, i, i, i, i, i, i, p]
            launch.restype = ctypes.c_int
        for size in (lib.band_conv_workspace_bytes,
                     lib.zband_conv_workspace_bytes):
            size.argtypes = [i, i, i, i]
            size.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def band_conv_dw_padded_plain(
    rb_tiles: torch.Tensor,  # (n_tiles, K, TILE) int32
    starts: torch.Tensor,  # (G, n_tiles) int32, ALIGN units
    grad: torch.Tensor,  # (Mp, Cout) bf16 or f32 output gradient
    feats: torch.Tensor,  # (Mp, Cin) same dtype, the forward's features
    m: int,
    win: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`band_conv_dw_padded`:
    ``d_w[K-1-k] = sum feats[row] (outer) grad[rb[row, k]]`` over the
    in-window entries, as K masked gathers and matmuls in f32."""
    k = rb_tiles.shape[1]
    idx, ok = in_window(rb_tiles, starts, m, win)
    g32, f32 = grad.float(), feats.float()
    d_w = torch.empty(
        (k, feats.shape[1], grad.shape[1]), dtype=torch.float32,
        device=grad.device,
    )
    for j in range(k):
        rows = idx[:, j, :].reshape(-1)
        keep = ok[:, j, :].reshape(-1)
        d_w[k - 1 - j] = f32.T @ (g32[torch.where(keep, rows, 0)]
                                  * keep[:, None])
    return d_w


def band_conv_bwd_padded_plain(
    rb_tiles: torch.Tensor,  # (n_tiles, K, TILE) int32
    starts: torch.Tensor,  # (G, n_tiles) int32, ALIGN units
    grad: torch.Tensor,  # (Mp, Cout) bf16 or f32 output gradient
    feats: torch.Tensor,  # (Mp, Cin) same dtype, the forward's features
    w_bwd: torch.Tensor,  # (K, Cout, Cin) f32: W[::-1] channel-transposed
    m: int,
    win: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`band_conv_bwd_padded`:
    ``d_feats`` is the band conv of ``grad`` with ``w_bwd``, and ``d_w``
    that of :func:`band_conv_dw_padded_plain`."""
    return (band_conv_padded_plain(rb_tiles, starts, grad, w_bwd, m, win),
            band_conv_dw_padded_plain(rb_tiles, starts, grad, feats, m, win))


def band_conv_bwd_padded(
    rb_tiles: torch.Tensor,
    starts: torch.Tensor,
    grad: torch.Tensor,
    feats: torch.Tensor,
    w_bwd: torch.Tensor,
    m: int,
    win: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Both cotangents of the band conv's kernel part (see
    :func:`band_conv_bwd_padded_plain`): ``(d_feats (Mp, Cin) f32,
    d_w (K, Cin, Cout) f32)``, ``d_w`` in the weights' own offset order.

    On a CUDA tensor this runs the forward kernel on ``(grad, w_bwd)`` for
    ``d_feats`` and :func:`band_conv_dw_padded` for ``d_w``; each raises on
    what its kernel does not take. CPU tensors take the plain versions
    through the same two wrappers. Both kernels take K = 27 and 125."""
    k = rb_tiles.shape[1]
    cout, cin = grad.shape[1], feats.shape[1]
    if w_bwd.shape != (k, cout, cin):
        raise ValueError(
            f"band_conv_bwd_padded: shapes grad {tuple(grad.shape)}, feats "
            f"{tuple(feats.shape)}, w_bwd {tuple(w_bwd.shape)}"
        )
    d_w = band_conv_dw_padded(rb_tiles, starts, grad, feats, m, win)
    return band_conv_padded(rb_tiles, starts, grad, w_bwd, m, win), d_w


def band_conv_dw_padded(
    rb_tiles: torch.Tensor,
    starts: torch.Tensor,
    grad: torch.Tensor,
    feats: torch.Tensor,
    m: int,
    win: int,
) -> torch.Tensor:
    """The weight gradient of the band conv's kernel part (see
    :func:`band_conv_dw_padded_plain`), (K, Cin, Cout) f32.

    On a CUDA tensor this launches ``csrc/band_conv_bwd.cu``, whose
    per-block partial sums are added here, or raises; a CPU tensor takes
    the plain version."""
    if flops.counting():
        flops.log_kernel_flops("band_conv_bwd", _band_flops(
            rb_tiles, starts, m, win, feats.shape[1], grad.shape[1]))
    if grad.device.type == "cpu":
        return band_conv_dw_padded_plain(rb_tiles, starts, grad, feats, m, win)
    if grad.device.type != "cuda":
        raise ValueError(
            f"band_conv_bwd_padded: unsupported device {grad.device}"
        )
    n_tiles, k, _ = rb_tiles.shape
    mp, cout = grad.shape
    cin = feats.shape[1]
    if feats.shape[0] != mp:
        raise ValueError(
            f"band_conv_bwd_padded: shapes grad {tuple(grad.shape)}, feats "
            f"{tuple(feats.shape)}"
        )
    _check_plan_args("band_conv_bwd_padded", rb_tiles, starts, mp, win)
    if feats.dtype != grad.dtype or grad.dtype not in (torch.bfloat16,
                                                       torch.float32):
        raise TypeError("band_conv_bwd_padded: grad and feats must share "
                        f"bf16 or f32 ({grad.dtype}, {feats.dtype})")
    tensors = (rb_tiles, starts, grad, feats)
    if any(t.device != grad.device for t in tensors):
        raise ValueError("band_conv_bwd_padded: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("band_conv_bwd_padded: tensors must be contiguous")

    lib = _bwd_library()
    n_blocks, per_block = _bwd_grid(n_tiles, k, cin, cout)
    partial = torch.empty(
        (n_blocks, k, cin, cout), dtype=torch.float32, device=grad.device
    )
    with torch.cuda.device(grad.device):
        rc = lib.band_conv_bwd_launch(
            rb_tiles.data_ptr(), starts.data_ptr(), grad.data_ptr(),
            feats.data_ptr(), int(grad.dtype == torch.bfloat16),
            partial.data_ptr(), n_blocks, n_tiles, per_block, k, cin, cout,
            m, win, stream_handle(grad.device),
        )
    check_launch("band_conv_bwd", rc)
    LAUNCHES["band_conv_bwd"] += 1
    return partial.sum(dim=0)


#: per kernel size K: the blocks the weight-gradient kernel aims for, and
#: the offsets a block owns. K = 27: two waves of one block (a dx plane's 9
#: offsets, 200 KB of shared memory) on each of an H100's 132 SMs. K = 125:
#: four waves of one block (a (dx, dy) group's 5 offsets, 120 KB): its
#: blocks are smaller, so more of them even out the tail. The partial sums
#: (n_blocks, K, Cin, Cout) f32 stay near 10 MB at TreeLearn's K = 125
#: widths (32->32: 21 blocks along the tiles, 10.8 MB; 64->64: 5, 10.2 MB;
#: 128->64: 2, 8.2 MB; 96->96: 2, 9.2 MB), as at K = 27 (9.0-9.7 MB).
_BWD_TARGET_BLOCKS = {27: 2 * 132, 125: 4 * 132}
_BWD_UNIT = {27: 9, 125: 5}


def _bwd_grid(n_tiles: int, k: int, cin: int,
              cout: int) -> tuple[int, int]:
    """(blocks along the tiles, tiles per block) of the weight-gradient
    kernel, whose grid is that times K / unit blocks of offsets times the
    32 x 32 channel slices."""
    slices = -(-cin // _BWD_SLICE) * -(-cout // _BWD_SLICE)
    units = k // _BWD_UNIT[k]
    n_blocks = max(1, min(n_tiles, _BWD_TARGET_BLOCKS[k] // (units * slices)))
    per_block = -(-n_tiles // n_blocks)
    return -(-n_tiles // per_block), per_block


def _bwd_library():
    lib = load_library("band_conv_bwd")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.band_conv_bwd_launch.argtypes = [
            p, p, p, p, i, p, i, i, i, i, i, i, i, i, p,
        ]
        lib.band_conv_bwd_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def band_viable(k: int, cin: int, cout: int, dtype) -> bool:
    """Whether the forward kernel takes this conv shape: 3x3x3 or 5x5x5
    kernels in bf16 or f32. The kernel stages 64 bytes of a row at a time,
    splits outputs wider than 128 columns over blocks and gathers rows
    rather than staging windows, so its shared memory is the same at every
    width and window (the TPU gate was a VMEM budget that turned deep wide
    levels away); only ``k`` and the type decide."""
    return k in KERNEL_SIZES and dtype in (torch.bfloat16, torch.float32)


def _band_impl(feats, weights, plan: BandPlan, valid, dtype):
    m, cin = feats.shape
    mp = plan.rb_tiles.shape[0] * TILE
    masked = feats * valid[:, None]
    fpad = torch.zeros((mp, cin), dtype=dtype, device=feats.device)
    fpad[:m] = masked
    out = band_conv_padded(
        plan.rb_tiles, plan.starts, fpad, weights.float().contiguous(), m,
        plan.win,
    )[:m]
    out = out.index_add(
        0, plan.res_rows, _residual_repair(masked, weights, plan, m)
    )
    return out * valid[:, None]


def _residual_repair(masked, weights, plan, m):
    """Mini gather conv over just the rows whose windows missed entries:
    one (R, K) row gather and one (R, K*Cin) x (K*Cin, Cout) f32 matmul."""
    cin = masked.shape[1]
    k, _, cout = weights.shape
    feats_pad = torch.cat(
        [masked, torch.zeros((1, cin), dtype=masked.dtype,
                             device=masked.device)]
    )
    gathered = feats_pad[plan.res_rb.clamp(max=m)]  # (R, K, Cin)
    contrib = gathered.reshape(-1, k * cin) @ weights.reshape(k * cin, cout)
    return contrib * plan.res_valid[:, None]


def _band_grads(feats, weights, plan: BandPlan, valid, grad, dtype):
    """The band path of the JAX package's ``_band_conv_bwd``: both
    cotangents from :func:`band_conv_bwd_padded` over the plan's windows
    (gradient and features rounded to ``dtype``, f32 weights and sums),
    plus the residual entries, which the plan assigns to the rows that own
    them, in f32 from one shared (R, K) gather of gradient rows."""
    m, cin = feats.shape
    k, _, cout = weights.shape
    mp = plan.rb_tiles.shape[0] * TILE
    feats_m = feats * valid[:, None]
    g_m = grad.float() * valid[:, None]
    # offs[j] == -offs[K-1-j]: the transposed conv is a conv with the
    # offset-flipped, channel-transposed kernel over the same rulebook
    w_bwd = weights.float().flip(0).transpose(1, 2).contiguous()
    gpad = torch.zeros((mp, cout), dtype=dtype, device=feats.device)
    gpad[:m] = g_m
    fpad = torch.zeros((mp, cin), dtype=dtype, device=feats.device)
    fpad[:m] = feats_m
    d_f, d_w = band_conv_bwd_padded(
        plan.rb_tiles, plan.starts, gpad, fpad, w_bwd, m, plan.win
    )
    g_pad = torch.cat(
        [g_m, torch.zeros((1, cout), dtype=g_m.dtype, device=g_m.device)]
    )
    gath = g_pad[plan.res_rb.clamp(max=m)] * plan.res_valid[:, None, None]
    gath = gath.reshape(-1, k * cout)  # (R, K*Cout)
    d_f = d_f[:m].index_add(
        0, plan.res_rows, gath @ w_bwd.reshape(k * cout, cin)
    )
    f_res = feats_m[plan.res_rows].float() * plan.res_valid[:, None]
    # d_w[K-1-j] += feats[r] (outer) g[res_rb[r, j]] over residual entries
    dw_res = (gath.T @ f_res).reshape(k, cout, cin)
    return d_f * valid[:, None], d_w + dw_res.transpose(1, 2).flip(0)


class _BandConv(torch.autograd.Function):
    """The band conv with the JAX package's ``_band_conv_vjp`` gradient.
    When the features need no gradient (the stem, on raw voxel features),
    the weight gradient takes the gather formulation, as the JAX package's
    ``needs_feats_grad=False`` convs do."""

    @staticmethod
    def forward(ctx, feats, weights, valid, plan, dtype):
        ctx.save_for_backward(feats, weights, valid)
        ctx.plan, ctx.dtype = plan, dtype
        return _band_impl(feats, weights, plan, valid, dtype)

    @staticmethod
    def backward(ctx, grad):
        from .sparse import _gather_grads

        feats, weights, valid = ctx.saved_tensors
        if ctx.needs_input_grad[0]:
            d_feats, d_w = _band_grads(
                feats, weights, ctx.plan, valid, grad, ctx.dtype
            )
            d_feats = d_feats.to(feats.dtype)
        else:
            d_feats, d_w = _gather_grads(
                ctx.dtype, feats, weights, ctx.plan.rulebook, valid, grad,
                False,
            )
        return d_feats, d_w.to(weights.dtype), None, None, None


def band_subm_conv_apply(
    feats: torch.Tensor,  # (M, Cin)
    weights: torch.Tensor,  # (K, Cin, Cout), kernel-offset layout
    plan: BandPlan,
    valid: torch.Tensor,
    compute_dtype=None,
) -> torch.Tensor:
    """Submanifold conv on the band engine; same weights layout as
    :func:`.sparse.subm_conv_apply`. Takes the exact gather engine when the
    plan's residual cap overflowed (``plan.ok`` false) or the kernels do
    not take the shape."""
    from .sparse import _subm_conv

    dtype = compute_dtype or feats.dtype
    k, cin, cout = weights.shape
    gather_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    viable = band_viable(k, cin, cout, dtype)
    if not viable or not bool(plan.ok):
        GATHER_ROUTES["shape" if not viable else "overflow"] += 1
        return _subm_conv(gather_dtype, feats, weights, plan.rulebook, valid)
    return _BandConv.apply(feats, weights, valid, plan, gather_dtype)


def choose_band_plan(
    rulebook: torch.Tensor,
    valid: torch.Tensor,
    cin: int,
    cout: int,
    dtype,
    window: int = WIN,
):
    """Band plan for a level, or the rulebook unchanged (gather engine)
    when the kernel does not take the level's widest conv."""
    k = rulebook.shape[1]
    if band_viable(k, cin, cout, dtype):
        return build_band_plan(rulebook, valid, window)
    return rulebook


# ---------------------------------------------------------------------------
# z-packed band conv: one anchor row per (dx, dy) group
# ---------------------------------------------------------------------------

ZALIGN = 8  # z-band window anchors are stored in units of 8 rows


class ZBandPlan(NamedTuple):
    """Banded conv schedule with z-packed feature bands.

    Row ``i`` of the packed features ``zq`` holds, for dz = -r..r, the
    features of the voxel at (b, x, y, z_i + dz) or zeros (``zoff`` says
    which row that is). The rulebook's ksize entries of one (dx, dy) group
    of row ``i`` are then the bands of ONE row, the group's dz = 0 entry
    (its anchor): a group costs one row read and one (ksize*Cin, Cout)
    product. Entries of groups whose anchor is missing or outside its
    window go to the residual repair, as in :class:`BandPlan`."""

    rulebook: torch.Tensor  # (M, K) int64 full rulebook (gather route)
    anchors: torch.Tensor  # (n_tiles, G, TILE) int32 dz=0 neighbor rows
    starts: torch.Tensor  # (G, n_tiles) int32 window anchor, ZALIGN units
    zoff: torch.Tensor  # (M, ksize-1) int64 row shift of the z+dz voxel
    # (slots dz = -r..-1, +1..+r), 0 = missing
    ok: torch.Tensor  # () bool: residual rows fit the cap
    valid: torch.Tensor  # (M,) bool
    res_rows: torch.Tensor  # (R,) int64 output rows owning residual entries
    res_rb: torch.Tensor  # (R, K) int64 rulebook restricted to them
    res_valid: torch.Tensor  # (R,) bool
    win: int  # window rows (a multiple of ZALIGN)


def build_zband_plan(
    rulebook: torch.Tensor,
    valid: torch.Tensor,
    window: int = WIN,
    res_divisor: int = 4,
) -> ZBandPlan:
    """Window schedule anchored at each (dx, dy) group's dz=0 column, on
    :func:`build_band_plan`'s premise (lex-sorted level, monotone rulebook
    columns). The z-shift table comes from the center group's columns: the
    (0, 0, dz) neighbor of row i sits at row i+s with |s| <= |dz|."""
    m, k = rulebook.shape
    dev = rulebook.device
    ksize = round(k ** (1 / 3))
    r = (ksize - 1) // 2
    g = ksize * ksize
    win = -(-window // ZALIGN) * ZALIGN
    mp = max(-(-m // TILE), -(-win // TILE)) * TILE
    n_tiles = mp // TILE
    pad = mp - m

    iota = torch.arange(m, device=dev)
    gc = (g - 1) // 2  # center (dx = dy = 0) group
    zoff = torch.stack([
        torch.where(col < m, col - iota, 0)
        for col in (rulebook[:, gc * ksize + dz + r]
                    for dz in [*range(-r, 0), *range(1, r + 1)])
    ], dim=1)

    rb = torch.cat(
        [rulebook, torch.full((pad, k), m, dtype=rulebook.dtype, device=dev)]
    )
    tiles = rb.reshape(n_tiles, TILE, k).transpose(1, 2)  # (n_tiles, K, T)
    grouped = tiles.reshape(n_tiles, g, ksize, TILE)
    found = grouped < m
    anchors = grouped[:, :, r, :]  # (n_tiles, G, TILE)
    anc_found = found[:, :, r, :]
    min_idx = torch.where(anc_found, anchors, mp).amin(dim=2)
    has = anc_found.any(dim=2)
    base8 = torch.div(
        torch.where(has, min_idx, 0).clamp(0, mp - win), ZALIGN,
        rounding_mode="floor",
    )
    local = anchors - (base8 * ZALIGN)[:, :, None]
    covered = anc_found & (local >= 0) & (local < win)
    viol = found & ~covered[:, :, None, :]

    # missing-anchor groups (a found dz != 0 entry whose dz = 0 column is
    # empty: surface slopes end z-columns) are residual too, so the cap is
    # larger than BandPlan's
    rcap = max(m // res_divisor, 256)
    row_viol = viol.any(dim=2).any(dim=1)  # (n_tiles, TILE)
    count = row_viol.sum()
    rows = torch.nonzero(row_viol.reshape(-1)).squeeze(1)[:rcap]
    res_rows = torch.full((rcap,), m - 1, dtype=torch.int64, device=dev)
    res_rows[: rows.shape[0]] = rows
    res_valid = torch.arange(rcap, device=dev) < count
    res_rows = torch.where(res_valid, res_rows, m - 1)
    viol_mk = viol.reshape(n_tiles, k, TILE).transpose(1, 2).reshape(mp, k)
    rb_masked = torch.where(viol_mk, rb, m)
    res_rb = torch.where(res_valid[:, None], rb_masked[res_rows], m)
    return ZBandPlan(
        rulebook=rulebook,
        anchors=anchors.to(torch.int32).contiguous(),
        starts=base8.T.to(torch.int32).contiguous(),
        zoff=zoff,
        ok=count <= rcap,
        valid=valid,
        res_rows=res_rows,
        res_rb=res_rb,
        res_valid=res_valid,
        win=win,
    )


def zband_pack(feats: torch.Tensor, zoff: torch.Tensor, ksize: int,
               mp: int) -> torch.Tensor:
    """(Mp, ksize*Cin) z-packed rows of the (M, Cin) features, bands
    ordered dz = -r..r (the kernel-offset order within a group), zero rows
    below ``mp``: band dz of row i is ``feats[i + s]`` where ``zoff`` gives
    the shift ``s`` of the (0, 0, dz) neighbor (|s| <= |dz|), else 0."""
    m, cin = feats.shape
    r = (ksize - 1) // 2
    zq = torch.zeros((mp, ksize * cin), dtype=feats.dtype,
                     device=feats.device)
    zq[:m, r * cin:(r + 1) * cin] = feats
    for t, dz in enumerate([*range(-r, 0), *range(1, r + 1)]):
        band = zq[:m, (dz + r) * cin:(dz + r + 1) * cin]
        step = 1 if dz > 0 else -1
        for s in range(step, dz + step, step):
            hit = zoff[:, t] == s
            lo, hi = max(0, -s), min(m, m - s)  # rows whose i + s is a row
            rows = torch.nonzero(hit[lo:hi]).squeeze(1) + lo
            band[rows] = feats[rows + s]
    return zq


def zband_conv_padded_plain(
    anchors: torch.Tensor,  # (n_tiles, G, TILE) int32
    starts: torch.Tensor,  # (G, n_tiles) int32, ZALIGN units
    zq: torch.Tensor,  # (Mp, ksize*Cin) bf16 or f32
    w2: torch.Tensor,  # (G, ksize*Cin, Cout) f32
    m: int,
    win: int,
) -> torch.Tensor:
    """Plain PyTorch version of :func:`zband_conv_padded`: per group, the
    covered anchors' packed rows gathered and multiplied in f32.
    (Mp, Cout) float32."""
    n_tiles, g, tile = anchors.shape
    idx = anchors.to(torch.int64)
    local = idx - (starts.to(torch.int64) * ZALIGN).T[:, :, None]
    ok = (idx < m) & (local >= 0) & (local < win)
    f32 = zq.float()
    out = torch.zeros((n_tiles * tile, w2.shape[-1]), dtype=torch.float32,
                      device=zq.device)
    for gi in range(g):
        keep = ok[:, gi, :].reshape(-1)
        rows = torch.where(keep, idx[:, gi, :].reshape(-1), 0)
        out = out + (f32[rows] * keep[:, None]) @ w2[gi]
    return out


def _zband_flops(anchors, starts, m, win, e, cout) -> torch.Tensor:
    """The z-band kernel's analytic FLOPs (:mod:`..utils.flops`): 2 x the
    found in-window anchors x ksize*Cin (``e``) x Cout, a device
    tensor."""
    idx = anchors.to(torch.int64)
    local = idx - (starts.to(torch.int64) * ZALIGN).T[:, :, None]
    ok = (idx < m) & (local >= 0) & (local < win)
    return 2 * ok.sum() * (e * cout)


def zband_conv_padded(
    anchors: torch.Tensor,
    starts: torch.Tensor,
    zq: torch.Tensor,
    w2: torch.Tensor,
    m: int,
    win: int,
) -> torch.Tensor:
    """For every 128-row output tile t and row i, the sum over (dx, dy)
    groups g whose anchor ``a = anchors[t, g, i]`` is found (< m) and lies
    in the group's window ``[8 * starts[g, t], + win)`` of
    ``zq[a] @ w2[g]`` (see :func:`zband_conv_padded_plain`); (Mp, Cout)
    float32.

    On a CUDA tensor this launches the z-band instance of
    ``csrc/band_conv.cu`` (its weight split, then its GEMM, with the groups
    as the offsets) or raises; a CPU tensor takes the plain version."""
    if flops.counting():
        flops.log_kernel_flops("zband_conv", _zband_flops(
            anchors, starts, m, win, zq.shape[1], w2.shape[-1]))
    if zq.device.type == "cpu":
        return zband_conv_padded_plain(anchors, starts, zq, w2, m, win)
    if zq.device.type != "cuda":
        raise ValueError(f"zband_conv_padded: unsupported device {zq.device}")
    n_tiles, g, tile = anchors.shape
    mp, e = zq.shape
    gw, e_w, cout = w2.shape
    if g not in (9, 25) or gw != g:
        raise ValueError(
            f"zband_conv_padded takes 3x3x3 and 5x5x5 kernels (G={g}, {gw})"
        )
    if tile != TILE or mp != n_tiles * TILE or e_w != e or e % round(
            g ** 0.5):
        raise ValueError(
            f"zband_conv_padded: shapes anchors {tuple(anchors.shape)}, zq "
            f"{tuple(zq.shape)}, w2 {tuple(w2.shape)}"
        )
    if starts.shape != (g, n_tiles) or win % ZALIGN or not 0 < win <= mp:
        raise ValueError(
            f"zband_conv_padded: starts {tuple(starts.shape)}, win {win}"
        )
    if anchors.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("zband_conv_padded: anchors and starts must be int32")
    if zq.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"zband_conv_padded: zq dtype {zq.dtype}")
    if w2.dtype != torch.float32:
        raise TypeError(f"zband_conv_padded: w2 dtype {w2.dtype}")
    tensors = (anchors, starts, zq, w2)
    if any(t.device != zq.device for t in tensors):
        raise ValueError("zband_conv_padded: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("zband_conv_padded: tensors must be contiguous")

    lib = _library()
    bf16 = int(zq.dtype == torch.bfloat16)
    out = torch.empty((mp, cout), dtype=torch.float32, device=zq.device)
    workspace = torch.empty(
        lib.zband_conv_workspace_bytes(g, e, cout, bf16), dtype=torch.uint8,
        device=zq.device,
    )
    with torch.cuda.device(zq.device):
        rc = lib.zband_conv_launch(
            anchors.data_ptr(), starts.data_ptr(), zq.data_ptr(), bf16,
            w2.data_ptr(), out.data_ptr(), workspace.data_ptr(), n_tiles, g,
            e, cout, m, win, stream_handle(zq.device),
        )
    check_launch("zband_conv", rc)
    LAUNCHES["zband_conv"] += 1  # not a band_conv launch: its own count
    return out


def zband_viable(k: int, dtype) -> bool:
    """Whether the z-band kernel takes this conv shape: 3x3x3 or 5x5x5
    kernels in bf16 or f32. It is the band kernel's instance at 9 or 25
    groups, so as there only ``k`` and the type decide (the TPU gate was a
    VMEM budget)."""
    return k in (27, 125) and dtype in (torch.bfloat16, torch.float32)


def _zband_impl(feats, weights, plan: ZBandPlan, valid, dtype):
    m, cin = feats.shape
    k, _, cout = weights.shape
    ksize = round(k ** (1 / 3))
    mp = plan.anchors.shape[0] * TILE
    masked = feats * valid[:, None]
    zq = zband_pack(masked.to(dtype), plan.zoff, ksize, mp)
    # (K, Cin, Cout) -> (G, ksize*Cin, Cout): the kernel-offset order runs
    # dz fastest, as zq's bands do
    w2 = weights.float().reshape(ksize * ksize, ksize * cin, cout)
    out = zband_conv_padded(
        plan.anchors, plan.starts, zq, w2.contiguous(), m, plan.win
    )[:m]
    out = out.index_add(
        0, plan.res_rows, _residual_repair(masked, weights, plan, m)
    )
    return out * valid[:, None]


class _ZBandConv(torch.autograd.Function):
    """The z-band conv with the JAX package's ``_zband_conv_vjp`` gradient:
    ``d_feats`` is the same kernel and repair over the same plan on the
    output gradient with the offset-flipped, channel-transposed kernel
    (which entries a window covers depends on the rulebook, not on the
    weights); ``d_w`` is the gather formulation."""

    @staticmethod
    def forward(ctx, feats, weights, valid, plan, dtype):
        ctx.save_for_backward(feats, weights, valid)
        ctx.plan, ctx.dtype = plan, dtype
        return _zband_impl(feats, weights, plan, valid, dtype)

    @staticmethod
    def backward(ctx, grad):
        from .sparse import _gather_grads

        feats, weights, valid = ctx.saved_tensors
        d_feats = None
        if ctx.needs_input_grad[0]:
            w_bwd = weights.flip(0).transpose(1, 2)
            d_feats = _zband_impl(
                grad.float() * valid[:, None], w_bwd, ctx.plan, valid,
                ctx.dtype,
            ).to(feats.dtype)
        _, d_w = _gather_grads(
            ctx.dtype, feats, weights, ctx.plan.rulebook, valid, grad, False
        )
        return d_feats, d_w.to(weights.dtype), None, None, None


def zband_subm_conv_apply(
    feats: torch.Tensor,  # (M, Cin)
    weights: torch.Tensor,  # (K, Cin, Cout), kernel-offset layout
    plan: ZBandPlan,
    valid: torch.Tensor,
    compute_dtype=None,
) -> torch.Tensor:
    """Submanifold conv on the z-packed band engine; same weights layout as
    every other engine. Takes the exact gather engine when the plan's
    residual cap overflowed (``plan.ok`` false) or the kernel does not take
    the shape, and counts each such conv in :data:`GATHER_ROUTES`."""
    from .sparse import _subm_conv

    dtype = compute_dtype or feats.dtype
    gather_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    viable = zband_viable(weights.shape[0], dtype)
    if not viable or not bool(plan.ok):
        GATHER_ROUTES["zband shape" if not viable else "zband overflow"] += 1
        return _subm_conv(gather_dtype, feats, weights, plan.rulebook, valid)
    return _ZBandConv.apply(feats, weights, valid, plan, gather_dtype)
