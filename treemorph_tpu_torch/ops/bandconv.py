"""Banded-window submanifold conv: a hand-written CUDA kernel over windows
of lex-sorted feature rows.

Port of the main-path part of ``treemorph_tpu/ops/bandconv.py``. Every voxel
level is lex-sorted (:mod:`.voxelize`, :func:`.sparse.build_downsample`), so
adding a fixed kernel offset preserves order and every rulebook COLUMN is
monotone over its found entries. For a tile of 128 consecutive output rows,
all found neighbors of one (dx, dy) group (its 3 dz offsets) therefore lie in
a narrow window of feature rows. :func:`build_band_plan` anchors one
``win``-row window per (tile, group); the kernel (``csrc/band_conv.cu``,
through :func:`band_conv_padded`) stages each window on chip and applies the
group's filters to the rows it finds there.

Exactness: found neighbors that fall outside their window (the tail of the
band-width distribution) are repaired by a mini gather pass
(:func:`_residual_repair`) over the output rows that own them. If those rows
overflow their cap (``max(m // 32, 256)``), the plan is not ``ok`` and
:func:`band_subm_conv_apply` takes the exact gather engine instead, so the
engine is exact either way.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from typing import NamedTuple

import torch

from .cuda import LAUNCHES, check_launch, load_library, stream_handle

TILE = 128  # output rows per kernel block
WIN = 448  # feature-window rows per (dx, dy) group
ALIGN = 64  # window anchors are stored in units of 64 rows

#: the kernel's shared-memory layout (csrc/band_conv.cu): a win x 33-float
#: window chunk plus 3 filters of 32 input channels x up to 64 columns
_CHUNK, _PITCH, _COLS, _MAX_COL_GROUPS = 32, 33, 16, 4
#: shared memory one block may use on an H100
SMEM_LIMIT = 232_448

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
    ksize = round(k ** (1 / 3))
    idx = rb_tiles.to(torch.int64)
    group = torch.arange(k, device=idx.device) // ksize
    base = (starts.to(torch.int64) * ALIGN)[group].T  # (n_tiles, K)
    local = idx - base[:, :, None]
    ok = (idx < m) & (local >= 0) & (local < win)
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

    On a CUDA tensor this launches the kernel of ``csrc/band_conv.cu`` or
    raises; a CPU tensor takes the plain version."""
    if feats.device.type == "cpu":
        return band_conv_padded_plain(rb_tiles, starts, feats, weights, m, win)
    if feats.device.type != "cuda":
        raise ValueError(f"band_conv_padded: unsupported device {feats.device}")
    n_tiles, k, tile = rb_tiles.shape
    mp, cin = feats.shape
    kw, cin_w, cout = weights.shape
    g = starts.shape[0]
    if k != 27 or kw != 27 or g != 9:
        raise ValueError(
            f"band_conv_padded takes 3x3x3 kernels only (K={k}, {kw})"
        )
    if tile != TILE or mp != n_tiles * TILE or cin_w != cin:
        raise ValueError(
            f"band_conv_padded: shapes rb_tiles {tuple(rb_tiles.shape)}, "
            f"feats {tuple(feats.shape)}, weights {tuple(weights.shape)}"
        )
    if starts.shape != (g, n_tiles) or win % ALIGN or not 0 < win <= mp:
        raise ValueError(
            f"band_conv_padded: starts {tuple(starts.shape)}, win {win}"
        )
    if rb_tiles.dtype != torch.int32 or starts.dtype != torch.int32:
        raise TypeError("band_conv_padded: rb_tiles and starts must be int32")
    if feats.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"band_conv_padded: feats dtype {feats.dtype}")
    if weights.dtype != torch.float32:
        raise TypeError(f"band_conv_padded: weights dtype {weights.dtype}")
    tensors = (rb_tiles, starts, feats, weights)
    if any(t.device != feats.device for t in tensors):
        raise ValueError("band_conv_padded: tensors on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("band_conv_padded: tensors must be contiguous")
    if band_smem_bytes(win, cout) > SMEM_LIMIT:
        raise ValueError(f"band_conv_padded: window {win} exceeds shared memory")

    lib = _library()
    out = torch.empty((mp, cout), dtype=torch.float32, device=feats.device)
    with torch.cuda.device(feats.device):
        rc = lib.band_conv_launch(
            rb_tiles.data_ptr(), starts.data_ptr(), feats.data_ptr(),
            int(feats.dtype == torch.bfloat16), weights.data_ptr(),
            out.data_ptr(), n_tiles, k, cin, cout, m, win,
            stream_handle(feats.device),
        )
    check_launch("band_conv", rc)
    LAUNCHES["band_conv"] += 1
    return out


def _library():
    lib = load_library("band_conv")
    if not getattr(lib, "_typed", False):
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.band_conv_launch.argtypes = [p, p, p, i, p, p, i, i, i, i, i, i, p]
        lib.band_conv_launch.restype = ctypes.c_int
        lib._typed = True
    return lib


def band_smem_bytes(win: int, cout: int) -> int:
    """Shared memory one kernel block uses (csrc/band_conv.cu)."""
    groups = min(-(-cout // _COLS), _MAX_COL_GROUPS)
    return (win * _PITCH + 3 * _CHUNK * groups * _COLS) * 4


def band_viable(k: int, cin: int, cout: int, dtype, win: int = WIN) -> bool:
    """Whether the kernel takes this conv shape: 3x3x3 kernels whose
    window fits a block's shared memory. The kernel stages 32 input
    channels at a time and splits wide outputs over blocks, so every
    channel count fits (the TPU gate was a VMEM budget that turned deep
    wide levels away); only ``k`` and the window size decide."""
    win = -(-win // ALIGN) * ALIGN
    return (
        k == 27
        and dtype in (torch.bfloat16, torch.float32)
        and band_smem_bytes(win, cout) <= SMEM_LIMIT
    )


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


def band_subm_conv_apply(
    feats: torch.Tensor,  # (M, Cin)
    weights: torch.Tensor,  # (K, Cin, Cout), kernel-offset layout
    plan: BandPlan,
    valid: torch.Tensor,
    compute_dtype=None,
) -> torch.Tensor:
    """Submanifold conv on the band engine; same weights layout as
    :func:`.sparse.subm_conv_apply`. Takes the exact gather engine when the
    plan's residual cap overflowed (``plan.ok`` false) or the kernel does
    not take the shape."""
    from .sparse import _subm_conv_impl

    dtype = compute_dtype or feats.dtype
    k, cin, cout = weights.shape
    gather_dtype = torch.bfloat16 if dtype == torch.bfloat16 else torch.float32
    viable = band_viable(k, cin, cout, dtype, plan.win)
    if not viable or not bool(plan.ok):
        GATHER_ROUTES["shape" if not viable else "overflow"] += 1
        return _subm_conv_impl(
            gather_dtype, feats, weights, plan.rulebook, valid
        )
    return _band_impl(feats, weights, plan, valid, gather_dtype)


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
    if band_viable(k, cin, cout, dtype, window):
        return build_band_plan(rulebook, valid, window)
    return rulebook
