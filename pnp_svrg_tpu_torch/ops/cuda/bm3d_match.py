"""BM3D block matching: CUDA kernel K1 (``csrc/bm3d_match.cu``) and its plain
PyTorch version.

Replaces the Pallas kernel ``bm3d_match_pallas`` (``_match_kernel``,
``pnp_svrg_tpu/ops/pallas/bm3d_match.py``). Both versions return, for every
reference block, the indices of the ``k`` search offsets with the smallest
patch SSD, ascending, ties to the lowest index, with +inf for candidates that
leave the image and index 0 in spare slots when fewer than ``k`` are valid.

``mode`` selects where bf16 rounding happens, because the two JAX matchers
round at different points:

* ``"f32"``: none.
* ``"bf16_xla"`` (``matcher="xla"``/``"auto"``, ``denoisers/bm3d.py:189-198``):
  the image is cast to bf16, the difference and the square are rounded to
  bf16, the sum is f32.
* ``"bf16_pallas"`` (``matcher="pallas"``, ``bm3d_match.py:83``): difference
  and square in f32, only the square rounded to bf16, the sum f32.

The wrapper :func:`bm3d_match` takes the plain version only for a CPU tensor;
for a CUDA tensor it launches K1 or raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch
import torch.nn.functional as F

from pnp_svrg_tpu_torch.ops.cuda import _build

MODES = {"f32": 0, "bf16_xla": 1, "bf16_pallas": 2}
TILE_R, TILE_C = 4, 8  # reference blocks per CTA (kTileR/kTileC in the source)
_WARPS, _IN_FLIGHT, _REF_ROWS = 4, 2, 20  # kWarps, kInFlight and kRefRows in the source
_MAX_COLS = TILE_C + 2  # kMaxCols: half-block positions of a column tile
_MAX_OFFSETS = 32 * 20  # phase 2 holds at most 20 offsets a lane (search 12)
KERNEL_BLOCK, KERNEL_K = 8, 16  # the patch edge and group size K1 is built for
_MAX_SMEM = 227 * 1024


@functools.lru_cache(maxsize=32)
def _band_select(size: int, grid: tuple, block: int) -> np.ndarray:
    """(size, len(grid)) 0/1 matrix: column i sums window [grid[i], grid[i]+block)."""
    s = np.zeros((size, len(grid)), np.float32)
    for i, g in enumerate(grid):
        s[g : g + block, i] = 1.0
    return s


def match_distances_plain(
    imgs: torch.Tensor, rows, cols, offsets, block: int, mode: str = "f32",
    chunk: int = 72,
) -> torch.Tensor:
    """(B, nR, nC, S) patch SSDs, +inf at invalid candidates.

    Port of ``_match_distances``: per chunk of offsets, the squared-difference
    images against statically shifted copies, contracted with two banded 0/1
    matrices (box filter + reference-grid sampling)."""
    if mode not in MODES:
        raise ValueError(f"unknown match mode {mode!r}; have {tuple(MODES)}")
    b, h, w = imgs.shape
    dev = imgs.device
    rows_np = np.asarray(rows, np.int64)
    cols_np = np.asarray(cols, np.int64)
    offsets = np.asarray(offsets, np.int64).reshape(-1, 2)
    last_r, last_c = h - block, w - block
    sel_h = torch.as_tensor(_band_select(h, tuple(rows_np.tolist()), block), device=dev)
    sel_w = torch.as_tensor(_band_select(w, tuple(cols_np.tolist()), block), device=dev)
    r = int(np.abs(offsets).max())
    x = imgs.to(torch.float32)
    if mode == "bf16_xla":
        x = x.to(torch.bfloat16)
    padded = F.pad(x, (r, r, r, r))
    parts = []
    for start in range(0, len(offsets), chunk):
        offs = offsets[start : start + chunk]
        shifted = torch.stack(
            [padded[:, r + dy : r + dy + h, r + dx : r + dx + w] for dy, dx in offs],
            dim=1,
        )  # (B, c, H, W)
        diff = x[:, None] - shifted
        sq = diff * diff  # bf16_xla: both steps round to bf16
        if mode == "bf16_pallas":
            sq = sq.to(torch.bfloat16)
        d = torch.einsum("hi,bchw,wj->bijc", sel_h, sq.to(torch.float32), sel_w)
        valid = (
            (rows_np[:, None, None] + offs[:, 0][None, None, :] >= 0)
            & (rows_np[:, None, None] + offs[:, 0][None, None, :] <= last_r)
            & (cols_np[None, :, None] + offs[:, 1][None, None, :] >= 0)
            & (cols_np[None, :, None] + offs[:, 1][None, None, :] <= last_c)
        )  # (nR, nC, c)
        valid = torch.as_tensor(valid, device=dev)
        parts.append(torch.where(valid[None], d, torch.inf))
    return torch.cat(parts, dim=-1)


def top_k_offsets_plain(dists: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k smallest distances along the last axis, ascending,
    by k argmin-and-mask passes (``torch.argmin`` returns the first minimal
    index: ties go to the lowest offset, and once only +inf is left it
    returns 0, the reference's fill)."""
    iota = torch.arange(dists.shape[-1], device=dists.device)
    idxs = []
    for _ in range(k):
        i = torch.argmin(dists, dim=-1)
        idxs.append(i)
        dists = torch.where(iota == i[..., None], torch.inf, dists)
    return torch.stack(idxs, dim=-1).to(torch.int32)


def bm3d_match_plain(imgs, rows, cols, offsets, block, k, mode="f32"):
    """The plain PyTorch version of K1: (B, nR, nC, k) int32."""
    return top_k_offsets_plain(
        match_distances_plain(imgs, rows, cols, offsets, block, mode), k
    )


def tile_regions(rows, cols, search: int, block: int):
    """K1's per-tile staging: for each tile of TILE_R x TILE_C reference
    blocks, the origin ``(rows[first] - search, cols[first] - search)`` of
    the image region it stages and the rows its reference patches span.
    Returns (row origins, column origins, smem_h, smem_w, largest
    reference-row span): every reference patch and every candidate within
    ``search`` of it lies in ``[origin, origin + smem)`` along each axis."""

    def axis(grid, tile):
        starts = range(0, len(grid), tile)
        spans = [int(grid[min(i + tile, len(grid)) - 1]) - int(grid[i]) for i in starts]
        return [int(grid[i]) - search for i in starts], max(spans)

    oy, span_r = axis(rows, TILE_R)
    ox, span_c = axis(cols, TILE_C)
    return oy, ox, span_r + block + 2 * search, span_c + block + 2 * search, span_r + block


def column_plans(cols, search: int, block: int) -> np.ndarray:
    """K1's column plan of each tile: ``[nb, P_0 .. P_9, a_0, b_0 .. a_7,
    b_7]``. ``P`` are the tile's distinct half-block column positions in
    region coordinates (``cols[c] - cols[first] + search`` and that plus
    ``block // 2``); reference column j's 8-wide sum is the half sums at
    ``P[a_j]`` and ``P[b_j]``."""
    half = block // 2
    plans = np.zeros((-(-len(cols) // TILE_C), 1 + _MAX_COLS + 2 * TILE_C), np.int32)
    for t, c0 in enumerate(range(0, len(cols), TILE_C)):
        lx = [int(c) - int(cols[c0]) + search for c in cols[c0 : c0 + TILE_C]]
        pos = sorted(set(lx) | {v + half for v in lx})
        if len(pos) > _MAX_COLS:
            raise ValueError(f"reference columns {lx} need {len(pos)} > {_MAX_COLS} half-block "
                             "positions (K1 is built for step grids)")
        plans[t, 0] = len(pos)
        plans[t, 1 : 1 + len(pos)] = pos
        for j, v in enumerate(lx):
            plans[t, 1 + _MAX_COLS + 2 * j : 3 + _MAX_COLS + 2 * j] = pos.index(v), pos.index(v + half)
    return plans


@dataclasses.dataclass(frozen=True, eq=False)
class MatchGeometry:
    """Device copies of the grid and offsets and K1's shared-memory layout,
    made once per shape, so that a call does no per-offset host work."""

    rows_t: torch.Tensor
    cols_t: torch.Tensor
    offsets_t: torch.Tensor
    col_plan: torch.Tensor  # (ceil(nC / TILE_C), 27) int32: column_plans()
    search: int
    ref_rows: int  # the largest reference-row span of a tile, plus the block
    smem_h: int
    smem_w: int
    pitch: int  # region row pitch (odd: conflict-free loads)
    d_pitch: int  # distance buffer row pitch (odd)

    @property
    def smem_bytes(self) -> int:
        hsum = _WARPS * _IN_FLIGHT * _REF_ROWS * _MAX_COLS
        return 4 * (self.smem_h * self.pitch + TILE_R * TILE_C * self.d_pitch + hsum)


@functools.lru_cache(maxsize=32)
def _geometry(rows: tuple, cols: tuple, offsets: tuple, block: int,
              device: torch.device) -> MatchGeometry:
    search = max(abs(v) for off in offsets for v in off)
    _, _, smem_h, smem_w, ref_rows = tile_regions(rows, cols, search, block)
    as_dev = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    plan = torch.as_tensor(column_plans(cols, search, block), device=device)
    return MatchGeometry(as_dev(rows), as_dev(cols), as_dev(offsets), plan, search, ref_rows,
                         smem_h, smem_w, smem_w | 1, len(offsets) | 1)


def match_geometry(rows, cols, offsets, block: int, device) -> MatchGeometry:
    """K1's geometry for these reference coordinates and (S, 2) offsets."""
    return _geometry(
        tuple(int(v) for v in rows), tuple(int(v) for v in cols),
        tuple((int(dy), int(dx)) for dy, dx in np.asarray(offsets).reshape(-1, 2)),
        int(block), torch.device(device),
    )


def _lib():
    lib = _build.load("bm3d_match")
    fn = lib.bm3d_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 14 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bm3d_match(
    imgs: torch.Tensor, rows, cols, offsets, block: int, k: int, mode: str = "f32",
    geometry: MatchGeometry | None = None,
) -> torch.Tensor:
    """Top-``k`` offset indices (B, nR, nC, k) int32 for every reference block.

    ``rows``/``cols``: reference coordinates; ``offsets``: (S, 2) (dy, dx) in
    ascending index order; ``geometry``: their :func:`match_geometry` on the
    tensor's device, made once by a caller that matches many times (without
    it the wrapper looks it up from the arguments; with it, its numbers of
    rows, columns and offsets must be the arguments'). A CPU tensor takes
    the plain version; a CUDA tensor launches K1 (counted in
    ``bm3d_match.launches``)."""
    if mode not in MODES:
        raise ValueError(f"unknown match mode {mode!r}; have {tuple(MODES)}")
    if imgs.dim() != 3 or imgs.dtype != torch.float32:
        raise ValueError(f"expected a (B, H, W) float32 tensor, got {tuple(imgs.shape)} {imgs.dtype}")
    if geometry is not None:
        sizes = (geometry.rows_t.numel(), geometry.cols_t.numel(), geometry.offsets_t.shape[0])
        if sizes != (len(rows), len(cols), len(offsets)):
            raise ValueError(f"geometry for {sizes} rows, columns and offsets, called with "
                             f"{(len(rows), len(cols), len(offsets))}")
    if imgs.device.type == "cpu":
        return bm3d_match_plain(imgs, rows, cols, offsets, block, k, mode)
    if imgs.device.type != "cuda":
        raise ValueError(f"bm3d_match runs on cpu or cuda, not {imgs.device}")
    if (block, k) != (KERNEL_BLOCK, KERNEL_K):
        raise ValueError(f"K1 is built for block={KERNEL_BLOCK}, k={KERNEL_K}, "
                         f"not block={block}, k={k}")
    g = geometry or match_geometry(rows, cols, offsets, block, imgs.device)
    if g.rows_t.device != imgs.device:
        raise ValueError(f"geometry on {g.rows_t.device} but images on {imgs.device}")
    if g.ref_rows > _REF_ROWS:
        raise ValueError(f"reference rows of a tile span {g.ref_rows} > {_REF_ROWS} pixels "
                         "(K1 is built for reference steps up to 4)")
    if g.offsets_t.shape[0] > _MAX_OFFSETS or g.smem_bytes > _MAX_SMEM:
        raise ValueError(f"search window too large: {g.offsets_t.shape[0]} offsets (K1 holds "
                         f"{_MAX_OFFSETS}), {g.smem_bytes} bytes of shared memory")
    b, h, w = imgs.shape
    x = imgs.contiguous()
    nr, nc, s = g.rows_t.numel(), g.cols_t.numel(), g.offsets_t.shape[0]
    out = torch.empty((b, nr, nc, k), dtype=torch.int32, device=imgs.device)
    err = _lib()(
        x.data_ptr(), g.rows_t.data_ptr(), g.cols_t.data_ptr(), g.offsets_t.data_ptr(),
        g.col_plan.data_ptr(), out.data_ptr(), b, h, w, nr, nc, s, int(block), int(k), MODES[mode],
        g.search, g.smem_h, g.smem_w, g.pitch, g.d_pitch,
        torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    _build.check(err, f"bm3d_match (block={block}, k={k}, mode={mode})")
    bm3d_match.launches += 1
    return out


bm3d_match.launches = 0
