"""BM3D block matching: CUDA kernel K1 (``csrc/bm3d_match.cu``) and its plain
PyTorch version.

Replaces the Pallas kernel ``bm3d_match_pallas`` (``_match_kernel``,
``pnp_svrg_tpu/ops/pallas/bm3d_match.py``). Both versions return, for every
reference block, the indices of the ``k`` search offsets with the smallest
patch SSD, ascending, ties to the lowest index, with +inf for candidates that
leave the image and index 0 in spare slots when fewer than ``k`` are valid.
``row_valid_bounds=(lo, hi)`` also makes +inf every candidate whose rows leave
``[lo, hi)`` (the row-sharded spatial path's halo padding, the bounds of
``_match_distances``, ``pnp_svrg_tpu/denoisers/bm3d.py:213-219``); the
default ``(0, H)`` changes nothing.

``mode`` selects where bf16 rounding happens, because the two JAX matchers
round at different points:

* ``"f32"``: none.
* ``"bf16_xla"`` (``matcher="xla"``/``"auto"``, ``denoisers/bm3d.py:189-198``):
  the image is cast to bf16, the difference and the square are rounded to
  bf16, the sum is f32.
* ``"bf16_pallas"`` (``matcher="pallas"``, ``bm3d_match.py:83``): difference
  and square in f32, only the square rounded to bf16, the sum f32.

The wrapper :func:`bm3d_match` takes the plain version only for a CPU tensor;
for a CUDA tensor it launches K1 or raises. K1 has four kernels in one
source, and :func:`match_kernel` names the one that takes a call:
``bm3d_match_kernel``, built for 8 x 8 blocks, 16 matches, a step-4 grid and
at most 640 offsets (the headline's and the bench lanes'); else, at block 8,
``bm3d_match_tile_kernel`` (any step, window and k: the reference profile's
step 3, 1,521 offsets, 16 / 32 matches); else ``bm3d_match_span_kernel``, for
every other block of :data:`MATCH_ENVELOPE` (the golden oracle's block 4
among them) on a strictly ascending grid; else ``bm3d_match_any_kernel``,
which takes what is left (a grid with a repeated coordinate, which the BM3D
denoiser never makes). A setting outside the envelope raises before any
launch (:func:`check_match_envelope`). The design the span kernel replaced,
the any-kernel, stays reachable by name through :func:`launch`, so that a
caller can time the two on one call (:data:`PREV_DESIGN`).
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
KERNEL_BLOCK, KERNEL_K = 8, 16  # the patch edge and group size of bm3d_match_kernel
ANY_TILE_R, ANY_TILE_C = 4, 4  # kAnyTileR / kAnyTileC: bm3d_match_any_kernel's tiles
# bm3d_match_tile_kernel: a tile's patches span at most TILE_SPAN rows (one a
# lane) and columns (kTileSpan); it holds at most TILE_MAX blocks (kTileMax).
TILE_SPAN, TILE_MAX, TILE_CHUNK = 32, 81, 64  # kTileSpan, kTileMax, kChunk (offsets a chunk)
K1_KERNELS = ("bm3d_match_kernel", "bm3d_match_tile_kernel", "bm3d_match_any_kernel", "bm3d_match_span_kernel")
# The design the span kernel replaced on every block other than 8.
PREV_DESIGN = "bm3d_match_any_kernel"
# bm3d_match_span_kernel: at most SPAN_MOST blocks a tile (one a thread of
# its CTA), and no more than let three CTAs share an SM's 228 KB (each with
# the 1 KB the card keeps a CTA).
SPAN_MOST, SPAN_BUDGET = 256, 228 * 1024 // 3 - 1024
_MAX_SMEM = 227 * 1024
# The settings K1 takes on the card: (least, most) of each; k is also a
# power of two (the Hadamard transform along the group needs one), the
# reference step 1 to the block, the search step and the row bounds any.
MATCH_ENVELOPE = {"block": (2, 16), "search": (0, 24), "k": (1, 64)}


def check_match_envelope(block: int, k: int, search: int, step: int) -> None:
    """Raise ValueError, naming the bound, unless K1 takes this ``block``,
    group size ``k``, window radius ``search`` and reference ``step`` (the
    largest stride of the grid) on the card."""
    lo, hi = MATCH_ENVELOPE["block"]
    if not lo <= block <= hi:
        raise ValueError(f"K1 takes block {lo}-{hi}, not {block}")
    if not 1 <= step <= block:
        raise ValueError(f"K1 takes a reference step of 1 to the block ({block}), not {step}")
    lo, hi = MATCH_ENVELOPE["search"]
    if not lo <= search <= hi:
        raise ValueError(f"K1 takes search {lo}-{hi} (at most {(2 * hi + 1) ** 2} offsets), not {search}")
    lo, hi = MATCH_ENVELOPE["k"]
    if not (lo <= k <= hi and k & (k - 1) == 0):
        raise ValueError(f"K1 takes a power-of-two k in {lo}-{hi}, not {k}")


@functools.lru_cache(maxsize=32)
def _band_select(size: int, grid: tuple, block: int) -> np.ndarray:
    """(size, len(grid)) 0/1 matrix: column i sums window [grid[i], grid[i]+block)."""
    s = np.zeros((size, len(grid)), np.float32)
    for i, g in enumerate(grid):
        s[g : g + block, i] = 1.0
    return s


def match_distances_plain(
    imgs: torch.Tensor, rows, cols, offsets, block: int, mode: str = "f32",
    chunk: int = 72, row_valid_bounds: tuple | None = None,
) -> torch.Tensor:
    """(B, nR, nC, S) patch SSDs, +inf at invalid candidates.

    Port of ``_match_distances``: per chunk of offsets, the squared-difference
    images against statically shifted copies, contracted with two banded 0/1
    matrices (box filter + reference-grid sampling)."""
    if mode not in MODES:
        raise ValueError(f"unknown match mode {mode!r}; have {tuple(MODES)}")
    b, h, w = imgs.shape
    dev = imgs.device
    lo, hi = _check_bounds(row_valid_bounds, h)
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
            & (rows_np[:, None, None] + offs[:, 0][None, None, :] >= lo)
            & (rows_np[:, None, None] + offs[:, 0][None, None, :] <= hi - block)
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


def bm3d_match_plain(imgs, rows, cols, offsets, block, k, mode="f32", row_valid_bounds=None):
    """The plain PyTorch version of K1: (B, nR, nC, k) int32."""
    return top_k_offsets_plain(
        match_distances_plain(imgs, rows, cols, offsets, block, mode,
                              row_valid_bounds=row_valid_bounds), k
    )


def _check_bounds(row_valid_bounds, h: int) -> tuple:
    """``(lo, hi)`` as ints with ``0 <= lo <= hi <= h``; ``(0, h)`` for None."""
    lo, hi = (0, h) if row_valid_bounds is None else row_valid_bounds
    if not (isinstance(lo, int) and isinstance(hi, int) and 0 <= lo <= hi <= h):
        raise ValueError(f"row_valid_bounds must be ints with 0 <= lo <= hi <= {h}, "
                         f"got {row_valid_bounds!r}")
    return lo, hi


def tile_regions(rows, cols, search: int, block: int, tile: tuple = (TILE_R, TILE_C)):
    """K1's per-tile staging: for each tile of ``tile`` = (rows, columns) of
    reference blocks (``bm3d_match_kernel``'s by default), the origin
    ``(rows[first] - search, cols[first] - search)`` of the image region it
    stages and the rows its reference patches span. Returns (row origins,
    column origins, smem_h, smem_w, largest reference-row span): every
    reference patch and every candidate within ``search`` of it lies in
    ``[origin, origin + smem)`` along each axis."""

    def axis(grid, n):
        starts = range(0, len(grid), n)
        spans = [int(grid[min(i + n, len(grid)) - 1]) - int(grid[i]) for i in starts]
        return [int(grid[i]) - search for i in starts], max(spans)

    oy, span_r = axis(rows, tile[0])
    ox, span_c = axis(cols, tile[1])
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


def tile_plan(grid, block: int, most: int) -> np.ndarray | None:
    """``bm3d_match_tile_kernel``'s tiles along one axis of the reference
    grid, cut greedily: (n, 3) int32 rows of (first index, count, mask),
    where the tile's coordinates less its first are the mask's set bits and
    span at most :data:`TILE_SPAN` pixels with their patches, and a tile has
    at most ``most`` of them. None unless the grid strictly ascends (the
    masks could not tell two equal coordinates apart)."""
    grid = [int(v) for v in grid]
    if any(b <= a for a, b in zip(grid[:-1], grid[1:])):
        return None
    tiles, start = [], 0
    while start < len(grid):
        end = start + 1
        while end < len(grid) and end - start < most and grid[end] - grid[start] + block <= TILE_SPAN:
            end += 1
        mask = sum(1 << (v - grid[start]) for v in grid[start:end])
        tiles.append((start, end - start, mask))
        start = end
    return np.asarray(tiles, np.int32)


def span_entries(k: int) -> int:
    """Entries of a block's running top-k in ``bm3d_match_span_kernel``: its
    thread keeps 4 or 8 keys for k up to 8; a warp keeps k above."""
    return next((n for n in (4, 8) if k <= n), k)


def span_smem_bytes(search: int, pitch: int, most: int, k: int) -> int:
    """Dynamic shared memory of a ``bm3d_match_span_kernel`` CTA (``span_lists_at``
    and its launch in the source): the staged region, ``most`` rows of
    distances, the chunk's offset indices, then the top-k lists, 8 bytes an
    entry."""
    words = ((TILE_SPAN + 2 * search) * (pitch + 1) + most * (TILE_CHUNK + 1) + TILE_CHUNK + 1) & ~1
    return 4 * words + 8 * most * span_entries(k)


def span_most(search: int, k: int) -> int:
    """The most blocks a span tile may hold at this window and k: one a
    thread, and no more than keep :func:`span_smem_bytes` within
    :data:`SPAN_BUDGET`."""
    pitch = (TILE_SPAN + 2 * search) | 1
    fixed = span_smem_bytes(search, pitch, 0, k) + 4  # the lists' alignment word
    return min(SPAN_MOST, (SPAN_BUDGET - fixed) // (4 * (TILE_CHUNK + 1) + 8 * span_entries(k)))


@dataclasses.dataclass(frozen=True, eq=False)
class SpanPlan:
    """``bm3d_match_span_kernel``'s tiles for one k: :func:`tile_plan` of the
    rows and the columns, ``most`` the largest tile's blocks (its layout's
    stride) and the CTA's shared memory."""

    row_tiles: torch.Tensor  # (n, 3) int32
    col_tiles: torch.Tensor
    most: int
    smem_bytes: int


def span_plan(rows, cols, block: int, search: int, k: int, device, most: int | None = None) -> SpanPlan:
    """The span kernel's tiles: of the cuts with at most ``a`` reference rows
    and ``most`` // ``a`` columns a tile, the one with the fewest tiles (a
    CTA forms its whole span's terms, however many blocks it holds), the
    squarer on ties. ``most`` is :func:`span_most`'s unless given (a caller
    timing smaller tiles)."""
    most = most or span_most(search, k)
    cuts = []
    for a in range(1, min(most, TILE_SPAN) + 1):
        row_tiles, col_tiles = tile_plan(rows, block, a), tile_plan(cols, block, most // a)
        cuts.append((len(row_tiles) * len(col_tiles), abs(len(row_tiles) - len(col_tiles)), a,
                     row_tiles, col_tiles))
    *_, row_tiles, col_tiles = min(cuts, key=lambda c: c[:3])
    used = int(row_tiles[:, 1].max()) * int(col_tiles[:, 1].max())
    pitch = (TILE_SPAN + 2 * search) | 1
    as_dev = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    return SpanPlan(as_dev(row_tiles), as_dev(col_tiles), used, span_smem_bytes(search, pitch, used, k))


def visit_order(offsets) -> np.ndarray:
    """``bm3d_match_tile_kernel``'s order of the (S, 2) offsets: nearest the
    window's centre first (by dy^2 + dx^2, ties by index), where the best
    matches tend to be, so that its running top-k tightens early. The
    result does not depend on it: the kernel compares offset indices."""
    offsets = np.asarray(offsets, np.int64).reshape(-1, 2)
    return np.lexsort((np.arange(len(offsets)), (offsets ** 2).sum(1))).astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class MatchGeometry:
    """Device copies of the grid and offsets and K1's shared-memory layouts,
    made once per shape, so that a call does no per-offset host work.
    ``col_plan`` is None where ``bm3d_match_kernel`` cannot take the grid
    and window, ``row_tiles`` and ``col_tiles`` where
    ``bm3d_match_tile_kernel`` cannot (a block other than 8, a grid that
    does not strictly ascend), ``tile_order`` and ``tile_offsets`` where
    neither it nor ``bm3d_match_span_kernel`` can (a grid that does not
    strictly ascend); ``bm3d_match_any_kernel`` takes every geometry.
    :meth:`span` gives the span kernel's tiles for a k, made at its first
    call."""

    rows_t: torch.Tensor
    cols_t: torch.Tensor
    offsets_t: torch.Tensor
    col_plan: torch.Tensor | None  # (ceil(nC / TILE_C), 27) int32: column_plans()
    block: int
    step: int  # the largest stride of the reference grid
    search: int
    ref_rows: int  # the largest reference-row span of a tile, plus the block
    smem_h: int
    smem_w: int
    pitch: int  # region row pitch (odd: conflict-free loads)
    d_pitch: int  # distance buffer row pitch (odd)
    any_smem_h: int  # bm3d_match_any_kernel's largest tile region, rows
    any_pitch: int  # and its row pitch (odd, at least its width)
    row_tiles: torch.Tensor | None  # (n, 3) int32: tile_plan() of the rows
    col_tiles: torch.Tensor | None  # and of the columns
    tile_order: torch.Tensor | None  # (S,) int32: visit_order(), the tile and span kernels' order
    tile_offsets: torch.Tensor | None  # (S, 2) int32: the offsets in that order
    tile_pitch: int  # the tile and span kernels' region row pitch (odd, >= TILE_SPAN + 2 search)
    rows: tuple = ()  # the reference coordinates, on the host
    cols: tuple = ()
    plans: dict = dataclasses.field(default_factory=dict, repr=False)  # k -> SpanPlan

    def span(self, k: int) -> SpanPlan:
        """``bm3d_match_span_kernel``'s tiles for group size ``k`` (:func:`span_plan`)."""
        if k not in self.plans:
            self.plans[k] = span_plan(self.rows, self.cols, self.block, self.search, k, self.rows_t.device)
        return self.plans[k]

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of ``bm3d_match_kernel``'s CTA."""
        hsum = _WARPS * _IN_FLIGHT * _REF_ROWS * _MAX_COLS
        return 4 * (self.smem_h * self.pitch + TILE_R * TILE_C * self.d_pitch + hsum)

    @property
    def any_smem_bytes(self) -> int:
        """Dynamic shared memory of ``bm3d_match_any_kernel``'s CTA."""
        return 4 * self.any_smem_h * self.any_pitch

    def tile_smem_bytes(self, k: int) -> int:
        """Dynamic shared memory of ``bm3d_match_tile_kernel``'s CTA: the
        staged region, the distances of a chunk and the running top-k's."""
        region = (TILE_SPAN + 2 * self.search) * (self.tile_pitch + 1)  # f32, or bf16 pairs twice
        return 4 * (region + TILE_MAX * (TILE_CHUNK + 1)) + 8 * TILE_MAX * k

    def first_kernel_takes(self, block: int, k: int) -> bool:
        """Whether ``bm3d_match_kernel`` (8 x 8 blocks, 16 matches, a step-4
        column plan, at most 640 offsets) takes a call (:func:`match_kernel`)."""
        return ((block, k) == (KERNEL_BLOCK, KERNEL_K) and self.col_plan is not None
                and self.ref_rows <= _REF_ROWS and self.offsets_t.shape[0] <= _MAX_OFFSETS
                and self.smem_bytes <= _MAX_SMEM)


def match_kernel(g: MatchGeometry, block: int, k: int) -> str:
    """The K1 kernel that takes a call at geometry ``g`` with this ``block``
    and ``k``: ``bm3d_match_kernel`` wherever it can (every call it took
    before the tile kernel existed), else ``bm3d_match_tile_kernel`` at
    block 8 and ``bm3d_match_span_kernel`` at any other block (a grid that
    strictly ascends), else ``bm3d_match_any_kernel`` (every geometry)."""
    if g.first_kernel_takes(block, k):
        return "bm3d_match_kernel"
    if g.tile_order is None:
        return PREV_DESIGN
    return "bm3d_match_tile_kernel" if block == KERNEL_BLOCK else "bm3d_match_span_kernel"


def grid_step(grid) -> int:
    """The largest stride between consecutive reference coordinates (1 for
    a single block)."""
    return max([int(b) - int(a) for a, b in zip(grid[:-1], grid[1:])] or [1])


@functools.lru_cache(maxsize=32)
def _geometry(rows: tuple, cols: tuple, offsets: tuple, block: int,
              device: torch.device) -> MatchGeometry:
    search = max(abs(v) for off in offsets for v in off)
    _, _, smem_h, smem_w, ref_rows = tile_regions(rows, cols, search, block)
    _, _, any_h, any_w, _ = tile_regions(rows, cols, search, block, (ANY_TILE_R, ANY_TILE_C))
    as_dev = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    try:
        plan = torch.as_tensor(column_plans(cols, search, block), device=device)
    except ValueError:  # not a grid bm3d_match_kernel's column plan covers
        plan = None
    # The tile and span kernels' order of offsets, and the tile kernel's
    # plans; None where they cannot take the call.
    tiles = [None] * 4
    if tile_plan(rows, block, 1) is not None and tile_plan(cols, block, 1) is not None:
        order = visit_order(offsets)
        tiles[2:] = as_dev(order), as_dev(np.asarray(offsets)[order])
        if block == KERNEL_BLOCK:
            row_tiles = tile_plan(rows, block, TILE_MAX)
            tiles[:2] = as_dev(row_tiles), as_dev(tile_plan(cols, block, TILE_MAX // int(row_tiles[:, 1].max())))
    return MatchGeometry(as_dev(rows), as_dev(cols), as_dev(offsets), plan, block,
                         max(grid_step(rows), grid_step(cols)), search, ref_rows, smem_h, smem_w,
                         smem_w | 1, len(offsets) | 1, any_h, any_w | 1, *tiles,
                         (TILE_SPAN + 2 * search) | 1, rows, cols)


def match_geometry(rows, cols, offsets, block: int, device) -> MatchGeometry:
    """K1's geometry for these reference coordinates and (S, 2) offsets."""
    return _geometry(
        tuple(int(v) for v in rows), tuple(int(v) for v in cols),
        tuple((int(dy), int(dx)) for dy, dx in np.asarray(offsets).reshape(-1, 2)),
        int(block), torch.device(device),
    )


ENTRIES = {  # kernel name -> (its entry point in the source, pointer and int arguments)
    "bm3d_match_kernel": ("bm3d_match_launch", 6, 16),
    "bm3d_match_tile_kernel": ("bm3d_match_tile_launch", 8, 15),
    "bm3d_match_any_kernel": ("bm3d_match_any_launch", 5, 14),
    "bm3d_match_span_kernel": ("bm3d_match_span_launch", 8, 16),
}


def bind(lib: ctypes.CDLL) -> dict:
    """Kernel name -> its entry point in a library built from
    ``csrc/bm3d_match.cu``, with its argument types set."""
    fns = {}
    for name, (entry, pointers, ints) in ENTRIES.items():
        fn = fns[name] = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return fns


def _lib() -> dict:
    """:func:`bind` of the built library."""
    return bind(_build.load("bm3d_match"))


def launch(kernel: str, fn, x: torch.Tensor, g: MatchGeometry, out: torch.Tensor, block: int, k: int,
           mode: str, lo: int, hi: int) -> None:
    """Launch ``kernel`` through its bound entry point ``fn`` (:func:`bind`)
    on the current stream: images ``x`` (B, H, W) contiguous, ``out`` (B, nR,
    nC, k) int32, candidate rows ``[lo, hi)``; raises if the launch fails.
    It checks nothing else and counts nothing (:func:`bm3d_match` does
    both): a caller that times one kernel against another, on a call both
    take (the any-kernel, :data:`PREV_DESIGN`, takes every call), launches
    through it."""
    b, h, w = x.shape
    nr, nc, s = g.rows_t.numel(), g.cols_t.numel(), g.offsets_t.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), g.rows_t.data_ptr(), g.cols_t.data_ptr(), g.offsets_t.data_ptr())
    if kernel == "bm3d_match_kernel":
        err = fn(*ptrs, g.col_plan.data_ptr(), out.data_ptr(), b, h, w, nr, nc, s, int(block), int(k),
                 MODES[mode], g.search, g.smem_h, g.smem_w, g.pitch, g.d_pitch, lo, hi - block, stream)
    elif kernel == "bm3d_match_tile_kernel":
        err = fn(*ptrs[:3], g.tile_offsets.data_ptr(), g.tile_order.data_ptr(), g.row_tiles.data_ptr(),
                 g.col_tiles.data_ptr(), out.data_ptr(), b, h, w, nr, nc, g.row_tiles.shape[0],
                 g.col_tiles.shape[0], s, int(block), int(k), MODES[mode], g.search, g.tile_pitch, lo,
                 hi - block, stream)
    elif kernel == "bm3d_match_span_kernel":
        p = g.span(int(k))
        err = fn(*ptrs[:3], g.tile_offsets.data_ptr(), g.tile_order.data_ptr(), p.row_tiles.data_ptr(),
                 p.col_tiles.data_ptr(), out.data_ptr(), b, h, w, nr, nc, p.row_tiles.shape[0],
                 p.col_tiles.shape[0], s, int(block), int(k), MODES[mode], g.search, g.tile_pitch, p.most,
                 lo, hi - block, stream)
    else:
        err = fn(*ptrs, out.data_ptr(), b, h, w, nr, nc, s, int(block), int(k), MODES[mode], g.search,
                 g.any_smem_h, g.any_pitch, lo, hi - block, stream)
    _build.check(err, f"bm3d_match ({kernel}, block={block}, k={k}, mode={mode})")


def bm3d_match(
    imgs: torch.Tensor, rows, cols, offsets, block: int, k: int, mode: str = "f32",
    geometry: MatchGeometry | None = None, row_valid_bounds: tuple | None = None,
) -> torch.Tensor:
    """Top-``k`` offset indices (B, nR, nC, k) int32 for every reference block.

    ``rows``/``cols``: reference coordinates; ``offsets``: (S, 2) (dy, dx) in
    ascending index order; ``geometry``: their :func:`match_geometry` on the
    tensor's device, made once by a caller that matches many times (without
    it the wrapper looks it up from the arguments; with it, its numbers of
    rows, columns and offsets must be the arguments'); ``row_valid_bounds``:
    integer ``(lo, hi)``, the rows that count as image rows. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel
    :func:`match_kernel` names inside :data:`MATCH_ENVELOPE` and raises
    outside it. Each launch counts one in ``bm3d_match.launches`` and one in
    ``bm3d_match.by_kernel`` under the kernel's name."""
    if mode not in MODES:
        raise ValueError(f"unknown match mode {mode!r}; have {tuple(MODES)}")
    if imgs.dim() != 3 or imgs.dtype != torch.float32:
        raise ValueError(f"expected a (B, H, W) float32 tensor, got {tuple(imgs.shape)} {imgs.dtype}")
    if geometry is not None:
        sizes = (geometry.rows_t.numel(), geometry.cols_t.numel(), geometry.offsets_t.shape[0])
        if sizes != (len(rows), len(cols), len(offsets)):
            raise ValueError(f"geometry for {sizes} rows, columns and offsets, called with "
                             f"{(len(rows), len(cols), len(offsets))}")
    lo, hi = _check_bounds(row_valid_bounds, imgs.shape[1])
    if imgs.device.type == "cpu":
        return bm3d_match_plain(imgs, rows, cols, offsets, block, k, mode, row_valid_bounds)
    if imgs.device.type != "cuda":
        raise ValueError(f"bm3d_match runs on cpu or cuda, not {imgs.device}")
    g = geometry or match_geometry(rows, cols, offsets, block, imgs.device)
    check_match_envelope(block, k, g.search, g.step)
    if g.block != block:
        raise ValueError(f"geometry for block {g.block}, called with block {block}")
    if g.rows_t.device != imgs.device:
        raise ValueError(f"geometry on {g.rows_t.device} but images on {imgs.device}")
    if g.any_smem_bytes > _MAX_SMEM:  # not reached inside the envelope
        raise ValueError(f"a tile's region needs {g.any_smem_bytes} bytes of shared memory")
    x = imgs.contiguous()
    out = torch.empty((x.shape[0], g.rows_t.numel(), g.cols_t.numel(), k), dtype=torch.int32, device=x.device)
    kernel = match_kernel(g, block, k)
    launch(kernel, _lib()[kernel], x, g, out, block, k, mode, lo, hi)
    bm3d_match.launches += 1
    bm3d_match.by_kernel[kernel] += 1
    return out


bm3d_match.launches = 0
bm3d_match.by_kernel = dict.fromkeys(K1_KERNELS, 0)
