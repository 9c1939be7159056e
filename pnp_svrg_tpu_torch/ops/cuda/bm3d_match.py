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
step 3, 1,521 offsets, 16 / 32 matches; k 128 merged by ranks, on tiles of at
most :func:`tile_most` blocks); else, on a strictly ascending grid,
``bm3d_match_span_kernel`` for blocks 2-16 (the golden oracle's block 4 among
them), ``bm3d_match_pixel_kernel`` for block 1 at k up to 8 (a thread a
reference pixel, no distance buffer) and ``bm3d_match_span_rt_kernel`` for
block 1 past k 8 and blocks 17-32 (the span kernel's trees with the block
read at run time); else ``bm3d_match_any_kernel``, which takes what is left
(a grid with a repeated coordinate, which the BM3D denoiser never makes)
inside its own bounds (:data:`ANY_ENVELOPE`).

The envelope: block 1-32, any step (past the block a tile simply holds fewer
blocks), a power-of-two k up to 128, and any window whose staged region
fits one CTA's shared memory (:func:`match_search_limit`). A window wider
than the image is taken through its reach (:meth:`MatchGeometry.reach`): an
offset with ``|dy| > H - block`` or ``|dx| > W - block`` is +inf for every
reference block, so the tile and span kernels skip it and stage only the
halo of the rest, and every index they return stays the offset's index in
the full window (a fill is index 0, as there). Where the whole region would
crowd the CTA, the tile kernel (k up to 64) and the span kernel (blocks
2-16) stage the reach in parts (:class:`PartPlan`: sub-windows of offsets,
each with its own halo, the tile's reference span staged apart) and visit
only the parts some block of the tile can take; elsewhere the plan has one
part, today's path bit for bit (:meth:`MatchGeometry.tile`,
:meth:`MatchGeometry.span` with a reach). A setting outside the
envelope raises before any launch, naming its bound
(:func:`check_match_envelope`). The designs the tile and span kernels
replaced stay reachable by name through :func:`launch`, so that a caller can
time the two on one call (:func:`prev_design`): the any-kernel
(:data:`PREV_DESIGN`), the tile kernel's four-slot merge at k 128
(``bm3d_match_tile_slots_kernel``) and the span kernel as it was before the
pixel and run-time kernels and the rank merge
(``bm3d_match_span_serial_kernel``).
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
K1_KERNELS = ("bm3d_match_kernel", "bm3d_match_tile_kernel", "bm3d_match_any_kernel", "bm3d_match_span_kernel",
              "bm3d_match_span_rt_kernel", "bm3d_match_pixel_kernel", "bm3d_match_tile_slots_kernel",
              "bm3d_match_span_serial_kernel")
# The design the tile and span kernels replaced on every block (and the
# kernel of a grid that does not strictly ascend).
PREV_DESIGN = "bm3d_match_any_kernel"
# The designs replaced later, reachable by name only: the tile kernel's
# four-slot merge at k 128, and the span kernel with its serial run-time
# phase 1 (blocks 1 and 17-32) and its four-slot merge.
TILE_SLOTS, SPAN_SERIAL = K1_KERNELS[6:]
RANK_K = 128  # kRankK: k merged by ranks (the four slots a lane of k 128)
# bm3d_match_tile_kernel at k 128: as many blocks a tile (at most TILE_MAX)
# as let three CTAs share an SM's 228 KB (each with the 1 KB the card keeps
# a CTA), or else two, where that is at least TILE_MAX // 2 (at most about
# twice the tiles, each forming its span's terms); else TILE_MAX, one CTA an
# SM. TILE_BUDGETS: a CTA's bytes for three and for two.
TILE_BUDGETS = (228 * 1024 // 3 - 1024, 228 * 1024 // 2 - 1024)
# bm3d_match_span_kernel: at most SPAN_MOST blocks a tile (one a thread of
# its CTA), and no more than let three CTAs share an SM's 228 KB (each with
# the 1 KB the card keeps a CTA); where that holds no block (a wide window's
# region), as many as one CTA's shared memory holds.
SPAN_MOST, SPAN_BUDGET = 256, 228 * 1024 // 3 - 1024
_MAX_SMEM = 227 * 1024
# A window staged in parts (PartPlan): the tile's reference span staged
# apart, TILE_SPAN rows of TILE_SPAN + 1 words (kRefWords in the source:
# f32, or mode 1's bf16 pairs in the first TILE_SPAN // 2 + 1 of each row);
# a part's row of the host-made table is PART_COLS ints (kPartCols: its
# first position in the plan's order, its count, dy0, dy1, dx0, dx1). Parts
# are the cells of bands of dy and dx, cut where some tile's live offsets
# begin or end (MatchGeometry.live_cuts) and split to at most a width
# between MIN_PART_EDGE and the window's. A plan's cost
# (MatchGeometry.visit_cost) counts each part a tile visits as PART_COST
# chunks besides its own: its staging, its barrier, its last chunk's idle
# warps.
REF_WORDS, PART_COLS, MIN_PART_EDGE, PART_COST = TILE_SPAN * (TILE_SPAN + 1), 6, 9, 0.5
# The settings K1 takes on the card: (least, most) of each; k is also a
# power of two (the Hadamard transform along the group needs one); the
# reference step, the search step and the row bounds any; the search
# radius as far as match_search_limit(block, k).
MATCH_ENVELOPE = {"block": (1, TILE_SPAN), "k": (1, 128)}
# bm3d_match_any_kernel's own bounds (kMinBlock, kMaxBlock, kMaxK in the
# source; its 4 x 4 tiles' regions at search 24): it takes only a grid with
# a repeated coordinate, which the BM3D denoiser never makes.
ANY_ENVELOPE = {"block": (2, 16), "search": (0, 24), "k": (1, 64)}


def check_match_envelope(block: int, k: int, search: int, step: int) -> None:
    """Raise ValueError, naming the bound, unless K1 takes this ``block``,
    group size ``k``, window radius ``search`` (the reach's, on an image
    narrower than the window: :meth:`MatchGeometry.reach`) and reference
    ``step`` (the largest stride of the grid) on the card.

    The bounds that stay, and why:

    * block 1-32 (:data:`TILE_SPAN`): the tile and span kernels give each
      lane of a warp one row of a tile's 32-pixel span and hold a tile's
      reference columns as bits of a 32-bit mask, so a block's rows must fit
      the warp's 32 lanes. Block 33 needs another tiling (not built).
    * a power-of-two k (the Hadamard transform along the group needs one)
      up to 128: a warp keeps a block's running top-k in one, two or four
      slots a lane (k 32, 64, 128); k 256 would need eight (not built). Its
      lists take 8 bytes an entry: 8 x 81 x 128 = 82,944 bytes for a
      tile-kernel CTA of 81 blocks at k 128 (:func:`tile_most` cuts a tile to
      fewer where that lets three or two CTAs share an SM).
    * step 1 or more (a grid that strictly ascends; at a step past the block
      a tile holds fewer blocks, one from step 25 at block 8).
    * search 0 to :func:`match_search_limit` (block, k): the windows whose
      one-part plan fits one CTA's 227 KB (232,448 bytes), the tile's
      32-pixel span plus the window's halo, (32 + 2 search) rows of (33 + 2
      search) 4-byte words, beside its distance buffer and top-k lists. At
      block 8 and k 16 that is search 95: 222 x 224 x 4 = 198,912 bytes of
      region, 21,060 of distances and 10,368 of lists. The calls past three
      CTAs an SM stage the window in parts (:class:`PartPlan`), which fit
      three CTAs at any window; the limit stays where every call can also
      take the one-part plan, the design the parts replaced, which
      ``launch(..., plan=...)`` reaches on the same call. A wider window on
      a small image is taken through its reach."""
    lo, hi = MATCH_ENVELOPE["block"]
    if not lo <= block <= hi:
        raise ValueError(f"K1 takes block {lo}-{hi} (a tile's span is {TILE_SPAN} pixels, one row a lane), "
                         f"not {block}")
    if step < 1:
        raise ValueError(f"K1 takes a reference step of 1 or more, not {step}")
    lo, hi = MATCH_ENVELOPE["k"]
    if not (lo <= k <= hi and k & (k - 1) == 0):
        raise ValueError(f"K1 takes a power-of-two k in {lo}-{hi} (at most four top-k slots a lane), not {k}")
    most = match_search_limit(block, k)
    if not 0 <= search <= most:
        raise ValueError(f"K1 takes search 0-{most} at block {block}, k {k} (its CTA's "
                         f"{match_smem_bytes(block, k, most)} bytes of shared memory of {_MAX_SMEM}), "
                         f"not {search}")


def check_any_envelope(block: int, k: int, search: int) -> None:
    """Raise ValueError, naming the bound, unless ``bm3d_match_any_kernel``
    (a grid with a repeated coordinate) takes this setting: block 2-16, k
    up to 64 (two slots a lane), search 0-24 (:data:`ANY_ENVELOPE`)."""
    for name, v in (("block", block), ("search", search), ("k", k)):
        lo, hi = ANY_ENVELOPE[name]
        if not lo <= v <= hi:
            raise ValueError(f"K1 takes a grid that does not strictly ascend (bm3d_match_any_kernel) at "
                             f"{name} {lo}-{hi}, not {v}")


def tile_smem_bytes(search: int, k: int, most: int | None = None) -> int:
    """Dynamic shared memory of a ``bm3d_match_tile_kernel`` CTA: the
    staged region, the distances of a chunk and the running top-k's, for
    :data:`TILE_MAX` blocks below k 128 (and in the four-slot design,
    ``most`` None); at k 128 by ranks for ``most`` blocks, the keys
    8-byte aligned."""
    region = (TILE_SPAN + 2 * search) * (((TILE_SPAN + 2 * search) | 1) + 1)  # f32, or bf16 pairs twice
    if k <= 64 or most is None:
        return 4 * (region + TILE_MAX * (TILE_CHUNK + 1)) + 8 * TILE_MAX * k
    return 4 * ((region + most * (TILE_CHUNK + 1) + 1) & ~1) + 8 * most * k


def tile_most(search: int, k: int) -> int:
    """The most blocks a ``bm3d_match_tile_kernel`` tile holds: :data:`TILE_MAX`
    below k 128; at k 128 as many as keep :func:`tile_smem_bytes` within
    the first of :data:`TILE_BUDGETS` (three CTAs an SM, then two) that
    leaves at least half of :data:`TILE_MAX`, else :data:`TILE_MAX`."""
    if k <= 64:
        return TILE_MAX
    for budget in TILE_BUDGETS:
        most = next((m for m in range(TILE_MAX, 0, -1) if tile_smem_bytes(search, k, m) <= budget), 0)
        if most >= TILE_MAX // 2:
            return most
    return TILE_MAX


def pixel_smem_bytes(search: int) -> int:
    """Dynamic shared memory of a ``bm3d_match_pixel_kernel`` CTA: the
    staged region alone, f32."""
    return 4 * (TILE_SPAN + 2 * search) * ((TILE_SPAN + 2 * search) | 1)


def match_smem_bytes(block: int, k: int, search: int) -> int:
    """The least dynamic shared memory K1's tile kernel (block 8) or span
    kernels (a tile of one block) need at this window and k."""
    if block == KERNEL_BLOCK:
        return tile_smem_bytes(search, k, tile_most(search, k))
    return span_smem_bytes(search, (TILE_SPAN + 2 * search) | 1, 1, k) + 4  # with the lists' alignment word


@functools.lru_cache(maxsize=None)
def match_search_limit(block: int, k: int) -> int:
    """The widest window radius whose K1 CTA fits :data:`_MAX_SMEM`
    (:func:`match_smem_bytes`)."""
    search = 0
    while match_smem_bytes(block, k, search + 1) <= _MAX_SMEM:
        search += 1
    return search


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
    where the tile's coordinates less its first are the mask's set bits
    (bit 31, at block 1, as the int32's sign) and span at most
    :data:`TILE_SPAN` pixels with their patches, and a tile has at most
    ``most`` of them. None unless the grid strictly ascends (the masks could
    not tell two equal coordinates apart)."""
    grid = [int(v) for v in grid]
    if any(b <= a for a, b in zip(grid[:-1], grid[1:])):
        return None
    tiles, start = [], 0
    while start < len(grid):
        end = start + 1
        while end < len(grid) and end - start < most and grid[end] - grid[start] + block <= TILE_SPAN:
            end += 1
        mask = sum(1 << (v - grid[start]) for v in grid[start:end])
        tiles.append((start, end - start, mask - (1 << 32) if mask >= 1 << 31 else mask))
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
    :data:`SPAN_BUDGET`, or within :data:`_MAX_SMEM` where that budget
    holds no block."""
    pitch = (TILE_SPAN + 2 * search) | 1
    fixed = span_smem_bytes(search, pitch, 0, k) + 4  # the lists' alignment word
    per = 4 * (TILE_CHUNK + 1) + 8 * span_entries(k)
    most = (SPAN_BUDGET - fixed) // per
    return min(SPAN_MOST, most if most >= 1 else (_MAX_SMEM - fixed) // per)


@dataclasses.dataclass(frozen=True, eq=False)
class PartPlan:
    """A reach's offsets cut into parts that the tile and span kernels stage
    one at a time (:func:`part_plan`): each part's row of ``table`` is
    (first position in ``order`` / ``offsets``, count, dy0, dy1, dx0, dx1),
    the part's offsets in the visiting order, the parts nearest the window's
    centre first. A CTA stages its tile's reference span apart
    (:data:`REF_WORDS`) and, for each part some block of the tile can take,
    the ``rows`` x (``pitch`` - 1) box of pixels its offsets reach from the
    span (f32 at row pitch ``pitch``, or mode 1's bf16 pairs in two
    alignments)."""

    table: torch.Tensor  # (n, PART_COLS) int32
    order: torch.Tensor  # (S',) int32: window indices, part by part
    offsets: torch.Tensor  # (S', 2) int32: the offsets in that order
    rows: int  # TILE_SPAN + the largest dy extent of a part
    pitch: int  # odd: TILE_SPAN + the largest dx extent, made even, + 1
    cuts: tuple  # (dy, dx) cut points: a band of each axis starts at each

    @property
    def words(self) -> int:
        """Shared-memory words of the reference span and a part's box."""
        return part_words(self.rows, self.pitch)


def part_words(rows: int, pitch: int) -> int:
    """Shared-memory words of the reference span and a part's box of
    ``rows`` rows at row pitch ``pitch`` (f32, or both pairs layouts)."""
    return REF_WORDS + rows * (pitch + 1)


@dataclasses.dataclass(frozen=True, eq=False)
class SpanPlan:
    """``bm3d_match_span_kernel``'s tiles for one k: :func:`tile_plan` of the
    rows and the columns, ``most`` the largest tile's blocks (its layout's
    stride) and the CTA's shared memory; ``parts`` where the window is
    staged in parts (None: one part, the whole reach at once)."""

    row_tiles: torch.Tensor  # (n, 3) int32
    col_tiles: torch.Tensor
    most: int
    smem_bytes: int
    parts: PartPlan | None = None


def box(width: int) -> tuple:
    """(rows, pitch) of the box a part of at most ``width`` offsets an axis
    stages (:class:`PartPlan`)."""
    cols = TILE_SPAN + width - 1
    return TILE_SPAN + width - 1, cols + (cols & 1) + 1


def _parts(offsets, cuts: tuple) -> tuple:
    """:func:`part_plan` in numpy: (the positions of ``offsets`` part by
    part, the table, the box's rows, its pitch)."""
    offs = np.asarray(offsets, np.int64).reshape(-1, 2)
    band = np.stack([np.searchsorted(np.asarray(c, np.int64), offs[:, a], side="right")
                     for a, c in enumerate(cuts)], 1)
    _, cell = np.unique(band[:, 0] * (len(cuts[1]) + 1) + band[:, 1], return_inverse=True)
    cell = cell.reshape(-1)
    by_cell = np.argsort(cell, kind="stable")
    first = np.concatenate([[0], np.cumsum(np.bincount(cell))[:-1]])
    lo = np.stack([np.minimum.reduceat(offs[by_cell, a], first) for a in (0, 1)], 1)
    hi = np.stack([np.maximum.reduceat(offs[by_cell, a], first) for a in (0, 1)], 1)
    rank = np.empty(len(first), np.int64)  # each cell's place: its centre's distance from the window's, then the cell
    rank[np.lexsort((np.arange(len(first)), ((lo + hi) ** 2).sum(1)))] = np.arange(len(first))
    lo, hi = lo[np.argsort(rank)], hi[np.argsort(rank)]
    pos = np.argsort(rank[cell], kind="stable")
    counts = np.bincount(rank[cell])
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    cols = TILE_SPAN + int((hi - lo)[:, 1].max())
    return (pos, np.stack([first, counts, lo[:, 0], hi[:, 0], lo[:, 1], hi[:, 1]], 1),
            TILE_SPAN + int((hi - lo)[:, 0].max()), cols + (cols & 1) + 1)


def part_plan(offsets, order, cuts: tuple, device) -> PartPlan:
    """``offsets`` (S', 2), in the visiting order with window indices
    ``order``, cut into parts: the cells of bands of dy and dx, a band of
    axis a starting at each of ``cuts[a]`` (:meth:`MatchGeometry.live_cuts`),
    each part's offsets kept in the visiting order,
    the parts by the distance of their centre from the window's (then by
    cell), so that the running top-k tightens early. An empty cell makes no
    part."""
    pos, table, rows, pitch = _parts(offsets, cuts)
    as_dev = lambda v: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.int32, device=device)  # noqa: E731
    return PartPlan(as_dev(table), as_dev(np.asarray(order)[pos]),
                    as_dev(np.asarray(offsets).reshape(-1, 2)[pos]), rows, pitch, tuple(map(tuple, cuts)))


def parts_live(table, row_span: tuple, col_span: tuple, lo: int, hi: int, last_c: int) -> np.ndarray:
    """Which parts of a ``table`` (:class:`PartPlan`'s, as numpy) a tile
    whose reference rows span ``row_span`` = (first, last) and columns
    ``col_span`` can take, by the kernels' test: some row plus some dy of
    the part in ``[lo, hi]`` (the candidate top rows), some column plus some
    dx in ``[0, last_c]``. A part it cannot take is +inf for every block of
    the tile, so skipping it changes no result."""
    t = np.asarray(table).reshape(-1, PART_COLS)
    return ((row_span[0] + t[:, 2] <= hi) & (row_span[1] + t[:, 3] >= lo)
            & (col_span[0] + t[:, 4] <= last_c) & (col_span[1] + t[:, 5] >= 0))


def tile_parts_smem_bytes(words: int, k: int) -> int:
    """Dynamic shared memory of a ``bm3d_match_tile_kernel`` CTA on a parts
    plan (k up to 64): the reference span and a part's box (``words``,
    :func:`part_words`), the distances of a chunk and :data:`TILE_MAX`
    blocks' top-k lists."""
    return 4 * (words + TILE_MAX * (TILE_CHUNK + 1)) + 8 * TILE_MAX * k


def span_parts_smem_bytes(words: int, most: int, k: int) -> int:
    """Dynamic shared memory of a ``bm3d_match_span_kernel`` CTA on a parts
    plan: :func:`span_smem_bytes` with the reference span and a part's box
    (``words``) in place of the whole region."""
    return 4 * ((words + most * (TILE_CHUNK + 1) + TILE_CHUNK + 1) & ~1) + 8 * most * span_entries(k)


def span_parts_most(words: int, k: int) -> int:
    """:func:`span_most` on a parts plan: the most blocks (one a thread)
    that keep :func:`span_parts_smem_bytes` within :data:`SPAN_BUDGET`, 0
    where none does."""
    return next((m for m in range(SPAN_MOST, 0, -1) if span_parts_smem_bytes(words, m, k) <= SPAN_BUDGET), 0)


def _cut(rows, cols, block: int, most: int) -> tuple:
    """(row tiles, column tiles, the largest tile's blocks): of the cuts
    (:func:`tile_plan`) with at most ``a`` reference rows and ``most`` //
    ``a`` columns a tile, the one with the fewest tiles (a CTA forms its
    whole span's terms, however many blocks it holds), the squarer on
    ties."""
    cuts = []
    for a in range(1, min(most, TILE_SPAN) + 1):
        row_tiles, col_tiles = tile_plan(rows, block, a), tile_plan(cols, block, most // a)
        cuts.append((len(row_tiles) * len(col_tiles), abs(len(row_tiles) - len(col_tiles)), a,
                     row_tiles, col_tiles))
    *_, row_tiles, col_tiles = min(cuts, key=lambda c: c[:3])
    return row_tiles, col_tiles, int(row_tiles[:, 1].max()) * int(col_tiles[:, 1].max())


def _plan(row_tiles, col_tiles, most: int, smem_bytes: int, device) -> SpanPlan:
    as_dev = lambda v: torch.as_tensor(v, device=device)  # noqa: E731
    return SpanPlan(as_dev(row_tiles), as_dev(col_tiles), most, smem_bytes)


def span_plan(rows, cols, block: int, search: int, k: int, device, most: int | None = None) -> SpanPlan:
    """The span kernels' tiles (:func:`_cut`) of at most ``most`` blocks,
    :func:`span_most`'s unless given (a caller timing smaller tiles)."""
    row_tiles, col_tiles, used = _cut(rows, cols, block, most or span_most(search, k))
    return _plan(row_tiles, col_tiles, used, span_smem_bytes(search, (TILE_SPAN + 2 * search) | 1, used, k), device)


def pixel_plan(rows, cols, search: int, device) -> SpanPlan:
    """``bm3d_match_pixel_kernel``'s tiles: the span kernels' cut at a
    thread a block (:data:`SPAN_MOST`); its shared memory is the region's."""
    row_tiles, col_tiles, used = _cut(rows, cols, 1, SPAN_MOST)
    return _plan(row_tiles, col_tiles, used, pixel_smem_bytes(search), device)


def visit_order(offsets) -> np.ndarray:
    """``bm3d_match_tile_kernel``'s order of the (S, 2) offsets: nearest the
    window's centre first (by dy^2 + dx^2, ties by index), where the best
    matches tend to be, so that its running top-k tightens early. The
    result does not depend on it: the kernel compares offset indices."""
    offsets = np.asarray(offsets, np.int64).reshape(-1, 2)
    return np.lexsort((np.arange(len(offsets)), (offsets ** 2).sum(1))).astype(np.int32)


@dataclasses.dataclass(frozen=True, eq=False)
class Reach:
    """The offsets the tile and span kernels visit on one image size:
    those some reference block can take (``|dy| <= H - block``, ``|dx| <= W
    - block``; at least one), in :func:`visit_order` with each one's index
    in the full window, the radius they need (``search``) and the staged
    region's row pitch."""

    order: torch.Tensor  # (S',) int32: the window indices, in the visiting order
    offsets: torch.Tensor  # (S', 2) int32: the offsets, in that order
    search: int
    pitch: int  # odd, >= TILE_SPAN + 2 search
    host: tuple = ()  # (offsets, order) as numpy
    size: tuple = ()  # the image's (H, W)
    plans: dict = dataclasses.field(default_factory=dict, repr=False)  # ("tile" / "span", k) -> SpanPlan


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
    call, and :meth:`reach` the offsets the tile and span kernels visit on
    an image size."""

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
    offsets: tuple = ()  # the (dy, dx) offsets, on the host
    host_tiles: tuple = ()  # row_tiles and col_tiles as numpy
    plans: dict = dataclasses.field(default_factory=dict, repr=False)  # (k, search) and the like -> SpanPlan
    reaches: dict = dataclasses.field(default_factory=dict, repr=False)  # (H, W) -> Reach

    def span(self, k: int, search: int | None = None, reach: Reach | None = None) -> SpanPlan:
        """``bm3d_match_span_kernel``'s tiles for group size ``k``
        (:func:`span_plan`) at the window radius ``search`` (the geometry's
        unless given: a reach's). With a ``reach``, the plan its calls take:
        of this one and the reach in parts of each odd width from the
        window's down to :data:`MIN_PART_EDGE` (:meth:`span_parts`), the one
        whose tiles cost the least (:meth:`visit_cost`), this one on ties,
        then the widest parts."""
        if reach is not None:
            if ("span", k) not in reach.plans:
                one = self.span(k, reach.search)
                best = self.visit_cost(one.row_tiles, one.col_tiles, None, reach), one
                for width in range(2 * reach.search + 1, MIN_PART_EDGE - 1, -2):
                    cut = self._span_parts(k, reach, width)
                    if cut is not None and cut[0] < best[0]:
                        best = cut[0], cut
                reach.plans["span", k] = best[1] if best[1] is one else self._span_plan(reach, *best[1][1:])
            return reach.plans["span", k]
        search = self.search if search is None else search
        if (k, search) not in self.plans:
            self.plans[k, search] = span_plan(self.rows, self.cols, self.block, search, k, self.rows_t.device)
        return self.plans[k, search]

    def visit_cost(self, row_tiles, col_tiles, table, reach: Reach) -> float:
        """The cost of the tiles ``row_tiles`` x ``col_tiles`` visiting
        ``reach`` on the whole image (no row bounds), in chunks of
        :data:`TILE_CHUNK` offsets (each about the same: a warp's 32 x 32
        terms an offset and a merge a block): every tile's chunks of each
        part of ``table`` (numpy) it can take (:func:`parts_live`; a chunk
        never crosses a part) and :data:`PART_COST` a part, or the chunks of
        the whole reach where ``table`` is None."""
        if table is None:
            return float(len(row_tiles) * len(col_tiles) * -(-len(reach.host[1]) // TILE_CHUNK))
        chunks = -(-table[:, 1] // TILE_CHUNK) + PART_COST
        h, w = reach.size
        return float(sum(chunks[parts_live(table, r, c, 0, h - self.block, w - self.block)].sum()
                         for r in self._spans(row_tiles, self.rows) for c in self._spans(col_tiles, self.cols)))

    @staticmethod
    def _spans(tiles, grid) -> list:
        """Each tile's first and last reference coordinate (``tiles`` a
        :func:`tile_plan`, in numpy or a tensor on any device)."""
        tiles = tiles.cpu().numpy() if isinstance(tiles, torch.Tensor) else np.asarray(tiles)
        return [(int(grid[t[0]]), int(grid[t[0] + t[1] - 1])) for t in tiles]

    def live_cuts(self, row_tiles, col_tiles, reach: Reach, width: int) -> tuple:
        """Cut points (:func:`part_plan`) of the reach's dy and dx: where some
        tile's live offsets begin or end (a tile whose reference rows span
        [a, b] takes dy in [-b, H - block - a]), each band then split evenly
        into bands of at most ``width`` values; a part either holds an offset
        some block of a tile takes or none of the tile's."""
        offs = reach.host[0]
        out = []
        for a, (tiles, grid, size) in enumerate(((row_tiles, self.rows, reach.size[0]),
                                                 (col_tiles, self.cols, reach.size[1]))):
            lo, hi = int(offs[:, a].min()), int(offs[:, a].max())
            live = {v for first, last in self._spans(tiles, grid) for v in (-last, size - self.block - first + 1)}
            edges = [lo] + sorted(v for v in live if lo < v <= hi) + [hi + 1]
            cuts = []
            for start, end in zip(edges[:-1], edges[1:]):
                n = -(-(end - start) // width)
                cuts += [start + (end - start) * i // n for i in range(1, n + 1)]
            out.append(tuple(cuts[:-1]))
        return tuple(out)

    def _span_parts(self, k: int, reach: Reach, width: int, cuts: tuple | None = None) -> tuple | None:
        """(:meth:`visit_cost`, row tiles, column tiles, blocks, shared
        memory, cuts) of :meth:`span_parts`; None where no block fits."""
        most = span_parts_most(part_words(*(box(width) if cuts is None else _parts(reach.host[0], cuts)[2:])), k)
        if most < 1:
            return None
        row_tiles, col_tiles, used = _cut(self.rows, self.cols, self.block, most)
        cuts = cuts or self.live_cuts(row_tiles, col_tiles, reach, width)
        _, table, rows, pitch = _parts(reach.host[0], cuts)
        return (self.visit_cost(row_tiles, col_tiles, table, reach), row_tiles, col_tiles, used,
                span_parts_smem_bytes(part_words(rows, pitch), used, k), cuts)

    def _span_plan(self, reach: Reach, row_tiles, col_tiles, used: int, smem: int, cuts: tuple) -> SpanPlan:
        return dataclasses.replace(_plan(row_tiles, col_tiles, used, smem, self.rows_t.device),
                                   parts=part_plan(*reach.host, cuts, self.rows_t.device))

    def span_parts(self, k: int, reach: Reach, width: int, cuts: tuple | None = None) -> SpanPlan | None:
        """``bm3d_match_span_kernel``'s reach in parts of at most ``width``
        offsets an axis cut where the tiles' live offsets begin and end
        (:meth:`live_cuts`), or at ``cuts`` (``width`` unused), on tiles of as
        many blocks as leave three CTAs an SM beside their box
        (:func:`span_parts_most`, :func:`_cut`); None where no block fits."""
        cut = self._span_parts(k, reach, width, cuts)
        return None if cut is None else self._span_plan(reach, *cut[1:])

    def tile_parts(self, k: int, reach: Reach, width: int | None = None, cuts: tuple | None = None) -> SpanPlan:
        """``bm3d_match_tile_kernel``'s reach in parts (k up to 64) on the
        geometry's tiles: cut at ``cuts``, or where the tiles' live offsets
        begin and end and then to at most ``width`` offsets an axis
        (:meth:`live_cuts`); without either, of the odd widths down to
        :data:`MIN_PART_EDGE` whose box lets three CTAs share an SM, the one
        whose tiles cost the least (:meth:`visit_cost`), the widest on
        ties."""
        if k > 64:
            raise ValueError(f"the tile kernel stages a window in parts at k up to 64, not {k}")
        tiles = self.host_tiles
        if cuts is None and width is None:
            best = None
            for w in range(2 * reach.search + 1, MIN_PART_EDGE - 1, -2):
                c = self.live_cuts(*tiles, reach, w)
                _, table, rows, pitch = _parts(reach.host[0], c)
                if tile_parts_smem_bytes(part_words(rows, pitch), k) <= TILE_BUDGETS[0]:
                    cost = self.visit_cost(*tiles, table, reach)
                    if best is None or cost < best[0]:
                        best = cost, c
            cuts = best[1]
        parts = part_plan(*reach.host, cuts or self.live_cuts(*tiles, reach, width), self.rows_t.device)
        return SpanPlan(self.row_tiles, self.col_tiles, TILE_MAX, tile_parts_smem_bytes(parts.words, k), parts)

    def tile(self, k: int, search: int | None = None, reach: Reach | None = None) -> SpanPlan:
        """``bm3d_match_tile_kernel``'s tiles for group size ``k`` at the
        window radius ``search`` (the geometry's unless given): the
        geometry's own (:data:`TILE_MAX` blocks) below k 128 or where
        :func:`tile_most` keeps :data:`TILE_MAX`, else :func:`_cut` at
        :func:`tile_most`. With a ``reach``, the plan its calls take: this
        one wherever its CTA lets three share an SM (and at k 128, where the
        lists bound the tiles: :func:`tile_most`), else its reach in parts
        (:meth:`tile_parts`)."""
        if reach is not None:
            if ("tile", k) not in reach.plans:
                one = self.tile(k, reach.search)
                reach.plans["tile", k] = (one if k > 64 or one.smem_bytes <= TILE_BUDGETS[0]
                                          else self.tile_parts(k, reach))
            return reach.plans["tile", k]
        search = self.search if search is None else search
        key = ("tile", k, search)
        if key not in self.plans:
            most = tile_most(search, k)
            if most == TILE_MAX:
                self.plans[key] = SpanPlan(self.row_tiles, self.col_tiles, TILE_MAX,
                                           tile_smem_bytes(search, k, TILE_MAX if k > 64 else None))
            else:
                row_tiles, col_tiles, used = _cut(self.rows, self.cols, self.block, most)
                self.plans[key] = _plan(row_tiles, col_tiles, used, tile_smem_bytes(search, k, used),
                                        self.rows_t.device)
        return self.plans[key]

    def pixel(self, search: int | None = None) -> SpanPlan:
        """``bm3d_match_pixel_kernel``'s tiles (:func:`pixel_plan`) at the
        window radius ``search`` (the geometry's unless given)."""
        search = self.search if search is None else search
        if ("pixel", search) not in self.plans:
            self.plans["pixel", search] = pixel_plan(self.rows, self.cols, search, self.rows_t.device)
        return self.plans["pixel", search]

    def reach(self, h: int, w: int) -> Reach:
        """The offsets the tile and span kernels visit on an ``h`` x ``w``
        image (:class:`Reach`): the whole window wherever some block can
        take every offset of it (every window inside the image)."""
        if (h, w) not in self.reaches:
            order = visit_order(self.offsets)
            offs = np.asarray(self.offsets, np.int64).reshape(-1, 2)[order]
            keep = (np.abs(offs[:, 0]) <= h - self.block) & (np.abs(offs[:, 1]) <= w - self.block)
            if keep.all():
                r = Reach(self.tile_order, self.tile_offsets, self.search, self.tile_pitch, (offs, order), (h, w))
            else:
                keep[0] |= not keep.any()  # at least one offset: an all-fill result, as the plain version's
                search = int(np.abs(offs[keep]).max())
                as_dev = lambda v: torch.as_tensor(v, dtype=torch.int32, device=self.rows_t.device)  # noqa: E731
                r = Reach(as_dev(order[keep]), as_dev(offs[keep]), search, (TILE_SPAN + 2 * search) | 1,
                          (offs[keep], order[keep]), (h, w))
            self.reaches[h, w] = r
        return self.reaches[h, w]

    @property
    def smem_bytes(self) -> int:
        """Dynamic shared memory of ``bm3d_match_kernel``'s CTA."""
        hsum = _WARPS * _IN_FLIGHT * _REF_ROWS * _MAX_COLS
        return 4 * (self.smem_h * self.pitch + TILE_R * TILE_C * self.d_pitch + hsum)

    @property
    def any_smem_bytes(self) -> int:
        """Dynamic shared memory of ``bm3d_match_any_kernel``'s CTA."""
        return 4 * self.any_smem_h * self.any_pitch

    def tile_smem_bytes(self, k: int, search: int | None = None) -> int:
        """Dynamic shared memory of ``bm3d_match_tile_kernel``'s CTA
        (:func:`tile_smem_bytes`) at the geometry's window radius, or
        ``search`` (a reach's)."""
        return tile_smem_bytes(self.search if search is None else search, k)

    def first_kernel_takes(self, block: int, k: int) -> bool:
        """Whether ``bm3d_match_kernel`` (8 x 8 blocks, 16 matches, a step-4
        column plan, at most 640 offsets) takes a call (:func:`match_kernel`)."""
        return ((block, k) == (KERNEL_BLOCK, KERNEL_K) and self.col_plan is not None
                and self.ref_rows <= _REF_ROWS and self.offsets_t.shape[0] <= _MAX_OFFSETS
                and self.smem_bytes <= _MAX_SMEM)


def match_kernel(g: MatchGeometry, block: int, k: int) -> str:
    """The K1 kernel that takes a call at geometry ``g`` with this ``block``
    and ``k``: ``bm3d_match_kernel`` wherever it can (every call it took
    before the tile kernel existed), else on a grid that strictly ascends
    ``bm3d_match_tile_kernel`` at block 8, ``bm3d_match_pixel_kernel`` at
    block 1 and k up to 8, ``bm3d_match_span_rt_kernel`` at block 1 past k 8
    and blocks 17-32, ``bm3d_match_span_kernel`` at blocks 2-16; else
    ``bm3d_match_any_kernel`` (every geometry)."""
    if g.first_kernel_takes(block, k):
        return "bm3d_match_kernel"
    if g.tile_order is None:
        return PREV_DESIGN
    if block == KERNEL_BLOCK:
        return "bm3d_match_tile_kernel"
    if block == 1 and k <= 8:
        return "bm3d_match_pixel_kernel"
    return "bm3d_match_span_rt_kernel" if block == 1 or block > 16 else "bm3d_match_span_kernel"


def prev_design(kernel: str, k: int, parts: bool = False) -> str:
    """The design ``kernel`` replaced on a call at group size ``k``: on a
    call whose plan stages the window in ``parts``, the same kernel on the
    one-part plan (``launch(..., plan=...)``: :meth:`MatchGeometry.tile` /
    :meth:`MatchGeometry.span` without a reach); else the four-slot tile
    kernel at block 8 and k 128, the serial span kernel for the pixel and
    run-time kernels and for the span kernel at k 128, else the any-kernel
    (:data:`PREV_DESIGN`)."""
    if parts:
        return kernel
    if k > 64 and kernel == "bm3d_match_tile_kernel":
        return TILE_SLOTS
    if kernel in ("bm3d_match_pixel_kernel", "bm3d_match_span_rt_kernel") or (
            k > 64 and kernel == "bm3d_match_span_kernel"):
        return SPAN_SERIAL
    return PREV_DESIGN


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
    tiles, host_tiles = [None] * 4, ()
    if tile_plan(rows, block, 1) is not None and tile_plan(cols, block, 1) is not None:
        order = visit_order(offsets)
        tiles[2:] = as_dev(order), as_dev(np.asarray(offsets)[order])
        if block == KERNEL_BLOCK:
            row_tiles = tile_plan(rows, block, TILE_MAX)
            host_tiles = row_tiles, tile_plan(cols, block, TILE_MAX // int(row_tiles[:, 1].max()))
            tiles[:2] = map(as_dev, host_tiles)
    return MatchGeometry(as_dev(rows), as_dev(cols), as_dev(offsets), plan, block,
                         max(grid_step(rows), grid_step(cols)), search, ref_rows, smem_h, smem_w,
                         smem_w | 1, len(offsets) | 1, any_h, any_w | 1, *tiles,
                         (TILE_SPAN + 2 * search) | 1, rows, cols, offsets, host_tiles)


def match_geometry(rows, cols, offsets, block: int, device) -> MatchGeometry:
    """K1's geometry for these reference coordinates and (S, 2) offsets."""
    return _geometry(
        tuple(int(v) for v in rows), tuple(int(v) for v in cols),
        tuple((int(dy), int(dx)) for dy, dx in np.asarray(offsets).reshape(-1, 2)),
        int(block), torch.device(device),
    )


ENTRIES = {  # kernel name -> (its entry point in the source, pointer and int arguments)
    "bm3d_match_kernel": ("bm3d_match_launch", 6, 16),
    "bm3d_match_tile_kernel": ("bm3d_match_tile_launch", 9, 18),
    "bm3d_match_any_kernel": ("bm3d_match_any_launch", 5, 14),
    "bm3d_match_span_kernel": ("bm3d_match_span_launch", 9, 18),
    "bm3d_match_span_rt_kernel": ("bm3d_match_span_rt_launch", 9, 18),
    "bm3d_match_pixel_kernel": ("bm3d_match_pixel_launch", 9, 18),
    "bm3d_match_tile_slots_kernel": ("bm3d_match_tile_slots_launch", 8, 15),
    "bm3d_match_span_serial_kernel": ("bm3d_match_span_serial_launch", 9, 18),
}


# The library of the replaced designs' entries (TILE_SLOTS, SPAN_SERIAL):
# csrc/bm3d_match_replaced.cu, bm3d_match.cu's source built with only those.
REPLACED_LIBRARY = "bm3d_match_replaced"


def bind(lib: ctypes.CDLL) -> dict:
    """Kernel name -> its entry point in a library built from
    ``csrc/bm3d_match.cu`` (or ``bm3d_match_replaced.cu``), with its
    argument types set, for each entry the library has."""
    fns = {}
    for name, (entry, pointers, ints) in ENTRIES.items():
        if not hasattr(lib, entry):
            continue
        fn = fns[name] = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return fns


class _Entries(dict):
    """The built library's entries; a replaced design's, from
    :data:`REPLACED_LIBRARY`, built and bound at its first use."""

    def __missing__(self, name: str):
        if name not in ENTRIES:
            raise KeyError(name)
        self.update(bind(_build.load(REPLACED_LIBRARY)))
        return self[name]


@functools.lru_cache(maxsize=None)
def _lib() -> dict:
    """:func:`bind` of the built library (the replaced designs' at first use)."""
    return _Entries(bind(_build.load("bm3d_match")))


# The kernels that take a plan staging the window in parts (PartPlan).
PARTED = ("bm3d_match_tile_kernel", "bm3d_match_span_kernel")


def launch(kernel: str, fn, x: torch.Tensor, g: MatchGeometry, out: torch.Tensor, block: int, k: int,
           mode: str, lo: int, hi: int, plan: SpanPlan | None = None) -> None:
    """Launch ``kernel`` through its bound entry point ``fn`` (:func:`bind`)
    on the current stream: images ``x`` (B, H, W) contiguous, ``out`` (B, nR,
    nC, k) int32, candidate rows ``[lo, hi)``; raises if the launch fails.
    It checks nothing else and counts nothing (:func:`bm3d_match` does
    both): a caller that times one kernel against another, on a call both
    take (the any-kernel, :data:`PREV_DESIGN`, takes every call inside its
    envelope; :func:`prev_design` names the design a kernel replaced),
    launches through it. The tile and span kernels take the plan their
    geometry gives the image's reach (:meth:`MatchGeometry.tile`,
    :meth:`MatchGeometry.span`), or ``plan`` where given (the one-part plan
    a parts plan replaced, or another a caller times); a plan in parts
    that ``kernel`` cannot take raises before the launch."""
    b, h, w = x.shape
    if plan is not None and plan.parts is not None and (kernel not in PARTED or (
            kernel == "bm3d_match_tile_kernel" and k > 64)):
        raise ValueError(f"{kernel} at k {k} takes no window in parts (the tile kernel up to k 64 and the span "
                         "kernel do)")
    nr, nc, s = g.rows_t.numel(), g.cols_t.numel(), g.offsets_t.shape[0]
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), g.rows_t.data_ptr(), g.cols_t.data_ptr(), g.offsets_t.data_ptr())
    if kernel == "bm3d_match_kernel":
        err = fn(*ptrs, g.col_plan.data_ptr(), out.data_ptr(), b, h, w, nr, nc, s, int(block), int(k),
                 MODES[mode], g.search, g.smem_h, g.smem_w, g.pitch, g.d_pitch, lo, hi - block, stream)
    elif kernel == TILE_SLOTS:
        r = g.reach(h, w)
        err = fn(*ptrs[:3], r.offsets.data_ptr(), r.order.data_ptr(), g.row_tiles.data_ptr(),
                 g.col_tiles.data_ptr(), out.data_ptr(), b, h, w, nr, nc, g.row_tiles.shape[0],
                 g.col_tiles.shape[0], r.order.shape[0], int(block), int(k), MODES[mode], r.search, r.pitch, lo,
                 hi - block, stream)
    elif kernel != PREV_DESIGN:  # the tile kernel and the span kernels: a plan, its most, its parts
        r = g.reach(h, w)
        p = plan or (g.tile(int(k), reach=r) if kernel == "bm3d_match_tile_kernel" else
                     g.pixel(r.search) if kernel == "bm3d_match_pixel_kernel" else
                     g.span(int(k), reach=r) if kernel == "bm3d_match_span_kernel" else g.span(int(k), r.search))
        q = p.parts
        order, offs = (r.order, r.offsets) if q is None else (q.order, q.offsets)
        err = fn(*ptrs[:3], offs.data_ptr(), order.data_ptr(), p.row_tiles.data_ptr(), p.col_tiles.data_ptr(),
                 out.data_ptr(), None if q is None else q.table.data_ptr(), b, h, w, nr, nc,
                 p.row_tiles.shape[0], p.col_tiles.shape[0], order.shape[0], int(block), int(k), MODES[mode],
                 r.search, r.pitch if q is None else q.pitch, p.most, lo, hi - block,
                 0 if q is None else q.table.shape[0], 0 if q is None else q.rows, stream)
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
    if g.block != block:
        raise ValueError(f"geometry for block {g.block}, called with block {block}")
    if g.rows_t.device != imgs.device:
        raise ValueError(f"geometry on {g.rows_t.device} but images on {imgs.device}")
    kernel = match_kernel(g, block, k)
    if kernel == PREV_DESIGN:
        check_any_envelope(block, k, g.search)
        if g.any_smem_bytes > _MAX_SMEM:  # not reached inside ANY_ENVELOPE
            raise ValueError(f"a tile's region needs {g.any_smem_bytes} bytes of shared memory")
    else:
        check_match_envelope(block, k, g.reach(imgs.shape[1], imgs.shape[2]).search, g.step)
    x = imgs.contiguous()
    out = torch.empty((x.shape[0], g.rows_t.numel(), g.cols_t.numel(), k), dtype=torch.int32, device=x.device)
    launch(kernel, _lib()[kernel], x, g, out, block, k, mode, lo, hi)
    bm3d_match.launches += 1
    bm3d_match.by_kernel[kernel] += 1
    return out


bm3d_match.launches = 0
bm3d_match.by_kernel = dict.fromkeys(K1_KERNELS, 0)
