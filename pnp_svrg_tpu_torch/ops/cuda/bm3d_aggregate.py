"""BM3D aggregation, fused: CUDA kernel K2 (``csrc/bm3d_aggregate.cu``) and
its plain PyTorch version.

Replaces the Pallas kernel ``bm3d_scatter_pallas`` (``_scatter_kernel``,
``pnp_svrg_tpu/ops/pallas/bm3d_scatter.py``) and the unfold-add
``_unfold_table`` that follows it in ``_aggregate``
(``pnp_svrg_tpu/denoisers/bm3d.py``). Both versions compute, per image, the
weighted overlap-add of the group estimates::

    wk  = wgt[b, g] * kaiser
    num = unfold_table(scatter(idx, est * wk)),  den = the same with wk

as (B, H, W) planes. The plain version forms the (B, hh*ww, 2*b*b)
patch-position table (``index_add_``) and folds it (``F.fold``); the kernel
adds straight into image tiles held in shared memory and has no table.

The kernel sums each tile's footprint in shared memory, stores it in a
scratch buffer, and a second launch sums the footprints that cover each
pixel in ascending tile order: no float atomic, so two calls on the same
inputs give the same bits. It agrees with the plain version to f32
rounding (about 1e-6 relative to the plane's magnitude; bit for bit where
every term and partial sum is representable, as with dyadic inputs), not
in its order: the plain version sums by table row, then folds.

The wrapper :func:`bm3d_aggregate` takes the plain version only for a CPU
tensor; for a CUDA tensor it launches K2 or raises. :func:`aggregate_kernel`
names the kernel of a call: ``bm3d_aggregate_kernel<BLOCK, KK>``, compiled
for (8, 16) and (8, 32) on 2 x 2 tiles of reference blocks where those
tiles' planes fit one CTA (search 37 at step 3: every BM3D lane's calls);
``bm3d_aggregate_gather_kernel`` where staged footprints lose
(:func:`gather_takes`: past block 16, or where the packed kernel's planes
pass a CTA, its scratch passes the estimates' bytes or its CTAs leave
fewer than eight warps an SM), which builds a member index per call and
sums every output pixel from it, with no footprint; and
``bm3d_aggregate_packed_kernel<Q>`` for the rest of
:data:`AGGREGATE_ENVELOPE` (block 1-32, K up to 128: K1's), on the larger
tiles of :func:`packed_plan` with the idle lanes of small patches given
members of their own. Their footprints are those of any grid: at a step
past the block, pixels that no member covers keep ``den = 0``, as in the
plain version. A setting outside the envelope raises before any launch
(:func:`check_aggregate_envelope`). The design the packed kernel replaced,
``bm3d_aggregate_kernel<0, 0>`` (block and K read at run time, 2 x 2
tiles), stays reachable through :func:`launch` alone, so that a caller can
time the two on one call (:data:`PREV_DESIGN`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch
import torch.nn.functional as F

from pnp_svrg_tpu_torch.ops.cuda import _build

TILE_R, TILE_C, _WARPS = 2, 2, 4  # kTileR, kTileC and kWarps in the source
_MAX_SMEM = 227 * 1024
PACKED_MAX_WARPS = 8  # kPackedMaxWarps in the source
PACKED_SMEM = 64 * 1024  # the packed plans' shared memory a CTA, at most
PACKED_VALUES = 1024  # member values a warp of the packed kernel adds, at least
K2_KERNELS = ("bm3d_aggregate_kernel", "bm3d_aggregate_packed_kernel", "bm3d_aggregate_gather_kernel")
# The run-time design the packed kernel replaced: launched only by name.
PREV_DESIGN = "bm3d_aggregate_kernel<0, 0>"
COMPILED = ((8, 16), (8, 32))  # the (block, K) bm3d_aggregate_kernel is compiled for
# The settings K2 takes on the card, as K1 (``bm3d_match.MATCH_ENVELOPE``):
# (least, most) of the patch edge and of the group size K, a power of two.
# Its footprints are those of any grid and window K1 takes (the gather form
# takes those no packed CTA holds).
AGGREGATE_ENVELOPE = {"block": (1, 32), "k": (1, 128)}
# The gather form's rule (gather_takes), from k2_variants' timings: the
# packed kernel's scratch over the estimates' bytes, and its resident warps
# an SM, on its plan for the call.
GATHER_SCRATCH_RATIO, GATHER_MIN_WARPS = 1.0, 8
N_SMS = 132  # an H100's SMs: the index kernel's CTAs are planned for them
INDEX_MAX_ROWS = 8192  # table rows a run, at most
INDEX_SMEM = 160 * 1024  # an index CTA's shared memory: its rows and the members it keeps


def check_aggregate_envelope(block: int, k: int) -> None:
    """Raise ValueError, naming the bound, unless K2 takes this patch edge
    and group size on the card.

    The bounds that stay, and why: block 1-32 and a power-of-two K up to
    128 are K1's (``bm3d_match.check_match_envelope``): no BM3D call past
    them reaches the aggregation, so no kernel is built for them (the
    packed kernel's K is a shift, and a member past block 32 would be more
    than 1,024 values a warp). The footprint bounds no call: where a
    packed CTA's planes would pass its shared memory (at block 8, search
    82 on a 256 px image), :func:`aggregate_plan` gives the call to the
    gather form, whose CTAs hold only the Kaiser window."""
    lo, hi = AGGREGATE_ENVELOPE["block"]
    if not lo <= block <= hi:
        raise ValueError(f"K2 takes block {lo}-{hi}, not {block}")
    lo, hi = AGGREGATE_ENVELOPE["k"]
    if not (lo <= k <= hi and k & (k - 1) == 0):
        raise ValueError(f"K2 takes a power-of-two group size K in {lo}-{hi}, not {k}")


def unfold_table(table: torch.Tensor, block: int, h: int, w: int):
    """(B, hh*ww, 2*b*b) patch-position table -> (num, den) images by the
    static overlap-add (``F.fold``): channel 0 is the numerator, 1 the
    denominator."""
    out = F.fold(table.transpose(1, 2), (h, w), kernel_size=block)  # (B, 2, H, W)
    return out[:, 0], out[:, 1]


def bm3d_aggregate_plain(idx, est, wgt, kaiser, h: int, w: int):
    """The plain version of K2: the update rows ``[est * wk | wk]``, one
    ``index_add_`` into a zeroed patch-position table, then the unfold-add.
    Returns (num, den), each (B, H, W)."""
    b, p, bb = est.shape
    g = wgt.shape[1]
    block = math.isqrt(bb)
    hh, ww = h - block + 1, w - block + 1
    wk = wgt[..., None, None] * kaiser  # (B, G, 1, b*b)
    est_g = est.reshape(b, g, p // g, bb)
    num_upd = (est_g * wk).reshape(b, p, bb)
    den_upd = wk.expand(est_g.shape).reshape(b, p, bb)
    upd = torch.cat([num_upd, den_upd], dim=-1)
    table = torch.zeros((b * hh * ww, 2 * bb), dtype=torch.float32, device=est.device)
    base = torch.arange(b, device=est.device)[:, None] * (hh * ww)
    table.index_add_(0, (idx.to(torch.int64) + base).reshape(-1), upd.reshape(b * p, 2 * bb))
    return unfold_table(table.view(b, hh * ww, 2 * bb), block, h, w)


def aggregate_kernel(block: int, k: int, geometry: AggregateGeometry | None = None) -> str:
    """The K2 kernel that takes a call with this patch edge and group size
    on ``geometry``: ``bm3d_aggregate_kernel`` at its compiled (8, 16) and
    (8, 32) where its 2 x 2 tiles' planes fit one CTA (every BM3D lane's;
    without a geometry, the window is taken to fit),
    ``bm3d_aggregate_gather_kernel`` where staged footprints lose
    (:func:`gather_takes`), ``bm3d_aggregate_packed_kernel`` everywhere
    else (and, without a geometry, off (8, 16) and (8, 32))."""
    if geometry is None:
        return K2_KERNELS[0] if (block, k) in COMPILED else K2_KERNELS[1]
    if (block, k) in COMPILED and geometry.smem_bytes <= _MAX_SMEM:
        return K2_KERNELS[0]
    gathers = gather_takes(block, k, geometry.packed(k), geometry.n_r, geometry.n_c)
    return K2_KERNELS[2] if gathers else K2_KERNELS[1]


def lane_groups(block: int) -> int:
    """Lane groups a warp of the packed kernel: as many members as a warp's
    32 lanes hold side by side, block^2 lanes each (one where block^2 > 16)."""
    bb = block * block
    return 32 // bb if bb <= 16 else 1


def footprints(h: int, w: int, rows, cols, search: int, block: int, tile: tuple = (TILE_R, TILE_C)):
    """Per-tile footprint origins and the largest footprint of K2's tiles of
    ``tile`` = (rows, columns) reference blocks.

    A member of reference block (r, c) sits at
    ``(clip(rows[r] + dy, 0, h - block), clip(cols[c] + dx, 0, w - block))``
    with ``|dy|, |dx| <= search``, so the members of a tile of reference
    blocks land in ``[clip(first - search), clip(last + search) + block)``
    along each axis. Returns (row origins, column origins, fh, fw)."""

    def axis(grid, size, tile):
        last = size - block
        clip = lambda v: min(max(v, 0), last)  # noqa: E731
        origins, spans = [], []
        for i in range(0, len(grid), tile):
            lo = clip(int(grid[i]) - search)
            hi = clip(int(grid[min(i + tile, len(grid)) - 1]) + search) + block
            origins.append(lo)
            spans.append(hi - lo)
        return origins, max(spans)

    oy, fh = axis(rows, h, tile[0])
    ox, fw = axis(cols, w, tile[1])
    return oy, ox, fh, fw


def packed_smem(fh: int, fw: int, warps: int, groups: int) -> int:
    """Shared memory of a packed CTA: (num, den) planes of the footprint for
    each lane group of each warp."""
    return 2 * warps * groups * fh * fw * 4


def packed_plan(h: int, w: int, rows, cols, search: int, block: int, k: int) -> tuple:
    """The packed kernel's square tile edge (reference blocks), warps a CTA
    and lane groups a warp for this grid, window and group size ``k``.

    Every CTA zeroes its planes, sums them into its footprint and stores
    it, and the fold reads it back: a cost of the footprint, against which
    the tile's members must weigh, but small CTAs keep the most of them in
    flight (``examples/k2_variants.py`` times tile edges 2-12 with 1, 2 and 4
    warps at the run-time rows). So a CTA is one warp where the lanes hold
    several members side by side (block^2 <= 16), else two, and the tile
    the smallest, 2 x 2 at least, that gives each warp
    :data:`PACKED_VALUES` member values to add. The tile shrinks back
    where its planes pass :data:`PACKED_SMEM` or its footprints would take
    more scratch than the 2 x 2 tiles'; at 2 x 2, a warp takes fewer lane
    groups where their planes do not fit (with one group its planes are the
    2 x 2 kernel's a warp). Where even those pass :data:`PACKED_SMEM` (a
    window far wider than the step), a CTA is one warp and its tile grows
    until its members' values are as many as its planes'."""
    groups = lane_groups(block)
    warps = 1 if groups > 1 else 2
    oy, ox, fh, fw = footprints(h, w, rows, cols, search, block)
    pair_area = len(oy) * len(ox) * fh * fw
    n = max(len(rows), len(cols))
    edge = TILE_R
    while edge < n and edge * edge * k * block * block < PACKED_VALUES * warps:
        edge += 1
    for edge in range(edge, TILE_R - 1, -1):
        oy, ox, fh, fw = footprints(h, w, rows, cols, search, block, (edge, edge))
        if packed_smem(fh, fw, warps, groups) <= PACKED_SMEM and len(oy) * len(ox) * fh * fw <= pair_area:
            return edge, warps, groups
    while groups > 1 and packed_smem(fh, fw, warps, groups) > PACKED_SMEM:
        groups //= 2
    if packed_smem(fh, fw, warps, groups) <= PACKED_SMEM:
        return TILE_R, warps, groups
    # A window far wider than the step: a CTA zeroes, stores and folds back
    # planes larger than its members. One warp a CTA, and the smallest tile
    # whose members' values are as many as its planes' (k2_variants' rows
    # search40 and search_widest), as far as one CTA's shared memory holds;
    # one reference block a tile where even 2 x 2 does not fit.
    plan = (1, 1, groups)
    for edge in range(TILE_R, n + 1):
        fh, fw = footprints(h, w, rows, cols, search, block, (edge, edge))[2:]
        if packed_smem(fh, fw, 1, groups) > _MAX_SMEM:
            break
        plan = (edge, 1, groups)
        if edge * edge * k * block * block >= 2 * fh * fw:
            break
    return plan


def packed_warps_an_sm(plan: PackedPlan) -> int:
    """Warps of ``plan``'s CTAs resident on one SM of an H100: as many CTAs
    as its 228 KB of shared memory (1 KB a CTA reserved), 64 warps and 32
    CTAs allow."""
    ctas = min(32, 64 // plan.warps, (228 * 1024) // (plan.smem_bytes + 1024))
    return ctas * plan.warps


def scratch_ratio(plan: PackedPlan, block: int, k: int, n_r: int, n_c: int) -> float:
    """Bytes of footprints ``plan``'s CTAs store to scratch (and its fold
    reads back) over the bytes of estimates the call holds (``n_r`` x
    ``n_c`` groups of ``k`` members of ``block``^2 values), for any batch."""
    return plan.scratch_bytes(1) / (n_r * n_c * k * block * block * 4)


def gather_takes(block: int, k: int, plan: PackedPlan, n_r: int, n_c: int) -> bool:
    """Whether a call off the compiled kernel goes to the gather form, on
    the packed kernel's plan for it: past block 16 (where the packed kernel
    reads a member's values at run time, a warp a member), where that plan's
    planes pass one CTA's shared memory, where its scratch passes
    :data:`GATHER_SCRATCH_RATIO` times the estimates' bytes
    (:func:`scratch_ratio`), or where its CTAs leave fewer than
    :data:`GATHER_MIN_WARPS` warps an SM (:func:`packed_warps_an_sm`)."""
    return (block > 16 or plan.smem_bytes > _MAX_SMEM
            or scratch_ratio(plan, block, k, n_r, n_c) > GATHER_SCRATCH_RATIO
            or packed_warps_an_sm(plan) < GATHER_MIN_WARPS)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """The gather kernel's CTAs: ``rows`` pixel rows a lane (0: one pixel a
    thread, its own walk; 1: a warp's 8 columns x 4 rows, one walk a warp,
    ``unroll`` members in flight), ``warps`` a CTA, ``wx`` of them side by
    side."""

    rows: int
    warps: int
    wx: int
    block: int
    unroll: int = 8

    @property
    def tile(self) -> tuple:
        """(rows, columns) of output pixels a CTA."""
        if self.rows == 0:
            return self.warps, 32
        return 4 * self.rows * (self.warps // self.wx), 8 * self.wx

    @property
    def smem_bytes(self) -> int:
        """A CTA's shared memory: the Kaiser window, and with ``rows`` > 0
        each warp's staged bucket offsets (its patch rows by its columns and
        one past) and its patch rows' first entries (gather_stage_ints in
        the source)."""
        b = self.block
        return 4 * (b * b + (self.warps * ((4 * self.rows + b - 1) * (b + 9) + 1) if self.rows else 0))


def gather_plan(block: int, per_row: float = 1.0, rows: int | None = None, warps: int | None = None,
                wx: int | None = None, unroll: int | None = None) -> GatherPlan:
    """The gather kernel's plan at this patch edge for ``per_row`` members a
    table row on average, or one with the rows a lane, warps, warps across
    or members in flight given (a caller timing other choices): one pixel a
    thread, 8 warps a CTA (32 x 8 pixels), up to block 2, where a member has
    no patch row for lanes to share; past it one walk a warp over 8 x 4
    pixels, 4 warps, 2 across (16 x 8 pixels a CTA), each member's patch
    rows read by the lanes together, 8 members in flight, or 4 where a
    warp's walk holds fewer than 32 (fewer registers: more warps an SM;
    ``examples/k2_variants.py --part gather`` times the others)."""
    if rows is None:
        rows = 0 if block <= 2 else 1
    warps = warps or (8 if rows == 0 else 4)
    wx = wx or (1 if rows == 0 else min(2, warps))
    if unroll is None:
        unroll = 4 if rows and (4 * rows + block - 1) * (block + 7) * per_row < 32 else 8
    return GatherPlan(rows, warps, wx, block, unroll)


def index_plan(b: int, n_rows: int, p: int) -> tuple:
    """(table rows a run, members an index CTA keeps in shared memory, its
    threads) of the gather form's member index for ``b`` images of
    ``n_rows`` table rows and ``p`` members each: runs of rows as even as
    the rows allow, about :data:`N_SMS` CTAs in all (each reads all its
    image's rows), from 256 to :data:`INDEX_MAX_ROWS` rows a run, as many
    members as the rest of :data:`INDEX_SMEM` holds (16 bytes a member, 8 a
    row), and 1,024 threads where an image has more than 16,384 members,
    else 512 (k2_variants: fewer threads lose where the rows are many, gain
    where they are few)."""
    runs = max(-(-n_rows // INDEX_MAX_ROWS), min(-(-n_rows // 256), N_SMS // max(b, 1)), 1)
    chunk = -(-(-(-n_rows // runs)) // 32) * 32
    return chunk, (INDEX_SMEM // 4 - 2 * chunk - 35) // 4, 1024 if p > 16384 else 512


def member_index_plain(idx: torch.Tensor, n_rows: int) -> tuple:
    """The plain version of the gather form's member index: (offsets, ids),
    offsets (B, n_rows + 1) into ids (B * P), image b's entries from b * P
    on, each row's members (their index p in the image) in ascending order;
    rows outside ``[0, n_rows)`` are left out. A stable sort by row, and the
    counts by ``bincount``."""
    b, p = idx.shape
    rows = idx.to(torch.int64)
    keep = (rows >= 0) & (rows < n_rows)
    ids = torch.full((b * p,), -1, dtype=torch.int32, device=idx.device)
    offsets = torch.empty((b, n_rows + 1), dtype=torch.int32, device=idx.device)
    for i in range(b):
        r = rows[i][keep[i]]
        members = torch.arange(p, device=idx.device)[keep[i]]
        order = torch.sort(r, stable=True).indices
        ids[i * p : i * p + len(r)] = members[order].to(torch.int32)
        counts = torch.bincount(r, minlength=n_rows)
        offsets[i, 0] = i * p
        offsets[i, 1:] = i * p + torch.cumsum(counts, 0)
    return offsets, ids


def covering_tiles(origins, extent: int, size: int) -> list:
    """Per pixel row (or column) of an image ``size`` long, the first and
    last tile whose footprint ``[origin, origin + extent)`` holds it, as
    ``[first, last]``; ``[0, -1]`` where none does. The origins ascend (each
    is a clipped ascending grid value), so the covering tiles are a run."""
    out = []
    for y in range(size):
        tiles = [t for t, o in enumerate(origins) if o <= y < o + extent]
        out.append([tiles[0], tiles[-1]] if tiles else [0, -1])
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class PackedPlan:
    """The packed kernel's tiles: ``tile`` x ``tile`` reference blocks, their
    footprints and covering lists as :class:`AggregateGeometry` holds the 2 x
    2 tiles', ``warps`` a CTA and ``groups`` lane groups a warp."""

    tile: int
    warps: int
    groups: int
    fh: int
    fw: int
    tile_oy: torch.Tensor
    tile_ox: torch.Tensor
    cover_y: torch.Tensor
    cover_x: torch.Tensor

    @property
    def smem_bytes(self) -> int:
        return 2 * self.warps * self.groups * self.fh * self.fw * 4

    def scratch_bytes(self, b: int) -> int:
        return b * len(self.tile_oy) * len(self.tile_ox) * 2 * self.fh * self.fw * 4


def make_packed_plan(h: int, w: int, rows, cols, search: int, block: int, k: int, device,
                     tile: int | None = None, warps: int | None = None,
                     groups: int | None = None) -> PackedPlan:
    """:func:`packed_plan`'s plan on ``device``, or one with the tile edge,
    warps or lane groups given (a caller timing other choices)."""
    t, nw, ng = packed_plan(h, w, rows, cols, search, block, k)
    t, nw, ng = tile or t, warps or nw, groups or ng
    oy, ox, fh, fw = footprints(h, w, rows, cols, search, block, (t, t))
    as_dev = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return PackedPlan(t, nw, ng, fh, fw, as_dev(oy), as_dev(ox), as_dev(covering_tiles(oy, fh, h)),
                      as_dev(covering_tiles(ox, fw, w)))


@dataclasses.dataclass(frozen=True, eq=False)
class AggregateGeometry:
    """What K2 needs besides its tensors, made once per shape and device,
    with the scratch its footprints pass through (grown to the largest
    call seen; calls that share it run in order on one stream). Its own
    fields are the 2 x 2 tiles of ``bm3d_aggregate_kernel`` (and of
    :data:`PREV_DESIGN`); :meth:`packed` the packed kernel's plan for a
    group size, made at its first call."""

    h: int
    w: int
    block: int
    n_r: int
    n_c: int
    fh: int
    fw: int
    tile_oy: torch.Tensor  # (ceil(nR / TILE_R),) int32 on the device
    tile_ox: torch.Tensor  # (ceil(nC / TILE_C),) int32
    cover_y: torch.Tensor  # (H, 2) int32: first and last tile row covering each row
    cover_x: torch.Tensor  # (W, 2) int32
    search: int
    rows: tuple
    cols: tuple
    plans: dict = dataclasses.field(default_factory=dict, repr=False)  # K -> PackedPlan
    work: dict = dataclasses.field(default_factory=dict, repr=False)

    def packed(self, k: int) -> PackedPlan:
        """The packed kernel's plan (:func:`packed_plan`) for group size ``k``."""
        if k not in self.plans:
            self.plans[k] = make_packed_plan(self.h, self.w, self.rows, self.cols, self.search, self.block, k,
                                             self.tile_oy.device)
        return self.plans[k]

    @property
    def smem_bytes(self) -> int:
        return 2 * _WARPS * self.fh * self.fw * 4  # private planes for each warp

    def scratch_bytes(self, b: int, plan: PackedPlan | None = None) -> int:
        """The footprints of ``b`` images in the 2 x 2 tiles (or ``plan``'s):
        (tile rows, tile columns, num and den, fh, fw) f32 each."""
        if plan is not None:
            return plan.scratch_bytes(b)
        return b * len(self.tile_oy) * len(self.tile_ox) * 2 * self.fh * self.fw * 4

    def workspace(self, b: int, plan: PackedPlan | None = None) -> tuple:
        """(scratch, overflow flags, epoch) for a call on ``b`` images in the
        2 x 2 tiles (or ``plan``'s): the buffers are allocated once, grown
        with the call and never cleared; the epoch is one more each call. A
        stale flag that meets its epoch again after 2**31 - 1 calls costs
        only time: the fold's scan adds just the members outside their
        footprints, which the tiles skip."""
        floats = self.scratch_bytes(b, plan) // 4
        dev = self.tile_oy.device
        if self.work.get("floats", 0) < floats:
            self.work["scratch"] = torch.empty(floats, dtype=torch.float32, device=dev)
            self.work["floats"] = floats
        if self.work.get("batch", 0) < b:
            self.work["overflow"] = torch.zeros(b, dtype=torch.int32, device=dev)
            self.work["batch"] = b
        self.work["epoch"] = self.work.get("epoch", 0) % (2**31 - 1) + 1
        return self.work["scratch"], self.work["overflow"], self.work["epoch"]

    def index_workspace(self, b: int, p: int) -> tuple:
        """(offsets, ids, any_ids, any_rows) of the gather form's member index
        for ``b`` images of ``p`` members: int32, B * (hh * ww + 1) and B * P
        (three times) long, allocated once and grown with the call; each
        call writes what it reads."""
        n = (b * ((self.h - self.block + 1) * (self.w - self.block + 1) + 1), b * p)
        dev = self.tile_oy.device
        if any(a < c for a, c in zip(self.work.get("index", (0, 0)), n)):
            self.work["index"] = n
            self.work["offsets"] = torch.empty(n[0], dtype=torch.int32, device=dev)
            self.work["ids"] = torch.empty((3, max(n[1], 1)), dtype=torch.int32, device=dev)
        return self.work["offsets"], *self.work["ids"]


@functools.lru_cache(maxsize=16)
def aggregate_geometry(h: int, w: int, rows: tuple, cols: tuple, search: int, block: int,
                       device: torch.device) -> AggregateGeometry:
    """The 2 x 2 tiles' footprints (:func:`footprints`) and the tiles
    covering each pixel row and column (:func:`covering_tiles`), on
    ``device``; the packed kernel's plans follow at their first call."""
    oy, ox, fh, fw = footprints(h, w, rows, cols, search, block)
    as_dev = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return AggregateGeometry(h, w, block, len(rows), len(cols), fh, fw, as_dev(oy), as_dev(ox),
                             as_dev(covering_tiles(oy, fh, h)), as_dev(covering_tiles(ox, fw, w)),
                             search, tuple(rows), tuple(cols))


def per_row(geometry: AggregateGeometry, k: int) -> float:
    """Members a table row on ``geometry`` at group size ``k``, on average."""
    n_rows = (geometry.h - geometry.block + 1) * (geometry.w - geometry.block + 1)
    return geometry.n_r * geometry.n_c * k / n_rows


def aggregate_plan(geometry: AggregateGeometry, k: int) -> tuple:
    """(kernel, plan) of a K2 call on ``geometry`` at group size ``k``: the
    kernel :func:`aggregate_kernel` names, and the geometry's own 2 x 2
    tiles, its packed plan (:meth:`AggregateGeometry.packed`) or the gather
    plan (:func:`gather_plan`, which holds no footprint). Raises ValueError,
    naming the bound, outside :data:`AGGREGATE_ENVELOPE`."""
    check_aggregate_envelope(geometry.block, k)
    kernel = aggregate_kernel(geometry.block, k, geometry)
    if kernel == K2_KERNELS[2]:
        return kernel, gather_plan(geometry.block, per_row(geometry, k))
    return kernel, (geometry.packed(k) if kernel == K2_KERNELS[1] else geometry)


ENTRIES = {  # kernel name -> (its entry point in the source, its C argument types)
    K2_KERNELS[0]: ("bm3d_aggregate_launch", [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    K2_KERNELS[1]: ("bm3d_aggregate_packed_launch", [ctypes.c_void_p] * 10 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 13 + [ctypes.c_void_p]),
    K2_KERNELS[2]: ("bm3d_aggregate_gather_launch", [ctypes.c_void_p] * 10 + [ctypes.c_int] * 14 + [ctypes.c_void_p]),
}
ENTRIES[PREV_DESIGN] = ENTRIES[K2_KERNELS[0]]  # the same entry: it runs <0, 0> off (8, 16), (8, 32)


def bind(lib: ctypes.CDLL) -> dict:
    """Kernel name -> its entry point in a library built from
    ``csrc/bm3d_aggregate.cu``, with its argument types set."""
    fns = {}
    for name, (entry, argtypes) in ENTRIES.items():
        fn = fns[name] = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return fns


def _lib() -> dict:
    """:func:`bind` of the built library."""
    return bind(_build.load("bm3d_aggregate"))


def launch(kernel: str, fn, idx, est, wgt, kaiser, h: int, w: int, geometry: AggregateGeometry,
           plan: PackedPlan | GatherPlan | None = None):
    """One call of ``kernel`` through its bound entry point ``fn``
    (:func:`bind`) on checked, contiguous arguments: (num, den), each (B, H,
    W), in new memory; raises if the launch fails. The packed and gather
    kernels run on ``plan``, by default the geometry's for the call's K
    (:meth:`AggregateGeometry.packed`, :func:`gather_plan` as
    :func:`aggregate_plan` makes it). It checks
    nothing else and counts nothing (:func:`bm3d_aggregate` does both): a
    caller that times one kernel or plan against another on one call
    launches through it. :data:`PREV_DESIGN` takes any call but (8, 16) and
    (8, 32), where the entry runs the compiled kernel."""
    b, p, bb = est.shape
    block, k = math.isqrt(bb), p // wgt.shape[1]
    if kernel == PREV_DESIGN and (block, k) in COMPILED:
        raise ValueError(f"{PREV_DESIGN} does not take (block, K) = {(block, k)}")
    planes = torch.empty((2, b, h, w), dtype=torch.float32, device=est.device)
    stream = torch.cuda.current_stream(est.device).cuda_stream
    if kernel == K2_KERNELS[2]:
        plan = plan or gather_plan(block, per_row(geometry, k))
        chunk, cap, threads = index_plan(b, (h - block + 1) * (w - block + 1), p)
        index = geometry.index_workspace(b, p)
        err = fn(idx.data_ptr(), est.data_ptr(), wgt.data_ptr(), kaiser.data_ptr(), *(t.data_ptr() for t in index),
                 planes[0].data_ptr(), planes[1].data_ptr(), b, h, w, geometry.n_r, geometry.n_c, k, block, chunk,
                 cap, threads, plan.rows, plan.unroll, plan.warps, plan.wx, stream)
        _build.check(err, f"bm3d_aggregate ({kernel}, block={block}, K={k})")
        return planes[0], planes[1]
    if kernel == K2_KERNELS[1]:
        plan = plan or geometry.packed(k)
    scratch, overflow, epoch = geometry.workspace(b, plan)
    g = plan or geometry
    args = [idx.data_ptr(), est.data_ptr(), wgt.data_ptr(), kaiser.data_ptr(), g.tile_oy.data_ptr(),
            g.tile_ox.data_ptr(), g.cover_y.data_ptr(), g.cover_x.data_ptr(), scratch.data_ptr(),
            overflow.data_ptr(), epoch, planes[0].data_ptr(), planes[1].data_ptr(), b, h, w,
            geometry.n_r, geometry.n_c, k, block, g.fh, g.fw]
    if kernel == K2_KERNELS[1]:
        args += [g.tile, g.tile, g.warps, g.groups]
    err = fn(*args, stream)
    _build.check(err, f"bm3d_aggregate ({kernel}, block={block}, K={k})")
    return planes[0], planes[1]


def bm3d_aggregate(idx: torch.Tensor, est: torch.Tensor, wgt: torch.Tensor,
                   kaiser: torch.Tensor, h: int, w: int,
                   geometry: AggregateGeometry | None = None):
    """(num, den), each (B, H, W): the weighted overlap-add of the group
    estimates.

    ``idx``: (B, P) int32 patch-position rows ``py * ww + px``; ``est``:
    (B, P, b*b) f32 estimates, member k of group g at ``p = g * K + k``;
    ``wgt``: (B, G) f32 group weights; ``kaiser``: (b*b,) f32; ``h``, ``w``:
    the image size; ``geometry``: :func:`aggregate_geometry` of the
    reference grid and search, which K2 needs and the plain version does
    not. A CPU tensor takes the plain version; a CUDA tensor launches the
    K2 kernel :func:`aggregate_kernel` names inside
    :data:`AGGREGATE_ENVELOPE` and raises outside it or where its
    footprint does not fit (:func:`aggregate_plan`). Each call counts one
    in ``bm3d_aggregate.launches`` and one in ``bm3d_aggregate.by_kernel``
    under the kernel's name.

    A row outside ``[0, hh * ww)`` makes the plain version's ``index_add_``
    raise; the kernels cannot raise, and drop that member (checking the rows
    on the host would make every call wait for the device). A member whose
    patch lies outside its tile's footprint (BM3D's clipped members never
    do) is still added, in a fixed order: by a slow scan in the tile
    kernels, through its patch position in the gather form.

    Each K2 kernel is two launches (the tiles, then the fold; the index,
    then the sums), counted once; calls with one geometry share its scratch
    and must run in order on one stream."""
    if est.dim() != 3 or est.dtype != torch.float32:
        raise ValueError(f"expected (B, P, b*b) float32 estimates, got {tuple(est.shape)} {est.dtype}")
    b, p, bb = est.shape
    block = math.isqrt(bb)
    if idx.shape != (b, p) or idx.dtype != torch.int32:
        raise ValueError(f"expected ({b}, {p}) int32 rows, got {tuple(idx.shape)} {idx.dtype}")
    if (wgt.dim() != 2 or wgt.shape[0] != b or wgt.dtype != torch.float32
            or wgt.shape[1] == 0 or p % wgt.shape[1]):
        raise ValueError(f"expected ({b}, G) float32 weights for {p} members in G groups, "
                         f"got {tuple(wgt.shape)} {wgt.dtype}")
    g = wgt.shape[1]
    if kaiser.shape != (bb,) or block * block != bb:
        raise ValueError(f"kaiser {tuple(kaiser.shape)} does not fit {tuple(est.shape)} estimates")
    if geometry is not None:
        fits = (geometry.h, geometry.w, geometry.block, geometry.n_r * geometry.n_c)
        if fits != (h, w, block, g):
            raise ValueError(f"geometry for (H, W, block, groups) {fits}, called with "
                             f"{(h, w, block, g)}")
    if len({t.device for t in (idx, est, wgt, kaiser)}) != 1:
        raise ValueError("idx, est, wgt and kaiser must be on one device")
    if est.device.type == "cpu":
        return bm3d_aggregate_plain(idx, est, wgt, kaiser, h, w)
    if est.device.type != "cuda":
        raise ValueError(f"bm3d_aggregate runs on cpu or cuda, not {est.device}")
    if geometry is None:
        raise ValueError("K2 needs the aggregate_geometry of the reference grid and search")
    kernel, _ = aggregate_plan(geometry, p // g)
    if geometry.tile_oy.device != est.device:
        raise ValueError(f"geometry on {geometry.tile_oy.device} but tensors on {est.device}")
    idx, est, wgt, kaiser = (t.contiguous() for t in (idx, est, wgt, kaiser))
    planes = launch(kernel, _lib()[kernel], idx, est, wgt, kaiser, h, w, geometry)
    bm3d_aggregate.launches += 1
    bm3d_aggregate.by_kernel[kernel] += 1
    return planes


bm3d_aggregate.launches = 0
bm3d_aggregate.by_kernel = dict.fromkeys(K2_KERNELS, 0)
