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
names the tile kernel of a call: ``bm3d_aggregate_kernel<BLOCK, KK>``,
compiled for (8, 16) and (8, 32) on 2 x 2 tiles of reference blocks where
those tiles' planes fit one CTA (search 37 at step 3), and
``bm3d_aggregate_packed_kernel<Q>`` for the rest of
:data:`AGGREGATE_ENVELOPE` (block 1-32, K up to 128: K1's), on the larger
tiles of :func:`packed_plan` with the idle lanes of small patches given
members of their own, and past block 16 with the values a lane read at run
time (Q = 0). Its footprints are those of any grid: at a step past the
block, pixels that no member covers keep ``den = 0``, as in the plain
version. A setting outside the envelope, or a footprint whose planes pass
one CTA's shared memory even at one reference block a tile, raises before
any launch (:func:`check_aggregate_envelope`, :func:`aggregate_plan`; the
BM3D denoiser asks the latter before K1 runs). The design the
packed kernel replaced, ``bm3d_aggregate_kernel<0, 0>`` (block and K read
at run time, 2 x 2 tiles), stays reachable through :func:`launch` alone, so
that a caller can time the two on one call (:data:`PREV_DESIGN`).
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
K2_KERNELS = ("bm3d_aggregate_kernel", "bm3d_aggregate_packed_kernel")
# The run-time design the packed kernel replaced: launched only by name.
PREV_DESIGN = "bm3d_aggregate_kernel<0, 0>"
COMPILED = ((8, 16), (8, 32))  # the (block, K) bm3d_aggregate_kernel is compiled for
# The settings K2 takes on the card, as K1 (``bm3d_match.MATCH_ENVELOPE``):
# (least, most) of the patch edge and of the group size K, a power of two.
# Its footprints are those of any grid and window K1 takes, as far as a
# CTA's planes fit shared memory (bm3d_aggregate).
AGGREGATE_ENVELOPE = {"block": (1, 32), "k": (1, 128)}


def check_aggregate_envelope(block: int, k: int) -> None:
    """Raise ValueError, naming the bound, unless K2 takes this patch edge
    and group size on the card.

    The bounds that stay, and why: block 1-32 and a power-of-two K up to
    128 are K1's (``bm3d_match.check_match_envelope``): no BM3D call past
    them reaches the aggregation, so no kernel is built for them (the
    packed kernel's K is a shift, and a member past block 32 would be more
    than 1,024 values a warp). The footprint is the other bound, which
    :func:`aggregate_plan` checks on the call's geometry. The compiled
    kernel's CTA holds 4 warps' (num, den) planes of a 2 x 2 tile's
    footprint, 32 fh fw bytes: at step 3 and block 8, fh = fw = 2 search +
    11, so from search 38 (87 x 87: 242,208 bytes) its calls go to the
    packed kernel. A packed CTA holds a (num, den) pair of fh x fw f32
    planes for each lane group of each warp, 8 fh fw bytes at the least
    (one warp, one group, one reference block a tile, whose footprint is
    2 search + block along each axis, clipped to the image), which must
    fit one CTA's 227 KB (232,448 bytes): fh = fw = 170 at most, so at
    block 8 search 81 on an image of 170 pixels or more (search 82 needs
    8 x 172 x 172 = 236,672 bytes), and any window K1 takes on a 128 px
    image (8 x 128 x 128 = 131,072 bytes)."""
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
    """The K2 tile kernel that takes a call with this patch edge and group
    size on ``geometry``: ``bm3d_aggregate_kernel`` at its compiled (8, 16)
    and (8, 32) where its 2 x 2 tiles' planes fit one CTA (every BM3D
    lane's; without a geometry, the window is taken to fit),
    ``bm3d_aggregate_packed_kernel`` everywhere else."""
    fits = geometry is None or geometry.smem_bytes <= _MAX_SMEM
    return K2_KERNELS[0] if (block, k) in COMPILED and fits else K2_KERNELS[1]


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


def aggregate_plan(geometry: AggregateGeometry, k: int) -> tuple:
    """(kernel, tiles) of a K2 call on ``geometry`` at group size ``k``: the
    kernel :func:`aggregate_kernel` names, and the geometry's own 2 x 2
    tiles or its packed plan (:meth:`AggregateGeometry.packed`). Raises
    ValueError, naming the bound, outside :data:`AGGREGATE_ENVELOPE` or
    where even the packed kernel's planes pass one CTA's shared memory
    (:func:`check_aggregate_envelope` gives the bytes)."""
    check_aggregate_envelope(geometry.block, k)
    kernel = aggregate_kernel(geometry.block, k, geometry)
    plan = geometry.packed(k) if kernel == K2_KERNELS[1] else geometry
    if plan.smem_bytes > _MAX_SMEM:
        raise ValueError(f"K2 takes a footprint whose (num, den) planes fit one CTA's shared memory "
                         f"({_MAX_SMEM} bytes): {plan.fh}x{plan.fw} needs {plan.smem_bytes} at search "
                         f"{geometry.search}, block {geometry.block} on {geometry.h}x{geometry.w}")
    return kernel, plan


ENTRIES = {  # kernel name -> (its entry point in the source, its C argument types)
    K2_KERNELS[0]: ("bm3d_aggregate_launch", [ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                    + [ctypes.c_int] * 9 + [ctypes.c_void_p]),
    K2_KERNELS[1]: ("bm3d_aggregate_packed_launch", [ctypes.c_void_p] * 10 + [ctypes.c_int]
                    + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 13 + [ctypes.c_void_p]),
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
           plan: PackedPlan | None = None):
    """One call of ``kernel`` through its bound entry point ``fn``
    (:func:`bind`) on checked, contiguous arguments: (num, den), each (B, H,
    W), in new memory; raises if the launch fails. The packed kernel runs on
    ``plan``, by default the geometry's for the call's K. It checks nothing
    else and counts nothing (:func:`bm3d_aggregate` does both): a caller
    that times one kernel or plan against another on one call launches
    through it. :data:`PREV_DESIGN` takes any call but (8, 16) and (8, 32),
    where the entry runs the compiled kernel."""
    b, p, bb = est.shape
    block, k = math.isqrt(bb), p // wgt.shape[1]
    if kernel == PREV_DESIGN and (block, k) in COMPILED:
        raise ValueError(f"{PREV_DESIGN} does not take (block, K) = {(block, k)}")
    if kernel == K2_KERNELS[1]:
        plan = plan or geometry.packed(k)
    scratch, overflow, epoch = geometry.workspace(b, plan)
    planes = torch.empty((2, b, h, w), dtype=torch.float32, device=est.device)
    g = plan or geometry
    args = [idx.data_ptr(), est.data_ptr(), wgt.data_ptr(), kaiser.data_ptr(), g.tile_oy.data_ptr(),
            g.tile_ox.data_ptr(), g.cover_y.data_ptr(), g.cover_x.data_ptr(), scratch.data_ptr(),
            overflow.data_ptr(), epoch, planes[0].data_ptr(), planes[1].data_ptr(), b, h, w,
            geometry.n_r, geometry.n_c, k, block, g.fh, g.fw]
    if kernel == K2_KERNELS[1]:
        args += [g.tile, g.tile, g.warps, g.groups]
    err = fn(*args, torch.cuda.current_stream(est.device).cuda_stream)
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
    raise; the kernel cannot raise, and drops that member (checking the rows
    on the host would make every call wait for the device). A member whose
    patch lies outside its tile's footprint (BM3D's clipped members never
    do) is still added, in a fixed order, by a slow scan.

    K2 is two launches (the tiles, then the fold), counted once; calls
    with one geometry share its scratch and must run in order on one
    stream."""
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
