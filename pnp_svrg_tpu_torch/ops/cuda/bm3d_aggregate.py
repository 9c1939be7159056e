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
tensor; for a CUDA tensor it launches K2 or raises. The source's
``bm3d_aggregate_kernel<BLOCK, KK>`` is compiled for (8, 16) and (8, 32)
and reads block and K at run time for the rest of
:data:`AGGREGATE_ENVELOPE`; a setting outside it raises before any launch
(:func:`check_aggregate_envelope`).
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
# The settings K2 takes on the card, as K1 (``bm3d_match.MATCH_ENVELOPE``):
# (least, most) of the patch edge and of the group size K, a power of two.
# Its footprints are those of any grid and window K1 takes.
AGGREGATE_ENVELOPE = {"block": (2, 16), "k": (1, 64)}


def check_aggregate_envelope(block: int, k: int) -> None:
    """Raise ValueError, naming the bound, unless K2 takes this patch edge
    and group size on the card."""
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


def footprints(h: int, w: int, rows, cols, search: int, block: int):
    """Per-tile footprint origins and the largest footprint of K2's tiles.

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

    oy, fh = axis(rows, h, TILE_R)
    ox, fw = axis(cols, w, TILE_C)
    return oy, ox, fh, fw


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
class AggregateGeometry:
    """What K2 needs besides its tensors, made once per shape and device,
    with the scratch its footprints pass through (grown to the largest
    batch seen; calls that share it run in order on one stream)."""

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
    work: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def smem_bytes(self) -> int:
        return 2 * _WARPS * self.fh * self.fw * 4  # private planes for each warp

    def scratch_bytes(self, b: int) -> int:
        """The footprints of ``b`` images: (tile rows, tile columns, num and
        den, fh, fw) f32 each."""
        return b * len(self.tile_oy) * len(self.tile_ox) * 2 * self.fh * self.fw * 4

    def workspace(self, b: int) -> tuple:
        """(scratch, overflow flags, epoch) for a call on ``b`` images: the
        buffers are allocated once, grown with the batch and never cleared;
        the epoch is one more each call. A stale flag that meets its epoch
        again after 2**31 - 1 calls costs only time: the fold's scan adds
        just the members outside their footprints, which the tiles skip."""
        if self.work.get("batch", 0) < b:
            dev = self.tile_oy.device
            self.work["scratch"] = torch.empty(self.scratch_bytes(b) // 4, dtype=torch.float32, device=dev)
            self.work["overflow"] = torch.zeros(b, dtype=torch.int32, device=dev)
            self.work["batch"] = b
        self.work["epoch"] = self.work.get("epoch", 0) % (2**31 - 1) + 1
        return self.work["scratch"], self.work["overflow"], self.work["epoch"]


@functools.lru_cache(maxsize=16)
def aggregate_geometry(h: int, w: int, rows: tuple, cols: tuple, search: int, block: int,
                       device: torch.device) -> AggregateGeometry:
    """The footprints of :func:`footprints` and the tiles covering each pixel
    row and column (:func:`covering_tiles`), on ``device``."""
    oy, ox, fh, fw = footprints(h, w, rows, cols, search, block)
    as_dev = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return AggregateGeometry(h, w, block, len(rows), len(cols), fh, fw, as_dev(oy), as_dev(ox),
                             as_dev(covering_tiles(oy, fh, h)), as_dev(covering_tiles(ox, fw, w)))


def bind(fn):
    """``fn``, a library's ``bm3d_aggregate_launch``, with its C signature."""
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] + [ctypes.c_void_p] * 2
                   + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _lib():
    fn = _build.load("bm3d_aggregate").bm3d_aggregate_launch
    return fn if fn.argtypes is not None else bind(fn)


def launch(fn, idx, est, wgt, kaiser, h: int, w: int, geometry: AggregateGeometry):
    """One call of the bound entry point ``fn`` on checked, contiguous
    arguments: (num, den), each (B, H, W), in new memory."""
    b, p, bb = est.shape
    scratch, overflow, epoch = geometry.workspace(b)
    planes = torch.empty((2, b, h, w), dtype=torch.float32, device=est.device)
    err = fn(
        idx.data_ptr(), est.data_ptr(), wgt.data_ptr(), kaiser.data_ptr(),
        geometry.tile_oy.data_ptr(), geometry.tile_ox.data_ptr(), geometry.cover_y.data_ptr(),
        geometry.cover_x.data_ptr(), scratch.data_ptr(), overflow.data_ptr(), epoch,
        planes[0].data_ptr(), planes[1].data_ptr(), b, h, w, geometry.n_r, geometry.n_c,
        p // wgt.shape[1], math.isqrt(bb), geometry.fh, geometry.fw,
        torch.cuda.current_stream(est.device).cuda_stream,
    )
    _build.check(err, f"bm3d_aggregate (block={math.isqrt(bb)})")
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
    not. A CPU tensor takes the plain version; a CUDA tensor launches K2
    (counted in ``bm3d_aggregate.launches``) inside :data:`AGGREGATE_ENVELOPE`
    and raises outside it.

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
    check_aggregate_envelope(geometry.block, p // g)
    if geometry.smem_bytes > _MAX_SMEM:
        raise ValueError(f"footprint {geometry.fh}x{geometry.fw} too large for shared memory")
    if geometry.tile_oy.device != est.device:
        raise ValueError(f"geometry on {geometry.tile_oy.device} but tensors on {est.device}")
    idx, est, wgt, kaiser = (t.contiguous() for t in (idx, est, wgt, kaiser))
    planes = launch(_lib(), idx, est, wgt, kaiser, h, w, geometry)
    bm3d_aggregate.launches += 1
    return planes


bm3d_aggregate.launches = 0
