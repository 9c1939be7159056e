"""BM3D's operations and bytes, counted from shapes.

``match_bounds`` and ``aggregate_work`` are the port's smoke-run arithmetic
(``chip_smoke.py`` at the time this benchmark was written), frozen here:
K1's least time over the valid (reference block, offset) pairs in the
separable form (the squared-difference plane per offset, block-wide row sums
at the reference columns, block-tall column sums at the reference rows,
shared among that offset's blocks) at the float32 peak; K2's bytes (its
inputs read once, the two planes written once) at HBM bandwidth.
``denoise_flops`` is what one two-stage call needs whatever runs it: K1's
separable matching in both stages, each 3-D transform in its separable form
(the 2-D DCT of each patch by rows and columns, the Walsh-Hadamard along the
group as a K x K product), and the aggregation's products and adds."""

from __future__ import annotations

import numpy as np

from portbench.counts.peaks import F32_FLOPS, HBM_BYTES_PER_S


def ref_grid(size: int, block: int, step: int) -> np.ndarray:
    last = size - block
    pts = list(range(0, last + 1, step))
    if pts[-1] != last:
        pts.append(last)
    return np.asarray(pts, np.int64)


def search_offsets(search: int, search_step: int = 1) -> np.ndarray:
    d1 = search_step * np.arange(-(search // search_step), search // search_step + 1)
    return np.asarray([(dy, dx) for dy in d1 for dx in d1], np.int64)


def match_bounds(b: int, h: int, w: int, rows, cols, offs, lo: int = 0, hi: int | None = None,
                 block: int = 8, k: int = 16) -> dict:
    nr, nc = len(rows), len(cols)
    hi = h if hi is None else hi
    offs = np.asarray(offs, np.int64).reshape(-1, 2)
    ry = np.asarray(rows, np.int64)[:, None] + offs[None, :, 0]
    cx = np.asarray(cols, np.int64)[:, None] + offs[None, :, 1]
    per_row = ((ry >= max(0, lo)) & (ry <= min(h, hi) - block)).sum(0)
    per_col = ((cx >= 0) & (cx <= w - block)).sum(0)
    valid = int((per_row * per_col).sum()) * b
    direct = valid * block * block * 3
    separable = valid * (2 * h * w + (block - 1) * h * nc + (block - 1) * nr * nc) / (nr * nc)
    nbytes = b * h * w * 4 + b * nr * nc * k * 4
    out = {"valid_pairs": valid, "direct_operations": direct, "separable_operations": separable,
           "bytes": nbytes}
    for name, ops in (("direct", direct), ("separable", separable)):
        out[f"bound_{name}_ms"] = max(ops / F32_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        out[f"bound_{name}_by"] = "operations" if ops / F32_FLOPS > nbytes / HBM_BYTES_PER_S else "bytes"
    return out


def aggregate_work(b: int, g: int, k: int, block: int, h: int, w: int) -> tuple:
    p = g * k
    nbytes = (b * p + b * p * block * block + b * g + block * block + 2 * b * h * w) * 4
    return nbytes, b * p * block * block * 4


def _geometry(cfg: dict) -> tuple:
    p, n = cfg["bm3d"], cfg["size"]
    rows = ref_grid(n, p["block"], p["step"])
    return p, n, rows, rows, search_offsets(p["search"], p.get("search_step", 1))


def k1_bound_ms(cfg: dict, lanes: int, k: int) -> float:
    """K1's least time for one call on ``lanes`` images (separable form)."""
    p, n, rows, cols, offs = _geometry(cfg)
    return match_bounds(lanes, n, n, rows, cols, offs, block=p["block"], k=k)["bound_separable_ms"]


def k2_bound_ms(cfg: dict, lanes: int, k: int) -> float:
    """K2's least time for one call on ``lanes`` images with groups of ``k``."""
    p, n, rows, cols, _ = _geometry(cfg)
    nbytes, ops = aggregate_work(lanes, len(rows) * len(cols), k, p["block"], n, n)
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS) * 1e3


def transform_flops(k: int, block: int) -> float:
    """One 3-D transform of a group of ``k`` patches in separable form."""
    bb = block * block
    return k * 2 * (2.0 * block * bb) + bb * 2.0 * k * k


def denoise_flops(cfg: dict) -> float:
    """One two-stage call, a lane."""
    p, n, rows, cols, offs = _geometry(cfg)
    g = len(rows) * len(cols)
    bb = p["block"] ** 2
    match = match_bounds(1, n, n, rows, cols, offs, block=p["block"])["separable_operations"]
    ht = 2 * transform_flops(p["group_ht"], p["block"]) * g
    wie = 3 * transform_flops(p["group_wie"], p["block"]) * g
    agg = 4.0 * g * bb * (p["group_ht"] + p["group_wie"])
    return 2 * match + ht + wie + agg
