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
import functools

import numpy as np
import torch
import torch.nn.functional as F

from pnp_svrg_tpu_torch.ops.cuda import _build

MODES = {"f32": 0, "bf16_xla": 1, "bf16_pallas": 2}
_TILE = 8  # reference blocks per CTA side (kTileR/kTileC in the source)
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


@functools.lru_cache(maxsize=32)
def _geometry(rows: tuple, cols: tuple, offsets: tuple, block: int, device: torch.device):
    """Device copies of the grid and offsets (made once, so the loop does not
    copy host memory every call) and the largest tile region."""
    search = max(abs(v) for off in offsets for v in off)

    def span(grid):
        n = len(grid)
        return max(grid[min(i + _TILE, n) - 1] - grid[i] for i in range(0, n, _TILE))

    smem_h = span(rows) + block + 2 * search
    smem_w = span(cols) + block + 2 * search
    as_dev = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return as_dev(rows), as_dev(cols), as_dev(offsets), search, smem_h, smem_w


def _lib():
    lib = _build.load("bm3d_match")
    fn = lib.bm3d_match_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def bm3d_match(
    imgs: torch.Tensor, rows, cols, offsets, block: int, k: int, mode: str = "f32"
) -> torch.Tensor:
    """Top-``k`` offset indices (B, nR, nC, k) int32 for every reference block.

    ``rows``/``cols``: reference coordinates; ``offsets``: (S, 2) (dy, dx) in
    ascending index order. A CPU tensor takes the plain version; a CUDA
    tensor launches K1 (counted in ``bm3d_match.launches``)."""
    if mode not in MODES:
        raise ValueError(f"unknown match mode {mode!r}; have {tuple(MODES)}")
    if imgs.dim() != 3 or imgs.dtype != torch.float32:
        raise ValueError(f"expected a (B, H, W) float32 tensor, got {tuple(imgs.shape)} {imgs.dtype}")
    if imgs.device.type == "cpu":
        return bm3d_match_plain(imgs, rows, cols, offsets, block, k, mode)
    if imgs.device.type != "cuda":
        raise ValueError(f"bm3d_match runs on cpu or cuda, not {imgs.device}")
    if (block, k) != (KERNEL_BLOCK, KERNEL_K):
        raise ValueError(f"K1 is built for block={KERNEL_BLOCK}, k={KERNEL_K}, "
                         f"not block={block}, k={k}")
    b, h, w = imgs.shape
    rows_t, cols_t, offs_t, search, smem_h, smem_w = _geometry(
        tuple(int(v) for v in rows), tuple(int(v) for v in cols),
        tuple((int(dy), int(dx)) for dy, dx in np.asarray(offsets).reshape(-1, 2)),
        int(block), imgs.device,
    )
    if smem_h * smem_w * 4 > _MAX_SMEM:
        raise ValueError(f"search window too large for shared memory ({smem_h}x{smem_w} floats)")
    x = imgs.contiguous()
    nr, nc, s = rows_t.numel(), cols_t.numel(), offs_t.shape[0]
    out = torch.empty((b, nr, nc, k), dtype=torch.int32, device=imgs.device)
    err = _lib()(
        x.data_ptr(), rows_t.data_ptr(), cols_t.data_ptr(), offs_t.data_ptr(),
        out.data_ptr(), b, h, w, nr, nc, s, int(block), int(k), MODES[mode],
        search, smem_h, smem_w, torch.cuda.current_stream(imgs.device).cuda_stream,
    )
    _build.check(err, f"bm3d_match (block={block}, k={k}, mode={mode})")
    bm3d_match.launches += 1
    return out


bm3d_match.launches = 0
