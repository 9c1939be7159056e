"""BM3D aggregation scatter: CUDA kernel K2 (``csrc/bm3d_scatter.cu``) and its
plain PyTorch version.

Replaces the Pallas kernel ``bm3d_scatter_pallas`` (``_scatter_kernel``,
``pnp_svrg_tpu/ops/pallas/bm3d_scatter.py``): the per-image row scatter-add
``table[b, idx[b, p], :] += upd[b, p, :]`` that ``_aggregate``
(``pnp_svrg_tpu/denoisers/bm3d.py:305-328``) forms with ``.at[].add``.

The kernel adds with f32 atomics, so its summation order changes from run to
run; it agrees with the plain version to f32 rounding (about 1e-5 relative
to the row magnitude), not bit for bit.

The wrapper :func:`bm3d_scatter` takes the plain version only for a CPU
tensor; for a CUDA tensor it launches K2 or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pnp_svrg_tpu_torch.ops.cuda import _build


def bm3d_scatter_plain(idx: torch.Tensor, upd: torch.Tensor, table_rows: int) -> torch.Tensor:
    """The plain version of K2: one ``index_add_`` into a zeroed table."""
    b, p, w = upd.shape
    table = torch.zeros((b * table_rows, w), dtype=torch.float32, device=upd.device)
    base = torch.arange(b, device=upd.device)[:, None] * table_rows
    table.index_add_(0, (idx.to(torch.int64) + base).reshape(-1), upd.reshape(b * p, w))
    return table.view(b, table_rows, w)


def _lib():
    fn = _build.load("bm3d_scatter").bm3d_scatter_launch
    if fn.argtypes is None:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return fn


def bm3d_scatter(
    idx: torch.Tensor, upd: torch.Tensor, table_rows: int, check_bounds: bool = False
) -> torch.Tensor:
    """(B, table_rows, W) table with ``table[b, idx[b, p]] += upd[b, p]``.

    ``idx``: (B, P) int32 rows in [0, table_rows); ``upd``: (B, P, W) f32.
    ``check_bounds=True`` verifies ``idx`` on the host first, which waits for
    the device; the kernel itself skips rows outside the table. A CPU tensor
    takes the plain version; a CUDA tensor launches K2 (counted in
    ``bm3d_scatter.launches``)."""
    if upd.dim() != 3 or upd.dtype != torch.float32:
        raise ValueError(f"expected (B, P, W) float32 updates, got {tuple(upd.shape)} {upd.dtype}")
    if idx.shape != upd.shape[:2] or idx.dtype != torch.int32:
        raise ValueError(f"expected (B, P) int32 indices, got {tuple(idx.shape)} {idx.dtype}")
    if idx.device != upd.device:
        raise ValueError(f"idx on {idx.device} but upd on {upd.device}")
    if check_bounds and bool(((idx < 0) | (idx >= table_rows)).any()):
        raise IndexError(f"scatter index outside [0, {table_rows})")
    if upd.device.type == "cpu":
        return bm3d_scatter_plain(idx, upd, table_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"bm3d_scatter runs on cpu or cuda, not {upd.device}")
    b, p, w = upd.shape
    if w % 4:
        raise ValueError(f"row width {w} is not a multiple of 4 (float4 rows)")
    idx = idx.contiguous()
    upd = upd.contiguous()
    if upd.data_ptr() % 16:
        raise ValueError("updates must be 16-byte aligned for float4 loads")
    table = torch.zeros((b, table_rows, w), dtype=torch.float32, device=upd.device)
    err = _lib()(
        idx.data_ptr(), upd.data_ptr(), table.data_ptr(), b, p, w, table_rows,
        torch.cuda.current_stream(upd.device).cuda_stream,
    )
    _build.check(err, "bm3d_scatter")
    bm3d_scatter.launches += 1
    return table


bm3d_scatter.launches = 0
