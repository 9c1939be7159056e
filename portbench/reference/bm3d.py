"""Two-stage BM3D, plainly (Dabov et al. 2007, fixed group sizes): block
matching by squared differences, a 3-D transform (2-D DCT of each patch x
Walsh-Hadamard along the group) with hard thresholding, a Kaiser-weighted
overlap-add; then a Wiener stage that matches on the stage-1 estimate.

A frozen copy of the arithmetic the configuration states: the matching in
its rounding mode (``bf16_xla``: the image, each difference and each square
rounded to bfloat16, the sums float32), ties to the lowest offset index, +inf
for candidates that leave the image, the exact top k by repeated argmin; the
transform as one dense product with ``kron(H_K, D (x) D)``; the aggregation
an ``index_add_`` into a patch-position table folded back to the image. No
kernel of the program: every step is a PyTorch operation, computed in blocks
of offsets. float32; the control turns on TF32 for the products."""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.precision import matmul_precision

OFFSET_CHUNK = 72


def dct_matrix(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    d = np.cos(np.pi * (2 * i + 1) * k / (2 * n))
    d[0, :] *= 1.0 / math.sqrt(n)
    d[1:, :] *= math.sqrt(2.0 / n)
    return d.astype(np.float32)


def hadamard_matrix(n: int) -> np.ndarray:
    h = np.array([[1.0]])
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return (h / math.sqrt(n)).astype(np.float32)


def kaiser2d(n: int, beta: float) -> np.ndarray:
    w = np.kaiser(n, beta)
    return np.outer(w, w).astype(np.float32)


def ref_grid(size: int, block: int, step: int) -> np.ndarray:
    """Reference-block coordinates: the stride grid, the last block always in."""
    last = size - block
    pts = list(range(0, last + 1, step))
    if pts[-1] != last:
        pts.append(last)
    return np.asarray(pts, np.int64)


def search_offsets(search: int, search_step: int = 1) -> np.ndarray:
    d1 = search_step * np.arange(-(search // search_step), search // search_step + 1)
    return np.asarray([(dy, dx) for dy in d1 for dx in d1], np.int64)


def _band_select(size: int, grid, block: int) -> np.ndarray:
    s = np.zeros((size, len(grid)), np.float32)
    for i, g in enumerate(grid):
        s[g: g + block, i] = 1.0
    return s


def match_distances(imgs, rows, cols, offsets, block: int, mode: str) -> torch.Tensor:
    """(B, nR, nC, S) patch SSDs, +inf where a candidate leaves the image."""
    b, h, w = imgs.shape
    dev = imgs.device
    sel_h = torch.as_tensor(_band_select(h, rows, block), device=dev)
    sel_w = torch.as_tensor(_band_select(w, cols, block), device=dev)
    r = int(np.abs(offsets).max())
    x = imgs.to(torch.float32)
    if mode == "bf16_xla":
        x = x.to(torch.bfloat16)
    elif mode != "f32":
        raise ValueError(f"match mode {mode!r} is not one the reference computes")
    padded = F.pad(x, (r, r, r, r))
    parts = []
    for start in range(0, len(offsets), OFFSET_CHUNK):
        offs = offsets[start: start + OFFSET_CHUNK]
        shifted = torch.stack([padded[:, r + dy: r + dy + h, r + dx: r + dx + w] for dy, dx in offs], dim=1)
        diff = x[:, None] - shifted
        sq = diff * diff
        d = torch.einsum("hi,bchw,wj->bijc", sel_h, sq.to(torch.float32), sel_w)
        ry = rows[:, None, None] + offs[:, 0][None, None, :]
        cx = cols[None, :, None] + offs[:, 1][None, None, :]
        valid = (ry >= 0) & (ry <= h - block) & (cx >= 0) & (cx <= w - block)
        parts.append(torch.where(torch.as_tensor(valid, device=dev)[None], d, torch.inf))
    return torch.cat(parts, dim=-1)


def top_k(dists: torch.Tensor, k: int) -> torch.Tensor:
    """The k smallest along the last axis, ascending, ties to the lowest
    index, index 0 once only +inf is left."""
    iota = torch.arange(dists.shape[-1], device=dists.device)
    idxs = []
    for _ in range(k):
        i = torch.argmin(dists, dim=-1)
        idxs.append(i)
        dists = torch.where(iota == i[..., None], torch.inf, dists)
    return torch.stack(idxs, dim=-1)


class Setup:
    """Grid, offsets and matrices of one configuration on one device."""

    def __init__(self, cfg: dict, h: int, w: int, device):
        self.block, self.lam = cfg["block"], cfg["lam"]
        self.k_ht, self.k_wie = cfg["group_ht"], cfg["group_wie"]
        self.mode = "bf16_xla" if cfg["match_dtype"] == "bfloat16" else "f32"
        self.rows = ref_grid(h, self.block, cfg["step"])
        self.cols = ref_grid(w, self.block, cfg["step"])
        self.offsets = search_offsets(cfg["search"], cfg.get("search_step", 1))
        d2 = dct_matrix(self.block)
        d2d = np.kron(d2, d2)

        def dev(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

        self.rows_t, self.cols_t = dev(self.rows, torch.int64), dev(self.cols, torch.int64)
        self.offsets_t = dev(self.offsets, torch.int64)
        self.kaiser = dev(kaiser2d(self.block, cfg["kaiser_beta"]).reshape(-1))
        self.t3_ht = dev(np.kron(hadamard_matrix(self.k_ht), d2d))
        self.t3_wie = dev(np.kron(hadamard_matrix(self.k_wie), d2d))


def _groups(imgs, s: Setup, top_idx):
    b, h, w = imgs.shape
    off = s.offsets_t[top_idx]
    py = torch.clamp(s.rows_t[None, :, None, None] + off[..., 0], 0, h - s.block)
    px = torch.clamp(s.cols_t[None, None, :, None] + off[..., 1], 0, w - s.block)
    bi = torch.arange(b, device=imgs.device)[:, None, None, None]
    patches = imgs.unfold(1, s.block, 1).unfold(2, s.block, 1)
    groups = patches[bi, py, px]
    return groups.reshape(*groups.shape[:4], s.block * s.block), py, px


def _aggregate(est, wgt, py, px, s: Setup, h: int, w: int) -> torch.Tensor:
    b, bb, block = est.shape[0], est.shape[-1], s.block
    hh, ww = h - block + 1, w - block + 1
    idx = (py * ww + px).reshape(b, -1)
    est = est.reshape(b, -1, bb)
    g = wgt.reshape(b, -1).shape[1]
    p = est.shape[1]
    wk = wgt.reshape(b, -1)[..., None, None] * s.kaiser
    est_g = est.reshape(b, g, p // g, bb)
    upd = torch.cat([(est_g * wk).reshape(b, p, bb), wk.expand(est_g.shape).reshape(b, p, bb)], dim=-1)
    table = torch.zeros((b * hh * ww, 2 * bb), dtype=torch.float32, device=est.device)
    base = torch.arange(b, device=est.device)[:, None] * (hh * ww)
    table.index_add_(0, (idx + base).reshape(-1), upd.reshape(b * p, 2 * bb))
    out = F.fold(table.view(b, hh * ww, 2 * bb).transpose(1, 2), (h, w), kernel_size=block)
    return out[:, 0] / torch.clamp(out[:, 1], min=1e-12)


def _match(x, s: Setup, k: int):
    return top_k(match_distances(x, s.rows, s.cols, s.offsets, s.block, s.mode), k)


def denoise(s: Setup, x: torch.Tensor, sigma: torch.Tensor, tf32: bool = False) -> torch.Tensor:
    """Both stages on (B, H, W) ``x`` at (B,) ``sigma``."""
    b, h, w = x.shape
    bb = s.block * s.block
    sig_g, sig_c = sigma[:, None, None], sigma[:, None, None, None]
    with matmul_precision(tf32):
        top = _match(x, s, s.k_ht)
        groups, py, px = _groups(x, s, top)
        coeffs = groups.reshape(*groups.shape[:3], -1) @ s.t3_ht.T
        keep = coeffs.abs() > s.lam * sig_c
        n_kept = torch.clamp(keep.sum(dim=-1), min=1).to(torch.float32)
        est = (torch.where(keep, coeffs, 0.0) @ s.t3_ht).reshape(*groups.shape[:3], -1, bb)
        basic = _aggregate(est, 1.0 / (sig_g * sig_g * n_kept + 1e-12), py, px, s, h, w)
        top = _match(basic, s, s.k_wie)
        g_basic, py, px = _groups(basic, s, top)
        g_noisy, _, _ = _groups(x, s, top)
        c_basic = g_basic.reshape(*g_basic.shape[:3], -1) @ s.t3_wie.T
        c_noisy = g_noisy.reshape(*g_noisy.shape[:3], -1) @ s.t3_wie.T
        wien = c_basic ** 2 / (c_basic ** 2 + sig_c * sig_c + 1e-12)
        est = ((wien * c_noisy) @ s.t3_wie).reshape(*g_basic.shape[:3], -1, bb)
        return _aggregate(est, 1.0 / (sig_g * sig_g * (wien ** 2).sum(dim=-1) + 1e-12), py, px, s, h, w)


def plug_and_play(s: Setup, x: torch.Tensor, sigma_est: torch.Tensor, modifier: torch.Tensor,
                  tf32: bool = False) -> torch.Tensor:
    """The PnP contract: denoise at ``modifier * sigma_est`` where the
    estimate is positive, else at 0 (no fallback strength is configured)."""
    sigma = torch.where(sigma_est > 0, sigma_est * modifier, torch.zeros_like(sigma_est))
    return denoise(s, x.to(torch.float32), sigma, tf32)


def make(cfg: dict, traffic: dict, device, root):
    """The configuration's reference denoiser as ``f(x, tf32) -> out``: the
    wavelet estimate of each lane's noise, times the lane's modifier, then
    both stages."""
    from portbench.reference.sigma import estimate_sigma

    s = Setup(cfg["bm3d"], cfg["size"], cfg["size"], device)
    mod = torch.tensor([lane["sigma_modifier"] for lane in traffic["lanes"]], dtype=torch.float32, device=device)
    return lambda x, tf32=False: plug_and_play(s, x, estimate_sigma(x), mod, tf32)
