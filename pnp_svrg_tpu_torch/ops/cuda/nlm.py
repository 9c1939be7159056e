"""Non-local means: CUDA kernel K3 (``csrc/nlm.cu``) and its plain PyTorch
version.

Replaces the Pallas kernel ``nlm_denoise_pallas`` (``_nlm_kernel``,
``pnp_svrg_tpu/ops/pallas/nlm_kernel.py``), which computes the same function
as ``nlm_denoise`` (``pnp_svrg_tpu/denoisers/nlm.py:38-111``): skimage's
slow-mode NLM re-ordered as a loop over the ``(2d+1)^2`` shifts. For each
shift (dy-major, then dx):

1. square the difference between the reflect-padded image and its shift;
2. box-sum it over the ``p x p`` window (rows ``i..i+p-1`` of the padded
   canvas, so for the even p = 4 image rows ``i-2..i+1``);
3. weight ``exp(-max(dist - 2 sigma^2 p^2, 0) * (1 / (h^2 p^2)))``;
4. zero the weight of candidates outside ``[lo, hi) x [0, W)``;
5. accumulate the weight and the weight times ``x[i+dy, j+dx]``;

and return ``acc / max(wsum, 1e-12)``. The formula is kept in exactly this
form, unguarded: ``h = 0`` gives NaN (the self-shift's ``-0 * inf``), as in
JAX.

The wrapper :func:`nlm_denoise` takes the plain version only for a CPU
tensor; for a CUDA tensor it launches K3 or raises. K3 reads ``h`` and
``sigma`` through device pointers, so the reconstruction loop, whose
``(h, sigma)`` come from a sigma estimate on the card, never waits for it.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from pnp_svrg_tpu_torch.ops.cuda import _build

# The settings K3 takes on the card: (least, most) of each. ``nlm_kernel``
# is built for (4, 5), ``nlm_any_kernel<P>`` takes the rest.
NLM_ENVELOPE = {"patch_size": (1, 11), "patch_distance": (1, 15)}


def check_nlm_envelope(patch_size: int, patch_distance: int) -> None:
    """Raise ValueError, naming the bound, unless K3 takes this patch size
    and distance on the card."""
    for name, v in (("patch_size", patch_size), ("patch_distance", patch_distance)):
        lo, hi = NLM_ENVELOPE[name]
        if not (isinstance(v, int) and lo <= v <= hi):
            raise ValueError(f"K3 takes {name} {lo}-{hi}, not {v!r}")


def _lane_values(v, b: int, device: torch.device, name: str) -> torch.Tensor:
    """Scalar or (B,) ``v`` as a contiguous (B,) float32 tensor on ``device``,
    without reading anything back: a Python number is filled there, a tensor
    must already be there (a copy from the host would wait)."""
    if not isinstance(v, torch.Tensor):
        return torch.full((b,), float(v), dtype=torch.float32, device=device)
    if v.device != device:
        raise ValueError(f"{name} on {v.device} but the image on {device}")
    if v.numel() not in (1, b):
        raise ValueError(f"{name} must be a scalar or ({b},), got {tuple(v.shape)}")
    return v.to(torch.float32).reshape(-1).expand(b).contiguous()


def nlm_denoise_plain(
    image: torch.Tensor, h, sigma, patch_size: int = 4, patch_distance: int = 5,
    row_valid_bounds: tuple | None = None,
) -> torch.Tensor:
    """The plain version of K3 on an (H, W) or (B, H, W) image; ``h`` and
    ``sigma`` are scalars or (B,). ``row_valid_bounds=(lo, hi)`` restricts
    the rows that count as in-image candidates (default ``(0, H)``)."""
    x = image.to(torch.float32)
    single = x.dim() == 2
    if single:
        x = x[None]
    b, hh, ww = x.shape
    pr = patch_size // 2
    d = patch_distance
    p = patch_size
    xp = F.pad(x, (pr, pr, pr, pr), mode="reflect")
    h = _lane_values(h, b, x.device, "h")[:, None, None]
    sigma = _lane_values(sigma, b, x.device, "sigma")[:, None, None]
    inv_h2 = 1.0 / (h * h * p * p)
    offset = 2.0 * sigma * sigma * (p * p)
    row_lo, row_hi = (0, hh) if row_valid_bounds is None else row_valid_bounds
    row = torch.arange(hh, device=x.device)[:, None]
    col = torch.arange(ww, device=x.device)[None, :]

    wsum = torch.zeros_like(x)
    acc = torch.zeros_like(x)
    for dy in range(-d, d + 1):
        for dx in range(-d, d + 1):
            sq = (xp - torch.roll(xp, (-dy, -dx), dims=(-2, -1))) ** 2
            srow = sum(sq[:, k : k + hh, :] for k in range(p))  # window over rows
            dist = sum(srow[:, :, k : k + ww] for k in range(p))  # then columns
            wgt = torch.exp(-torch.clamp_min(dist - offset, 0.0) * inv_h2)
            valid = (
                (row + dy >= row_lo) & (row + dy < row_hi) & (col + dx >= 0) & (col + dx < ww)
            ).to(x.dtype)
            wgt = wgt * valid
            wsum = wsum + wgt
            acc = acc + wgt * torch.roll(x, (-dy, -dx), dims=(-2, -1))
    out = acc / torch.clamp_min(wsum, 1e-12)
    return out[0] if single else out


def _lib():
    fn = _build.load("nlm").nlm_launch
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def nlm_denoise(
    image: torch.Tensor, h, sigma, patch_size: int = 4, patch_distance: int = 5,
    row_valid_bounds: tuple | None = None,
) -> torch.Tensor:
    """NLM of an (H, W) or (B, H, W) float32 image with per-lane ``h`` and
    ``sigma`` (scalars or (B,) tensors on the image's device).

    A CPU tensor takes the plain version; a CUDA tensor launches K3 (counted
    in ``nlm_denoise.launches``), which takes :data:`NLM_ENVELOPE` and
    integer row bounds ``0 <= lo <= hi <= H``, and raises outside them."""
    if image.dim() not in (2, 3):
        raise ValueError(f"expected an (H, W) or (B, H, W) image, got {tuple(image.shape)}")
    if image.device.type == "cpu":
        return nlm_denoise_plain(image, h, sigma, patch_size, patch_distance, row_valid_bounds)
    if image.device.type != "cuda":
        raise ValueError(f"nlm_denoise runs on cpu or cuda, not {image.device}")
    if image.dtype != torch.float32:
        raise ValueError(f"expected float32, got {image.dtype}")
    check_nlm_envelope(patch_size, patch_distance)
    single = image.dim() == 2
    x = (image[None] if single else image).contiguous()
    b, hh, ww = x.shape
    if min(hh, ww) <= patch_size // 2:
        raise ValueError(f"image {hh}x{ww} too small to reflect-pad by {patch_size // 2}")
    lo, hi = (0, hh) if row_valid_bounds is None else row_valid_bounds
    if not (isinstance(lo, int) and isinstance(hi, int) and 0 <= lo <= hi <= hh):
        raise ValueError(f"row_valid_bounds must be ints with 0 <= lo <= hi <= {hh}, "
                         f"got {row_valid_bounds!r}")
    hs = _lane_values(h, b, x.device, "h")
    ss = _lane_values(sigma, b, x.device, "sigma")
    out = torch.empty_like(x)
    err = _lib()(
        x.data_ptr(), hs.data_ptr(), ss.data_ptr(), out.data_ptr(), b, hh, ww,
        patch_size, patch_distance, lo, hi, torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "nlm")
    nlm_denoise.launches += 1
    return out[0] if single else out


nlm_denoise.launches = 0
