"""The denoiser-training patch pipeline.

Port of ``pnp_svrg_tpu/training/data.py``: stride-10 40x40 patches at 4
image scales, each patch flipped or rotated by one of 8 modes, shuffled into
minibatches with AWGN added on the fly. The JAX package cuts and augments
patches with a native C++ library or numpy; here ``Tensor.unfold`` cuts the
grid and ``torch.rot90`` / ``torch.flip`` augment, on the device the patch set
is built for, and the result is bit-identical (both only copy pixels).

The augmentation modes, the permutation and the noise come from a
``numpy.random.Generator`` seeded as the JAX package seeds it (host numpy in
both packages, no JAX key stream), so the port's batches are the JAX
package's batches. The patch set stays on the device and each batch is
gathered there by index; the host draws only the batch's normal noise.

Default source images: the 400-image train set of the reference checkout
(not in this repository); any directory of grayscale images works.
"""

from __future__ import annotations

from pathlib import Path
from typing import Iterator, Sequence

import numpy as np
import torch

from pnp_svrg_tpu_torch.device import resolve_device

REFERENCE_TRAIN_DIR = Path(
    "/root/reference/denoisers/DeepDenoisers/training/data/train"
)
REFERENCE_VAL_DIR = Path(
    "/root/reference/denoisers/DeepDenoisers/training/data/Set12"
)

SCALES = (1.0, 0.9, 0.8, 0.7)  # the reference's prepare_data scales
PATCH = 40
STRIDE = 10


def load_gray(path: Path, scale: float = 1.0) -> np.ndarray:
    """An image as grayscale f32 in [0, 1], resized by ``scale`` with PIL's
    default resampling (the JAX package's ``load_gray``)."""
    from PIL import Image

    img = Image.open(path).convert("L")
    if scale != 1.0:
        w, h = img.size
        img = img.resize((int(w * scale), int(h * scale)))
    return np.asarray(img, np.float32) / 255.0


def im2patch(img: torch.Tensor, patch: int = PATCH, stride: int = STRIDE) -> torch.Tensor:
    """(n, patch, patch) patches of an (H, W) image on the stride grid, rows
    of the grid first."""
    return img.unfold(0, patch, stride).unfold(1, patch, stride).reshape(-1, patch, patch)


def augment(patch: torch.Tensor, mode: int) -> torch.Tensor:
    """The reference's 8 flips and rotations of the last two axes: mode
    ``m`` rotates by ``m // 2`` quarter turns (``np.rot90``'s direction) and,
    for odd ``m``, then flips the rows (``np.flipud``)."""
    if not 0 <= mode < 8:
        raise ValueError(f"augmentation mode {mode} out of range")
    out = torch.rot90(patch, mode // 2, dims=(-2, -1))
    return torch.flip(out, dims=(-2,)) if mode % 2 else out


def augment_patches(patches: torch.Tensor, modes: np.ndarray) -> torch.Tensor:
    """Each patch of (n, P, P) ``patches`` augmented by its own mode
    (``modes``, n values in [0, 8) on the host)."""
    out = patches.clone()
    for m in range(1, 8):
        sel = np.flatnonzero(modes == m)
        if len(sel):
            idx = torch.from_numpy(sel).to(patches.device)
            out[idx] = augment(patches[idx], m)
    return out


def build_patch_dataset(
    image_dir: Path | str = REFERENCE_TRAIN_DIR,
    max_images: int | None = None,
    patch: int = PATCH,
    stride: int = STRIDE,
    scales: Sequence[float] = SCALES,
    augment_modes: bool = True,
    seed: int = 0,
    device=None,
) -> torch.Tensor:
    """(N, patch, patch) f32 clean patches on ``device`` (CUDA unless
    ``"cpu"``): every image at every scale cut into stride-grid patches,
    each patch augmented by a mode drawn from ``default_rng(seed)``. The
    images are the directory's ``*.png`` then its ``*.jpg`` files, each
    sorted."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    paths = sorted(Path(image_dir).glob("*.png")) + sorted(Path(image_dir).glob("*.jpg"))
    if max_images is not None:
        paths = paths[:max_images]
    if not paths:
        raise FileNotFoundError(f"no images found under {image_dir}")
    chunks = []
    for p in paths:
        for s in scales:
            img = load_gray(p, s)
            if min(img.shape) < patch:
                continue
            ps = im2patch(torch.from_numpy(img).to(dev), patch, stride)
            if augment_modes:
                ps = augment_patches(ps, rng.integers(0, 8, size=len(ps)).astype(np.uint8))
            chunks.append(ps)
    return torch.cat(chunks).contiguous()


def batches(
    patches: torch.Tensor,
    batch_size: int,
    noise_sigma: float | tuple[float, float],
    seed: int = 0,
    drop_last: bool = True,
) -> Iterator[tuple[torch.Tensor, torch.Tensor]]:
    """Yield (noisy, noise) NCHW minibatches on the patches' device.

    ``noise_sigma``: a fixed sigma in [0, 1] units (mode S) or a (lo, hi)
    range sampled per sample (blind mode B). The draws are the JAX
    package's: the permutation first, then per batch the sigmas (mode B) and
    the normal noise, in float64 on the host, cast to f32."""
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(patches))
    order = torch.from_numpy(idx).to(patches.device)
    n_full = len(idx) // batch_size
    pin = patches.device.type == "cuda"
    for b in range(n_full if drop_last else n_full + 1):
        sel = order[b * batch_size : (b + 1) * batch_size]
        if len(sel) == 0:
            break
        clean = patches[sel][:, None]
        if isinstance(noise_sigma, tuple):
            sig = rng.uniform(noise_sigma[0], noise_sigma[1], size=(len(sel), 1, 1, 1))
        else:
            sig = np.full((len(sel), 1, 1, 1), noise_sigma)
        host = torch.from_numpy((sig * rng.standard_normal(tuple(clean.shape))).astype(np.float32))
        # A pinned copy lets the host draw the next batch while this one is
        # in flight; the caching host allocator keeps the block until then.
        noise = host.pin_memory().to(patches.device, non_blocking=True) if pin else host
        yield clean + noise, noise
