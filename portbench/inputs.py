"""What every configuration's inputs share: seeds and images.

A run's seed may be any whole number (the driver's exceed 32 bits); each
use of it takes a 64-bit generator seed derived from it and a tag, so the
inputs, the capture plan and each reconstruction's minibatch stream are
drawn independently, and the same seed gives the same inputs."""

from __future__ import annotations

import hashlib

import numpy as np

INPUTS, PLAN, WARM_UP, RECONSTRUCTION = 0, 1, 2, 3


def derive(seed: int, *tag: int) -> int:
    """A seed for ``torch.Generator.manual_seed`` from the run's seed and a tag."""
    words = [int(seed) % 2**32, int(seed) // 2**32 % 2**32, int(seed) < 0, *tag]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])


def rng(seed: int, *tag: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *tag))


def sha256(path) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()[:16]


def checked_file(root, rel: str, digest: str):
    """``root / rel``, which must hold the bytes the benchmark was written
    for (the first 16 hex digits of their SHA-256)."""
    path = root / rel
    got = sha256(path)
    if got != digest:
        raise RuntimeError(f"{rel}: sha256 {got}, the benchmark was written for {digest}")
    return path


def load_image(root, rel: str, digest: str, h: int, w: int) -> np.ndarray:
    """A grayscale image resized to (h, w) by PIL's nearest neighbour and
    min-max normalised to [0, 1] (the reference code's loader)."""
    from PIL import Image

    img = Image.open(checked_file(root, rel, digest))
    arr = np.array(img.resize((w, h)), dtype=np.float32)
    if arr.ndim == 3:
        arr = arr.mean(axis=-1)
    lo, hi = arr.min(), arr.max()
    return (arr - lo) / (hi - lo)
