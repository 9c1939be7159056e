"""Image loading (numpy/PIL; a copy of ``pnp_svrg_tpu/utils/io.py``).

The port keeps its own copy so that it never imports the JAX package.
``load_image`` must stay bit-identical to the reference's: PIL
nearest-neighbour resize, then min-max normalisation to [0, 1].
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
# The reference implementation's data directory, in its checkout beside this
# repository (the JAX package's REFERENCE_DATA_DIR); nothing in the port
# reads it.
REFERENCE_DATA_DIR = _REPO_ROOT.parent / "reference" / "data"
DATA_DIR = _REPO_ROOT / "data"
SET12_DIR = DATA_DIR / "Set12"


def resolve_data_path(name: str | os.PathLike) -> Path:
    """Resolve a data file against the repo data dir."""
    p = Path(name)
    if p.is_absolute():
        return p
    for base in (DATA_DIR, _REPO_ROOT):
        cand = base / p
        if cand.exists():
            return cand
    return DATA_DIR / p


def load_image(path: str | os.PathLike, h: int, w: int) -> np.ndarray:
    """Load a grayscale image, resize to (h, w), min-max normalize to [0, 1]."""
    from PIL import Image

    img = Image.open(resolve_data_path(path))
    arr = np.array(img.resize((w, h)), dtype=np.float32)
    if arr.ndim == 3:  # RGB: keep the channel mean as luma
        arr = arr.mean(axis=-1)
    lo, hi = arr.min(), arr.max()
    return (arr - lo) / (hi - lo)


def set12_paths() -> list[Path]:
    return sorted(SET12_DIR.glob("*.png"))
