"""State carried over from the JAX package: problem data and per-lane
hyperparameters (this path has no learned weights).

* :func:`csmri_from_numpy` builds the port's batched ``CSMRI`` from the JAX
  ``CSMRI`` fields as numpy arrays.
* :func:`lane_params` slices per-lane (eta, sigma_modifier) from a tuned JSON
  by lane name (``bench.py:114-132``).
* :func:`load_headline_problems` reads the committed fixture
  ``data/headline_csmri_128.npz``: the 13 headline problems (Set12 with
  variable-density masks plus the ``13.png`` flagship lane) exactly as the
  JAX package builds them, so the port sees the reference's masks and noise
  (its generators cannot replay JAX's key streams).
* :func:`load_headline_masks` reads ``data/headline_masks_key2.npz``: the
  minibatch masks the JAX ``pnp_svrg`` draws in ``bench.py``'s timed
  headline run (``PRNGKey(2)``), for runs comparable lane by lane.

Both fixtures are written by ``python tests/test_torch_fixture.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.problems.csmri import CSMRI
from pnp_svrg_tpu_torch.utils.io import load_image

HEADLINE_FIXTURE = Path(__file__).resolve().parent / "data" / "headline_csmri_128.npz"
HEADLINE_MASKS = HEADLINE_FIXTURE.parent / "headline_masks_key2.npz"


def csmri_from_numpy(arrays: dict, device=None) -> CSMRI:
    """Port ``CSMRI`` from the stacked JAX fields as numpy arrays: ``y``,
    ``mask``, ``x``, ``x_init`` (B, H, W) and optional ``m0``, ``snr``,
    ``sigma`` (B,); a missing ``m0`` is counted from the mask."""
    dev = resolve_device(device)
    b = np.asarray(arrays["y"]).shape[0]

    def img(name, dtype):
        return torch.as_tensor(np.asarray(arrays[name]).astype(dtype), device=dev)

    def lane(name, default):
        a = np.asarray(arrays.get(name, default), np.float32)
        return torch.as_tensor(np.broadcast_to(a, (b,)).copy(), device=dev)

    mask = img("mask", np.float32)
    m0 = arrays.get("m0")
    return CSMRI(
        y=img("y", np.complex64),
        mask=mask,
        x=img("x", np.float32),
        x_init=img("x_init", np.float32),
        m0=mask.sum(dim=(-2, -1)) if m0 is None else lane("m0", m0),
        snr=lane("snr", 0.0),
        sigma=lane("sigma", 0.0),
    )


def lane_params(tuned, lane_names, default_eta, default_mod, device=None):
    """(B,) float32 (eta, sigma_modifier) by lane NAME from a tuned JSON
    (dict, path, or None); lanes it lacks get the defaults."""
    if isinstance(tuned, (str, os.PathLike)):
        with open(tuned) as f:
            tuned = json.load(f)
    by_name = {}
    if tuned:
        by_name = {
            n: (e, m)
            for n, e, m in zip(tuned["lanes"], tuned["eta"], tuned["sigma_modifier"])
        }
    pairs = [by_name.get(n, (default_eta, default_mod)) for n in lane_names]
    dev = resolve_device(device)
    eta = torch.tensor([p[0] for p in pairs], dtype=torch.float32, device=dev)
    mod = torch.tensor([p[1] for p in pairs], dtype=torch.float32, device=dev)
    return eta, mod


def load_headline_problems(device=None, path=HEADLINE_FIXTURE):
    """(CSMRI, lane names) of the committed headline problems; the ground
    truth is reloaded with the port's ``load_image``."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    paths = [str(p) for p in data["paths"]]
    h, w = data["y"].shape[-2:]
    arrays = {
        "y": data["y"],
        "mask": data["mask"],
        "x": np.stack([load_image(p, h, w) for p in paths]),
        "x_init": data["x_init"],
        "snr": data["snr"],
        "sigma": data["sigma"],
    }
    return csmri_from_numpy(arrays, device), [str(n) for n in data["lanes"]]


def load_headline_masks(device=None, path=HEADLINE_MASKS) -> torch.Tensor:
    """(n_outer, t2, B, H, W) float32 minibatch masks of the JAX headline run,
    for ``pnp_svrg(..., masks=...)``."""
    with np.load(path) as f:
        packed = f["masks"]
    masks = np.unpackbits(packed, axis=-1).astype(np.float32)
    return torch.as_tensor(masks, device=resolve_device(device))
