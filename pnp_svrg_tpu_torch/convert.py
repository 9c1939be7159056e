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
* The CSMRI + NLM lane (``bench.py:465-506``): :func:`load_nlm_problem` is
  the one-lane problem of ``13.png`` from the headline fixture,
  :func:`nlm_params` the tuned configuration and its provenance grid from
  ``data/csmri_nlm_tuned.json``, :func:`load_nlm_masks` the minibatch masks
  of the JAX lane's run (``data/csmri_nlm_masks_key2.npz``, an unbatched key
  chain) and :func:`load_nlm_reference` that run's PSNR trace and SSIM.

The fixtures are written by ``python tests/test_torch_fixture.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.problems.csmri import CSMRI
from pnp_svrg_tpu_torch.utils.io import DATA_DIR, load_image

HEADLINE_FIXTURE = Path(__file__).resolve().parent / "data" / "headline_csmri_128.npz"
HEADLINE_MASKS = HEADLINE_FIXTURE.parent / "headline_masks_key2.npz"
NLM_MASKS = HEADLINE_FIXTURE.parent / "csmri_nlm_masks_key2.npz"
NLM_TUNED = DATA_DIR / "csmri_nlm_tuned.json"
NLM_LANE = "13.png"


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


def load_headline_problems(device=None, path=HEADLINE_FIXTURE, lanes=None):
    """(CSMRI, lane names) of the committed headline problems, or of the
    named ``lanes`` only; the ground truth is reloaded with the port's
    ``load_image``."""
    with np.load(path) as f:
        data = {k: f[k] for k in f.files}
    names = [str(n) for n in data["lanes"]]
    keep = list(range(len(names))) if lanes is None else [names.index(n) for n in lanes]
    paths = [str(data["paths"][i]) for i in keep]
    h, w = data["y"].shape[-2:]
    arrays = {
        "y": data["y"][keep],
        "mask": data["mask"][keep],
        "x": np.stack([load_image(p, h, w) for p in paths]),
        "x_init": data["x_init"][keep],
        "snr": data["snr"][keep],
        "sigma": data["sigma"][keep],
    }
    return csmri_from_numpy(arrays, device), [names[i] for i in keep]


def _unpack_masks(path, device) -> torch.Tensor:
    with np.load(path) as f:
        packed = f["masks"]
    masks = np.unpackbits(packed, axis=-1).astype(np.float32)
    return torch.as_tensor(masks, device=resolve_device(device))


def load_headline_masks(device=None, path=HEADLINE_MASKS) -> torch.Tensor:
    """(n_outer, t2, B, H, W) float32 minibatch masks of the JAX headline run,
    for ``pnp_svrg(..., masks=...)``."""
    return _unpack_masks(path, device)


def load_nlm_problem(device=None, path=HEADLINE_FIXTURE) -> CSMRI:
    """The one-lane CSMRI of the CSMRI + NLM lane: ``13.png`` at 128 px with
    the reference's uniform mask and ``PRNGKey(0)``, as ``bench.py:486-490``
    builds it (the headline fixture's last lane)."""
    return load_headline_problems(device, path, lanes=[NLM_LANE])[0]


def nlm_params(path=NLM_TUNED) -> dict:
    """The tuned CSMRI + NLM configuration: ``eta``, ``lr_decay``,
    ``sigma_modifier``, ``n_outer``, ``t2``, ``mini_batch_size``, and the
    tuner's grid ``etas`` and ``mods``."""
    with open(path) as f:
        tuned = json.load(f)
    keys = ("eta", "lr_decay", "sigma_modifier", "n_outer", "t2", "mini_batch_size")
    out = {k: tuned[k] for k in keys}
    out["etas"] = list(tuned["provenance"]["etas"])
    out["mods"] = list(tuned["provenance"]["mods"])
    return out


def load_nlm_masks(device=None, path=NLM_MASKS) -> torch.Tensor:
    """(n_outer, t2, 1, H, W) float32 minibatch masks of the JAX CSMRI + NLM
    run (``PRNGKey(2)``), for ``pnp_svrg(..., masks=...)``."""
    return _unpack_masks(path, device)


def load_nlm_reference(path=NLM_MASKS) -> dict:
    """The JAX CSMRI + NLM run on those masks: ``psnr_per_iter`` (numpy,
    ``1 + n_outer*(t2+1)`` entries) and its final ``ssim``."""
    with np.load(path) as f:
        return {"psnr_per_iter": f["psnr_per_iter"], "ssim": float(f["ssim"])}
