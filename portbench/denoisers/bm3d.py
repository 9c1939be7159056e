"""The program's BM3D denoiser at the configuration's parameters, each lane
at its own ``sigma_modifier`` (from the traffic's lanes)."""

from __future__ import annotations

import torch


def program_denoiser(cfg: dict, traffic: dict, device, root):
    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams

    mod = torch.tensor([lane["sigma_modifier"] for lane in traffic["lanes"]], dtype=torch.float32, device=device)
    return BM3DDenoiser(sigma_modifier=mod, params=BM3DParams(**cfg["bm3d"]))
