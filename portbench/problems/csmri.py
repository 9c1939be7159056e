"""CS-MRI inputs: for each lane its image, a Bernoulli sampling mask (the
``keep_low_freq`` x ``keep_low_freq`` lowest frequencies always sampled where
the lane asks), real Gaussian noise on the sampled spectrum at the
configuration's SNR, and the zero-filled ``x_init = minmax(|ifft2(y)|)``;
drawn on the device from one generator, lane after lane."""

from __future__ import annotations

import torch

from portbench import inputs as common


def _low_index(n: int, k: int, device) -> torch.Tensor:
    if k <= 1:
        return torch.arange(1, device=device)
    return torch.cat([torch.arange(k), torch.arange(n - k + 1, n)]).to(device)


def _minmax(x: torch.Tensor) -> torch.Tensor:
    lo = x.amin(dim=(-2, -1), keepdim=True)
    hi = x.amax(dim=(-2, -1), keepdim=True)
    return (x - lo) / (hi - lo)


def make_inputs(cfg: dict, traffic: dict, seed: int, device, root) -> dict:
    h = w = cfg["size"]
    gen = torch.Generator(device=device).manual_seed(common.derive(seed, common.INPUTS))
    snr_lin = 10.0 ** (cfg["snr_db"] / 10.0)
    parts = {k: [] for k in ("x", "mask", "y", "x_init", "sigma")}
    for lane in traffic["lanes"]:
        img = common.load_image(root, lane["image"], lane["sha256"], h, w)
        x = torch.as_tensor(img, device=device)[None]
        mask = (torch.rand((1, h, w), generator=gen, device=device) < cfg["sample_prob"]).to(torch.float32)
        k = int(lane.get("keep_low_freq", 0))
        if k:
            mask[:, _low_index(h, k, device)[:, None], _low_index(w, k, device)[None, :]] = 1.0
        y0 = mask * torch.fft.fft2(x)
        sigma = torch.sqrt(torch.linalg.vector_norm(y0.reshape(1, -1), dim=-1) / snr_lin / h / w)
        y = y0 + mask * (sigma[:, None, None] * torch.randn((1, h, w), generator=gen, device=device))
        for key, val in (("x", x), ("mask", mask), ("y", y.to(torch.complex64)),
                         ("x_init", _minmax(torch.fft.ifft2(y).abs()).to(torch.float32)),
                         ("sigma", sigma.to(torch.float32))):
            parts[key].append(val)
    out = {k: torch.cat(v) for k, v in parts.items()}
    out["m0"] = out["mask"].sum(dim=(-2, -1))
    out["snr"] = torch.full_like(out["sigma"], float(cfg["snr_db"]))
    return out


def program_problem(inp: dict):
    """The inputs as the program's batched CS-MRI problem."""
    from pnp_svrg_tpu_torch.problems.csmri import CSMRI

    return CSMRI(y=inp["y"], mask=inp["mask"], x=inp["x"], x_init=inp["x_init"], m0=inp["m0"],
                 snr=inp["snr"], sigma=inp["sigma"])
