"""Standalone CSMRI demo -- equivalent of the reference's ``pnp_csmri.py``:
CSMRI on 13.png (256x256, p=0.5, SNR 30), RealSN-DnCNN sigma=5 denoiser
(reference ``pnp_csmri.py:21``, ``denoisers/RealSN_DnCNN.py:8-42``), GD vs
SGD vs SVRG comparison figure.

Port of ``examples/pnp_csmri_demo.py``, with its flags:

    python -m pnp_svrg_tpu_torch.examples.pnp_csmri_demo [--cpu] [--small] [--out PATH]

The RealSN weights were trained by this framework
(``checkpoints/realsn_dncnn_noise5.npz``; the upstream
``RealSN_DnCNN_noise5.pth`` blob is missing from the reference checkout).
Falls back to the converted plain-DnCNN checkpoint when the trained file is
absent. The problem comes from a generator seeded with 0; each stochastic
row draws its minibatches from its own generator seeded with 1. The figure
goes to ``build/figures/pnp_csmri_demo.png`` unless ``--out`` names another
path (matplotlib is needed only for the figure).
"""

import argparse
import time
from pathlib import Path

import torch

from pnp_svrg_tpu_torch.algorithms.loops import pnp_gd, pnp_sgd, pnp_svrg
from pnp_svrg_tpu_torch.denoisers.dncnn import DnCNNDenoiser
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.examples import FIGURES_DIR
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.utils.io import load_image


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the CUDA card)")
    parser.add_argument("--small", action="store_true", help="128x128")
    parser.add_argument("--out", default=str(FIGURES_DIR / "pnp_csmri_demo.png"),
                        help="figure path (default: build/figures/pnp_csmri_demo.png)")
    return parser.parse_args(argv)


def make_problem(args, device):
    """13.png at 256 px (128 with ``--small``), ratio 0.5, SNR 30."""
    h = 128 if args.small else 256
    img = load_image("13.png", h, h)
    gen = torch.Generator(device=device).manual_seed(0)
    return make_csmri(img, gen, sample_prob=0.5, snr=30, device=device)


def make_denoiser(device):
    try:
        # The reference demo's denoiser: RealSN_DnCNN sigma=5, here on
        # weights this framework trained (Lipschitz-0.3 RealSN recipe).
        den = DnCNNDenoiser.from_pretrained("RealSN_DnCNN", 5, device=device)
        print("denoiser: RealSN_DnCNN sigma=5 (framework-trained)")
    except FileNotFoundError:
        den = DnCNNDenoiser.from_pretrained("DnCNN", 5, device=device)
        print("denoiser: DnCNN sigma=5 (realsn_dncnn_noise5.npz not found -- "
              "train it with pnp_svrg_tpu_torch.examples.train_realsn --export)")
    return den


def make_runs(prob, args, device) -> dict:
    """The row table, ``{name: callable}``."""
    den = make_denoiser(device)
    n = prob.h * prob.w

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    return {
        "PnP-GD": lambda: pnp_gd(prob, den, eta=0.6 * n, n_iters=30),
        "PnP-SGD": lambda: pnp_sgd(
            prob, den, eta=0.3 * n, n_iters=30, mini_batch_size=4000, generator=gen()),
        "PnP-SVRG": lambda: pnp_svrg(
            prob, den, eta=0.3 * n, n_outer=3, t2=10, mini_batch_size=4000,
            generator=gen()),
    }


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    prob = make_problem(args, device)
    outs = {}
    for name, fn in make_runs(prob, args, device).items():
        t0 = time.time()
        outs[name] = fn()
        print(f"{name}: {float(outs[name]['final_psnr'][0]):.2f} dB "
              f"({time.time() - t0:.1f}s)")

    from pnp_svrg_tpu_torch.utils.viz import show_grid

    images = [prob.x[0], prob.x_init[0]] + [o["image"][0] for o in outs.values()]
    titles = (
        ["original", f"init {float(prob.psnr(prob.x_init)[0]):.1f} dB"]
        + [f"{k} {float(v['final_psnr'][0]):.1f} dB" for k, v in outs.items()]
    )
    fig = show_grid(images, titles, ncols=5)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        fig.savefig(args.out, dpi=130, bbox_inches="tight")
        print(f"saved {args.out}")
    return outs


if __name__ == "__main__":
    main()
