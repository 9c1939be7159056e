"""Reproduce the paper's CSMRI experiment (reference
``create_paper_figures_csmri.ipynb`` cells 4-15, recorded outputs in
BASELINE.md): 13.png at 128x128, sampling ratio 0.5, SNR 10 dB, BM3D
denoiser, all five PnP algorithms at the reference's iteration budgets.

Port of ``examples/paper_csmri.py``, with its flags and row format:

    python -m pnp_svrg_tpu_torch.examples.paper_csmri [--cpu] [--eta-scale auto|ref]

``--eta-scale ref`` runs the reference's exact hyperparameters (eta ~ 0.1,
under which gradient steps are ~(z - x)/N and the dynamics are
denoiser-driven); the default ``auto`` uses data-consistency step sizes
calibrated for the exact-gradient scaling. The problem comes from a
generator seeded with ``--seed``; every stochastic row draws its
minibatches from its own generator seeded with 1. The metrics CSV goes to
``build/figures/paper_csmri.csv`` unless ``--save`` names another path.
"""

import argparse
import time

import torch

from pnp_svrg_tpu_torch.algorithms.loops import pnp_gd, pnp_saga, pnp_sarah, pnp_sgd, pnp_svrg
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.examples import FIGURES_DIR
from pnp_svrg_tpu_torch.ops.metrics import ssim
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.utils.io import load_image
from pnp_svrg_tpu_torch.utils.viz import write_metrics_csv

# Reference recorded results (BASELINE.md): algo -> (final PSNR dB, iters).
REFERENCE_RESULTS = {
    "svrg": (22.8, 175),
    "sgd": (23.3, 176),
    "gd": (22.9, 198),
    "saga": (22.9, 149),
    "sarah": (22.1, 159),
}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the CUDA card)")
    parser.add_argument("--eta-scale", choices=["auto", "ref"], default="auto")
    parser.add_argument("--seed", type=int, default=3)
    parser.add_argument("--save", default=str(FIGURES_DIR / "paper_csmri.csv"),
                        help="CSV output path (default: build/figures/paper_csmri.csv)")
    return parser.parse_args(argv)


def make_problem(args, device):
    """13.png at 128 px, ratio 0.5, SNR 10, from a generator seeded ``args.seed``."""
    img = load_image("13.png", 128, 128)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    return make_csmri(img, gen, sample_prob=0.5, snr=10, device=device)


def make_runs(prob, args, device) -> dict:
    """The row table, ``{name: callable}``, of ``args.eta_scale``."""
    params = BM3DParams(search=8)

    def gen():
        return torch.Generator(device=device).manual_seed(1)

    if args.eta_scale == "auto":
        # Data-consistency steps for exact gradients (stability: eta < 2*M0
        # for full grads, eta < mb for control-variate terms).
        return {
            "gd": lambda: pnp_gd(
                prob, BM3DDenoiser(sigma_modifier=1.5, params=params),
                eta=6000.0, n_iters=198),
            "sgd": lambda: pnp_sgd(
                prob, BM3DDenoiser(sigma_modifier=1.5, params=params),
                eta=6000.0, n_iters=176, mini_batch_size=4000, generator=gen()),
            "svrg": lambda: pnp_svrg(
                prob, BM3DDenoiser(sigma_modifier=1.5, params=params),
                eta=6000.0, n_outer=16, t2=10, mini_batch_size=4000, generator=gen()),
            "saga": lambda: pnp_saga(
                prob, BM3DDenoiser(sigma_modifier=1.0, params=params),
                eta=3000.0, n_iters=149, mini_batch_size=5000, hist_size=10,
                generator=gen()),
            "sarah": lambda: pnp_sarah(
                prob, BM3DDenoiser(sigma_modifier=1.5, params=params),
                eta=1500.0, n_outer=15, t2=10, mini_batch_size=4000, generator=gen()),
        }
    # The notebook's recorded hyperparameters (csmri nb cells 4-15).
    return {
        "svrg": lambda: pnp_svrg(
            prob, BM3DDenoiser(sigma_modifier=0.7, params=params),
            eta=0.1, n_outer=16, t2=10, mini_batch_size=500, generator=gen(),
            variant="faithful"),
        "sgd": lambda: pnp_sgd(
            prob, BM3DDenoiser(sigma_modifier=0.6, params=params),
            eta=0.1, n_iters=176, mini_batch_size=1000, generator=gen()),
        "gd": lambda: pnp_gd(
            prob, BM3DDenoiser(sigma_modifier=0.6, params=params),
            eta=0.1, n_iters=198),
        "saga": lambda: pnp_saga(
            prob, BM3DDenoiser(sigma_modifier=0.6, params=params),
            eta=0.1, n_iters=149, mini_batch_size=5000, hist_size=10,
            generator=gen()),
        "sarah": lambda: pnp_sarah(
            prob, BM3DDenoiser(sigma_modifier=0.6, params=params),
            eta=0.05, n_outer=15, t2=10, mini_batch_size=1000, generator=gen(),
            variant="faithful"),
    }


def main(argv=None):
    args = parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    prob = make_problem(args, device)
    init_psnr = float(prob.psnr(prob.x_init)[0])
    print(f"init PSNR {init_psnr:.2f} dB  (sigma {float(prob.sigma[0]):.4f}, "
          f"M0 {int(prob.m0[0])})")

    rows = []
    for name, fn in make_runs(prob, args, device).items():
        t0 = time.time()
        out = fn()
        final = float(out["final_psnr"][0])
        ref_psnr, ref_iters = REFERENCE_RESULTS[name]
        rows.append({
            "algorithm": out["algo_name"],
            "final_psnr": round(final, 2),
            "final_ssim": round(float(ssim(prob.x, out["image"])[0]), 4),
            "delta_psnr": round(final - init_psnr, 2),
            "reference_psnr": ref_psnr,
            "margin_vs_reference": round(final - ref_psnr, 2),
            "iters": out["psnr_per_iter"].shape[0] - 1,
            "seconds": round(time.time() - t0, 2),
        })
        print(rows[-1])
    if args.save:
        write_metrics_csv(rows, args.save)
    return rows


if __name__ == "__main__":
    main()
