"""RGB CSMRI comparison figure -- the working form of the reference's RGB
path (reference ``utils.py:66-92`` ``denoise_rgb``, commented out upstream,
and the ``data/RGB/*.jpg`` assets).

Port of ``examples/rgb_csmri.py``, with its flags. Reconstructs each color
channel of a BSDS image as a CSMRI problem, the three channels batched into
one PnP run (``utils.viz.reconstruct_rgb``, wavelet "TV" denoiser), and
writes an original / zero-filled / reconstructed comparison figure, by
default to ``build/figures/rgb_csmri.png`` (matplotlib is needed only for
the figure: :func:`run` computes the reconstruction):

    python -m pnp_svrg_tpu_torch.examples.rgb_csmri --cpu --size 64
"""

import argparse
from pathlib import Path

import numpy as np

from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.device import resolve_device
from pnp_svrg_tpu_torch.examples import FIGURES_DIR
from pnp_svrg_tpu_torch.utils.io import resolve_data_path
from pnp_svrg_tpu_torch.utils.viz import reconstruct_rgb


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the CUDA card)")
    parser.add_argument("--image", default="RGB/12084.jpg")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--algo", default="svrg")
    parser.add_argument("--snr", type=float, default=30.0)
    parser.add_argument("--eta", type=float, default=2000.0)
    parser.add_argument("--n-outer", type=int, default=8)
    parser.add_argument("--t2", type=int, default=10)
    parser.add_argument("--mb", type=int, default=2000)
    parser.add_argument("--out", default=str(FIGURES_DIR / "rgb_csmri.png"),
                        help="figure path (default: build/figures/rgb_csmri.png)")
    return parser.parse_args(argv)


def hyperparameters(args) -> dict:
    """The loop's hyperparameters for ``args.algo``, as the JAX script sets
    them from the flags."""
    mb = min(args.mb, args.size * args.size // 2)
    if args.algo in ("gd",):
        return dict(eta=args.eta, n_iters=args.n_outer * (args.t2 + 1))
    if args.algo in ("sgd", "saga"):
        return dict(eta=args.eta, n_iters=args.n_outer * (args.t2 + 1), mini_batch_size=mb)
    return dict(eta=args.eta, n_outer=args.n_outer, t2=args.t2, mini_batch_size=mb)


def psnr_db(a: np.ndarray, b: np.ndarray) -> float:
    return float(-10 * np.log10(float(np.mean((a - b) ** 2))))


def run(args, device=None) -> dict:
    """The reconstruction of ``args``' image on ``device`` (CUDA unless
    ``"cpu"``): the three (H, W, 3) images and the zero-filled and
    reconstructed PSNRs, overall and per channel."""
    from PIL import Image

    img = Image.open(resolve_data_path(args.image)).convert("RGB")
    img = np.asarray(img.resize((args.size, args.size)), np.float64) / 255.0
    orig, init, recon = reconstruct_rgb(
        img, algo=args.algo, denoiser=TVDenoiser(sigma_modifier=1.0),
        snr=args.snr, device=resolve_device(device), **hyperparameters(args),
    )
    res = {"orig": orig, "init": init, "recon": recon,
           "psnr_init": psnr_db(init, orig), "psnr_recon": psnr_db(recon, orig),
           "channels_init": [psnr_db(init[..., c], orig[..., c]) for c in range(3)],
           "channels_recon": [psnr_db(recon[..., c], orig[..., c]) for c in range(3)]}
    print(f"zero-filled {res['psnr_init']:.2f} dB -> reconstructed {res['psnr_recon']:.2f} dB")
    for c, name in enumerate("RGB"):
        print(f"  channel {name}: {res['channels_init'][c]:.2f} -> "
              f"{res['channels_recon'][c]:.2f} dB")
    return res


def main(argv=None):
    args = parse_args(argv)
    res = run(args, "cpu" if args.cpu else None)

    from pnp_svrg_tpu_torch.utils.viz import show_grid

    fig = show_grid(
        [res["orig"], res["init"], res["recon"]],
        titles=[
            "original",
            f"zero-filled ({res['psnr_init']:.1f} dB)",
            f"PnP-{args.algo.upper()} ({res['psnr_recon']:.1f} dB)",
        ],
        ncols=3,
        color_map=None,
    )
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
