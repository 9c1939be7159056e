"""Train a (RealSN-)DnCNN denoiser: port of ``examples/train_realsn.py`` with
its arguments.

    python -m pnp_svrg_tpu_torch.examples.train_realsn --exp build/exp_realsn40 \\
        --layers 17 --lip 0.3 --noiseL 40 --epochs 20 --milestone 13 \\
        --train-dir data/RGB --val-dir data/Set12

Runs on the CUDA card unless ``--cpu``. ``--train-dir`` and ``--val-dir``
(the reference checkout's 400-image train set and Set12 by default, as in
the JAX script) name the image directories. ``--export NAME`` also writes
the effective network to ``checkpoints/NAME.npz`` in the Flax layout, which
the denoiser loaders of both packages read.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from pnp_svrg_tpu_torch.denoisers.dncnn import CHECKPOINT_DIR
from pnp_svrg_tpu_torch.models.convert import flax_variables_from_torch, save_flax_npz
from pnp_svrg_tpu_torch.models.spectral_norm import ADAPTIVE_SIGMAS_6
from pnp_svrg_tpu_torch.training import TrainConfig, train
from pnp_svrg_tpu_torch.training.data import REFERENCE_TRAIN_DIR, REFERENCE_VAL_DIR

EXPORT_DIR = CHECKPOINT_DIR


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--exp", required=True, help="experiment directory")
    parser.add_argument("--layers", type=int, default=17)
    parser.add_argument("--features", type=int, default=64)
    parser.add_argument("--batchSize", type=int, default=128)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--milestone", type=int, default=30)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--lip", type=float, default=0.0,
                        help=">0 enables the RealSN per-layer constraint")
    parser.add_argument("--no-bn", action="store_true")
    parser.add_argument("--mode", choices=["S", "B"], default="S")
    parser.add_argument("--noiseL", type=float, default=40.0)
    parser.add_argument("--max-images", type=int, default=None)
    parser.add_argument("--max-steps", type=int, default=None)
    parser.add_argument("--adaptive", action="store_true",
                        help="use the reference's adaptive per-layer sigma list instead of the "
                        "uniform lip^(1/L) recipe (requires --layers 6)")
    parser.add_argument("--export", default=None,
                        help="also save the final weights as checkpoints/<EXPORT>.npz for the "
                        "denoiser loaders (e.g. realsn_dncnn_noise5)")
    parser.add_argument("--cpu", action="store_true", help="run on the CPU")
    parser.add_argument("--train-dir", type=Path, default=REFERENCE_TRAIN_DIR)
    parser.add_argument("--val-dir", type=Path, default=REFERENCE_VAL_DIR)
    args = parser.parse_args(argv)

    cfg = TrainConfig(
        depth=args.layers,
        features=args.features,
        use_bn=not args.no_bn,
        lip=args.lip,
        adaptive_sigmas=ADAPTIVE_SIGMAS_6 if args.adaptive else None,
        batch_size=args.batchSize,
        epochs=args.epochs,
        milestone=args.milestone,
        lr=args.lr,
        mode=args.mode,
        noise_level=args.noiseL,
    )
    model, history = train(
        cfg, args.exp, train_dir=args.train_dir, val_dir=args.val_dir, max_images=args.max_images,
        max_steps_per_epoch=args.max_steps, device="cpu" if args.cpu else None,
    )
    if history:
        last = history[-1]
        print(f"final: val PSNR {last['val_psnr']:.2f} dB, SSIM {last['val_ssim']:.4f}")
    if args.export:
        out = EXPORT_DIR / f"{args.export}.npz"
        save_flax_npz(flax_variables_from_torch(model), out)
        print(f"exported {out}")
    return model, history


if __name__ == "__main__":
    main()
