"""Tune the Deblur + BM3D lane (Set12/01 at 256x256, "Minimal" kernel, SNR 5:
the reference deblur notebook's configuration,
``create_paper_figures_deblur.ipynb`` cells 4-7).

Port of ``examples/tune_deblur.py``. Batched grid: C copies of one problem
(from a generator seeded with 0) carry per-lane (eta, sigma_modifier); one
run evaluates the chunk's configurations of one lr_decay. Deblur under PnP
is semi-convergent (PSNR peaks, then decays), so the iteration budget
(n_outer, t2) matters as much as the step size; both are swept as budgets.
Minibatches come from a generator seeded with 2 in every run.

The winner is printed as one JSON line and written, by default, to
``build/tuning/deblur_tuned.json`` (not committed).

On the card: python -m pnp_svrg_tpu_torch.examples.tune_deblur
"""

import argparse
import itertools
import json
import sys
import time
from pathlib import Path

from pnp_svrg_tpu_torch.examples import OUT_DIR, per_decay


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the CUDA card)")
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--image", default="Set12/01.png")
    parser.add_argument("--kernel", default="Minimal",
                        help='"Minimal", "Identity", or a kernel image path '
                             'under data/ (e.g. kernel25.png)')
    parser.add_argument("--scale", type=int, default=100,
                        help="scale_percent: <100 adds bilinear downsampling "
                             "(the reference's SR path, DeblurSR.py:95-108)")
    parser.add_argument("--snr", type=float, default=5.0)
    parser.add_argument("--etas", type=float, nargs="+",
                        default=[5e8, 2e9, 8e9])
    # Defaults cover the committed data/deblur_tuned.json winner
    # (eta=4e9, lr_decay=0.95, sigma_modifier=4.2).
    parser.add_argument("--decays", type=float, nargs="+",
                        default=[0.5, 0.6, 0.75, 0.9, 0.95])
    parser.add_argument("--mods", type=float, nargs="+",
                        default=[0.7, 1.0, 1.4, 2.1, 3.0, 4.2])
    parser.add_argument("--budgets", type=int, nargs=2, action="append",
                        default=None, metavar=("N_OUTER", "T2"))
    parser.add_argument("--mb", type=int, default=5000)
    parser.add_argument("--chunk", type=int, default=9)
    parser.add_argument("--search-step", type=int, default=1,
                        help="BM3D candidate-offset stride (grid-aligned search)")
    parser.add_argument("--matcher", default="xla",
                        choices=["xla", "pallas", "auto"],
                        help="which JAX matcher's bf16 rounding block matching follows")
    parser.add_argument("--match-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--out", default=str(OUT_DIR / "deblur_tuned.json"),
                        help="JSON path (default: build/tuning/deblur_tuned.json at "
                             "the repository root, not committed)")
    args = parser.parse_args(argv)
    budgets = args.budgets or [(4, 6), (6, 8)]

    import torch

    from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
    from pnp_svrg_tpu_torch.core.batched import stack_problems
    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
    from pnp_svrg_tpu_torch.device import resolve_device
    from pnp_svrg_tpu_torch.problems.deblur import make_deblur
    from pnp_svrg_tpu_torch.utils.io import load_image, resolve_data_path

    dev = resolve_device("cpu" if args.cpu else None)
    h = args.size
    img = load_image(resolve_data_path(args.image), h, h)
    kernel = args.kernel
    if kernel.endswith((".png", ".jpg", ".jpeg")):
        kernel = str(resolve_data_path(kernel))
    prob = make_deblur(img, torch.Generator(device=dev).manual_seed(0), kernel=kernel,
                       scale_percent=args.scale, snr=args.snr, device=dev)

    configs = list(itertools.product(args.etas, args.decays, args.mods))
    C = args.chunk
    while len(configs) % C:
        configs.append(configs[-1])

    def eval_batch(n_outer, t2, chunk):
        batched = stack_problems([prob] * len(chunk))
        eta = torch.tensor([c[0] for c in chunk], dtype=torch.float32)
        mod = torch.tensor([c[2] for c in chunk], dtype=torch.float32, device=dev)
        den = BM3DDenoiser(sigma_modifier=mod, params=BM3DParams(
            search=8, search_step=args.search_step, matcher=args.matcher,
            match_dtype=args.match_dtype))
        out = pnp_svrg(
            batched, den, eta, n_outer, t2, args.mb,
            generator=torch.Generator(device=dev).manual_seed(2), lr_decay=chunk[0][1],
        )
        return out["final_psnr"].cpu().numpy()

    best = (-1e9, None)
    for n_outer, t2 in budgets:
        for i in range(0, len(configs), C):
            chunk = configs[i : i + C]
            t0 = time.time()
            psnr = per_decay(chunk, lambda sub: eval_batch(n_outer, t2, sub))
            for (eta, dec, mod), p in zip(chunk, psnr):
                if p > best[0]:
                    best = (float(p), dict(eta=eta, lr_decay=dec,
                                           sigma_modifier=mod,
                                           n_outer=n_outer, t2=t2,
                                           mini_batch_size=args.mb))
            print(
                f"[outer={n_outer} t2={t2}] chunk {i // C}: best in chunk "
                f"{max(psnr):.2f} dB (running best {best[0]:.2f}) "
                f"({time.time() - t0:.1f}s)",
                file=sys.stderr,
            )
    print(f"winner: {best[0]:.2f} dB  config={best[1]}", file=sys.stderr)
    provenance = {
        "tuner": "pnp_svrg_tpu_torch/examples/tune_deblur.py",
        "etas": args.etas, "decays": args.decays, "mods": args.mods,
        "budgets": budgets, "mb": args.mb, "size": args.size,
        "image": args.image, "kernel": args.kernel, "scale": args.scale,
        "snr": args.snr,
    }
    record = {"psnr_db": best[0], **best[1],
              "search_step": args.search_step, "matcher": args.matcher,
              "match_dtype": args.match_dtype, "provenance": provenance}
    print(json.dumps(record))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
