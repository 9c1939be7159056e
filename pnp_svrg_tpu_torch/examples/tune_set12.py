"""Tune per-lane (eta, sigma_modifier) for the Set12 CSMRI headline lane.

Port of ``examples/tune_set12.py``. The headline runs all 12 Set12 images
plus the reference flagship lane (13.png) as one batched pnp_svrg + BM3D
run. A single shared (eta, sigma_modifier) leaves most lanes far below their
attainable PSNR; the loops take per-lane step sizes and denoiser modifiers,
so per-lane tuning costs nothing at run time.

Two stages, all batched (13 lanes a run, the headline's run):

1. shared-config grid sweep -- each (eta, mod) cell is one run over all lanes;
2. per-lane local refinement around each lane's stage-1 winner, evaluated
   with per-lane (B,) eta/mod tensors (3 x 3 multiplicative factors, twice);

then one confirm run of the per-lane winners. Each run draws its minibatches
from a generator seeded with 2 (the JAX script's ``PRNGKey(2)``).

``--from-fixture`` tunes on the committed headline problems
(``convert.load_headline_problems``: the JAX package's masks and noise), so
that the tuned values belong to the same problems as the headline lane;
without it the problems are the port's own draws (lane i from a generator
seeded with i, the flagship's with 0).

The winners are written as JSON in the format of
``data/set12_csmri_tuned.json``, by default to
``build/tuning/set12_csmri_tuned.json`` (not committed).

On the card: python -m pnp_svrg_tpu_torch.examples.tune_set12 --from-fixture
"""

import argparse
import itertools
import json
import os
import sys
import time
from pathlib import Path

from pnp_svrg_tpu_torch.examples import OUT_DIR


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the CUDA card)")
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--n-outer", type=int, default=16)
    parser.add_argument("--t2", type=int, default=10)
    parser.add_argument("--mb", type=int, default=4000)
    parser.add_argument("--search", type=int, default=8,
                        help="BM3D search radius (8 = the headline lane)")
    parser.add_argument("--search-step", type=int, default=1,
                        help="candidate-offset stride (2 with --matcher "
                             "pallas = the turbo lane)")
    parser.add_argument("--matcher", default="xla",
                        choices=["xla", "pallas", "auto"],
                        help="which JAX matcher's bf16 rounding block matching follows")
    parser.add_argument("--match-dtype", default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--etas", type=float, nargs="+",
                        default=[1500, 3000, 6000, 9000])
    parser.add_argument("--mods", type=float, nargs="+",
                        default=[0.6, 0.8, 1.0, 1.3])
    parser.add_argument("--keep-lowfreq", type=int, default=4,
                        help="variable-density low-frequency block for the "
                        "Set12 lanes (the flagship 13.png lane always stays "
                        "reference-exact, keep=0)")
    parser.add_argument("--from-fixture", action="store_true",
                        help="tune on the committed headline problems (128 px, "
                             "keep-lowfreq 4)")
    parser.add_argument("--out", default=str(OUT_DIR / "set12_csmri_tuned.json"),
                        help="JSON path (default: build/tuning/set12_csmri_tuned.json "
                             "at the repository root, not committed)")
    args = parser.parse_args(argv)

    import numpy as np
    import torch

    from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
    from pnp_svrg_tpu_torch.convert import load_headline_problems
    from pnp_svrg_tpu_torch.core.batched import stack_problems
    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
    from pnp_svrg_tpu_torch.device import resolve_device
    from pnp_svrg_tpu_torch.problems.csmri import make_csmri
    from pnp_svrg_tpu_torch.utils.io import load_image, resolve_data_path, set12_paths

    dev = resolve_device("cpu" if args.cpu else None)
    h = w = args.size
    if args.from_fixture:
        if (args.size, args.keep_lowfreq) != (128, 4):
            raise SystemExit("--from-fixture holds the 128-px problems with keep-lowfreq 4")
        batched, names = load_headline_problems(dev)
    else:
        paths = list(set12_paths()) + [resolve_data_path("13.png")]
        seeds = list(range(len(paths) - 1)) + [0]
        # Set12 lanes: variable-density masks; flagship 13.png lane: the
        # reference's uniform Bernoulli mask.
        keeps = [args.keep_lowfreq] * (len(paths) - 1) + [0]
        batched = stack_problems([
            make_csmri(load_image(p, h, w), torch.Generator(device=dev).manual_seed(s),
                       sample_prob=0.5, snr=10, keep_low_freq=kl, device=dev)
            for p, s, kl in zip(paths, seeds, keeps)
        ])
        names = [os.path.basename(str(p)) for p in paths]
    bsz = batched.batch_size

    def run(eta, mod):
        den = BM3DDenoiser(
            sigma_modifier=torch.as_tensor(np.asarray(mod), dtype=torch.float32, device=dev),
            params=BM3DParams(
                search=args.search, search_step=args.search_step,
                matcher=args.matcher, match_dtype=args.match_dtype,
            ),
        )
        out = pnp_svrg(
            batched, den, torch.as_tensor(np.asarray(eta), dtype=torch.float32),
            args.n_outer, args.t2, args.mb,
            generator=torch.Generator(device=dev).manual_seed(2),
        )
        return out["final_psnr"].cpu().numpy().astype(float)

    # ---- stage 1: shared-config grid --------------------------------------
    best_psnr = np.full(bsz, -1e9)
    best_eta = np.zeros(bsz)
    best_mod = np.zeros(bsz)
    t0 = time.time()
    for eta, mod in itertools.product(args.etas, args.mods):
        psnr = run(eta, mod)
        psnr = np.where(np.isfinite(psnr), psnr, -1e9)
        upd = psnr > best_psnr
        best_psnr = np.where(upd, psnr, best_psnr)
        best_eta = np.where(upd, eta, best_eta)
        best_mod = np.where(upd, mod, best_mod)
        print(
            f"[grid] eta={eta:<8g} mod={mod:<4g} mean={psnr.mean():6.2f} "
            f"min={psnr.min():6.2f}  ({time.time() - t0:.0f}s)",
            file=sys.stderr,
        )
    print(
        f"[grid done] mean={best_psnr.mean():.2f} min={best_psnr.min():.2f}",
        file=sys.stderr,
    )

    # ---- stage 2: per-lane local refinement -------------------------------
    for factors in ([0.7, 1.0, 1.4], [0.85, 1.0, 1.2]):
        for fe, fm in itertools.product(factors, factors):
            psnr = run(best_eta * fe, best_mod * fm)
            psnr = np.where(np.isfinite(psnr), psnr, -1e9)
            upd = psnr > best_psnr
            best_psnr = np.where(upd, psnr, best_psnr)
            best_eta = np.where(upd, best_eta * fe, best_eta)
            best_mod = np.where(upd, best_mod * fm, best_mod)
        print(
            f"[refine x{factors[-1]}] mean={best_psnr.mean():.2f} "
            f"min={best_psnr.min():.2f}",
            file=sys.stderr,
        )

    # ---- confirm the per-lane winners in one run --------------------------
    confirm = run(best_eta, best_mod)
    print(f"[confirm] mean={confirm.mean():.2f} min={confirm.min():.2f}",
          file=sys.stderr)

    result = {
        "config": {
            "size": h, "n_outer": args.n_outer, "t2": args.t2,
            "mini_batch_size": args.mb, "search": args.search,
            "search_step": args.search_step, "matcher": args.matcher,
            "match_dtype": args.match_dtype,
            "keep_low_freq": args.keep_lowfreq,
        },
        "lanes": names,
        "eta": [float(v) for v in best_eta],
        "sigma_modifier": [float(v) for v in best_mod],
        "tuned_psnr": [float(v) for v in confirm],
    }
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", file=sys.stderr)
    for n, e, m, p in zip(names, best_eta, best_mod, confirm):
        print(f"  {n:8s} eta={e:<9.5g} mod={m:<6.3g} psnr={p:6.2f}",
              file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
