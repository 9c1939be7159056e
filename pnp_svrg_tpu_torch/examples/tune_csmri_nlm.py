"""Tune the CSMRI + NLM quality lane (BASELINE configs[1]: "CSMRI on 13.png:
PnP-SVRG + NLM denoiser"; the reference's ``pnp_csmri.py`` problem family
with the ``denoisers/NLM.py`` prior).

Port of ``examples/tune_csmri_nlm.py``. Batched grid: C lanes of the SAME
13.png problem (the reference's uniform Bernoulli mask, from a generator
seeded with 0) carry per-lane (eta, sigma_modifier); one run evaluates the
chunk's configurations of one lr_decay, and on the card every denoise is one
launch of the NLM kernel (K3) over its lanes. Minibatches come from a
generator seeded with 2 in every run.

The winner is printed as one JSON line and written, by default, to
``build/tuning/csmri_nlm_tuned.json`` (not committed).

On the card: python -m pnp_svrg_tpu_torch.examples.tune_csmri_nlm
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
    parser.add_argument("--size", type=int, default=128)
    parser.add_argument("--image", default="13.png")
    parser.add_argument("--n-outer", type=int, default=16)
    parser.add_argument("--t2", type=int, default=10)
    parser.add_argument("--mb", type=int, default=4000)
    parser.add_argument("--etas", type=float, nargs="+",
                        default=[2000, 4000, 7000])
    parser.add_argument("--mods", type=float, nargs="+",
                        default=[0.7, 1.0, 1.4])
    parser.add_argument("--decays", type=float, nargs="+", default=[1.0])
    parser.add_argument("--chunk", type=int, default=9)
    parser.add_argument("--out", default=str(OUT_DIR / "csmri_nlm_tuned.json"),
                        help="JSON path (default: build/tuning/csmri_nlm_tuned.json "
                             "at the repository root, not committed)")
    args = parser.parse_args(argv)

    import torch

    from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
    from pnp_svrg_tpu_torch.core.batched import stack_problems
    from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
    from pnp_svrg_tpu_torch.device import resolve_device
    from pnp_svrg_tpu_torch.problems.csmri import make_csmri
    from pnp_svrg_tpu_torch.utils.io import load_image, resolve_data_path

    dev = resolve_device("cpu" if args.cpu else None)
    h = args.size
    img = load_image(resolve_data_path(args.image), h, h)
    prob = make_csmri(img, torch.Generator(device=dev).manual_seed(0), sample_prob=0.5, snr=10,
                      keep_low_freq=0, device=dev)

    configs = list(itertools.product(args.etas, args.decays, args.mods))
    C = args.chunk
    while len(configs) % C:
        configs.append(configs[-1])

    def eval_batch(chunk):
        batched = stack_problems([prob] * len(chunk))
        eta = torch.tensor([c[0] for c in chunk], dtype=torch.float32)
        mod = torch.tensor([c[2] for c in chunk], dtype=torch.float32, device=dev)
        out = pnp_svrg(
            batched, NLMDenoiser(sigma_modifier=mod), eta, args.n_outer, args.t2, args.mb,
            generator=torch.Generator(device=dev).manual_seed(2), lr_decay=chunk[0][1],
        )
        return out["final_psnr"].cpu().numpy()

    best = (-1e9, None)
    for i in range(0, len(configs), C):
        chunk = configs[i : i + C]
        t0 = time.time()
        psnr = per_decay(chunk, eval_batch)
        for (eta, dec, mod), p in zip(chunk, psnr):
            if p > best[0]:
                best = (float(p), dict(eta=eta, lr_decay=dec,
                                       sigma_modifier=mod,
                                       n_outer=args.n_outer, t2=args.t2,
                                       mini_batch_size=args.mb))
        print(
            f"chunk {i // C}: best in chunk {max(psnr):.2f} dB "
            f"(running best {best[0]:.2f}) ({time.time() - t0:.1f}s)",
            file=sys.stderr,
        )
    print(f"winner: {best[0]:.2f} dB  config={best[1]}", file=sys.stderr)
    provenance = {
        "tuner": "pnp_svrg_tpu_torch/examples/tune_csmri_nlm.py",
        "etas": args.etas, "decays": args.decays, "mods": args.mods,
        "n_outer": args.n_outer, "t2": args.t2, "mb": args.mb,
        "size": args.size, "image": args.image,
    }
    record = {"psnr_db": best[0], **best[1], "provenance": provenance}
    print(json.dumps(record))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
