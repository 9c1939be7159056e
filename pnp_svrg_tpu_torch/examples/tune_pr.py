"""Tune the PR + BM3D quality lane (BASELINE.md PR table: SVRG + BM3D 26.8 dB;
reference ``create_paper_figures_pr.ipynb`` cells 9-10), or with
``--algo sarah --denoiser realsn`` the PR + SARAH + RealSN-DnCNN lane.

Port of ``examples/tune_pr.py``: Set12/04 at 128x128, alpha 0.5 (8192
measurements), SNR 20, the problem from a generator seeded with 4 and every
run's minibatches from one seeded with 5 (the JAX script's ``PRNGKey(4)``
and ``PRNGKey(5)``). The tuner stacks copies of that one problem (holding its
matrix A once) and evaluates a chunk's (eta, sigma_modifier) configurations
of one lr_decay per run; one run per (n_outer, chunk, lr_decay).

``--replicas R`` puts each configuration in R lanes, which draw different
minibatches, and scores it by the replica MEAN (PR + SARAH swings several dB
across minibatch streams, so a one-lane winner is partly luck). The winner is
then certified alone: in a batch of exactly R lanes, or with R = 1 as one
unstacked problem.

The winner is printed as one JSON line and written, by default, to
``build/tuning/pr_tuned.json`` (not committed).

On the card: python -m pnp_svrg_tpu_torch.examples.tune_pr
"""

import argparse
import functools
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
    parser.add_argument("--num-meas", type=int, default=8192)
    parser.add_argument("--etas", type=float, nargs="+",
                        default=[0.1, 0.15, 0.2, 0.3])
    parser.add_argument("--decays", type=float, nargs="+",
                        default=[0.985, 0.99, 1.0])
    parser.add_argument("--mods", type=float, nargs="+",
                        default=[0.8, 1.0, 1.3])
    parser.add_argument("--outers", type=int, nargs="+", default=[20, 30])
    parser.add_argument("--t2", type=int, default=8)
    parser.add_argument("--mb", type=int, default=800)
    parser.add_argument("--algo", default="svrg", choices=["svrg", "sarah"])
    parser.add_argument("--denoiser", default="bm3d",
                        choices=["bm3d", "realsn"],
                        help="realsn = RealSN-DnCNN (framework-trained "
                             "checkpoint); ignores sigma_modifier, "
                             "so --mods collapses to [1.0]")
    parser.add_argument("--realsn-sigma", type=int, default=5,
                        choices=[5, 15, 40],
                        help="which framework-trained RealSN-DnCNN "
                             "checkpoint drives the realsn lanes")
    parser.add_argument("--sarah-variant", default="sarah",
                        choices=["sarah", "faithful"],
                        help="canonical SARAH recursion vs the reference v1 "
                             "frozen-anchor behavior (loops.py pnp_sarah)")
    parser.add_argument("--chunk", type=int, default=4,
                        help="LANES per batched run (the lanes share one A)")
    parser.add_argument("--replicas", type=int, default=1,
                        help="evaluate each config in this many batch lanes "
                             "and score by the REPLICA MEAN")
    parser.add_argument("--out", default=str(OUT_DIR / "pr_tuned.json"),
                        help="JSON path for the winning config (default: "
                             "build/tuning/pr_tuned.json at the repository "
                             "root, not committed)")
    args = parser.parse_args(argv)
    R = max(1, args.replicas)
    if args.chunk % R:
        raise SystemExit("--chunk must be a multiple of --replicas")

    import torch

    from pnp_svrg_tpu_torch.algorithms.loops import pnp_sarah, pnp_svrg
    from pnp_svrg_tpu_torch.core.batched import stack_problems
    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
    from pnp_svrg_tpu_torch.denoisers.dncnn import DnCNNDenoiser
    from pnp_svrg_tpu_torch.device import resolve_device
    from pnp_svrg_tpu_torch.problems.pr import make_phase_retrieval
    from pnp_svrg_tpu_torch.utils.io import load_image, resolve_data_path

    dev = resolve_device("cpu" if args.cpu else None)
    h = args.size
    img = load_image(resolve_data_path("Set12/04.png"), h, h)
    prob = make_phase_retrieval(img, torch.Generator(device=dev).manual_seed(4),
                                num_meas=args.num_meas, snr=20, device=dev)

    if args.algo == "sarah":
        loop = functools.partial(pnp_sarah, variant=args.sarah_variant)
    else:
        loop = pnp_svrg
    realsn = None
    if args.denoiser == "realsn":
        args.mods = [1.0]  # RealSN-DnCNN uses its training sigma
        realsn = DnCNNDenoiser.from_pretrained("RealSN_DnCNN", args.realsn_sigma, device=dev)
    configs = list(itertools.product(args.etas, args.decays, args.mods))

    def run(problem, eta, mod, n_outer, lr_decay):
        den = realsn
        if den is None:
            den = BM3DDenoiser(sigma_modifier=mod, params=BM3DParams(search=8))
        out = loop(problem, den, eta, n_outer, args.t2, args.mb,
                   generator=torch.Generator(device=dev).manual_seed(5), lr_decay=lr_decay)
        return out["final_psnr"].cpu().numpy()

    def eval_batch(n_outer, chunk):
        # Each config occupies R adjacent lanes (identical hyperparameters,
        # different minibatch draws); scores are replica means.
        lanes = [c for c in chunk for _ in range(R)]
        eta = torch.tensor([c[0] for c in lanes], dtype=torch.float32)
        mod = torch.tensor([c[2] for c in lanes], dtype=torch.float32, device=dev)
        lane_psnr = run(stack_problems([prob] * len(lanes)), eta, mod, n_outer, chunk[0][1])
        return lane_psnr.reshape(-1, R).mean(axis=1)

    best = (-1e9, None)
    C = max(1, args.chunk // R)
    while len(configs) % C:
        configs.append(configs[-1])
    for n_outer in args.outers:
        for i in range(0, len(configs), C):
            chunk = configs[i : i + C]
            t0 = time.time()
            psnr = per_decay(chunk, lambda sub: eval_batch(n_outer, sub))
            for (eta, dec, mod), p in zip(chunk, psnr):
                if p > best[0]:
                    best = (float(p), dict(eta=eta, lr_decay=dec,
                                           sigma_modifier=mod,
                                           n_outer=n_outer, t2=args.t2,
                                           mini_batch_size=args.mb))
            print(
                f"[outer={n_outer}] chunk {i // C}: best in chunk "
                f"{max(psnr):.2f} dB (running best {best[0]:.2f}) "
                f"({time.time() - t0:.1f}s)",
                file=sys.stderr,
            )
    print(f"winner: {best[0]:.2f} dB  config={best[1]}", file=sys.stderr)
    # Certification: the grid scored configs on whatever lanes they landed
    # at; re-evaluate the winner alone, in a batch of exactly R lanes (or as
    # one unstacked problem), the quantity a lane of R replicas reproduces.
    if C > 1:
        w = best[1]
        if R > 1:
            cert = float(eval_batch(
                w["n_outer"], [(w["eta"], w["lr_decay"], w["sigma_modifier"])]
            )[0])
            stream = f"lanes 0..{R - 1}"
        else:
            cert = float(run(prob, w["eta"], w["sigma_modifier"], w["n_outer"], w["lr_decay"])[0])
            stream = "single problem"
        print(
            f"certified on the lane's minibatch stream ({stream}): {cert:.2f} dB "
            f"(grid-lane score was {best[0]:.2f})",
            file=sys.stderr,
        )
        best = (cert, w)
    provenance = {
        "tuner": "pnp_svrg_tpu_torch/examples/tune_pr.py",
        "algo": args.algo, "denoiser": args.denoiser,
        "etas": args.etas, "decays": args.decays, "mods": args.mods,
        "outers": args.outers, "t2": args.t2, "mb": args.mb,
        "size": args.size, "num_meas": args.num_meas,
        "replicas": R,
    }
    record = {"psnr_db": best[0], "replicas": R, **best[1],
              "provenance": provenance}
    if args.denoiser == "realsn":
        record["realsn_sigma"] = args.realsn_sigma
        provenance["realsn_sigma"] = args.realsn_sigma
    if args.algo == "sarah":
        record["variant"] = args.sarah_variant
        provenance["sarah_variant"] = args.sarah_variant
    print(json.dumps(record))
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    return record


if __name__ == "__main__":
    main()
