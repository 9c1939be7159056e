"""Sampling-ratio sweep over Set12: the port of ``examples/sweep_sampratio.py``
(the reference ``script_diff_sampratio_set12.py``, BASELINE configs[4]): the
(problem x algorithm x denoiser x ratio x image) grid with a per-cell TPE
hyperparameter search at a fixed iteration budget, CSV output.

Problem factories mirror the reference ``get_problem``
(``script_diff_sampratio_set12.py:41-49``):
  csmri  : sample_prob = ratio                  (reference alpha/10, 256^2)
  deblur : "Minimal" kernel + scale_percent = ratio*100 bilinear SR
  pr     : 32x32, num_meas = ratio * 10 * 32 * 32
Image i is built from a generator seeded with i (the JAX script's
``PRNGKey(i)``), so the problems are the port's own draws.

The default execution is LOCKSTEP lane parallelism
(``tuning.sweep.sweep_grid_lockstep``): every image's TPE search for one
(algo, denoiser, ratio) cell class proposes its round of candidates, and the
whole round -- 12 images x C candidates -- runs as one batched ``run_pnp``
call. The integer hyperparameters are coarse Choices, shared in a round
through the rotating leader.

On the card (36 lanes a round: 12 images x 3 candidates):
    python -m pnp_svrg_tpu_torch.examples.sweep_sampratio --images 12 \\
        --ratios 0.5 --algos svrg --denoisers bm3d nlm --max-evals 6
Small CPU smoke:
    python -m pnp_svrg_tpu_torch.examples.sweep_sampratio --cpu --images 2 \\
        --size 32 --ratios 0.5 --algos svrg --denoisers tv --max-evals 4
"""

import argparse

from pnp_svrg_tpu_torch.examples import OUT_DIR


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--cpu", action="store_true", help="run on the CPU (else the CUDA card)")
    parser.add_argument("--problems", nargs="+", default=["csmri"],
                        choices=["csmri", "deblur", "pr"])
    parser.add_argument("--images", type=int, default=2)
    parser.add_argument("--ratios", type=float, nargs="+", default=[0.5])
    parser.add_argument("--algos", nargs="+", default=["svrg"],
                        choices=["gd", "sgd", "svrg", "sarah", "saga"])
    parser.add_argument("--denoisers", nargs="+", default=["tv"],
                        choices=["tv", "nlm", "bm3d"])
    parser.add_argument("--snr", type=float, default=20.0)
    parser.add_argument("--size", type=int, default=128,
                        help="CSMRI/Deblur image size (PR is fixed at 32^2 "
                             "like the reference)")
    parser.add_argument("--max-evals", type=int, default=20)
    parser.add_argument("--n-iters", type=int, default=60)
    parser.add_argument("--cand", type=int, default=3,
                        help="TPE candidates per cell per lockstep round")
    parser.add_argument("--max-lanes", type=int, default=48)
    parser.add_argument("--search", type=int, default=8,
                        help="BM3D search radius")
    parser.add_argument("--mb-opts", type=int, nargs="+", default=None,
                        help="absolute mini_batch_size Choice options "
                             "(shared across ratios; options > 0.8*m are "
                             "dropped per-cell). Default: fractions of m.")
    parser.add_argument("--t2-opts", type=int, nargs="+", default=[5, 10])
    parser.add_argument("--hist-opts", type=int, nargs="+", default=[10, 20])
    parser.add_argument("--sequential", action="store_true",
                        help="per-cell sequential TPE (the pre-lockstep path)")
    parser.add_argument("--trial-batch", type=int, default=1,
                        help="(sequential mode) TPE candidates per batched run")
    parser.add_argument("--out", default=str(OUT_DIR / "sweep.csv"),
                        help="CSV path (default: build/tuning/sweep.csv at the "
                             "repository root, not committed)")
    args = parser.parse_args(argv)

    import torch

    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
    from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
    from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
    from pnp_svrg_tpu_torch.device import resolve_device
    from pnp_svrg_tpu_torch.problems.csmri import make_csmri
    from pnp_svrg_tpu_torch.problems.deblur import make_deblur
    from pnp_svrg_tpu_torch.problems.pr import make_phase_retrieval
    from pnp_svrg_tpu_torch.tuning.sweep import sweep_grid, sweep_grid_lockstep
    from pnp_svrg_tpu_torch.tuning.tpe import Choice, LogUniform, Uniform
    from pnp_svrg_tpu_torch.utils.io import load_image, set12_paths

    dev = resolve_device("cpu" if args.cpu else None)
    den_factories = {
        "tv": lambda d: TVDenoiser(sigma_modifier=d),
        "nlm": lambda d: NLMDenoiser(sigma_modifier=d),
        "bm3d": lambda d: BM3DDenoiser(
            sigma_modifier=d, params=BM3DParams(search=args.search)
        ),
    }
    # Per-problem eta decades (the gradient scales differ by ~10 decades:
    # Hessian norms L~2.3e-10 for the "Minimal" deblur kernel vs O(1) for PR).
    eta_space = {
        "csmri": LogUniform(1e0, 3e4),
        "deblur": LogUniform(1e6, 1e10),
        "pr": LogUniform(1e-3, 1.0),
    }

    def make_problem(prob_name, seed, path, ratio):
        gen = torch.Generator(device=dev).manual_seed(seed)
        if prob_name == "csmri":
            img = load_image(path, args.size, args.size)
            return make_csmri(img, gen, sample_prob=ratio, snr=args.snr, device=dev)
        if prob_name == "deblur":
            img = load_image(path, args.size, args.size)
            return make_deblur(img, gen, kernel="Minimal",
                               scale_percent=int(round(ratio * 100)), snr=args.snr, device=dev)
        img = load_image(path, 32, 32)
        return make_phase_retrieval(img, gen, num_meas=int(round(ratio * 10 * 32 * 32)),
                                    snr=args.snr, device=dev)

    def space_for(prob_name, algo, m):
        # The integer hyperparameters are coarse Choices so a lockstep round
        # shares them (the reference searches them continuously via hyperopt).
        if args.mb_opts:
            mb_opts = [v for v in args.mb_opts if v <= 0.8 * m] or [
                min(args.mb_opts)
            ]
        else:
            mb_opts = sorted({max(50, int(f * m)) for f in (0.15, 0.3, 0.6)})
        space = {
            "eta": eta_space[prob_name],
            "dstrength": Uniform(0.3, 2.0),
        }
        if algo in ("sgd", "svrg", "saga", "sarah"):
            space["mini_batch_size"] = Choice(mb_opts)
        if algo in ("svrg", "sarah"):
            space["t2"] = Choice(list(args.t2_opts))
        if algo == "saga":
            space["hist_size"] = Choice(list(args.hist_opts))
        return space

    cells = []
    for prob_name in args.problems:
        for i, path in enumerate(set12_paths()[: args.images]):
            for ratio in args.ratios:
                prob = make_problem(prob_name, i, path, ratio)
                for algo in args.algos:
                    for dname in args.denoisers:
                        cells.append({
                            "problem": prob,
                            "algo": algo,
                            "denoiser_factory": den_factories[dname],
                            "problem_name": prob_name,
                            "denoiser_name": dname,
                            "image": path.name,
                            "ratio": ratio,
                            "snr": args.snr,
                            "seed": i,
                            "space": space_for(prob_name, algo, prob.m),
                        })
    if args.sequential:
        results = sweep_grid(
            cells, max_evals=args.max_evals, n_iters=args.n_iters,
            csv_path=args.out, trial_batch=args.trial_batch,
        )
    else:
        results = sweep_grid_lockstep(
            cells, max_evals=args.max_evals, n_iters=args.n_iters,
            cand_per_round=args.cand, max_lanes=args.max_lanes,
            csv_path=args.out,
        )
    print(f"wrote {len(results)} cells to {args.out}")
    return results


if __name__ == "__main__":
    main()
