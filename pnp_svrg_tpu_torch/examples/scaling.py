"""Scaling harness: batched CSMRI + PnP-SVRG + BM3D throughput against the
width of the data-parallel (batch) axis.

Port of ``examples/scaling.py``. For each width ``d`` of ``--devices`` the
first ``d`` ranks run ``--images-per-device`` Set12 CSMRI lanes of
``--size`` px each, together one ``run_batch("svrg", ...)`` over a (d, 1)
mesh; rank 0 prints one JSON line a width:

    {"devices": d, "ranks": d, "cards": c, "batch": B, "images_per_sec": ...,
     "image_iters_per_sec": ..., "wall_s": ..., "mean_psnr": ...}

``cards`` is the number of distinct cards those ranks use: ranks beyond the
cards share them (gloo), which measures the collectives' cost, not scaling.

    python -m pnp_svrg_tpu_torch.examples.scaling --devices 1 --size 64
    python -m pnp_svrg_tpu_torch.examples.scaling --world-size 2 --devices 1 2
    torchrun --nproc-per-node 2 -m pnp_svrg_tpu_torch.examples.scaling --devices 1 2

``--world-size N`` spawns N ranks itself over ``--backend`` (gloo by
default: it lets ranks share a card; nccl needs one card a rank); under
``torchrun`` the ranks come from its environment. ``--cpu`` runs on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

SPAWN_TIMEOUT_S = 1800.0  # the spawned ranks' limit, process group included


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true")
    parser.add_argument("--devices", type=int, nargs="+", default=[1])
    parser.add_argument("--images-per-device", type=int, default=2)
    parser.add_argument("--size", type=int, default=64)
    parser.add_argument("--n-outer", type=int, default=4)
    parser.add_argument("--t2", type=int, default=10)
    parser.add_argument("--eta", type=float, default=1500.0)
    parser.add_argument("--mb", type=int, default=1000)
    parser.add_argument("--search", type=int, default=6)
    parser.add_argument("--world-size", type=int, default=None,
                        help="spawn this many ranks (default: torchrun's, else 1)")
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--out", default=None,
                        help="optional JSON artifact path (adds the weak-scaling "
                             "efficiency against the first row)")
    parser.add_argument("--overhead-baseline", action="store_true",
                        help="also time each total batch unsharded on rank 0's card "
                             "and report t_sharded / t_unsharded")
    return parser


def _batch_mesh(d: int, device):
    """A (d, 1) mesh over ranks 0..d-1 (every rank must call this), or None
    on a rank outside it."""
    import torch.distributed as dist

    from pnp_svrg_tpu_torch.parallel.mesh import (
        BATCH_AXIS, MEAS_AXIS, GroupAxis, LocalAxis, Mesh, rank_device, world_size)

    names = (BATCH_AXIS, MEAS_AXIS)
    group = dist.new_group(list(range(d))) if d > 1 else None  # a collective call
    if world_size() > 1 and dist.get_rank() >= d:
        return None
    axis = GroupAxis(BATCH_AXIS, group) if group is not None else LocalAxis(BATCH_AXIS, 1)
    return Mesh(names, {BATCH_AXIS: d, MEAS_AXIS: 1},
                {BATCH_AXIS: axis, MEAS_AXIS: LocalAxis(MEAS_AXIS, 1)}, rank_device(device))


def run(rank: int, args) -> list:
    """The sweep on this rank; returns rank 0's rows (others return [])."""
    import torch
    import torch.distributed as dist

    from pnp_svrg_tpu_torch.core.batched import stack_problems
    from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
    from pnp_svrg_tpu_torch.parallel import run_batch
    from pnp_svrg_tpu_torch.parallel.meas import lane_seed
    from pnp_svrg_tpu_torch.parallel.mesh import world_size
    from pnp_svrg_tpu_torch.problems.csmri import make_csmri
    from pnp_svrg_tpu_torch.utils.io import load_image, set12_paths

    device = "cpu" if args.cpu else None
    world = world_size()
    den = BM3DDenoiser(sigma_modifier=1.0, params=BM3DParams(search=args.search))
    paths = set12_paths()
    iters = args.n_outer * (args.t2 + 1)
    rows = []
    for d in args.devices:
        if d > world:
            if rank == 0:
                print(json.dumps({"devices": d, "skipped": "not enough ranks"}), flush=True)
            continue
        mesh = _batch_mesh(d, device)
        if mesh is None:
            if world > 1:
                dist.barrier()
            continue
        dev = mesh.device
        bsz = d * args.images_per_device
        problems = [make_csmri(load_image(paths[i % len(paths)], args.size, args.size),
                               torch.Generator(device=dev).manual_seed(lane_seed(0, 0, i)),
                               0.5, snr=10, device=dev) for i in range(bsz)]
        batched = stack_problems(problems)

        def sync():
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)

        def timed(use_mesh):
            kw = dict(seed=1, eta=args.eta, n_outer=args.n_outer, t2=args.t2,
                      mini_batch_size=args.mb)
            run_batch("svrg", batched, den, mesh=use_mesh, **kw)  # warm-up: kernel builds, caches
            sync()
            t0 = time.perf_counter()
            out = run_batch("svrg", batched, den, mesh=use_mesh, **kw)
            psnr = out["final_psnr"].cpu().numpy()  # the copy to the host waits for the device
            return time.perf_counter() - t0, psnr

        dt, psnr = timed(mesh)
        cards = d if dev.type != "cuda" else min(d, torch.cuda.device_count())
        row = {"devices": d, "ranks": d, "cards": cards, "batch": bsz,
               "images_per_sec": bsz / dt, "image_iters_per_sec": bsz * iters / dt,
               "wall_s": dt, "mean_psnr": float(psnr.mean()),
               "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
        if args.overhead_baseline and rank == 0:
            dt0, _ = timed(None)
            row["unsharded_wall_s"] = dt0
            row["sharding_overhead"] = dt / dt0
        if world > 1:
            dist.barrier()
        if rank == 0:
            rows.append(row)
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> list:
    args = _parser().parse_args(argv)
    from pnp_svrg_tpu_torch.parallel.mesh import init_distributed, spawn

    if args.world_size and args.world_size > 1:
        rows = spawn(run, args.world_size, args.backend, (args,), SPAWN_TIMEOUT_S)[0]
    else:
        init_distributed(args.backend)
        import torch.distributed as dist

        rows = run(dist.get_rank() if dist.is_initialized() else 0, args)
    if args.out and rows:
        base = rows[0]["image_iters_per_sec"] / rows[0]["devices"]
        for row in rows:
            # weak-scaling efficiency: throughput a rank against the first row's
            row["weak_scaling_efficiency"] = row["image_iters_per_sec"] / row["devices"] / base
        record = {
            "program": (f"run_batch svrg+BM3D(search={args.search}), {args.images_per_device} x "
                        f"{args.size}^2 CSMRI images a rank, {args.n_outer}x({args.t2}+1) iters, "
                        "mesh (d, 1) batch axis"),
            "rows": rows,
        }
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.out}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
