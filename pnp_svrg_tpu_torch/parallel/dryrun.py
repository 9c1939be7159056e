"""Multi-rank dry run of the distributed layer.

The counterpart of ``dryrun_multichip`` in ``__graft_entry__.py:39``: on an
(n/2, 2) (batch, meas) mesh of ``n`` ranks (or (n, 1) for odd n) it runs

1. ``pnp_svrg`` + BM3D on 32 px CSMRI lanes, 2 a batch shard, the
   snapshots and stochastic gradients psummed over meas;
2. the headline program's per-lane geometry: 128 px CSMRI + BM3D (block 8,
   search 8), one outer round of one inner step, one lane a batch shard;
3. ``pnp_saga`` with its table sharded over meas (2 slots a shard);
4. with an even ``n``: ``pnp_svrg`` + NLM with the denoise step row-sharded
   over a (n/2, 2) (batch, spatial) mesh;
5. the dp x mp phase retrieval step (A's rows over meas).

BM3D runs with the 8 x 8 blocks the port's block-matching kernel is built
for (the JAX dry run takes 4 x 4 at 32 px). Call it in every rank of a
process group of ``n`` ranks (``init_distributed``), or with ``n = 1``
alone; ``python -m pnp_svrg_tpu_torch.parallel.dryrun --world-size 2
[--cpu]`` spawns the ranks over gloo.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.parallel.mesh import make_mesh, make_spatial_mesh, spawn, world_size
from pnp_svrg_tpu_torch.parallel.runner import run_batch
from pnp_svrg_tpu_torch.parallel.sharded import shard_pr_problem, sharded_pnp_step
from pnp_svrg_tpu_torch.problems.csmri import make_csmri
from pnp_svrg_tpu_torch.problems.pr import PhaseRetrieval


def _csmri_batch(h: int, count: int, roll: int, seed: int, device) -> object:
    xx, yy = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, h))
    base = (np.sin(5 * xx) * np.cos(4 * yy) * 0.4 + 0.5).astype(np.float32)
    gen = torch.Generator(device=device).manual_seed(seed)
    return stack_problems([make_csmri(np.roll(base, roll * i, axis=0), gen, 0.5, snr=10,
                                      device=device) for i in range(count)])


def _finite(out: dict, shape: tuple, what: str) -> list:
    psnr = out["final_psnr"].cpu().numpy()
    if tuple(out["z"].shape) != shape or not np.isfinite(psnr).all():
        raise RuntimeError(f"dryrun {what}: z {tuple(out['z'].shape)} (want {shape}), psnr {psnr}")
    return [float(v) for v in psnr]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the five programs above on this rank; returns their final PSNRs
    (every rank returns the whole batch's)."""
    if world_size() != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) needs a process group of {n_devices} "
                         f"ranks, not {world_size()}")
    shape = (n_devices // 2, 2) if n_devices % 2 == 0 else (n_devices, 1)
    mesh = make_mesh(shape, device=device)
    dev = mesh.device
    b_shard, m_shard = shape
    h = 32
    bsz = 2 * b_shard
    batched = _csmri_batch(h, bsz, 3, 0, dev)
    den = BM3DDenoiser(sigma_modifier=1.0, params=BM3DParams(search=4))
    res = {"mesh": list(shape)}
    out = run_batch("svrg", batched, den, seed=1, mesh=mesh, eta=100.0, n_outer=2, t2=2,
                    mini_batch_size=64 * m_shard)
    res["svrg_bm3d"] = _finite(out, (bsz, h * h), "pnp_svrg + BM3D")

    flagship = _csmri_batch(128, b_shard, 7, 7, dev)
    out = run_batch("svrg", flagship, BM3DDenoiser(sigma_modifier=1.0, params=BM3DParams(search=8)),
                    seed=8, mesh=mesh, eta=6000.0, n_outer=1, t2=1, mini_batch_size=2000 * m_shard)
    res["flagship_shape"] = _finite(out, (b_shard, 128 * 128), "128 px flagship shape")

    out = run_batch("saga", batched, den, seed=1, mesh=mesh, eta=100.0, n_iters=4,
                    mini_batch_size=64 * m_shard, hist_size=2 * m_shard, table_axis="meas",
                    table_shards=m_shard)
    res["saga_sharded_table"] = _finite(out, (bsz, h * h), "pnp_saga sharded table")

    if n_devices % 2 == 0 and n_devices > 1:
        out = run_batch("svrg", batched, NLMDenoiser(sigma_modifier=1.0), seed=1, image_shards=2,
                        mesh=make_spatial_mesh((n_devices // 2, 2), device=device), eta=100.0,
                        n_outer=2, t2=2, mini_batch_size=64)
        res["spatial_nlm"] = _finite(out, (bsz, h * h), "spatial NLM")

    n, m = h * h, 128 * m_shard
    gen = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn((bsz, m, n), generator=gen, device=dev)
    x = torch.rand((bsz, h, h), generator=gen, device=dev)
    y = torch.matmul(a, x.reshape(bsz, n, 1))[..., 0].abs()
    y = y + 0.01 * torch.randn((bsz, m), generator=gen, device=dev)
    z0 = torch.rand((bsz, h, h), generator=gen, device=dev)
    zeros = torch.zeros(bsz, device=dev)
    pr = PhaseRetrieval(a=a, y=y, x=x, x_init=z0, snr=zeros, sigma=zeros)
    shards = shard_pr_problem(pr, mesh)
    z1, psnr = sharded_pnp_step(mesh, TVDenoiser(sigma_modifier=1.0), eta=0.05)(
        shards, shards[0].x_init.reshape(shards[0].batch_size, n))
    res["pr_spmd_step"] = _finite({"z": z1, "final_psnr": psnr}, (bsz, n), "PR SPMD step")
    return res


def _rank(rank: int, n: int, device) -> dict:
    return dryrun_multichip(n, device)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--world-size", type=int, default=2)
    parser.add_argument("--backend", default="gloo")
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args(argv)
    device = "cpu" if args.cpu else None
    results = spawn(_rank, args.world_size, args.backend, (args.world_size, device), 600.0)
    print(json.dumps({"dryrun_multichip": args.world_size, "rank0": results[0]}))


if __name__ == "__main__":
    main()
