"""The distributed layer: meshes, measurement- and row-sharded loops, the
sharded phase retrieval step and the batch runner.

Port of ``pnp_svrg_tpu/parallel/``. A mesh has two axes:

* ``batch``: data parallel over images (the reference's process pool);
* ``meas``: the measurements split (PR's A rows, CSMRI's mask rows,
  Deblur's pixels), partial gradients summed over the axis; or
* ``spatial``: the denoise step's rows split, with halo rows.

Axes are ``torch.distributed`` groups of one process a rank, or emulated
in one process on a leading tensor axis (``parallel/mesh.py``). The port's
problems are natively batched, so there is no ``BatchedProblem``:
``stack_problems`` makes a batch.
"""

from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.parallel.meas import (
    MeasShardedBatched,
    run_batch_meas_emulated,
    run_batch_meas_sharded,
    split_meas,
)
from pnp_svrg_tpu_torch.parallel.mesh import (
    BATCH_AXIS,
    MEAS_AXIS,
    SPATIAL_AXIS,
    GroupAxis,
    LocalAxis,
    Mesh,
    init_distributed,
    make_mesh,
    make_spatial_mesh,
)
from pnp_svrg_tpu_torch.parallel.runner import reconstruct_set12, run_batch
from pnp_svrg_tpu_torch.parallel.sharded import pr_grad_full_sharded, shard_pr_problem, sharded_pnp_step
from pnp_svrg_tpu_torch.parallel.spatial import (
    SpatialTiledDenoiser,
    bm3d_denoise_spatial,
    denoise_spatial,
    nlm_denoise_spatial,
    run_batch_spatial,
)

__all__ = [
    "make_mesh",
    "make_spatial_mesh",
    "init_distributed",
    "Mesh",
    "LocalAxis",
    "GroupAxis",
    "BATCH_AXIS",
    "MEAS_AXIS",
    "SPATIAL_AXIS",
    "stack_problems",
    "run_batch",
    "reconstruct_set12",
    "shard_pr_problem",
    "pr_grad_full_sharded",
    "sharded_pnp_step",
    "split_meas",
    "MeasShardedBatched",
    "run_batch_meas_sharded",
    "run_batch_meas_emulated",
    "denoise_spatial",
    "nlm_denoise_spatial",
    "bm3d_denoise_spatial",
    "SpatialTiledDenoiser",
    "run_batch_spatial",
]
