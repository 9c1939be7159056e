"""Host-side utilities: image IO, config, logging, profiling, viz.

The export list of ``pnp_svrg_tpu/utils/__init__.py``, with ``fence`` (the
one-tensor device wait) beside ``scalar_fence``.
"""

from pnp_svrg_tpu_torch.utils.io import load_image, SET12_DIR, REFERENCE_DATA_DIR
from pnp_svrg_tpu_torch.utils.config import (
    Params,
    ExperimentConfig,
    ProblemConfig,
    AlgorithmConfig,
    DenoiserConfig,
    MeshConfig,
    SweepConfig,
)
from pnp_svrg_tpu_torch.utils.log import set_logger
from pnp_svrg_tpu_torch.utils.viz import (
    display_results,
    show_grid,
    gif,
    plot_training_curves,
    reconstruct_rgb,
    summarize_results,
    write_metrics_csv,
)
from pnp_svrg_tpu_torch.utils.profiling import trace, annotate, PhaseTimers, scalar_fence, fence

__all__ = [
    "load_image",
    "SET12_DIR",
    "REFERENCE_DATA_DIR",
    "Params",
    "ExperimentConfig",
    "ProblemConfig",
    "AlgorithmConfig",
    "DenoiserConfig",
    "MeshConfig",
    "SweepConfig",
    "set_logger",
    "display_results",
    "show_grid",
    "gif",
    "plot_training_curves",
    "reconstruct_rgb",
    "summarize_results",
    "write_metrics_csv",
    "trace",
    "annotate",
    "PhaseTimers",
    "scalar_fence",
    "fence",
]
