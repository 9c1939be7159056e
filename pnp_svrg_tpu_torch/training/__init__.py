"""Denoiser training (patch pipeline, RealSN-DnCNN training, config-guarded
checkpoints): the port of ``pnp_svrg_tpu/training``."""

from pnp_svrg_tpu_torch.training.checkpoint import ConfigMismatch, load_checkpoint, save_checkpoint
from pnp_svrg_tpu_torch.training.train_dncnn import TrainConfig, evaluate, train
from pnp_svrg_tpu_torch.training.utils import (
    adjust_ortho_decay_rate,
    batch_psnr,
    batch_ssim,
    l2_reg_normal_ortho,
    unroll_kernel,
    unroll_kernel_sparse,
)

__all__ = [
    "TrainConfig",
    "train",
    "evaluate",
    "save_checkpoint",
    "load_checkpoint",
    "ConfigMismatch",
    "batch_psnr",
    "batch_ssim",
    "l2_reg_normal_ortho",
    "adjust_ortho_decay_rate",
    "unroll_kernel",
    "unroll_kernel_sparse",
]
