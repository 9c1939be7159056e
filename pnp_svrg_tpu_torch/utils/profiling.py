"""Timing fences for host-side wall-clock timing.

Port of ``scalar_fence`` from ``pnp_svrg_tpu/utils/profiling.py``. PyTorch
returns from a CUDA call before the device has finished it, so a host clock
read after the call measures only the enqueue; :func:`fence` waits for the
device first.
"""

from __future__ import annotations

import torch


def fence(x: torch.Tensor) -> None:
    """Wait until the device holding ``x`` has finished all queued work
    (``torch.cuda.synchronize``); nothing to wait for on the CPU."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)
