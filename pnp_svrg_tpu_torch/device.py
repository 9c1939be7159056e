"""Device selection and float32 precision policy for the port.

Entry points run on CUDA unless the caller passes ``device="cpu"``. Asked for
CUDA on a machine without it they raise: nothing in the port quietly runs on
the CPU.

Precision: the JAX reference computes in full float32 (its SSIM filter asks
for ``Precision.HIGHEST``, ``pnp_svrg_tpu/ops/metrics.py:61-65``). PyTorch runs
float32 matmuls in full precision by default but lets cuDNN use TF32, so both
switches are turned off when this module is imported.

cuDNN may also pick its convolution algorithm by timing (``benchmark``) and
pick ones that add in a varying order. The CNN denoisers' convolutions run
under PR + SARAH, which turns one ulp into tenths of a dB, so cuDNN is held
to deterministic algorithms: a card run on the same minibatches repeats
itself and can be held to a floor.
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False


def default_device() -> torch.device:
    """The CUDA device; raises when CUDA is missing (pass ``device="cpu"``
    explicitly to run on the CPU)."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> :func:`default_device`; otherwise the named device, which
    must exist."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    return dev
