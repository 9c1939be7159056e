"""The whole step's share of the float32 peak: the operations an
image-iteration needs (``counts/step.py``: the gradients' products and
FFTs, the denoiser's direct convolutions or BM3D's separable transforms and
matching) times the image-iterations/s of the traced run's profiled
reconstructions (over their own wall time), over 67 TFLOP/s, in %."""

from portbench.counts.peaks import F32_FLOPS
from portbench.counts.step import flops_per_iter


def read(t):
    return 100.0 * flops_per_iter(t.cell.config, t.cell.traffic) * t.rate / F32_FLOPS
