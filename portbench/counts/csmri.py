"""CS-MRI gradients a lane: a full gradient is one fft2 and one ifft2, and so
is a minibatch gradient (the masks' products are not counted)."""

from portbench.counts.fft import fft2_flops


def full_gradient_flops(cfg: dict) -> float:
    return 2 * fft2_flops(cfg["size"], cfg["size"])


def minibatch_gradient_flops(cfg: dict, traffic: dict) -> float:
    return 2 * fft2_flops(cfg["size"], cfg["size"])
