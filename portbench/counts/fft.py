"""FFT operations at the customary 5 N log2 N for a complex transform of N points."""

import math


def fft2_flops(h: int, w: int) -> float:
    n = h * w
    return 5.0 * n * math.log2(n)
