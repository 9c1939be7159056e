"""Device ms per image-iteration of the records launched inside the denoiser
calls (between the markers the benchmark's denoiser wrapper sets)."""


def read(t):
    return t.denoise_s * 1e3 / t.iters
