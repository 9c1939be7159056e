"""Device ms per image-iteration of the records launched outside the
denoiser calls: the gradients, the update, the noise estimate and the
loop's bookkeeping."""


def read(t):
    return t.other_s * 1e3 / t.iters
