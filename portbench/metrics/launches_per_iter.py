"""Device records (kernels, copies, fills; the benchmark's markers left out)
per image-iteration of the profiled reconstructions, whose K1 and K2 records
equal the program's launch counters."""


def read(t):
    return t.records / t.iters
