"""The share of the profiled reconstructions' wall time in which no device
record ran: 1 - (union of record intervals) / wall, in %."""


def read(t):
    return 100.0 * (1.0 - t.busy_s / t.wall_s)
