"""K2 (aggregation): its least time by the frozen bound (inputs read once
and the two planes written once, at HBM bandwidth; one call a stage at
each stage's group size) over its device time, in %. Nothing where no K2
ran."""

from portbench.counts.bm3d import k2_bound_ms


def read(t):
    if not t.k2_calls or not t.k2_s:
        return None
    p = t.cell.config["bm3d"]
    per_denoise = k2_bound_ms(t.cell.config, t.lanes, p["group_ht"]) + k2_bound_ms(t.cell.config, t.lanes,
                                                                                   p["group_wie"])
    if t.k2_calls != 2 * t.denoiser_calls:
        raise RuntimeError(f"K2 ran {t.k2_calls} times in {t.denoiser_calls} two-stage denoiser calls")
    return 100.0 * t.denoiser_calls * per_denoise / 1e3 / t.k2_s
