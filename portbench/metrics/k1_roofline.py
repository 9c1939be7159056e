"""K1 (block matching): its least time by the frozen bound (the valid
(block, offset) pairs in the separable form at the float32 peak, both
stages' group sizes) over its device time, in %. Nothing where no K1 ran."""

from portbench.counts.bm3d import k1_bound_ms


def read(t):
    if not t.k1_calls or not t.k1_s:
        return None
    p = t.cell.config["bm3d"]
    per_denoise = k1_bound_ms(t.cell.config, t.lanes, p["group_ht"]) + k1_bound_ms(t.cell.config, t.lanes,
                                                                                   p["group_wie"])
    if t.k1_calls != 2 * t.denoiser_calls:
        raise RuntimeError(f"K1 ran {t.k1_calls} times in {t.denoiser_calls} two-stage denoiser calls")
    return 100.0 * t.denoiser_calls * per_denoise / 1e3 / t.k1_s
