"""The reading of a profiled reconstruction, on a made-up record list: the
records taken in launch order, the opening marker left out, the denoiser's
records told apart by its markers, K1 and K2 counted against the program's
launch counters, and the metric readers on the result."""

from __future__ import annotations

from types import SimpleNamespace

import pytest
from torch.autograd import DeviceType

from portbench import harness, spec
from portbench.tests.cells import REPO

US = 1000  # ns


class Event:
    def __init__(self, corr, start, dur, name, device=DeviceType.CUDA):
        self.corr, self.start, self.dur, self.nm, self.dev = corr, start, dur, name, device

    def correlation_id(self):
        return self.corr

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.dur

    def name(self):
        return self.nm

    def device_type(self):
        return self.dev

    def is_user_annotation(self):
        return False


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=SimpleNamespace(events=lambda: events)))


def _events(lose_marker=False, misplace=False):
    """Idle marker; a gradient kernel; a denoiser call (marker, K1, K2 tiles
    and fold, marker); a copy to pinned memory; the readback."""
    seq = [("spin_kernel", 2), ("fft_kernel", 10), ("spin_kernel", 2), ("bm3d_match_tile_kernel<1, 1>", 30),
           ("bm3d_aggregate_kernel<8, 16>", 20), ("bm3d_aggregate_fold_kernel", 5), ("spin_kernel", 2),
           ("Memcpy DtoH (Device -> Pinned)", 4), ("Memcpy DtoH (Device -> Pageable)", 6)]
    out, t = [], 0
    for corr, (name, dur) in enumerate(seq, start=100):
        t += 30_000 * US if corr == 101 else 3 * US  # the 20 ms pause after the idle marker, then 3 us gaps
        out.append(Event(corr, t, dur * US, name))
        t += dur * US
    out.append(Event(7, 0, 50_000 * US, harness.RECONSTRUCTION, DeviceType.CPU))
    if lose_marker:
        out.pop(0)
    if misplace:
        out[3].start -= 100 * US
    return out[::-1]  # the profiler's order is not the launch order


def test_records_are_attributed_in_launch_order():
    rec = harness.read_profile(_profile(_events()), {"bm3d_match": 1, "bm3d_aggregate": 1}, 1, wall_s=0.001)
    assert rec["complete"], rec["counts"]
    assert rec["counts"]["records"] == 5 and rec["counts"]["markers"] == 2
    assert rec["denoise_s"] == pytest.approx(55e-6) and rec["other_s"] == pytest.approx(16e-6)
    assert rec["k1_s"] == pytest.approx(30e-6) and rec["k2_s"] == pytest.approx(25e-6)
    assert rec["busy_s"] == pytest.approx(71e-6)
    labels = [g[0] for g in rec["gaps"]]
    assert labels.count("denoise") == 4 and "readback" in labels and labels[-1] == "host launch and return"


def test_a_lost_opening_marker_is_no_loss():
    rec = harness.read_profile(_profile(_events(lose_marker=True)), {"bm3d_match": 1, "bm3d_aggregate": 1}, 1, 0.001)
    assert rec["complete"]


@pytest.mark.parametrize("calls, misplace", [({"bm3d_match": 2, "bm3d_aggregate": 1}, False),
                                             ({"bm3d_match": 1, "bm3d_aggregate": 2}, False),
                                             ({"bm3d_match": 1, "bm3d_aggregate": 1}, True)])
def test_lost_or_misplaced_records_make_a_profile_incomplete(calls, misplace):
    assert not harness.read_profile(_profile(_events(misplace=misplace)), calls, 1, 0.001)["complete"]


def test_the_readers_on_a_summary():
    cell = spec.cell("csmri_bm3d.gd_b13", REPO)
    rec = harness.read_profile(_profile(_events()), {"bm3d_match": 2, "bm3d_aggregate": 2}, 1, 0.001)
    t = SimpleNamespace(cell=cell, lanes=13, reconstructions=1, iters=100, denoiser_calls=1, records=5,
                        wall_s=0.001, busy_s=rec["busy_s"], denoise_s=rec["denoise_s"], other_s=rec["other_s"],
                        k1_s=30e-3, k2_s=0.25e-3, k1_calls=2, k2_calls=2, by_name=rec["by_name"], rate=1000.0,
                        gaps=rec["gaps"])
    read = {m["name"]: spec.metric_reader(m["name"], REPO).read(t) for m in cell.per_layer}
    assert read["launches_per_iter"] == pytest.approx(0.05)
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 71e-6 / 1e-3))
    assert read["k1_roofline"] == pytest.approx(100 * 2 * 0.0199686 / 30, rel=1e-4)
    assert 0 < read["k2_roofline"] < 100 and 0 < read["step_mfu"] < 100
    t.k1_calls = t.k1_s = 0
    assert spec.metric_reader("k1_roofline", REPO).read(t) is None
