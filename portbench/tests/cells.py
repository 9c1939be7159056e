"""Tiny cells for the CPU tests: a checkout-like root holding the real
``BENCHMARK.json`` and data files plus small cells of the real
configuration (32 px, two lanes), each held to the real cell's limits: the
real cell's loop (PnP-GD, three rounds of two steps) and PnP-SVRG (three
outer rounds of two steps, the program's sampler drawing 100), which drives
the harness's capture of the program's minibatches. The program's kernel
wrappers take their plain versions on CPU tensors."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

from portbench import harness, spec

REPO = Path(__file__).resolve().parents[2]
REAL = "csmri_bm3d.gd_b13"
TINY = {  # cell -> what its traffic changes in the real cell's
    "tiny_csmri.gd": {"n_iters": 6, "check": {"reconstructions": 2, "among_first": 3, "steps": 2}},
    "tiny_csmri.svrg": {"algo": "svrg", "n_outer": 3, "t2": 2, "mini_batch_size": 100},
}


def make_root(tmp: Path) -> Path:
    """A root with the benchmark's files, ``data`` linked, and the tiny
    cells added as new files and entries."""
    (tmp / "portbench").mkdir(parents=True)
    for part in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(REPO / "portbench" / part, tmp / "portbench" / part)
    (tmp / "data").symlink_to(REPO / "data")
    bench = spec.benchmark(REPO)
    real = spec.cell(REAL, REPO)
    cfg = dict(real.config, size=32, bm3d=dict(real.config["bm3d"], search=3))
    (tmp / "portbench" / "configs" / "tiny_csmri.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny_csmri", "source": "a test", "file": "portbench/configs/tiny_csmri.json",
                             "reduced": ["size"], "why": "a test"})
    for name, change in TINY.items():
        traffic = name.split(".")[1]
        t = dict(real.traffic, lanes=real.traffic["lanes"][:2]) | change
        (tmp / "portbench" / "traffic" / f"tiny_{traffic}.json").write_text(json.dumps(t))
        shutil.copy(REPO / "portbench" / "limits" / f"{REAL}.json", tmp / "portbench" / "limits" / f"{name}.json")
        bench["workloads"].append({"name": name, "config": "tiny_csmri", "traffic": f"tiny_{traffic}", "chips": 1,
                                   "why": "a test"})
        for m in bench["per_layer"] + bench["end_to_end"]:
            if REAL in m.get("workloads", ()):
                m["workloads"].append(name)
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run(root: Path, name: str, seed: int = 2**40 + 3, seconds: float = 0.0) -> dict:
    """One run of a tiny cell on the CPU, the harness's look for a card skipped."""
    import pnp_svrg_tpu_torch.device  # noqa: F401

    return harness.run_cell(spec.cell(name, root), seed, seconds, False, "cpu", time.perf_counter())
