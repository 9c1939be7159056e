"""Readings that set a cell's correctness limits: the program's and the
control's, seed by seed, in one process.

    python3 portbench/control.py --workload csmri_bm3d.gd_b13 --seeds 11 12 13

For each seed: the cell's inputs, the reconstructions the check samples
(each seeded as in a run, nothing else of the window), and the check's
numbers for the program and for the control, the reference one precision
step lower in the program's place (``check.py``). One JSON line a seed. The
benchmark's own runs never run the control."""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, device: str) -> dict:
    import torch

    from portbench import check, harness

    run = harness.Run(cell, seed, device, False)
    run.warm_up()
    t0 = time.perf_counter()
    for idx in sorted(run.plan):
        run.reconstruct(idx, False)
    run.sync()
    run.reconstructions = max(run.plan) + 1
    recon_s = time.perf_counter() - t0
    caps, missing = run.captures()
    refs, inputs = harness._free_program(run)
    t0 = time.perf_counter()
    rs = [check.round_readings(refs, inputs, cell.traffic, run._eta(torch.float64), c, control=True) for c in caps]
    run.sync()
    return {"seed": seed, "rounds": [(c["recon"], c["index"]) for c in caps],
            "program": {n: max(r[n] for r in rs) for n in check.NAMES},
            "control": {n: min(r["control"][n] for r in rs) for n in check.NAMES},
            "faults": [f for r in rs for f in r["faults"]] + missing + run.answer_faults + run.errors,
            "failed": run.failed, "reconstructions_s": recon_s, "check_s": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import spec

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    import pnp_svrg_tpu_torch.device  # noqa: F401

    cell = spec.cell(args.workload, ROOT)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
