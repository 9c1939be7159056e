"""Run one cell of the benchmark once and print one result line.

    python3 portbench/run.py --workload csmri_bm3d.gd_b13 --seed 7 --seconds 10 --trace 0

From the root of a checkout on a machine with the cell's CUDA cards. Loads,
warms up, measures for ``--seconds`` (``--trace 1``: the per-layer metrics
from profiled reconstructions instead of the end-to-end ones), checks the
window's outputs against the plain reference and prints, as the last line
of standard output, ``{"correct", "attempted", "failed", "metrics",
"device", ["breakdown",] "checks"}``; the numbers compared, each beside its
limit, are also the last lines of standard error. Exits non-zero, printing
no result, without enough CUDA cards, or if JAX or the JAX package was
loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "build" / "portbench"  # the CUDA JIT cache, at a fixed path inside the checkout


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda_cache")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    sys.path.insert(0, str(ROOT))
    from portbench import harness, spec

    cell = spec.cell(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA card(s), found {have}", file=sys.stderr)
        return 2
    torch.set_num_threads(2)
    import pnp_svrg_tpu_torch.device  # noqa: F401 - the port's float32 policy: TF32 off, cuDNN deterministic

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    return harness.finish(result)


if __name__ == "__main__":
    sys.exit(main())
