"""Compare the quality fields of two ``chip_smoke.py`` outputs, bit for bit.

    python -m pnp_svrg_tpu_torch.examples.compare_runs PARENT.txt CHANGE.txt

Each output is read as its JSON lines. A field is a number (or a list of
numbers) under a key one of whose ``_``-separated words names a PSNR, an
SSIM, a trace or a loss (not a profiler group's name, which has spaces, nor
the profiler trace of the utilities' check, a record), at the same path in
the same record: records are matched by their phase and its
occurrence (a phase that runs twice, such as ``profile``, is matched in
order). Prints one JSON object: how many fields both runs have, how many
are equal, the paths of those that differ, and the paths only one run has.
Exits 1 if a field differs.
"""

from __future__ import annotations

import collections
import json
import sys

QUALITY = {"psnr", "ssim", "trace", "loss"}


def is_quality(key, value) -> bool:
    """Whether ``key`` names a quality field (see the module's note)."""
    return not (" " in key or (key == "trace" and isinstance(value, dict))) and bool(
        QUALITY & set(key.lower().split("_")))


def records(path: str) -> dict:
    """(phase, occurrence) -> record, for each JSON line with a ``phase``."""
    seen, out = collections.Counter(), {}
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "phase" in rec:
                out[(rec["phase"], seen[rec["phase"]])] = rec
                seen[rec["phase"]] += 1
    return out


def fields(node, path: str = "", quality: bool = False) -> dict:
    """path -> value of every number, or list of numbers, at or under a
    quality key."""
    if isinstance(node, dict):
        out = {}
        for k, v in node.items():
            out |= fields(v, f"{path}/{k}", quality or is_quality(str(k), v))
        return out
    if isinstance(node, list) and not all(isinstance(v, (int, float)) for v in node):
        out = {}
        for i, v in enumerate(node):
            out |= fields(v, f"{path}[{i}]", quality)
        return out
    return {path: node} if quality and isinstance(node, (int, float, list)) else {}


def main(argv=None) -> int:
    parent, change = (records(p) for p in (argv or sys.argv[1:]))
    a = {f"{k[0]}#{k[1]}{p}": v for k, r in parent.items() for p, v in fields(r).items()}
    b = {f"{k[0]}#{k[1]}{p}": v for k, r in change.items() for p, v in fields(r).items()}
    both = sorted(a.keys() & b.keys())
    differ = [p for p in both if a[p] != b[p]]
    print(json.dumps({"fields": len(both), "equal": len(both) - len(differ), "differ": differ,
                      "only_parent": sorted(a.keys() - b.keys()), "only_change": sorted(b.keys() - a.keys())}))
    return 1 if differ else 0


if __name__ == "__main__":
    raise SystemExit(main())
