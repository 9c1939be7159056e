"""The port stands alone: neither ``pnp_svrg_tpu_torch`` (its scripts under
``examples/`` included) nor ``chip_smoke.py`` imports jax, flax, anything of
the JAX package ``pnp_svrg_tpu`` or the repository's ``tools/``."""

from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "pnp_svrg_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "pnp_svrg_tpu", "tools")


def test_importing_the_port_and_chip_smoke_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'pnp_svrg_tpu', 'tools'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_jax_or_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            names = [a.value for a in node.args[:1] if isinstance(a, ast.Constant)]
        else:
            continue
        assert not any(_forbidden(n) for n in names), f"{path}:{node.lineno} imports {names}"


def test_the_scan_covers_every_slice_module():
    """The scans above take every module of the port; these are the ones
    each slice added, so a module moved out of the package shows here."""
    scanned = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for rel in ("algorithms/loops.py", "convert.py", "core/batched.py", "denoisers/bm3d.py",
                "denoisers/nlm.py", "denoisers/tv.py", "denoisers/dncnn.py", "models/dncnn.py",
                "models/convert.py", "problems/pr.py", "problems/deblur.py", "problems/csmri.py",
                "algorithms/compat.py", "core/checks.py", "tuning/tpe.py", "tuning/sweep.py",
                "utils/profiling.py", "examples/sweep_sampratio.py", "examples/sweep_snr.py",
                "examples/tune_set12.py", "examples/tune_csmri_nlm.py", "examples/tune_deblur.py",
                "examples/tune_pr.py", "models/spectral_norm.py", "training/__init__.py",
                "training/data.py", "training/utils.py", "training/checkpoint.py",
                "training/train_dncnn.py", "examples/train_realsn.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/meas.py", "parallel/sharded.py",
                "parallel/spatial.py", "parallel/runner.py", "parallel/dryrun.py",
                "examples/scaling.py", "utils/__init__.py", "utils/config.py", "utils/log.py",
                "utils/viz.py", "utils/io.py", "examples/paper_csmri.py", "examples/paper_deblur.py",
                "examples/paper_pr.py", "examples/pnp_csmri_demo.py", "examples/rgb_csmri.py",
                "examples/check_realsn_export.py", "ops/__init__.py", "problems/__init__.py"):
        assert f"pnp_svrg_tpu_torch/{rel}" in scanned, rel
    assert "chip_smoke.py" in scanned
