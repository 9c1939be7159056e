"""The module check that ends every run, and the reference's independence
from the program."""

from __future__ import annotations

import ast
import subprocess
import sys

from portbench.harness import forbidden_modules
from portbench.tests.cells import REPO


def test_the_check_compares_whole_top_level_names():
    assert forbidden_modules(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "pnp_svrg_tpu",
                              "pnp_svrg_tpu.ops"]) == sorted(["jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                                                              "pnp_svrg_tpu", "pnp_svrg_tpu.ops"])
    assert forbidden_modules(["pnp_svrg_tpu_torch", "pnp_svrg_tpu_torch.ops.cuda", "jaxtyping", "numpy"]) == []


def _imports(path) -> list:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    files = sorted((REPO / "portbench" / "reference").glob("*.py")) + sorted(
        (REPO / "portbench" / "counts").glob("*.py")) + [REPO / "portbench" / "check.py"]
    for path in files:
        for name in _imports(path):
            assert name.split(".")[0] not in ("pnp_svrg_tpu_torch", "pnp_svrg_tpu", "jax", "jaxlib", "flax"), (path, name)


def test_no_file_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in sorted((REPO / "portbench").rglob("*.py")):
        for name in _imports(path):
            assert name.split(".")[0] not in ("pnp_svrg_tpu", "jax", "jaxlib", "flax", "chip_smoke", "bench"), (path, name)


def test_loading_the_harness_and_the_reference_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.');"
            "import portbench.harness, portbench.control, portbench.check;"
            "import portbench.reference.bm3d, portbench.reference.csmri, portbench.reference.gd,"
            " portbench.reference.svrg, portbench.reference.sigma;"
            "import portbench.problems.csmri, portbench.denoisers.bm3d, portbench.loops.gd, portbench.loops.svrg;"
            "from portbench.harness import forbidden_modules;"
            "ref = [m for m in sys.modules if m.split('.')[0] == 'pnp_svrg_tpu_torch'];"
            "print(forbidden_modules(), ref); sys.exit(1 if forbidden_modules() or ref else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_a_run_without_a_card_prints_no_result():
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "csmri_bm3d.gd_b13", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""
