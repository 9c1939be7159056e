"""On the card: the control comes out as not correct, the program as correct,
at each cell's own size on one seed (``control.py``'s readings against the
cell's limits). Skips without a card; run it there as

    python3 -m pytest -q portbench/tests/test_portbench_card.py
"""

from __future__ import annotations

import pytest
import torch

from portbench import spec
from portbench.control import readings
from portbench.tests.cells import REPO


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import pnp_svrg_tpu_torch.device  # noqa: F401
    return "cuda"


@pytest.mark.parametrize("name", [w["name"] for w in spec.benchmark(REPO)["workloads"]])
def test_the_control_fails_and_the_program_passes(cuda, name):
    cell = spec.cell(name, REPO)
    r = readings(cell, 2**33 + 17, cuda)
    limits = cell.limits["limits"]
    assert not r["faults"] and r["failed"] == 0, r
    assert all(r["program"][n] <= limits[n] for n in limits), r
    assert any(r["control"][n] > limits[n] for n in limits), r
