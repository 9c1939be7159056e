"""The plain reference against the program at a tiny size on the CPU, where
the program's kernel wrappers take their plain versions: the noise
estimate, BM3D in both match modes, the CS-MRI gradients on the program's
own minibatches, and the minibatch check."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DParams, bm3d_denoise_batch
from pnp_svrg_tpu_torch.ops.sigma import estimate_sigma
from portbench import spec
from portbench.problems import csmri as cs_inputs
from portbench.reference import bm3d, csmri, sigma
from portbench.tests.cells import REAL, REPO, make_root


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _images(b=2, n=32, seed=0):
    rng = np.random.default_rng(seed)
    clean = np.clip(np.cumsum(rng.normal(size=(b, n, n)), -1) / 10 + 0.5, 0, 1)
    return torch.tensor(clean + rng.normal(scale=0.05, size=clean.shape), dtype=torch.float32)


def test_noise_estimate_bit_for_bit():
    x = _images(3, 48)
    assert torch.equal(sigma.estimate_sigma(x), estimate_sigma(x))


@pytest.mark.parametrize("match_dtype", ["bfloat16", "float32"])
def test_bm3d_against_the_programs_plain_path(match_dtype):
    cfg = dict(spec.cell(REAL, REPO).config["bm3d"], search=4, match_dtype=match_dtype)
    x = _images()
    sig = torch.tensor([0.05, 0.08])
    s = bm3d.Setup(cfg, 32, 32, "cpu")
    got = bm3d.denoise(s, x, sig)
    want = bm3d_denoise_batch(x, sig, BM3DParams(**cfg))
    assert torch.allclose(got, want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


def _rel(a, b):
    return float(torch.linalg.vector_norm(a.double() - b.double()) / torch.linalg.vector_norm(b.double()))


def test_csmri_gradients(root):
    cell = spec.cell("tiny_csmri.svrg", root)
    inp = cs_inputs.make_inputs(cell.config, cell.traffic, 5, torch.device("cpu"), root)
    prob = cs_inputs.program_problem(inp)
    z = inp["x_init"].reshape(2, -1)
    mb = prob.select_mb(torch.Generator().manual_seed(1), cell.traffic["mini_batch_size"])
    assert csmri.minibatch_fault(inp, mb, cell.traffic["mini_batch_size"]) is None
    assert _rel(prob.grad_full(z).reshape(2, -1), csmri.grad_full(inp, z)) < 1e-5
    assert _rel(prob.grad_stoch(z, mb).reshape(2, -1), csmri.grad_stoch(inp, z, mb)) < 1e-5


def test_a_minibatch_of_another_size_is_a_fault(root):
    cell = spec.cell("tiny_csmri.svrg", root)
    inp = cs_inputs.make_inputs(cell.config, cell.traffic, 5, torch.device("cpu"), root)
    mb = cs_inputs.program_problem(inp).select_mb(torch.Generator().manual_seed(1), cell.traffic["mini_batch_size"])
    extra = mb.clone().reshape(2, -1)
    extra[0, torch.nonzero((inp["mask"].reshape(2, -1)[0] > 0) & (extra[0] == 0))[0]] = 1.0
    assert "sizes" in csmri.minibatch_fault(inp, extra.reshape(mb.shape), cell.traffic["mini_batch_size"])
