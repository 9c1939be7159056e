"""Port parity for the conv-operator spectral norm
(``pnp_svrg_tpu_torch/models/spectral_norm.py``) and the kernel unrollers of
``training/utils.py``.

The JAX functions (on the CPU) and the port's run on the same random kernels
and probes, made with numpy from a seed; kernels go from Flax's (kh, kw, I, O)
to torch's (O, I, kh, kw) and probes from NHWC to NCHW. Both sides convolve in
f32 in other orders: sigma is held to 1e-5 relative, vectors and kernels to
2e-6 absolute (unit vectors; kernels of order 0.1). The power iteration's
sigma is also held to the largest singular value of the explicit SAME
operator (``unroll_kernel`` and ``np.linalg.svd``) to 1e-4 relative.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.models import spectral_norm as jsn
from pnp_svrg_tpu.training.utils import unroll_kernel as jax_unroll_kernel
from pnp_svrg_tpu_torch.models import spectral_norm as sn
from pnp_svrg_tpu_torch.training.utils import unroll_kernel, unroll_kernel_sparse

SIGMA_RTOL, VEC_ATOL = 1e-5, 2e-6
HW = 12  # probe size


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for torch in this module: the suite runs in
    several worker processes at once, and with a thread per core in each,
    torch's small CPU ops wait on each other's threads (this file's tests
    took up to 100x their single-process time)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _case(cin, cout, seed=0):
    rng = np.random.default_rng(seed)
    kernel = (rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin)).astype(np.float32)
    u = rng.standard_normal((1, HW, HW, cout)).astype(np.float32)
    u /= np.linalg.norm(u)
    return kernel, u


def _t_kernel(kernel):
    return torch.tensor(kernel).permute(3, 2, 0, 1).contiguous()


def _t_vec(u):
    return torch.tensor(np.asarray(u)).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


CASES = [(1, 8, 1), (8, 8, 5), (8, 1, 30), (4, 6, 2)]


@pytest.mark.parametrize("cin,cout,n_iters", CASES)
def test_conv_power_iteration_matches_jax(cin, cout, n_iters):
    kernel, u = _case(cin, cout)
    j_sigma, j_u = jsn.conv_power_iteration(jnp.asarray(kernel), jnp.asarray(u), n_iters)
    t_sigma, t_u = sn.conv_power_iteration(_t_kernel(kernel), _t_vec(u), n_iters)
    np.testing.assert_allclose(float(t_sigma), float(j_sigma), rtol=SIGMA_RTOL)
    np.testing.assert_allclose(_nhwc(t_u), np.asarray(j_u), atol=VEC_ATOL)


@pytest.mark.parametrize("cin,cout,n_iters", CASES)
def test_power_iteration_uv_and_sigma_uv_match_jax(cin, cout, n_iters):
    """The (u, v) pair without grad, sigma_uv's value and its gradient in the
    kernel (the path the train step differentiates)."""
    kernel, u = _case(cin, cout, seed=1)
    ju, jv = jsn.power_iteration_uv(jnp.asarray(kernel), jnp.asarray(u), n_iters)
    tk = _t_kernel(kernel).requires_grad_(True)
    tu, tv = sn.power_iteration_uv(tk, _t_vec(u), n_iters)
    assert not tu.requires_grad and not tv.requires_grad
    np.testing.assert_allclose(_nhwc(tu), np.asarray(ju), atol=VEC_ATOL)
    np.testing.assert_allclose(_nhwc(tv), np.asarray(jv), atol=VEC_ATOL)
    j_sigma, j_grad = jax.value_and_grad(jsn.sigma_uv)(jnp.asarray(kernel), ju, jv)
    t_sigma = sn.sigma_uv(tk, tu, tv)
    t_sigma.backward()
    np.testing.assert_allclose(t_sigma.item(), float(j_sigma), rtol=SIGMA_RTOL)
    np.testing.assert_allclose(tk.grad.permute(2, 3, 1, 0).numpy(), np.asarray(j_grad), atol=1e-5)


@pytest.mark.parametrize("target", [1.0, 0.3 ** (1 / 17), 5.0])
def test_spectrally_normalize_kernel_matches_jax(target):
    kernel, u = _case(8, 8, seed=2)
    jk, js, ju = jsn.spectrally_normalize_kernel(jnp.asarray(kernel), jnp.asarray(u), target, 10)
    tk, ts, tu = sn.spectrally_normalize_kernel(_t_kernel(kernel), _t_vec(u), target, 10)
    np.testing.assert_allclose(float(ts), float(js), rtol=SIGMA_RTOL)
    np.testing.assert_allclose(tk.permute(2, 3, 1, 0).numpy(), np.asarray(jk), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(_nhwc(tu), np.asarray(ju), atol=VEC_ATOL)


def _same_operator(kernel_t: np.ndarray, n: int) -> np.ndarray:
    """The dense matrix of the SAME 3x3 correlation on an n x n input with a
    (c_out, 1, 3, 3) kernel: the VALID operator on the zero-padded
    (n + 2)^2 input, restricted to the interior input pixels."""
    full = unroll_kernel(kernel_t, n + 2)
    interior = [(y + 1) * (n + 2) + (x + 1) for y in range(n) for x in range(n)]
    return full[:, interior]


# Kernels whose second singular value on an 8 x 8 input is at most 0.953 of
# the first, so 500 iterations converge (a one-channel kernel's top two
# often lie within 0.1 % of each other, where the iteration crawls).
@pytest.mark.parametrize("cout,seed", [(2, 0), (4, 1), (8, 0)])
def test_power_iteration_sigma_is_the_operator_norm(cout, seed):
    n = 8
    kernel_t = np.random.default_rng(seed).standard_normal((cout, 1, 3, 3)).astype(np.float32)
    want = np.linalg.svd(_same_operator(kernel_t.astype(np.float64), n), compute_uv=False)[0]
    u = sn.init_u(cout, n, torch.Generator().manual_seed(seed))
    sigma, _ = sn.conv_power_iteration(torch.tensor(kernel_t), u, 500)
    np.testing.assert_allclose(float(sigma), want, rtol=1e-4)


@pytest.mark.parametrize("n", [5, 8])
def test_unroll_kernel_is_the_jax_copy(n):
    kernel = np.random.default_rng(n).standard_normal((3, 1, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(unroll_kernel(kernel, n), jax_unroll_kernel(kernel, n))
    np.testing.assert_array_equal(unroll_kernel(kernel[0, 0], n), jax_unroll_kernel(kernel[0, 0], n))
    np.testing.assert_array_equal(unroll_kernel_sparse(kernel, n).toarray(), unroll_kernel(kernel, n))
    np.testing.assert_array_equal(unroll_kernel_sparse(kernel, n, sparse=False), unroll_kernel(kernel, n))


@pytest.mark.parametrize("scale_mul,target", [(3.0, 1.0), (0.2, 1.0), (1.0, 0.5)])
def test_bn_spectral_clamp_matches_jax(scale_mul, target):
    rng = np.random.default_rng(3)
    scale = (scale_mul * rng.standard_normal(16)).astype(np.float32)
    bias = rng.standard_normal(16).astype(np.float32)
    var = rng.uniform(0.5, 2.0, 16).astype(np.float32)
    js, jb = jsn.bn_spectral_clamp(jnp.asarray(scale), jnp.asarray(bias), jnp.asarray(var), target)
    ts, tb = sn.bn_spectral_clamp(torch.tensor(scale), torch.tensor(bias), torch.tensor(var), target)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6)


def test_targets_and_the_adaptive_length_check():
    assert sn.ADAPTIVE_SIGMAS_6 == jsn.ADAPTIVE_SIGMAS_6
    for lip, depth in ((0.3, 17), (1.0, 3), (0.5, 4)):
        assert sn.realsn_target(lip, depth) == jsn.realsn_target(lip, depth)
        assert sn.realsn_targets(lip, depth) == jsn.realsn_targets(lip, depth)
    assert sn.realsn_targets(0.3, 6, sn.ADAPTIVE_SIGMAS_6) == jsn.realsn_targets(0.3, 6, jsn.ADAPTIVE_SIGMAS_6)
    with pytest.raises(ValueError, match="incompatible"):
        sn.realsn_targets(0.3, 4, adaptive=(1.0, 0.5))
    with pytest.raises(ValueError, match="incompatible"):
        sn.realsn_targets(0.3, 17, adaptive=sn.ADAPTIVE_SIGMAS_6)


def test_init_u_is_a_seeded_unit_probe():
    a = sn.init_u(8, HW, torch.Generator().manual_seed(5))
    b = sn.init_u(8, HW, torch.Generator().manual_seed(5))
    assert a.shape == (1, 8, HW, HW)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    np.testing.assert_allclose(float(torch.linalg.vector_norm(a)), 1.0, rtol=1e-6)
