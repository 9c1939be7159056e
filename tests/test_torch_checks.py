"""Port parity of the gradient checks (``core/checks.py``) and of
``CSMRI.grad_scale``.

The three problems are built by the JAX package at 32 px (as
``tests/test_utils_aux.py`` builds them) and carried over to the port as
numpy arrays. The JAX checks run beside the port's on the same problems:
both must be under the tolerances the JAX tests use, and the port's, which
widens every float field to float64, also under its own defaults.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.core import grad_full_check as jax_grad_full_check
from pnp_svrg_tpu.core import grad_stoch_check as jax_grad_stoch_check
from pnp_svrg_tpu.problems import make_csmri, make_deblur, make_phase_retrieval
from pnp_svrg_tpu_torch.convert import csmri_from_numpy, deblur_from_numpy, pr_from_numpy
from pnp_svrg_tpu_torch.core import checks
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.problems.csmri import CSMRI

CSMRI_FIELDS = ("y", "mask", "x", "x_init", "m0", "snr", "sigma")
DEBLUR_FIELDS = ("y", "b", "b_adj", "x", "x_init", "ds_idx", "ds_w", "allowed", "snr", "sigma")
PR_FIELDS = ("a", "y", "x", "x_init", "snr", "sigma")
FULL_TOL, STOCH_TOL = 5e-3, 1e-4  # tests/test_utils_aux.py's


def _img(h=32, w=32):
    xx, yy = np.meshgrid(np.linspace(0, 1, w), np.linspace(0, 1, h))
    return jnp.asarray(np.sin(4 * xx) * np.cos(3 * yy) * 0.4 + 0.5, jnp.float32)


def _pair(maker):
    """(JAX problem, one-lane port problem on the CPU)."""
    key = jax.random.PRNGKey(0)
    if maker == "csmri":
        jp = make_csmri(key, _img(), sample_prob=0.5, snr=10)
        arrays = {f: np.asarray(getattr(jp, f))[None] for f in CSMRI_FIELDS}
        return jp, csmri_from_numpy(arrays, "cpu")
    if maker == "deblur":
        jp = make_deblur(key, _img(), kernel="Minimal", scale_percent=50, snr=5)
        return jp, deblur_from_numpy({f: np.asarray(getattr(jp, f)) for f in DEBLUR_FIELDS}, "cpu")
    jp = make_phase_retrieval(key, _img(), num_meas=512, snr=20)
    return jp, pr_from_numpy({f: np.asarray(getattr(jp, f)) for f in PR_FIELDS}, "cpu")


@pytest.fixture(scope="module", params=["csmri", "deblur", "pr"])
def pair(request):
    return request.param, _pair(request.param)


def test_checks_pass_on_the_three_problems_as_in_jax(pair):
    _, (jp, tp) = pair
    want_full = jax_grad_full_check(jp, tol=FULL_TOL)
    want_stoch = jax_grad_stoch_check(jp, tol=STOCH_TOL)
    got_full = checks.grad_full_check(tp, tol=FULL_TOL)
    got_stoch = checks.grad_stoch_check(tp, tol=STOCH_TOL)
    assert want_full < FULL_TOL and got_full < FULL_TOL, (want_full, got_full)
    assert want_stoch < STOCH_TOL and got_stoch < STOCH_TOL, (want_stoch, got_stoch)
    # In float64 both also pass at their defaults (1e-4 and 1e-6).
    assert checks.grad_full_check(tp) < 1e-4
    assert checks.grad_stoch_check(checks.widen(tp)) < 1e-6


def test_checks_take_every_lane(pair):
    """A batched problem is checked lane by lane (each lane its own
    directions); two copies of one lane pass as the lane does."""
    _, (_, tp) = pair
    two = stack_problems([tp, tp])
    assert two.batch_size == 2
    assert checks.grad_full_check(two) < 1e-4
    assert checks.grad_stoch_check(two) < STOCH_TOL
    assert checks.grad_stoch_check(checks.widen(two)) < 1e-6


def test_widen_makes_every_float_field_double(pair):
    _, (_, tp) = pair
    wide = checks.widen(tp)
    assert type(wide) is type(tp)
    for f in dataclasses.fields(tp):
        a, b = getattr(tp, f.name), getattr(wide, f.name)
        want = {torch.float32: torch.float64, torch.complex64: torch.complex128}.get(a.dtype, a.dtype)
        assert b.dtype == want and b.device == a.device, f.name
        np.testing.assert_array_equal(b.cpu().numpy(), a.cpu().numpy().astype(b.cpu().numpy().dtype))


def test_csmri_grad_scale_is_m0_and_needed():
    jp, tp = _pair("csmri")
    np.testing.assert_array_equal(tp.grad_scale().numpy(), np.asarray(jp.grad_scale())[None])
    assert checks.grad_full_check(tp) < 1e-4

    class Unscaled(CSMRI):
        def grad_scale(self):
            return torch.ones_like(self.m0)

    with pytest.raises(checks.GradientCheckError):
        checks.grad_full_check(Unscaled(**{f.name: getattr(tp, f.name) for f in dataclasses.fields(tp)}))


def test_a_mis_scaled_gradient_raises():
    _, tp = _pair("csmri")

    class Broken(CSMRI):
        """CSMRI with a wrongly scaled gradient."""

        def grad_full(self, z):
            return 3.0 * super().grad_full(z)

    broken = Broken(**{f.name: getattr(tp, f.name) for f in dataclasses.fields(tp)})
    with pytest.raises(checks.GradientCheckError, match="grad_full_check"):
        checks.grad_full_check(broken, tol=1e-3)
    with pytest.raises(checks.GradientCheckError, match="grad_stoch_check"):
        checks.grad_stoch_check(broken, tol=1e-3)
    err = checks.grad_full_check(broken, raise_on_fail=False)
    assert err == pytest.approx(2.0 / 3.0, rel=1e-6)  # |fd - 3 fd| / |3 fd|


def test_directions_come_from_the_generator():
    _, tp = _pair("pr")
    a = checks.grad_full_check(tp, generator=torch.Generator().manual_seed(5))
    b = checks.grad_full_check(tp, generator=torch.Generator().manual_seed(5))
    c = checks.grad_full_check(tp, generator=torch.Generator().manual_seed(6))
    assert a == b and a != c
