"""The frozen counts on the cell's shapes, against the bounds the port's
smoke runs recorded (K1 0.0200 ms at both BM3D stages, K2 0.0277 / 0.0548
ms), and the whole step's operations."""

from __future__ import annotations

import pytest

from portbench import spec
from portbench.counts import bm3d, csmri, step
from portbench.tests.cells import REAL, REPO, make_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.fixture
def cs():
    return spec.cell(REAL, REPO)


@pytest.mark.parametrize("k", [16, 32])  # profile_ht, profile_wiener
def test_k1_bound_at_both_stages(cs, k):
    assert bm3d.k1_bound_ms(cs.config, 13, k) == pytest.approx(0.0200, abs=5e-5)


@pytest.mark.parametrize("k, want", [(16, 0.0277), (32, 0.0548)])
def test_k2_bound_at_both_stages(cs, k, want):
    assert bm3d.k2_bound_ms(cs.config, 13, k) == pytest.approx(want, abs=5e-5)


def test_step_flops_an_image_iteration(cs):
    """GD: a full gradient and a two-stage BM3D call each step."""
    per_iter = step.flops_per_iter(cs.config, cs.traffic)
    assert per_iter == csmri.full_gradient_flops(cs.config) + bm3d.denoise_flops(cs.config)
    assert 1.3e9 < per_iter < 1.5e9


def test_svrg_counts_its_minibatch_gradients(root):
    c = spec.cell("tiny_csmri.svrg", root)
    per_recon = 3 * csmri.full_gradient_flops(c.config) + 12 * csmri.minibatch_gradient_flops(c.config, c.traffic) \
        + 6 * bm3d.denoise_flops(c.config)
    assert step.flops_per_iter(c.config, c.traffic) == pytest.approx(per_recon / 9)


def test_separable_transform_counts_less_than_the_dense_product():
    for k in (16, 32):
        assert bm3d.transform_flops(k, 8) < 2 * (64 * k) ** 2 / 10
