"""A run of each tiny cell on the CPU, the harness's look for a card skipped,
is correct; with the timed path broken underneath, ``correct`` comes out
false, once for each fault the cells can have. (A cell runs on one card, so
there is no exchange between chips to leave out.)"""

from __future__ import annotations

import pytest
import torch

import pnp_svrg_tpu_torch.problems.csmri as program_csmri
from pnp_svrg_tpu_torch.algorithms import loops
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser
from pnp_svrg_tpu_torch.problems.csmri import CSMRI
from portbench.tests.cells import TINY, make_root, run

CELLS = sorted(TINY)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("root"))


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(root, cell):
    result = run(root, cell)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] == 2 * 3
    assert set(result["checks"]) == {"update_gap", "denoise_gap", "denoise_gap_q90", "failed_lanes", "faults"}


def _denoisers(monkeypatch, wrap):
    monkeypatch.setattr(BM3DDenoiser, "denoise", wrap(BM3DDenoiser.denoise))


def _state_unchanged(monkeypatch):
    """Each denoiser step returns its state unchanged."""
    _denoisers(monkeypatch, lambda f: lambda self, x, *a: x)


def _step_skipped(monkeypatch):
    """Each loop step returns the iterate it was given: no update, no denoiser."""
    def step(problem, denoiser, z, v, step_size, t):
        img = z.reshape(-1, problem.h, problem.w)
        p = problem.psnr(img)
        return z, p, p, torch.zeros_like(p)
    monkeypatch.setattr(loops, "_denoise_step", step)


def _half_batch(monkeypatch):
    """Each gradient over half of its coefficients, the mean over the rest:
    the full gradient over the first half of each lane's sampled
    coefficients, over their count; a minibatch gradient over half of its
    minibatch, doubled."""
    def first_half(m):
        flat = m.reshape(m.shape[0], -1)
        return (flat * (flat.cumsum(1) <= flat.sum(1, keepdim=True) / 2)).reshape(m.shape)

    def full_half(self, z):
        half = first_half(self.mask)
        res = half * (torch.fft.fft2(self._img(z)) - self.y)
        return torch.fft.ifft2(res).real / half.sum(dim=(-2, -1))[:, None, None]

    stoch = CSMRI.grad_stoch
    monkeypatch.setattr(CSMRI, "grad_full", full_half)
    monkeypatch.setattr(CSMRI, "grad_stoch",
                        lambda self, z, mb: 2 * stoch(self, z, first_half(mb.reshape(self.mask.shape))))


def _sampler_draws_one_more(monkeypatch):
    """The program's sampler adds a coefficient to lane 0's minibatch, as a
    tie at the k-th score does."""
    sample = program_csmri.sample_k_mask

    def one_more(shape, k, generator, allowed=None, **kw):
        mb = sample(shape, k, generator, allowed=allowed, **kw)
        spare = torch.nonzero(((allowed > 0) & (mb == 0))[0].reshape(-1))[0]
        mb[0].view(-1)[spare] = 1.0
        return mb

    monkeypatch.setattr(program_csmri, "sample_k_mask", one_more)


def _answer_altered(monkeypatch):
    """One lane's denoised image altered where the denoiser produces it."""
    def wrap(f):
        def denoise(self, x, *a):
            out = f(self, x, *a).clone()
            out[0] += 1e-2
            return out
        return denoise
    _denoisers(monkeypatch, wrap)


def _border_altered(monkeypatch):
    """Each denoised image altered on its top rows only (a fifth of its
    pixels), as a kernel wrong on border tiles would: the median over a
    lane's pixels cannot see it, the 90th percentile does."""
    def wrap(f):
        def denoise(self, x, *a):
            out = f(self, x, *a).clone()
            out[:, : out.shape[1] // 5] += 1e-2
            return out
        return denoise
    _denoisers(monkeypatch, wrap)


def _result_altered(monkeypatch):
    """The reconstruction returns another image than its last step made."""
    for name in ("pnp_gd", "pnp_svrg"):
        f = getattr(loops, name)

        def altered(*a, _f=f, **k):
            out = _f(*a, **k)
            return out | {"image": out["image"] + 1e-3}
        monkeypatch.setattr(loops, name, altered)


FAULTS = {  # fault -> (the check that catches it, the cells that can have it)
    _state_unchanged: ("denoise_gap", CELLS), _step_skipped: ("faults", CELLS),
    _half_batch: ("update_gap", CELLS), _sampler_draws_one_more: ("faults", ["tiny_csmri.svrg"]),
    _answer_altered: ("denoise_gap", CELLS), _border_altered: ("denoise_gap_q90", CELLS),
    _result_altered: ("faults", CELLS),
}
CASES = [(cell, fault) for fault, (_, cells) in FAULTS.items() for cell in cells]


@pytest.mark.parametrize("cell, fault", CASES, ids=[f"{c}-{f.__name__.strip('_')}" for c, f in CASES])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, monkeypatch):
    fault(monkeypatch)
    result = run(root, cell)
    assert not result["correct"], result["checks"]
    caught = result["checks"][FAULTS[fault][0]]
    assert caught["value"] > caught["limit"], result["checks"]
