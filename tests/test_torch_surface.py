"""The port's public surface against the JAX package's.

Every ``__all__`` of ``pnp_svrg_tpu_torch`` and its sub-packages equals the
JAX package's, less the names listed below with their reasons, and every
public top-level name of every JAX module has a counterpart of the same name
in the port's module of the same path. The JAX side is read from its source
with ``ast``, so nothing of it is imported for the comparison. Then the
names this surface added are held to the JAX functions on the cases of
``tests/test_metrics_sigma.py`` and ``tests/test_wavelet.py``.
"""

from __future__ import annotations

import ast
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.ops import fourier as jax_fourier
from pnp_svrg_tpu.ops import metrics as jax_metrics
from pnp_svrg_tpu.ops import transforms as jax_transforms
from pnp_svrg_tpu.ops import wavelet as jax_wavelet
from pnp_svrg_tpu_torch.ops import fourier, metrics, transforms, wavelet

REPO = Path(__file__).resolve().parents[1]
JAX_PKG = REPO / "pnp_svrg_tpu"

# JAX names the port has no counterpart for, and why.
EXCEPTIONS = {
    # The port's loops return tensors, not a scan record, and its batching
    # is a stacked problem of the same class: no IterLog, no BatchedProblem
    # (pnp_svrg_tpu_torch/parallel/__init__.py).
    "algorithms": {"IterLog"},
    "algorithms.loops": {"IterLog"},
    "core.batched": {"BatchedProblem"},
    "parallel": {"BatchedProblem"},
    # The port's training step is a function, ``train_step``, not a factory
    # of jitted steps.
    "training.train_dncnn": {"make_train_step"},
    # The .pth conversion reads the reference checkout's PyTorch weights,
    # which are not in the repository; the port reads the converted
    # checkpoints/*.npz.
    "models.convert": {"CONVERSIONS", "DEFAULT_OUT", "REFERENCE_ROOT", "convert_all",
                       "mmo_simple_cnn_to_flax", "sequential_dncnn_to_flax"},
}
# Port names in an ``__all__`` that the JAX package's lacks, and why.
ADDITIONS = {
    # The device policy (CUDA unless the caller asks for the CPU), the
    # wall-clock compat API with its tuner adapters, the gradient checks,
    # batching, and the entry points the examples and chip_smoke.py call.
    "": {"default_device", "resolve_device", "compat", "tune_pnp_gd", "tune_pnp_sgd", "tune_pnp_svrg",
         "tune_pnp_saga", "tune_pnp_sarah", "grad_full_check", "grad_stoch_check", "GradientCheckError",
         "stack_problems", "BM3DParams", "bm3d_denoise_batch", "DnCNNDenoiser", "MMODenoiser",
         "nlm_denoise", "make_csmri", "make_deblur", "make_phase_retrieval"},
    "algorithms": {"step_schedule", "compat", "tune_pnp_gd", "tune_pnp_sgd", "tune_pnp_svrg",
                   "tune_pnp_saga", "tune_pnp_sarah"},
    # Flax weights both ways (the JAX package reads them natively) and
    # Flax's initialiser for training.
    "models": {"flax_init_", "load_flax_npz", "save_flax_npz", "torch_state_dict_from_flax",
               "flax_variables_from_torch", "u_state_from_flax", "u_state_to_flax"},
    # The mesh and its collective seam over torch.distributed.
    "parallel": {"Mesh", "LocalAxis", "GroupAxis"},
    # The host fence around a device call (JAX: block_until_ready).
    "utils": {"fence"},
}
# JAX modules with no module of the same path in the port: the Pallas
# kernels (the port's are ops/cuda/*.py over csrc/*.cu) and the C++ patch
# library (the port's training/data.py uses unfold, rot90 and flip).
NO_MODULE = ("ops.pallas", "native")


def _modules() -> list[str]:
    """Dotted paths, relative to the package, of the JAX modules that have a
    port counterpart ("" is the package itself)."""
    out = []
    for f in sorted(JAX_PKG.rglob("*.py")):
        rel = ".".join(f.relative_to(JAX_PKG).with_suffix("").parts).removesuffix("__init__").rstrip(".")
        if not rel.startswith(NO_MODULE):
            out.append(rel)
    return out


def _source(rel: str) -> ast.Module:
    path = JAX_PKG.joinpath(*rel.split(".")) if rel else JAX_PKG
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    return ast.parse(path.read_text())


def _jax_all(rel: str) -> set[str] | None:
    for node in _source(rel).body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def _jax_public(rel: str) -> set[str]:
    """Names a JAX module defines at its top level (functions, classes,
    assignments), not starting with an underscore."""
    names = set()
    for node in _source(rel).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.startswith("_")}


def _port(rel: str):
    return importlib.import_module("pnp_svrg_tpu_torch" + (f".{rel}" if rel else ""))


PACKAGES = [rel for rel in _modules() if _jax_all(rel) is not None]


def test_every_jax_package_with_an_all_is_compared():
    assert set(PACKAGES) == {"", "algorithms", "core", "denoisers", "models", "ops", "parallel", "problems",
                             "training", "tuning", "utils"}


@pytest.mark.parametrize("rel", PACKAGES, ids=lambda r: r or "pnp_svrg_tpu")
def test_port_all_equals_the_jax_all(rel):
    port = _port(rel)
    want = _jax_all(rel) - EXCEPTIONS.get(rel, set())
    assert set(port.__all__) - ADDITIONS.get(rel, set()) == want
    assert len(port.__all__) == len(set(port.__all__))
    assert all(hasattr(port, n) for n in port.__all__)


@pytest.mark.parametrize("rel", _modules(), ids=lambda r: r or "pnp_svrg_tpu")
def test_every_public_jax_name_has_a_port_counterpart(rel):
    port = _port(rel)
    missing = sorted(n for n in _jax_public(rel) - EXCEPTIONS.get(rel, set()) if not hasattr(port, n))
    assert not missing


def test_exceptions_name_only_jax_names_the_port_lacks():
    for rel, names in EXCEPTIONS.items():
        jax_names = _jax_public(rel) | (_jax_all(rel) or set())
        assert names <= jax_names, rel
        assert not any(hasattr(_port(rel), n) for n in names), rel
    for rel, names in ADDITIONS.items():
        assert not names & _jax_all(rel), rel


# -- the names this surface added, against JAX ---------------------------


def test_psnr_rounded_matches_jax(rng):
    a = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    b = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    got = float(metrics.psnr_rounded(torch.from_numpy(a), torch.from_numpy(b)))
    want = float(jax_metrics.psnr_rounded(jnp.asarray(a), jnp.asarray(b)))
    assert got == want
    assert abs(got - round(got, 2)) < 1e-6
    batch = torch.from_numpy(np.stack([a, b]))
    np.testing.assert_array_equal(metrics.psnr_rounded(batch, batch.flip(0)).numpy(), [want, want])


def test_psnr_rounded_rounds_half_to_even_as_jax_does(rng):
    """A PSNR whose f32 product by 100 lies exactly halfway between two
    integers (found by scanning ``data_range``) rounds as ``jnp.round``
    rounds it: half to even, bit for bit."""
    a = torch.from_numpy(rng.uniform(0, 1, (16, 16)).astype(np.float32))
    b = torch.clamp(a + 0.1, 0, 1)
    hits = []
    for dr in np.linspace(1.0, 1.2, 20001, dtype=np.float32):
        p = metrics.psnr(a, b, float(dr))
        scaled = float(p * 100)
        if scaled % 1 == 0.5:
            hits.append((float(dr), p, scaled))
    assert len(hits) >= 2
    for dr, p, scaled in hits:
        got = float(metrics.psnr_rounded(a, b, dr))
        assert got == float(jnp.round(jnp.asarray(p.numpy()), 2))
        assert round(got * 100) % 2 == 0, (scaled, got)


@pytest.mark.parametrize("wavelet_name", ["db1", "db2", "db4"])
@pytest.mark.parametrize("n", [8, 9, 16, 17, 64, 128])
def test_dwt1_idwt1_match_jax(wavelet_name, n, rng):
    x = rng.standard_normal((3, n)).astype(np.float32)
    ca, cd = wavelet.dwt1(torch.from_numpy(x), wavelet_name)
    jca, jcd = jax.jit(jax_wavelet.dwt1, static_argnums=1)(jnp.asarray(x), wavelet_name)
    np.testing.assert_allclose(ca.numpy(), np.asarray(jca), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cd.numpy(), np.asarray(jcd), rtol=1e-5, atol=1e-6)
    xr = wavelet.idwt1(ca, cd, wavelet_name, n)
    jxr = jax.jit(jax_wavelet.idwt1, static_argnums=(2, 3))(jca, jcd, wavelet_name, n)
    np.testing.assert_allclose(xr.numpy(), np.asarray(jxr), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xr.numpy(), x, atol=2e-5)  # perfect reconstruction, as in JAX


def test_dwt1_haar_golden_values_and_wavelets():
    ca, cd = wavelet.dwt1(torch.tensor([1.0, 2.0, 3.0, 4.0]), "db1")
    np.testing.assert_allclose(ca.numpy(), [2.12132034, 4.94974747], atol=1e-6)
    np.testing.assert_allclose(cd.numpy(), [-0.70710678, -0.70710678], atol=1e-6)
    assert wavelet.WAVELETS == jax_wavelet.WAVELETS
    with pytest.raises(ValueError, match="unknown wavelet"):
        wavelet.dwt1(torch.zeros(8), "db3")


def test_fft2_ifft2_match_jax(rng):
    x = rng.standard_normal((2, 12, 10)).astype(np.float32)
    got = fourier.fft2(torch.from_numpy(x))
    want = np.asarray(jax_fourier.fft2(jnp.asarray(x)))
    assert got.dtype == torch.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    back = fourier.ifft2(got)
    np.testing.assert_allclose(back.numpy(), np.asarray(jax_fourier.ifft2(jnp.asarray(want))), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(back.real.numpy(), x, atol=1e-5)


@pytest.mark.parametrize("n", [1, 2, 4, 8, 16])
def test_haar_matrix_is_the_jax_copy(n):
    got = transforms.haar_matrix(n)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jax_transforms.haar_matrix(n))
    np.testing.assert_allclose(got @ got.T, np.eye(n), atol=1e-6)


def test_haar_matrix_refuses_other_sizes():
    with pytest.raises(ValueError, match="power of 2"):
        transforms.haar_matrix(6)
