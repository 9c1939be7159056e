"""Port parity of the distributed layer's meshes, the row-bounded block
matching and BM3D, the row-sharded (spatial) denoising, the batch runner,
the dry run and the scaling driver.

The JAX side runs as ``tests/test_parallel.py`` runs it, on the 8 virtual
CPU devices of ``tests/conftest.py``; the port on the CPU (plain kernel
versions), emulated in this process and on two gloo ranks spawned here
(two spawns, each with its own time limit). Tolerances: bounded matching
has JAX's +inf pattern, its distances and its 16 smallest distances a
block to 1e-5 relative in f32 and 1e-4 in bf16 (the sums' order differs,
so a near-tie may swap two offsets); bounded BM3D by the mean absolute difference of those tests (1e-3 /
5e-3); NLM through the halo bit for bit against the port's unsharded NLM
and to 1e-5 against JAX; a BM3D loop through the halo within JAX's 0.5 dB.
"""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.denoisers import bm3d as jbm3d
from pnp_svrg_tpu.denoisers.nlm import nlm_denoise as jax_nlm_denoise
from pnp_svrg_tpu.parallel import bm3d_denoise_spatial as jax_bm3d_denoise_spatial
from pnp_svrg_tpu.parallel import make_mesh as jax_make_mesh
from pnp_svrg_tpu.parallel import nlm_denoise_spatial as jax_nlm_denoise_spatial
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.denoisers.bm3d import BM3DDenoiser, BM3DParams
from pnp_svrg_tpu_torch.denoisers.nlm import NLMDenoiser
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.examples import scaling
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1
from pnp_svrg_tpu_torch.ops.cuda.nlm import nlm_denoise
from pnp_svrg_tpu_torch.algorithms.loops import pnp_svrg
from pnp_svrg_tpu_torch.parallel import (
    bm3d_denoise_spatial,
    denoise_spatial,
    init_distributed,
    make_mesh,
    make_spatial_mesh,
    nlm_denoise_spatial,
    reconstruct_set12,
    run_batch,
    run_batch_meas_emulated,
)
from pnp_svrg_tpu_torch.parallel.dryrun import dryrun_multichip
from pnp_svrg_tpu_torch.parallel.mesh import LocalAxis, spawn
from pnp_svrg_tpu_torch.problems.csmri import make_csmri

K = 16
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _noisy(seed: int, shape: tuple) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# ---------------------------------------------------------------------------
# Meshes and the process group
# ---------------------------------------------------------------------------


def test_meshes_in_one_process():
    m = make_mesh(device="cpu")
    assert m.shape == {"batch": 1, "meas": 1} and m.device == torch.device("cpu")
    s = make_spatial_mesh((1, 4), device="cpu", emulate=True)
    assert s.shape == {"batch": 1, "spatial": 4} and s.axis("spatial").size == 4
    assert list(s.axis("spatial").shards) == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="world size"):
        make_mesh((2, 1), device="cpu")
    with pytest.raises(ValueError, match="one process"):
        make_mesh((2, 2), device="cpu", emulate=True)


def test_init_distributed_is_a_noop_without_env_and_needs_a_backend(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    init_distributed()
    assert not torch.distributed.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="backend"):
        init_distributed()


def test_local_axis_collectives():
    ax = LocalAxis("meas", 3)
    x = torch.arange(12.0).reshape(3, 2, 2)
    assert torch.equal(ax.psum(x), x.sum(0))
    assert torch.equal(ax.all_gather(x, dim=1), torch.cat(list(x), dim=1))


# ---------------------------------------------------------------------------
# K1 and BM3D with row bounds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bounds", [(8, 48), (0, 32), (13, 41)])
@pytest.mark.parametrize("mode,rtol", [("f32", 1e-5), ("bf16_xla", 1e-4)])
def test_bounded_k1_plain_matches_jax_xla_matcher(mode, rtol, bounds):
    """The same +inf pattern and distances, and the same 16 smallest
    distances a block (a near-tie may swap which offset holds one)."""
    x = _noisy(0, (2, 48, 40))
    rows, cols = bm3d._ref_grid(48, 8, 4), bm3d._ref_grid(40, 8, 4)
    offs = bm3d.search_offsets(6, 1)
    dtype = "float32" if mode == "f32" else "bfloat16"
    jax_dist = jax.jit(lambda im, lo, hi: jbm3d._match_distances(
        im, rows, cols, offs, 8, row_valid_bounds=(lo, hi), match_dtype=dtype))
    want_d = np.asarray(jax_dist(jnp.asarray(x), *bounds))
    got_d = k1.match_distances_plain(torch.tensor(x), rows, cols, offs, 8, mode,
                                     row_valid_bounds=bounds).numpy()
    np.testing.assert_array_equal(np.isinf(got_d), np.isinf(want_d))
    fin = np.isfinite(want_d)
    np.testing.assert_allclose(got_d[fin], want_d[fin], rtol=rtol, atol=1e-5)
    want = np.asarray(jax.jit(lambda d: jbm3d._top_k_offsets(d, K))(jnp.asarray(want_d)))
    got = k1.bm3d_match(torch.tensor(x), rows, cols, offs, 8, K, mode,
                        row_valid_bounds=bounds).numpy().astype(np.int64)
    picked = np.sort(np.take_along_axis(want_d, got, -1), -1)
    np.testing.assert_array_equal(np.isinf(picked), np.isinf(np.take_along_axis(want_d, want, -1)))
    np.testing.assert_allclose(picked, np.sort(np.take_along_axis(want_d, want, -1), -1),
                               rtol=rtol)
    lo, hi = bounds  # every kept candidate lies inside the bounds (or is the spare-slot fill)
    cand = rows[None, :, None, None] + offs[got][..., 0]
    assert (((cand >= lo) & (cand <= hi - 8)) | (got == 0)).all()


def test_k1_bounds_are_checked():
    x = torch.zeros((1, 32, 32))
    rows = bm3d._ref_grid(32, 8, 4)
    offs = bm3d.search_offsets(4, 1)
    for bad in ((-1, 32), (0, 33), (20, 10), (0.0, 32)):
        with pytest.raises(ValueError, match="row_valid_bounds"):
            k1.bm3d_match(x, rows, rows, offs, 8, K, row_valid_bounds=bad)
    full = k1.bm3d_match(x, rows, rows, offs, 8, K, row_valid_bounds=(0, 32))
    assert torch.equal(full, k1.bm3d_match(x, rows, rows, offs, 8, K))


@pytest.mark.parametrize("match_dtype,tol", [("float32", 1e-3), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("bounds", [(8, 48), (0, 40)])
def test_bounded_bm3d_matches_jax(match_dtype, tol, bounds):
    x = _noisy(1, (2, 48, 40)) * 0.3 + 0.35
    sig = np.asarray([0.1, 0.12], np.float32)
    # matcher="pallas" too: bounds take the XLA matcher's rounding in both packages
    want = np.asarray(jbm3d.bm3d_denoise_batch(
        jnp.asarray(x), jnp.asarray(sig),
        params=jbm3d.BM3DParams(search=6, match_dtype=match_dtype, matcher="pallas"),
        row_valid_bounds=bounds))
    got = bm3d.bm3d_denoise_batch(
        torch.tensor(x), torch.tensor(sig),
        params=BM3DParams(search=6, match_dtype=match_dtype, matcher="pallas"),
        row_valid_bounds=bounds).numpy()
    assert float(np.abs(got - want).mean()) < tol


def test_bounded_bm3d_weights_no_halo_reference_block():
    """Reference blocks in the padding rows get weight 0: the bounded
    denoise of an image whose padding rows are garbage equals, on the image
    rows' interior, the same denoise with other garbage there."""
    x = _noisy(2, (1, 64, 32)) * 0.3 + 0.35
    p = BM3DParams(search=4)
    a = x.copy()
    b = x.copy()
    b[:, :16] = _noisy(3, (1, 16, 32))
    out_a = bm3d.bm3d_denoise_batch(torch.tensor(a), 0.1, p, stages=1, row_valid_bounds=(16, 64))
    out_b = bm3d.bm3d_denoise_batch(torch.tensor(b), 0.1, p, stages=1, row_valid_bounds=(16, 64))
    assert torch.equal(out_a[:, 16:], out_b[:, 16:])


def test_denoiser_bounded_step_and_halo():
    den = BM3DDenoiser(sigma_modifier=1.0, params=BM3DParams(search=8))
    assert den.spatial_halo() == 32
    assert BM3DDenoiser(params=BM3DParams(search=4, block=4)).spatial_halo() == 16
    assert BM3DDenoiser(params=BM3DParams(search=5), stages=1).spatial_halo() == 16
    x = torch.tensor(_noisy(4, (2, 32, 32)))
    sig = torch.tensor([0.1, 0.1])
    t = torch.ones(2, dtype=torch.int32)
    assert torch.equal(den.denoise_bounded(x, sig, t, (0, 32)), den.denoise(x, sig, t))
    assert den.denoise_bounded(x[0], sig[0], t[0], (0, 32)).shape == (32, 32)


# ---------------------------------------------------------------------------
# Row-sharded denoising
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_nlm_spatial_matches_unsharded_and_jax(n):
    img = _noisy(5, (128, 64))
    ref = nlm_denoise(torch.tensor(img), 0.1, 0.1)
    got = nlm_denoise_spatial(torch.tensor(img), 0.1, 0.1,
                              make_spatial_mesh((1, n), device="cpu", emulate=True))
    assert torch.equal(got, ref)
    want = np.asarray(jax_nlm_denoise_spatial(jnp.asarray(img), 0.1, 0.1,
                                              jax_make_mesh((n, 1), devices=jax.devices()[:n])))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(want, np.asarray(jax_nlm_denoise(jnp.asarray(img), 0.1, 0.1)),
                               atol=1e-6)


def test_bm3d_spatial_matches_unsharded_and_jax():
    img = _noisy(6, (128, 64))
    p = BM3DParams(search=4)
    mesh = make_spatial_mesh((1, 2), device="cpu", emulate=True)
    got = bm3d_denoise_spatial(torch.tensor(img), 0.08, mesh, params=p).numpy()
    ref = bm3d.bm3d_denoise(torch.tensor(img), 0.08, p).numpy()
    assert np.abs(got - ref).max() <= 2e-6
    want = np.asarray(jax_bm3d_denoise_spatial(jnp.asarray(img), 0.08,
                                               jax_make_mesh((2, 1), devices=jax.devices()[:2]),
                                               params=jbm3d.BM3DParams(search=4)))
    assert float(np.abs(got - want).mean()) < 1e-3


def test_denoise_spatial_rejects_a_halo_taller_than_a_shard():
    blocks = torch.zeros((2, 16, 8))
    with pytest.raises(ValueError, match="too small"):
        denoise_spatial(lambda x, b: x, blocks, LocalAxis("spatial", 2), halo=16)


def _csmri_batch(h=32, bsz=4):
    gen = torch.Generator().manual_seed(0)
    return stack_problems([make_csmri(_noisy(i, (h, h)), gen, 0.5, snr=10, device="cpu")
                           for i in range(bsz)])


HP = dict(eta=100.0, n_outer=2, t2=2, mini_batch_size=64)


def test_nlm_image_shards_match_unsharded():
    batched = _csmri_batch()
    den = NLMDenoiser(sigma_modifier=1.0)
    plain = run_batch("svrg", batched, den, seed=3, **HP)
    shard = run_batch("svrg", batched, den, seed=3, image_shards=2, **HP)
    assert torch.equal(shard["z"], plain["z"])
    assert torch.equal(shard["psnr_per_iter"], plain["psnr_per_iter"])


def test_bm3d_image_shards_close_to_unsharded():
    batched = _csmri_batch()
    den = BM3DDenoiser(sigma_modifier=1.0, params=BM3DParams(search=4, block=4))
    plain = run_batch("svrg", batched, den, seed=3, **HP)["final_psnr"].numpy()
    shard = run_batch("svrg", batched, den, seed=3, image_shards=2, **HP)["final_psnr"].numpy()
    assert np.isfinite(shard).all()
    np.testing.assert_allclose(shard, plain, atol=0.5)


def test_unsupported_denoiser_raises():
    with pytest.raises(TypeError, match="no bounded"):
        run_batch("gd", _csmri_batch(), TVDenoiser(sigma_modifier=1.0), image_shards=2,
                  eta=10.0, n_iters=1)
    with pytest.raises(ValueError, match="spatial axis"):
        run_batch("gd", _csmri_batch(), NLMDenoiser(), image_shards=2,
                  mesh=make_mesh(device="cpu"), eta=10.0, n_iters=1)
    with pytest.raises(ValueError, match="unknown algorithm"):
        run_batch("adam", _csmri_batch(), NLMDenoiser())


def test_run_batch_result_keys_and_lane_streams():
    """The runner returns the whole batch's fields; without a mesh it equals
    the same loop on an emulated single meas shard (the same lane streams)."""
    batched = _csmri_batch()
    den = TVDenoiser(sigma_modifier=1.0)
    full = run_batch("svrg", batched, den, seed=4, **HP)
    assert set(full) == {"z", "image", "psnr_per_iter", "final_psnr", "psnr_before_denoise",
                         "sigma_est"}
    one = run_batch_meas_emulated(pnp_svrg, batched, den, 1, seed=4, **HP)
    assert torch.equal(full["z"], one["z"])


# ---------------------------------------------------------------------------
# Two gloo ranks, the dry run and the scaling driver
# ---------------------------------------------------------------------------


def _two_rank_spatial_and_batch(rank: int, batched, masks) -> dict:
    torch.set_num_threads(1)
    nlm = run_batch("svrg", batched, NLMDenoiser(sigma_modifier=1.0), seed=3, image_shards=2, **HP)
    mesh = make_mesh((2, 1), device="cpu")
    tv = run_batch("svrg", batched, TVDenoiser(sigma_modifier=1.0), mesh=mesh, masks=masks, **HP)
    drawn = run_batch("svrg", batched, TVDenoiser(sigma_modifier=1.0), seed=5, mesh=mesh, **HP)
    return {"nlm": nlm["z"].numpy(), "nlm_trace": nlm["psnr_per_iter"].numpy(),
            "tv": tv["z"].numpy(), "tv_trace": tv["psnr_per_iter"].numpy(),
            "drawn": drawn["z"].numpy()}


def test_two_ranks_spatial_nlm_and_batch_mesh_equal_unsharded(tmp_path):
    batched = _csmri_batch()
    rng = np.random.default_rng(9)
    m = batched.mask.numpy().reshape(4, -1)
    masks = np.zeros((1, 2, 2, 4, m.shape[1]), np.float32)  # (meas 1, n_outer, t2, B, H*W)
    for i in range(2):
        for j in range(2):
            for b in range(4):
                masks[0, i, j, b, rng.choice(np.flatnonzero(m[b]), 64, replace=False)] = 1.0
    masks = torch.tensor(masks.reshape(1, 2, 2, 4, 32, 32))
    ranks = spawn(_two_rank_spatial_and_batch, 2, "gloo", (batched, masks), SPAWN_TIMEOUT_S,
                  str(tmp_path))
    nlm = run_batch("svrg", batched, NLMDenoiser(sigma_modifier=1.0), seed=3, **HP)
    tv = run_batch("svrg", batched, TVDenoiser(sigma_modifier=1.0), masks=masks, **HP)
    drawn = run_batch("svrg", batched, TVDenoiser(sigma_modifier=1.0), seed=5, **HP)
    for r in ranks:
        np.testing.assert_array_equal(r["nlm"], nlm["z"].numpy())
        np.testing.assert_array_equal(r["nlm_trace"], nlm["psnr_per_iter"].numpy())
        # lanes split 2 + 2 over the ranks: per-lane arithmetic, threads aside
        np.testing.assert_allclose(r["tv"], tv["z"].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(r["tv_trace"], tv["psnr_per_iter"].numpy(), atol=1e-4, rtol=0)
        # drawn minibatches: each lane's own stream, whichever rank runs it
        np.testing.assert_allclose(r["drawn"], drawn["z"].numpy(), atol=1e-6, rtol=0)


def _two_rank_dryrun(rank: int) -> dict:
    torch.set_num_threads(1)
    return dryrun_multichip(2, device="cpu")


def test_dryrun_multichip_on_two_ranks(tmp_path):
    ranks = spawn(_two_rank_dryrun, 2, "gloo", (), SPAWN_TIMEOUT_S, str(tmp_path))
    assert ranks[0] == ranks[1]
    assert ranks[0]["mesh"] == [1, 2]
    assert set(ranks[0]) == {"mesh", "svrg_bm3d", "flagship_shape", "saga_sharded_table",
                             "spatial_nlm", "pr_spmd_step"}
    assert len(ranks[0]["svrg_bm3d"]) == 2 and len(ranks[0]["pr_spmd_step"]) == 2


def test_dryrun_multichip_one_rank_and_wrong_world():
    assert dryrun_multichip(1, device="cpu")["mesh"] == [1, 1]
    with pytest.raises(ValueError, match="process group"):
        dryrun_multichip(2, device="cpu")


def test_scaling_driver_in_process(tmp_path, capsys):
    out = tmp_path / "scaling.json"
    rows = scaling.main(["--cpu", "--size", "32", "--n-outer", "2", "--t2", "2", "--mb", "200",
                         "--search", "4", "--eta", "100", "--devices", "1", "2",
                         "--out", str(out)])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[1] == {"devices": 2, "skipped": "not enough ranks"}
    assert len(rows) == 1 and rows[0]["devices"] == 1 and rows[0]["batch"] == 2
    assert rows[0]["device_kind"] == "cpu" and np.isfinite(rows[0]["mean_psnr"])
    record = json.loads(out.read_text())
    assert record["rows"][0]["weak_scaling_efficiency"] == 1.0


def test_reconstruct_set12_runs_one_batch():
    make = lambda im, g: make_csmri(im, g, 0.5, snr=10, device="cpu")  # noqa: E731
    out = reconstruct_set12("gd", make, TVDenoiser(sigma_modifier=1.0), h=32, w=32, seed=2,
                            device="cpu", eta=100.0, n_iters=2)
    assert out["z"].shape == (12, 32 * 32) and out["psnr_per_iter"].shape == (3, 12)
    from pnp_svrg_tpu_torch.parallel.meas import lane_seed
    from pnp_svrg_tpu_torch.utils.io import load_image, set12_paths

    by_hand = stack_problems([make(load_image(p, 32, 32), torch.Generator().manual_seed(lane_seed(2, 0, i)))
                              for i, p in enumerate(set12_paths())])
    want = run_batch("gd", by_hand, TVDenoiser(sigma_modifier=1.0), seed=3, eta=100.0, n_iters=2)
    assert torch.equal(out["z"], want["z"]) and torch.isfinite(out["final_psnr"]).all()
