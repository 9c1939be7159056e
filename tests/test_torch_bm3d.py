"""Port parity: BM3D and the plain versions of kernels K1 (block matching) and
K2 (the fused aggregation).

On the CPU the kernel wrappers take their plain PyTorch versions; the CUDA
kernels themselves are held against those versions on the card by
``chip_smoke.py`` and ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pnp_svrg_tpu.denoisers import bm3d as jbm3d
from pnp_svrg_tpu.ops.pallas.bm3d_match import bm3d_match_pallas
from pnp_svrg_tpu.ops.pallas.bm3d_scatter import bm3d_scatter_pallas
from pnp_svrg_tpu_torch.denoisers import bm3d
from pnp_svrg_tpu_torch.ops.cuda import bm3d_match as k1
from pnp_svrg_tpu_torch.ops.cuda import bm3d_aggregate as k2
from pnp_svrg_tpu_torch.utils.io import load_image
from test_golden_parity import bm3d_oracle

K = 16


def _noisy_batch(rng, size=40, b=2, sigma=0.1):
    yy, xx = np.mgrid[:size, :size]
    clean = np.clip(0.5 + 0.3 * np.sin(yy / 3.0) * np.cos(xx / 2.0), 0, 1)
    clean[size // 4 : size // 2, size // 4 : size // 2] = 0.9
    noisy = clean[None] + sigma * rng.standard_normal((b, size, size))
    return clean.astype(np.float32), noisy.astype(np.float32)


def _set_agreement(a, b):
    a = np.asarray(a).reshape(-1, a.shape[-1])
    b = np.asarray(b).reshape(-1, b.shape[-1])
    return float(np.mean([len(set(p) & set(q)) / a.shape[1] for p, q in zip(a, b)]))


def _grid(size, search, step):
    rows = bm3d._ref_grid(size, 8, 4)
    return rows, bm3d.search_offsets(search, step)


@pytest.mark.parametrize("mode,floor", [("f32", 0.999), ("bf16_xla", 0.995)])
@pytest.mark.parametrize("search_step", [1, 2])
def test_plain_k1_matches_jax_xla_matcher(rng, mode, floor, search_step):
    _, x = _noisy_batch(rng)
    rows, offs = _grid(x.shape[-1], 6, search_step)
    dtype = "float32" if mode == "f32" else "bfloat16"
    want = jbm3d._top_k_offsets(
        jbm3d._match_distances(jnp.asarray(x), rows, rows, offs, 8, match_dtype=dtype), K
    )
    got = k1.bm3d_match_plain(torch.tensor(x), rows, rows, offs, 8, K, mode)
    assert got.shape == want.shape and got.dtype == torch.int32
    assert _set_agreement(got.numpy(), want) >= floor


@pytest.mark.parametrize("mode,floor", [("f32", 0.999), ("bf16_pallas", 0.995)])
@pytest.mark.parametrize("search_step", [1, 2])
def test_plain_k1_matches_pallas_kernel(rng, mode, floor, search_step):
    _, x = _noisy_batch(rng, size=32)
    rows, offs = _grid(x.shape[-1], 6, search_step)
    dtype = "float32" if mode == "f32" else "bfloat16"
    want = bm3d_match_pallas(
        jnp.asarray(x), tuple(rows.tolist()), tuple(rows.tolist()),
        tuple(map(tuple, offs.tolist())), 8, K, match_dtype=dtype, interpret=True,
    )
    got = k1.bm3d_match(torch.tensor(x), rows, rows, offs, 8, K, mode)
    assert _set_agreement(got.numpy(), want) >= floor


def test_k1_fills_spare_slots_with_offset_zero(rng):
    # search 8 on the stride-4 sublattice: a corner block has only 9 valid
    # candidates, and both JAX matchers fill the other 7 slots with index 0.
    _, x = _noisy_batch(rng, size=32, b=1)
    rows, offs = _grid(32, 8, 4)
    got = k1.bm3d_match(torch.tensor(x), rows, rows, offs, 8, K, "f32").numpy()
    want_xla = np.asarray(jbm3d._top_k_offsets(
        jbm3d._match_distances(jnp.asarray(x), rows, rows, offs, 8), K))
    want_pal = np.asarray(bm3d_match_pallas(
        jnp.asarray(x), tuple(rows.tolist()), tuple(rows.tolist()),
        tuple(map(tuple, offs.tolist())), 8, K, interpret=True))
    corner = got[0, 0, 0]
    assert np.all(corner[9:] == 0) and len(set(corner[:9])) == 9
    np.testing.assert_array_equal(corner, want_xla[0, 0, 0])
    np.testing.assert_array_equal(corner, want_pal[0, 0, 0])
    np.testing.assert_array_equal(got, want_xla)  # every block, fills included


def test_plain_k2_matches_pallas_and_xla_scatter(rng):
    # 20 x 20 px: 4 x 4 groups of K = 16 members, 256 rows into a 13 x 13
    # table, drawn at random: rows collide.
    h = w = 20
    b, g, k, bb, t = 2, 16, K, 64, 13 * 13
    idx = rng.integers(0, t, (b, g * k)).astype(np.int32)
    est = rng.standard_normal((b, g * k, bb)).astype(np.float32)
    wgt = rng.uniform(0.5, 2.0, (b, g)).astype(np.float32)
    kai = rng.uniform(0.1, 1.0, bb).astype(np.float32)
    num, den = k2.bm3d_aggregate(torch.tensor(idx), torch.tensor(est), torch.tensor(wgt),
                                 torch.tensor(kai), h, w)
    wk = np.repeat(wgt, k, axis=1)[..., None] * kai
    upd = np.concatenate([est * wk, np.broadcast_to(wk, est.shape)], axis=-1)
    want_pal = bm3d_scatter_pallas(jnp.asarray(idx), jnp.asarray(upd), t, chunk=128,
                                   interpret=True)
    flat = (idx + (np.arange(b) * t)[:, None]).reshape(-1)
    want_xla = jnp.zeros((b * t, 2 * bb)).at[flat].add(upd.reshape(-1, 2 * bb))
    for table in (want_pal, want_xla):  # sums of up to ~100 terms of order 1: f32 order
        wn, wd = jbm3d._unfold_table(table.reshape(b, 13, 13, 2, 8, 8), 8, h, w)
        np.testing.assert_allclose(num.numpy(), np.asarray(wn), atol=1e-5, rtol=1e-6)
        np.testing.assert_allclose(den.numpy(), np.asarray(wd), atol=1e-5, rtol=1e-6)


def test_k2_rejects_out_of_range_rows():
    est, wgt, kai = torch.zeros((1, 256, 64)), torch.ones((1, 16)), torch.ones(64)
    idx = torch.zeros((1, 256), dtype=torch.int32)
    idx[0, 5] = 13 * 13  # one past the table
    with pytest.raises((IndexError, RuntimeError)):
        k2.bm3d_aggregate(idx, est, wgt, kai, 20, 20)
    with pytest.raises(ValueError):
        k2.bm3d_aggregate(idx.long(), est, wgt, kai, 20, 20)
    with pytest.raises(ValueError):  # 255 members do not split into 16 groups
        k2.bm3d_aggregate(idx[:, :255], est[:, :255], wgt, kai, 20, 20)


def test_wrappers_refuse_a_geometry_made_for_other_arguments():
    grid = bm3d._ref_grid(48, 8, 4)
    x = torch.zeros((1, 48, 48))
    geom = k1.match_geometry(grid, grid, bm3d.search_offsets(6, 1), 8, "cpu")
    with pytest.raises(ValueError):  # the geometry of the 169-offset window, called with 49
        k1.bm3d_match(x, grid, grid, bm3d.search_offsets(6, 2), 8, K, geometry=geom)
    assert k1.bm3d_match(x, grid, grid, bm3d.search_offsets(6, 1), 8, K, geometry=geom).shape \
        == (1, len(grid), len(grid), K)
    agg = k2.aggregate_geometry(48, 48, tuple(grid.tolist()), tuple(grid.tolist()), 6, 8,
                                torch.device("cpu"))
    n = len(grid) ** 2
    args = (torch.zeros((1, n * K), dtype=torch.int32), torch.zeros((1, n * K, 64)),
            torch.ones((1, n)), torch.ones(64))
    with pytest.raises(ValueError):  # the footprints of a 48 px image, called for 40 px
        k2.bm3d_aggregate(*args, 40, 40, agg)
    num, den = k2.bm3d_aggregate(*args, 48, 48, agg)
    assert num.shape == den.shape == (1, 48, 48)


@pytest.mark.parametrize("match_dtype,tol", [("float32", 1e-3), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("stages", [1, 2])
def test_bm3d_denoise_batch_matches_jax(rng, match_dtype, tol, stages):
    _, x = _noisy_batch(rng)
    sig = np.asarray([0.1, 0.12], np.float32)
    want = np.asarray(jbm3d.bm3d_denoise_batch(
        jnp.asarray(x), jnp.asarray(sig),
        params=jbm3d.BM3DParams(search=6, match_dtype=match_dtype), stages=stages))
    got = bm3d.bm3d_denoise_batch(
        torch.tensor(x), torch.tensor(sig),
        params=bm3d.BM3DParams(search=6, match_dtype=match_dtype), stages=stages).numpy()
    assert float(np.abs(got - want).mean()) < tol


def test_bm3d_turbo_rounding_matches_jax_pallas_matcher(rng):
    _, x = _noisy_batch(rng, size=34)  # (34 - 8) % 4 != 0: stride 2 keeps the scatter
    kw = dict(search=6, search_step=2, match_dtype="bfloat16")
    want = np.asarray(jbm3d.bm3d_denoise_batch(
        jnp.asarray(x), 0.1, params=jbm3d.BM3DParams(matcher="pallas_interpret", **kw)))
    got = bm3d.bm3d_denoise_batch(
        torch.tensor(x), 0.1, params=bm3d.BM3DParams(matcher="pallas", **kw)).numpy()
    assert float(np.abs(got - want).mean()) < 5e-3


@pytest.mark.parametrize("stages", [1, 2])
def test_bm3d_matches_direct_loop_oracle(stages):
    prm = bm3d.BM3DParams(block=4, step=2, search=3, group_ht=4, group_wie=4)
    rng = np.random.default_rng(1)
    img = np.clip(
        0.5 + 0.3 * np.sin(np.arange(16) / 3)[:, None] * np.cos(np.arange(16) / 2)
        + 0.08 * rng.standard_normal((16, 16)), 0, 1,
    ).astype(np.float32)
    got = bm3d.bm3d_denoise(torch.tensor(img), 0.08, params=prm, stages=stages).numpy()
    want = bm3d_oracle(img, 0.08, jbm3d.BM3DParams(block=4, step=2, search=3, group_ht=4,
                                                    group_wie=4), stages=stages)
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_per_lane_sigma(rng):
    _, x = _noisy_batch(rng, b=2)
    p = bm3d.BM3DParams(search=4)
    both = bm3d.bm3d_denoise_batch(torch.tensor(x), torch.tensor([0.05, 0.2]), params=p)
    for i, s in enumerate((0.05, 0.2)):
        one = bm3d.bm3d_denoise_batch(torch.tensor(x[i : i + 1]), s, params=p)
        torch.testing.assert_close(both[i], one[0], atol=1e-6, rtol=1e-5)
    assert float((both[0] - both[1]).abs().mean()) > 1e-3


def test_denoiser_sigma_contract_matches_jax(rng):
    _, x = _noisy_batch(rng, size=32)
    est = np.asarray([0.08, 0.0], np.float32)  # lane 1 falls back to strength * decay**t
    t = np.asarray([3, 3], np.int32)
    jden = jbm3d.BM3DDenoiser(denoise_strength=0.2, sigma_modifier=1.5, decay=0.9,
                              params=jbm3d.BM3DParams(search=4))
    tden = bm3d.BM3DDenoiser(denoise_strength=0.2, sigma_modifier=1.5, decay=0.9,
                             params=bm3d.BM3DParams(search=4))
    want = np.asarray(jden.denoise(jnp.asarray(x), jnp.asarray(est), jnp.asarray(t)))
    got = tden.denoise(torch.tensor(x), torch.tensor(est), torch.tensor(t)).numpy()
    assert float(np.abs(got - want).mean()) < 1e-3


@pytest.mark.parametrize("size", [32, 48])
@pytest.mark.parametrize("match_dtype,tol", [("float32", 1e-3), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("stages", [1, 2])
def test_dense_aggregation_matches_jax(rng, size, match_dtype, tol, stages):
    # search_step 4 on the step-4 grid, (size - 8) % 4 == 0: both packages
    # take the scatter-free dense aggregation (the turbo4 lane's path).
    _, x = _noisy_batch(rng, size=size)
    sig = np.asarray([0.1, 0.12], np.float32)
    bf16 = match_dtype == "bfloat16"
    kw = dict(search=8, search_step=4, match_dtype=match_dtype)
    assert bm3d.dense_aggregation(size, size, bm3d.BM3DParams(**kw))
    want = np.asarray(jbm3d.bm3d_denoise_batch(
        jnp.asarray(x), jnp.asarray(sig), stages=stages,
        params=jbm3d.BM3DParams(matcher="pallas_interpret" if bf16 else "xla", **kw)))
    got = bm3d.bm3d_denoise_batch(
        torch.tensor(x), torch.tensor(sig), stages=stages,
        params=bm3d.BM3DParams(matcher="pallas" if bf16 else "xla", **kw)).numpy()
    assert float(np.abs(got - want).mean()) < tol


def test_dense_aggregation_equals_the_scatter_aggregation(rng):
    _, x = _noisy_batch(rng, size=40)
    xt = torch.tensor(x)
    p = bm3d.BM3DParams(search=8, search_step=4)
    g = bm3d._geometry(40, 40, p, xt.device)
    assert g.shift_y is not None and g.shift_y.shape == (25, 9, 9)
    est, wgt, top_idx, py, px = bm3d._stage1(xt, torch.tensor([0.1, 0.12]), p, g)
    dense = bm3d._aggregate_dense(est, wgt, top_idx, 8, 4, 40, 40, g.kaiser, g.shift_y, g.shift_x)
    scatter, _ = bm3d._aggregate(est, wgt, py, px, 8, 40, 40, g.kaiser, g.agg)
    torch.testing.assert_close(dense, scatter, atol=2e-6, rtol=1e-5)


def test_dense_aggregation_runs_no_scatter(rng, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("the dense aggregation called K2")

    monkeypatch.setattr(bm3d, "bm3d_aggregate", refuse)
    _, x = _noisy_batch(rng, size=32)
    out = bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, bm3d.BM3DParams(search=8, search_step=4))
    assert out.shape == x.shape and torch.isfinite(out).all()
    # 34 px: (34 - 8) % 4 != 0, so the same parameters need the scatter.
    assert not bm3d.dense_aggregation(34, 34, bm3d.BM3DParams(search=8, search_step=4))


def test_cpu_path_takes_steps_the_kernels_are_not_built_for(rng):
    # K1 is built for reference steps up to 4 on a step grid; the plain
    # versions, which the CPU runs, take any step.
    _, x = _noisy_batch(rng, size=32)
    kw = dict(step=3, search=4)
    want = np.asarray(jbm3d.bm3d_denoise_batch(jnp.asarray(x), 0.1, params=jbm3d.BM3DParams(**kw)))
    got = bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, params=bm3d.BM3DParams(**kw)).numpy()
    assert float(np.abs(got - want).mean()) < 1e-3


def test_unported_paths_raise(rng):
    _, x = _noisy_batch(rng, size=32)
    xt = torch.tensor(x)
    with pytest.raises(NotImplementedError):
        bm3d.bm3d_denoise_batch(xt, 0.1, bm3d.BM3DParams(search=4), row_valid_bounds=(0, 32))
    with pytest.raises(NotImplementedError):
        bm3d.bm3d_denoise_batch(xt, 0.1, bm3d.BM3DParams(search=4, topk="approx"))


def test_cpu_tensors_take_plain_versions_and_count_no_launch(rng):
    k1.bm3d_match.launches = 0
    k2.bm3d_aggregate.launches = 0
    _, x = _noisy_batch(rng, size=32)
    bm3d.bm3d_denoise_batch(torch.tensor(x), 0.1, bm3d.BM3DParams(search=4))
    assert k1.bm3d_match.launches == 0 and k2.bm3d_aggregate.launches == 0


def test_each_bf16_mode_follows_its_own_jax_matcher():
    # The two JAX matchers round bf16 at different points, so they pick
    # different groups near ties; each port mode tracks its own matcher
    # more closely than the two JAX matchers track each other.
    rng = np.random.default_rng(0)
    x = (load_image("13.png", 48, 48)[None] + 0.1 * rng.standard_normal((1, 48, 48)))
    x = x.astype(np.float32)
    rows, offs = _grid(48, 8, 1)
    jax_xla = np.asarray(jbm3d._top_k_offsets(
        jbm3d._match_distances(jnp.asarray(x), rows, rows, offs, 8, match_dtype="bfloat16"), K))
    jax_pal = np.asarray(bm3d_match_pallas(
        jnp.asarray(x), tuple(rows.tolist()), tuple(rows.tolist()),
        tuple(map(tuple, offs.tolist())), 8, K, match_dtype="bfloat16", interpret=True))
    port_xla = k1.bm3d_match(torch.tensor(x), rows, rows, offs, 8, K, "bf16_xla").numpy()
    port_pal = k1.bm3d_match(torch.tensor(x), rows, rows, offs, 8, K, "bf16_pallas").numpy()
    cross = _set_agreement(jax_xla, jax_pal)
    assert cross < 1.0
    assert _set_agreement(port_xla, jax_xla) > cross
    assert _set_agreement(port_pal, jax_pal) > cross
