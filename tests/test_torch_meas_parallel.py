"""Port parity of the measurement-parallel layer (``parallel/meas.py``,
``parallel/sharded.py`` and SAGA's sharded table).

The JAX side runs as ``tests/test_meas_parallel.py`` runs it: ``shard_map``
on the 8 virtual CPU devices of ``tests/conftest.py`` and the
``vmap(axis_name="meas")`` emulation. The port runs on the CPU (plain kernel
versions), emulated in this process and, once, on two gloo ranks spawned
here. Problems are the JAX tests' own 16 px batches, carried over as numpy.

Tolerances: the split is exact (0/1 masks, row slices), so it is compared
array for array; the wrapper's identities hold to 1e-5 relative (the
shards' gradients add in another order); deterministic GD end to end within
1e-3 dB and 1e-4 in ``z``; the sharded stochastic loops against the
unsharded ones on the union of the shards' minibatches within 1e-3 dB and
1e-4 (the psum reorders the sums); the sharded SAGA table, and the
process-group run against the emulated one, bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from test_meas_parallel import DEN as JAX_DEN
from test_meas_parallel import _batched, _wrapper_eval

from pnp_svrg_tpu.core.batched import BatchedProblem as JaxBatchedProblem
from pnp_svrg_tpu.parallel import make_mesh as jax_make_mesh
from pnp_svrg_tpu.parallel import run_batch as jax_run_batch
from pnp_svrg_tpu.parallel import split_meas as jax_split_meas
from pnp_svrg_tpu.parallel.meas import MeasShardedBatched as JaxMeasShardedBatched
from pnp_svrg_tpu.parallel.mesh import MEAS_AXIS as JAX_MEAS_AXIS
from pnp_svrg_tpu_torch.algorithms import loops
from pnp_svrg_tpu_torch.convert import csmri_from_numpy, deblur_from_numpy, pr_from_numpy
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.denoisers.tv import TVDenoiser
from pnp_svrg_tpu_torch.parallel import (
    MeasShardedBatched,
    make_mesh,
    pr_grad_full_sharded,
    run_batch,
    run_batch_meas_emulated,
    shard_pr_problem,
    sharded_pnp_step,
    split_meas,
)
from pnp_svrg_tpu_torch.parallel.mesh import LocalAxis, spawn
from pnp_svrg_tpu_torch.problems.pr import PhaseRetrieval

DEN = TVDenoiser(sigma_modifier=1.0)
PROBLEMS = ("csmri", "pr", "deblur")
SPAWN_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _port(jb, problem: str):
    """The port's batched problem from a JAX batched problem."""
    p = jb.problems
    if problem == "csmri":
        return csmri_from_numpy({f: np.asarray(getattr(p, f))
                                 for f in ("y", "mask", "x", "x_init", "m0", "snr", "sigma")}, "cpu")
    fields = {"pr": ("a", "y", "x", "x_init", "snr", "sigma"),
              "deblur": ("y", "b", "b_adj", "x", "x_init", "ds_idx", "ds_w", "allowed", "snr",
                         "sigma")}[problem]
    make = pr_from_numpy if problem == "pr" else deblur_from_numpy
    return stack_problems([make({f: np.asarray(getattr(p, f))[i] for f in fields}, "cpu")
                           for i in range(jb.batch_size)])


@pytest.fixture(scope="module")
def batches():
    return {name: (jb, _port(jb, name)) for name, jb in
            ((n, _batched(n)) for n in PROBLEMS)}


def _z(tp):
    return tp.x_init.reshape(tp.batch_size, -1) * 0.9 + 0.01


# ---------------------------------------------------------------------------
# split_meas
# ---------------------------------------------------------------------------


def _same_field(port: torch.Tensor, jax_field: np.ndarray, name: str):
    """``port`` against one shard's JAX field (lanes leading): equal, or
    held once (a leading 1, or no lane axis) and equal to every lane's."""
    got = port.numpy()
    if got.ndim == jax_field.ndim and got.shape[0] == jax_field.shape[0]:
        np.testing.assert_array_equal(got, jax_field, err_msg=name)
        return
    once = got[0] if got.ndim == jax_field.ndim else got
    for lane in jax_field:
        np.testing.assert_array_equal(once, lane, err_msg=name)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("problem", PROBLEMS + ("pr_kept_once",))
def test_split_meas_matches_jax(batches, problem, n):
    family = "pr" if problem == "pr_kept_once" else problem
    jb, tp = batches[family]
    if problem == "pr_kept_once":  # replicas holding one A (1, M, N)
        one = pr_from_numpy({f: np.asarray(getattr(jb.problems, f))[0]
                             for f in ("a", "y", "x", "x_init", "snr", "sigma")}, "cpu")
        tp = stack_problems([one] * 2)
        jb = JaxBatchedProblem(jax.tree_util.tree_map(lambda l: l[:1].repeat(2, 0), jb.problems))
        assert tp.a.shape[0] == 1
    want = jax_split_meas(jb, n)
    got = split_meas(tp, n)
    assert len(got) == n
    for s, shard in enumerate(got):
        if family == "pr":
            assert shard.a.shape[0] == tp.a.shape[0]  # an A held once stays held once
            assert shard.m == tp.m // n
        for f in ("a", "y", "x", "x_init", "mask", "m0", "allowed", "ds_idx", "ds_w", "b"):
            if hasattr(shard, f):
                _same_field(getattr(shard, f), np.asarray(getattr(want, f))[s], f)
    with pytest.raises(ValueError, match="not divisible"):
        split_meas(tp, 3)


def test_split_meas_rejects_other_problems():
    with pytest.raises(TypeError, match="no measurement split"):
        split_meas(object(), 2)
    with pytest.raises(ValueError, match="n >= 1"):
        split_meas(object(), 0)


# ---------------------------------------------------------------------------
# The wrapper's identities
# ---------------------------------------------------------------------------


def _wrapper(tp, n):
    return MeasShardedBatched(split_meas(tp, n), LocalAxis("meas", n), 2.0 * tp.m)


def _close(got, want, rtol=1e-5):
    got = np.asarray(got, np.float64).reshape(np.shape(want))
    want = np.asarray(want, np.float64)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rtol * scale, (np.abs(got - want).max(), scale)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("problem", PROBLEMS)
def test_wrapper_grad_full_and_f_match_jax(batches, problem, n):
    jb, tp = batches[problem]
    z = _z(tp)
    zj = jax.numpy.asarray(z.numpy())
    sp = _wrapper(tp, n)
    want_g = np.asarray(_wrapper_eval(jb, n, lambda w: w.grad_full(zj))).reshape(tp.batch_size, -1)
    _close(sp.grad_full(z).reshape(tp.batch_size, -1), want_g)
    _close(sp.grad_full(z).reshape(tp.batch_size, -1), tp.grad_full(z).reshape(tp.batch_size, -1))
    want_f = np.asarray(_wrapper_eval(jb, n, lambda w: w.f(zj)))
    _close(sp.f(z), want_f)
    _close(sp.f(z), tp.f(z))


@pytest.mark.parametrize("problem", PROBLEMS)
def test_wrapper_grad_stoch_matches_jax_and_the_union(batches, problem):
    jb, tp = batches[problem]
    n, k = 2, 64
    sp = _wrapper(tp, n)
    mb = sp.select_mb(None, k)  # (n, ...) from the (shard, lane) streams
    assert tuple(mb.shape) == sp.mb_shape(k)
    z = _z(tp)
    got = sp.grad_stoch(z, mb)
    # JAX's wrapper on the same per-shard minibatches.
    split = jax_split_meas(jb, n)

    def run(local, m):
        return JaxMeasShardedBatched(JaxBatchedProblem(local), n, 2.0 * jb.m).grad_stoch(
            jax.numpy.asarray(z.numpy()), m)

    want = jax.vmap(run, axis_name=JAX_MEAS_AXIS)(split, jax.numpy.asarray(mb.numpy()))[0]
    _close(got, np.asarray(want))
    # The unsharded problem on the union of the shards' minibatches.
    if problem == "pr":
        rows = tp.m // n
        union = torch.cat([mb[s] + s * rows for s in range(n)], dim=-1)
        assert all(set(u.tolist()) <= set(range(s * rows, (s + 1) * rows))
                   for s in range(n) for u in (mb[s] + s * rows))
    else:
        union = mb.sum(dim=0)
        assert union.max() <= 1 and (union.reshape(tp.batch_size, -1).sum(-1) == k).all()
        for s, shard in enumerate(split_meas(tp, n)):  # each shard draws in its own block
            assert ((mb[s] > 0) <= (shard.full_mb().reshape(mb[s].shape) > 0)).all()
    _close(got, tp.grad_stoch(z, union))


def test_select_mb_checks_divisibility(batches):
    _, tp = batches["csmri"]
    with pytest.raises(ValueError, match="not divisible"):
        _wrapper(tp, 2).select_mb(None, 33)


# ---------------------------------------------------------------------------
# End to end
# ---------------------------------------------------------------------------


def test_mesh_gd_matches_jax_end_to_end():
    """GD draws nothing: the port's (1, 2) emulated mesh against JAX's
    (4, 2) device mesh on the same 32 px problems."""
    jb = _batched("csmri", h=32)
    tp = _port(jb, "csmri")
    hp = dict(eta=500.0, n_iters=5)
    want = jax_run_batch("gd", jb, JAX_DEN, key=jax.random.PRNGKey(1), mesh=jax_make_mesh((4, 2)), **hp)
    got = run_batch("gd", tp, DEN, mesh=make_mesh((1, 2), device="cpu", emulate=True), **hp)
    np.testing.assert_allclose(got["psnr_per_iter"].numpy(), np.asarray(want["psnr_per_iter"]),
                               atol=1e-3)
    np.testing.assert_allclose(got["z"].numpy(), np.asarray(want["z"]), atol=1e-4)


LOOP_HP = {
    "sgd": (("n_iters",), dict(eta=10.0, n_iters=4, mini_batch_size=32)),
    "svrg": (("n_outer", "t2"), dict(eta=10.0, n_outer=2, t2=2, mini_batch_size=32)),
    "saga": (("n_iters",), dict(eta=10.0, n_iters=4, mini_batch_size=32, hist_size=4)),
    "sarah": (("n_outer", "t2"), dict(eta=10.0, n_outer=2, t2=2, mini_batch_size=32)),
}


def _injected(tp, n: int, lead: tuple, k: int, rng) -> tuple:
    """Per-shard minibatches (n,) + lead + a shard's ``mb_shape(k // n)``
    drawn with numpy inside each shard's block, and their union for the
    unsharded problem."""
    split = split_meas(tp, n)
    kl = k // n
    steps = int(np.prod(lead, dtype=np.int64))
    per = []
    for p in split:
        if isinstance(p, PhaseRetrieval):
            idx = np.stack([rng.permutation(p.m)[:kl] for _ in range(steps * p.batch_size)])
            per.append(idx.reshape(lead + (p.batch_size, kl)))
            continue
        allowed = p.full_mb().numpy().reshape(p.batch_size, -1) > 0
        m = np.zeros((steps, p.batch_size, allowed.shape[1]), np.float32)
        for t in range(steps):
            for b in range(p.batch_size):
                m[t, b, rng.choice(np.flatnonzero(allowed[b]), kl, replace=False)] = 1.0
        per.append(m.reshape(lead + tuple(p.mb_shape(kl))))
    sharded = torch.tensor(np.stack(per))
    if isinstance(tp, PhaseRetrieval):
        union = torch.cat([sharded[s] + s * (tp.m // n) for s in range(n)], dim=-1)
    else:
        union = sharded.sum(dim=0)
    return sharded, union


@pytest.mark.parametrize("problem,algo", [("csmri", a) for a in LOOP_HP]
                         + [("pr", "svrg"), ("deblur", "svrg")])
def test_sharded_loops_equal_unsharded_on_the_union(batches, problem, algo):
    _, tp = batches[problem]
    lead_names, hp = LOOP_HP[algo]
    hp = dict(hp, eta=0.05 if problem == "pr" else (1e4 if problem == "deblur" else 10.0))
    rng = np.random.default_rng(5)
    lead = tuple(hp[k] for k in lead_names)
    masks, union = _injected(tp, 2, lead, hp["mini_batch_size"], rng)
    extra_sh, extra_un = {}, {}
    if algo == "saga":
        mb0, mb0_union = _injected(tp, 2, (), hp["mini_batch_size"], rng)
        slots = torch.tensor(rng.integers(0, hp["hist_size"], hp["n_iters"]))
        extra_sh = dict(mb0=mb0, slots=slots)
        extra_un = dict(mb0=mb0_union, slots=slots)
    fn = loops._ALGOS[algo]
    got = run_batch_meas_emulated(fn, tp, DEN, 2, masks=masks, **extra_sh, **hp)
    want = fn(tp, DEN, masks=union, **extra_un, **hp)
    np.testing.assert_allclose(got["psnr_per_iter"].numpy(), want["psnr_per_iter"].numpy(),
                               atol=1e-3)
    np.testing.assert_allclose(got["z"].numpy(), want["z"].numpy(), atol=1e-4)


def test_saga_sharded_table_equals_replicated(batches):
    _, tp = batches["csmri"]
    hp = dict(eta=10.0, n_iters=6, mini_batch_size=32, hist_size=4)
    rep = run_batch_meas_emulated(loops.pnp_saga, tp, DEN, 2, seed=3, **hp)
    sh = run_batch_meas_emulated(loops.pnp_saga, tp, DEN, 2, seed=3, table_axis="meas",
                                 table_shards=2, **hp)
    assert torch.equal(sh["z"], rep["z"])
    assert torch.equal(sh["psnr_per_iter"], rep["psnr_per_iter"])


def test_saga_table_shards_validation(batches):
    _, tp = batches["csmri"]
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(ValueError, match="not divisible"):
        loops.pnp_saga(tp, DEN, 1.0, 2, 32, generator=gen, hist_size=5, table_shards=2,
                       table_axis=LocalAxis("meas", 2))
    with pytest.raises(ValueError, match="requires a bound table_axis"):
        loops.pnp_saga(tp, DEN, 1.0, 2, 32, generator=gen, hist_size=4, table_shards=2)
    with pytest.raises(ValueError, match="table_shards"):
        loops.pnp_saga(tp, DEN, 1.0, 2, 32, generator=gen, hist_size=4, table_shards=2,
                       table_axis=LocalAxis("meas", 4))


def test_pr_sharded_gradient_and_step(batches):
    _, tp = batches["pr"]
    z = _z(tp)
    mesh = make_mesh((1, 2), device="cpu", emulate=True)
    shards = shard_pr_problem(tp, mesh)
    _close(pr_grad_full_sharded(shards, z, mesh), tp.grad_full(z))
    one = make_mesh((1, 1), device="cpu", emulate=True)
    z1, psnr = sharded_pnp_step(mesh, DEN, 0.05)(shards, z)
    z0, psnr0 = sharded_pnp_step(one, DEN, 0.05)(shard_pr_problem(tp, one), z)
    np.testing.assert_allclose(psnr.numpy(), psnr0.numpy(), atol=1e-3)
    np.testing.assert_allclose(z1.numpy(), z0.numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------


def _two_rank_meas(rank: int, tp_csmri, tp_pr, hp: dict) -> dict:
    """On each of two ranks: SVRG and the SAGA table over a (1, 2) process-group
    mesh, and the sharded PR gradient and step."""
    torch.set_num_threads(1)
    mesh = make_mesh((1, 2), device="cpu")
    out = {"svrg": run_batch("svrg", tp_csmri, DEN, seed=3, mesh=mesh, **hp["svrg"])["z"].numpy(),
           "saga": run_batch("saga", tp_csmri, DEN, seed=3, mesh=mesh, table_axis="meas",
                             table_shards=2, **hp["saga"])["z"].numpy()}
    z = _z(tp_pr)
    shards = shard_pr_problem(tp_pr, mesh)
    out["pr_grad"] = pr_grad_full_sharded(shards, z, mesh).numpy()
    out["pr_step"] = sharded_pnp_step(mesh, DEN, 0.05)(shards, z)[0].numpy()
    out["calls"] = mesh.axis("meas").calls
    return out


def test_process_group_meas_equals_emulated(batches, tmp_path):
    """Two gloo ranks on the CPU run the same program as the emulation:
    equal results on both ranks, bit for bit, each rank denoising its own
    replicated iterate (no broadcast)."""
    _, tc = batches["csmri"]
    _, tpr = batches["pr"]
    hp = {"svrg": dict(eta=10.0, n_outer=2, t2=2, mini_batch_size=32),
          "saga": dict(eta=10.0, n_iters=4, mini_batch_size=32, hist_size=4)}
    ranks = spawn(_two_rank_meas, 2, "gloo", (tc, tpr, hp), SPAWN_TIMEOUT_S, str(tmp_path))
    emu = {"svrg": run_batch_meas_emulated(loops.pnp_svrg, tc, DEN, 2, seed=3, **hp["svrg"]),
           "saga": run_batch_meas_emulated(loops.pnp_saga, tc, DEN, 2, seed=3, table_axis="meas",
                                           table_shards=2, **hp["saga"])}
    mesh = make_mesh((1, 2), device="cpu", emulate=True)
    shards = shard_pr_problem(tpr, mesh)
    z = _z(tpr)
    for r in ranks:
        for name in ("svrg", "saga"):
            np.testing.assert_array_equal(r[name], emu[name]["z"].numpy(), err_msg=name)
        np.testing.assert_array_equal(r["pr_grad"], pr_grad_full_sharded(shards, z, mesh).numpy())
        np.testing.assert_array_equal(r["pr_step"],
                                      sharded_pnp_step(mesh, DEN, 0.05)(shards, z)[0].numpy())
        assert r["calls"]["all_reduce"] > 0 and r["calls"]["broadcast"] == 0
