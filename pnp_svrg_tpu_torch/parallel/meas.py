"""Measurement-parallel PnP: the five loops with their measurements split
over the ``meas`` axis of a (batch, meas) mesh.

Port of ``pnp_svrg_tpu/parallel/meas.py``. Each problem family splits its
measurements into ``n`` disjoint blocks (:func:`split_meas`):

* ``CSMRI``: the 0/1 sampling mask in blocks of spectrum rows; every shard
  keeps full-size (B, H, W) arrays (the FFT needs the whole grid) and its
  own ``m0``.
* ``PhaseRetrieval``: A's rows split physically; an A held once for all
  lanes, (1, M, N), stays held once, (1, M/n, N), in every shard.
* ``Deblur``: the low-resolution pixels through the ``allowed`` ownership
  mask; the shared bilinear gather stays shared.

:class:`MeasShardedBatched` speaks the problems' protocol to the unchanged
loops of ``algorithms/loops.py`` from the algebraic identities every problem
provides: ``grad_full == psum(grad_sum(z)) / psum(m_total)`` (``grad_sum`` is
``grad_stoch`` over all of a shard's measurements) and
``f == psum(2 m_local f_local) / (2 m)``; stochastic gradients are psummed.
The psums go through the meas axis object (``parallel/mesh.py``): a
``dist.all_reduce`` between ranks, or a sum over a leading shard axis in one
process (:func:`run_batch_meas_emulated`), the same program either way.

Minibatches are stratified: each shard draws ``k / n`` measurements of its
own block. Every (shard, lane) pair draws from its own ``torch.Generator``,
seeded from ``(seed, shard, global lane)`` (the JAX package folds the shard
and the global lane id into the key, ``meas.py:233-243``), so the draws do
not depend on how lanes and shards are laid out over processes: the
emulated and the process-group runs draw the same minibatches. Injected
minibatches (``masks``, SAGA's ``mb0``) carry a leading shard axis:
``(n,) + lead + problem.mb_shape(k // n)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pnp_svrg_tpu_torch.core.batched import take_lanes
from pnp_svrg_tpu_torch.parallel.mesh import BATCH_AXIS, MEAS_AXIS, LocalAxis
from pnp_svrg_tpu_torch.problems.csmri import CSMRI
from pnp_svrg_tpu_torch.problems.deblur import Deblur
from pnp_svrg_tpu_torch.problems.pr import PhaseRetrieval

OUT_LANE_DIMS = {"z": 0, "image": 0, "psnr_per_iter": 1, "final_psnr": 0,
                 "psnr_before_denoise": -1, "sigma_est": -1}  # a result's lane axis
INJECTED = ("masks", "mb0")  # minibatch arguments with a leading shard axis


# ---------------------------------------------------------------------------
# Measurement splitting
# ---------------------------------------------------------------------------


def _row_blocks(rows: int, n: int, device) -> torch.Tensor:
    """(n, rows) 0/1 ownership of contiguous row blocks."""
    if rows % n:
        raise ValueError(f"{rows} rows not divisible by {n} meas shards")
    owner = torch.arange(rows, device=device) // (rows // n)
    return (owner[None, :] == torch.arange(n, device=device)[:, None]).to(torch.float32)


def split_meas(problem, n: int) -> list:
    """``n`` problems, each holding one disjoint block of ``problem``'s
    measurements and a copy of everything else."""
    if n < 1:
        raise ValueError(f"need n >= 1 shards, got {n}")
    if isinstance(problem, CSMRI):
        return _split_csmri(problem, n)
    if isinstance(problem, PhaseRetrieval):
        return _split_pr(problem, n)
    if isinstance(problem, Deblur):
        return _split_deblur(problem, n)
    raise TypeError(f"no measurement split for {type(problem).__name__}")


def _split_csmri(p: CSMRI, n: int) -> list:
    blocks = _row_blocks(p.h, n, p.device)
    out = []
    for sel in blocks:
        sel = sel[None, :, None]  # (1, H, 1) against (B, H, W)
        mask = p.mask * sel
        out.append(dataclasses.replace(p, y=p.y * sel.to(p.y.dtype), mask=mask,
                                       m0=mask.sum(dim=(-2, -1))))
    return out


def _split_pr(p: PhaseRetrieval, n: int) -> list:
    if p.m % n:
        raise ValueError(f"{p.m} measurement rows not divisible by {n} shards")
    rows = p.m // n
    return [dataclasses.replace(p, a=p.a[:, i * rows:(i + 1) * rows], y=p.y[:, i * rows:(i + 1) * rows])
            for i in range(n)]


def _split_deblur(p: Deblur, n: int) -> list:
    blocks = _row_blocks(p.m, n, p.device)
    return [dataclasses.replace(p, allowed=p.allowed * blk[None]) for blk in blocks]


# ---------------------------------------------------------------------------
# The collective problem wrapper
# ---------------------------------------------------------------------------


def lane_seed(seed: int, shard: int, lane: int) -> int:
    """The seed of a (shard, global lane) minibatch stream."""
    a, b = np.random.SeedSequence([seed, shard, lane]).generate_state(2, np.uint32)
    return (int(a) << 31 | int(b)) & (2**63 - 1)


class MeasShardedBatched:
    """This process's measurement shards of a batched problem, speaking the
    whole problem's protocol through psums over the meas ``axis``.

    ``shards``: one problem per shard this process holds (``axis.shards``),
    each with the same lanes; ``f_den``: ``2 m`` of the unsplit problem
    (``f``'s normaliser); ``lane0``: the global index of the first lane
    (the lanes' minibatch streams are seeded by it); ``seed``: the streams'
    seed. The iterate stays replicated along the axis bit for bit: the
    psummed gradients are the same on every shard, and every shard denoises
    its own copy with denoisers that repeat themselves exactly (K2 and the
    Deblur-SR adjoint sum in a fixed order), as the JAX package assumes
    (``meas.py:314-315``); ``psnr`` and the other replicated fields come
    from the first shard."""

    def __init__(self, shards: list, axis, f_den: float, seed: int = 0, lane0: int = 0):
        if len(shards) != len(axis.shards):
            raise ValueError(f"{len(shards)} shards for an axis holding {len(axis.shards)}")
        self.shards, self.axis = shards, axis
        first = shards[0]
        b = first.batch_size
        self._lanes = [[take_lanes(p, slice(i, i + 1)) for i in range(b)] for p in shards]
        self._gens = [[torch.Generator(device=first.device).manual_seed(lane_seed(seed, s, lane0 + i))
                       for i in range(b)] for s in axis.shards]
        m_tot = torch.stack([torch.as_tensor(p.m_total(), dtype=torch.float32, device=first.device)
                             .expand(b) for p in shards])
        self.m_tot = axis.psum(m_tot)  # (B,) every shard's measurements
        self.f_den = f_den

    # -- replicated delegates -------------------------------------------------
    def __getattr__(self, name):
        if name in ("h", "w", "n", "batch_size", "x", "x_init", "device", "psnr"):
            return getattr(self.shards[0], name)
        raise AttributeError(name)

    # -- collective measurement ops -------------------------------------------
    def _psum(self, per_shard) -> torch.Tensor:
        return self.axis.psum(torch.stack(per_shard))

    def grad_full(self, z):
        g = self._psum([p.grad_sum(z) for p in self.shards])
        return g / self.m_tot.reshape((-1,) + (1,) * (g.dim() - 1))

    def grad_stoch(self, z, mb):
        """``mb``: (local shards,) + a shard's minibatch."""
        return self._psum([p.grad_stoch(z, mb[i]) for i, p in enumerate(self.shards)])

    def f(self, z):
        return self._psum([p.f(z) * (2.0 * p.m) for p in self.shards]) / self.f_den

    def mb_shape(self, k: int) -> tuple:
        return (len(self.shards),) + tuple(self.shards[0].mb_shape(k // self.axis.size))

    def select_mb(self, generator, k: int):
        """Stratified draw, ``k / n`` of each shard's own measurements a lane,
        from the (shard, lane) streams; ``generator`` (the loop's) is not
        used."""
        del generator
        if k % self.axis.size:
            raise ValueError(f"mini_batch_size {k} not divisible by {self.axis.size} meas shards")
        kl = k // self.axis.size
        return torch.stack([
            torch.cat([lane.select_mb(g, kl) for lane, g in zip(lanes, gens)])
            for lanes, gens in zip(self._lanes, self._gens)
        ])


# ---------------------------------------------------------------------------
# Runners
# ---------------------------------------------------------------------------


def _lane_range(batch_size: int, batch_axis) -> tuple:
    """(first global lane, lanes) of this process along the batch axis."""
    if batch_size % batch_axis.size:
        raise ValueError(f"batch {batch_size} not divisible by {batch_axis.size} batch shards")
    per = batch_size // batch_axis.size
    return batch_axis.shards[0] * per, per * len(batch_axis.shards)


def local_injection(t: torch.Tensor, axis, mb_ndim: int, lanes: slice) -> torch.Tensor:
    """An injected minibatch tensor ``(n,) + lead + mb`` cut to this
    process's shards and lanes, the shard axis moved after ``lead``."""
    lead = t.dim() - 1 - mb_ndim
    t = t[axis.shards.start:axis.shards.stop]
    t = t.narrow(1 + lead, lanes.start, lanes.stop - lanes.start)
    return t.movedim(0, lead)


def run_local(fn, shards: list, meas_axis, batch_axis, denoiser, seed: int, f_den: float,
              hp: dict, axes: dict | None = None) -> dict:
    """Run one loop on this process's (shards x lanes) and gather the full
    batch along the batch axis. ``shards``: this process's meas shards of
    the whole batch. A ``table_axis`` named by a string is looked up in
    ``axes``."""
    lane0, count = _lane_range(shards[0].batch_size, batch_axis)
    lanes = slice(lane0, lane0 + count)
    local = [take_lanes(p, lanes) for p in shards]
    hp = dict(hp)
    mb_ndim = len(local[0].mb_shape(1))
    for name in INJECTED:
        if hp.get(name) is not None:
            hp[name] = local_injection(hp[name], meas_axis, mb_ndim, lanes)
    if isinstance(hp.get("table_axis"), str):
        hp["table_axis"] = (axes or {})[hp["table_axis"]]
    if "eta" in hp and isinstance(hp["eta"], torch.Tensor) and hp["eta"].dim() == 1:
        hp["eta"] = hp["eta"][lanes]
    problem = MeasShardedBatched(local, meas_axis, f_den, seed=seed, lane0=lane0)
    gen = torch.Generator(device=problem.device).manual_seed(seed)  # replicated: SAGA's slots
    out = fn(problem, lanes_of(denoiser, lanes), generator=gen, **hp)
    return {k: batch_axis.all_gather(out[k][None], dim=d) if batch_axis.size > 1 else out[k]
            for k, d in OUT_LANE_DIMS.items()}


def lanes_of(denoiser, lanes: slice):
    """The denoiser with its per-lane (B,) tensor fields cut to ``lanes``,
    also in a denoiser it wraps."""
    if not dataclasses.is_dataclass(denoiser):
        return denoiser
    cut = {}
    for f in dataclasses.fields(denoiser):
        v = getattr(denoiser, f.name)
        if isinstance(v, torch.Tensor) and v.dim() == 1:
            cut[f.name] = v[lanes]
        elif dataclasses.is_dataclass(v) and lanes_of(v, lanes) is not v:
            cut[f.name] = lanes_of(v, lanes)
    return dataclasses.replace(denoiser, **cut) if cut else denoiser


def run_batch_meas_sharded(fn, problem, denoiser, mesh, seed: int = 0, **hp) -> dict:
    """Run one PnP loop over a (batch, meas) mesh: this process's lanes and
    measurement shard, every gradient psummed over the meas axis, and the
    full batch's result on every rank."""
    meas = mesh.axis(MEAS_AXIS)
    split = split_meas(problem, meas.size)
    mine = [split[s] for s in meas.shards]
    return run_local(fn, mine, meas, mesh.axis(BATCH_AXIS), denoiser, seed, 2.0 * problem.m, hp,
                     mesh.axes)


def run_batch_meas_emulated(fn, problem, denoiser, n_meas: int, seed: int = 0, **hp) -> dict:
    """The same measurement-sharded program in this one process: the
    ``n_meas`` shards on a leading tensor axis, every psum a sum over it."""
    meas = LocalAxis(MEAS_AXIS, n_meas)
    return run_local(fn, split_meas(problem, n_meas), meas, LocalAxis(BATCH_AXIS, 1),
                     denoiser, seed, 2.0 * problem.m, hp, {MEAS_AXIS: meas})
