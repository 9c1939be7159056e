"""Tree-structured Parzen estimator (TPE) hyperparameter search.

A copy of ``pnp_svrg_tpu/tuning/tpe.py`` (numpy only; the port keeps its own
so that it never imports the JAX package): for the same seed and the same
losses it proposes bit-identical parameters.

Self-contained replacement for ``hyperopt.fmin(tpe.suggest, ...)`` which the
reference uses for every per-cell search (reference
``script_diff_sampratio_set12.py:122-129``; hyperopt is not available on
this platform). Implements the standard TPE recipe:

* ``n_startup`` random trials, then
* split observations at the gamma-quantile of loss into good/bad sets,
* model each set with a 1-D Parzen (Gaussian-kernel) density per parameter,
* draw candidates from the good density and keep the candidate maximizing
  the density ratio l(x)/g(x).

Parameter types mirror the hyperopt distributions the reference's search
spaces use: ``Uniform``, ``LogUniform`` (hp.loguniform), ``QUniform``
(hp.quniform -> integers), ``Choice``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Uniform:
    lo: float
    hi: float

    def sample(self, rng):
        return float(rng.uniform(self.lo, self.hi))

    def to_unit(self, x):
        return (x - self.lo) / (self.hi - self.lo)

    def from_unit(self, u):
        return self.lo + u * (self.hi - self.lo)

    def finalize(self, x):
        return float(np.clip(x, self.lo, self.hi))


@dataclasses.dataclass(frozen=True)
class LogUniform:
    lo: float  # lower bound (value space, > 0)
    hi: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(math.log(self.lo), math.log(self.hi))))

    def to_unit(self, x):
        return (math.log(x) - math.log(self.lo)) / (
            math.log(self.hi) - math.log(self.lo)
        )

    def from_unit(self, u):
        return math.exp(
            math.log(self.lo) + u * (math.log(self.hi) - math.log(self.lo))
        )

    def finalize(self, x):
        return float(np.clip(x, self.lo, self.hi))


@dataclasses.dataclass(frozen=True)
class QUniform:
    lo: float
    hi: float
    q: float = 1.0

    def sample(self, rng):
        return self.finalize(rng.uniform(self.lo, self.hi))

    def to_unit(self, x):
        return (x - self.lo) / (self.hi - self.lo)

    def from_unit(self, u):
        return self.lo + u * (self.hi - self.lo)

    def finalize(self, x):
        v = np.round(np.clip(x, self.lo, self.hi) / self.q) * self.q
        return int(v) if float(self.q).is_integer() else float(v)


@dataclasses.dataclass(frozen=True)
class Choice:
    options: Sequence[Any]

    def sample(self, rng):
        return self.options[int(rng.integers(len(self.options)))]


@dataclasses.dataclass
class Trial:
    params: dict
    loss: float
    extra: dict = dataclasses.field(default_factory=dict)


class Trials:
    def __init__(self):
        self.trials: list[Trial] = []

    def append(self, t: Trial):
        self.trials.append(t)

    @property
    def best(self) -> Trial:
        return min(self.trials, key=lambda t: t.loss)

    def losses(self):
        return [t.loss for t in self.trials]

    def __len__(self):
        return len(self.trials)


def _parzen_logpdf(u: float, centers: np.ndarray, bw: float) -> float:
    if centers.size == 0:
        return 0.0
    z = (u - centers) / bw
    return float(
        np.log(np.mean(np.exp(-0.5 * z * z)) / (bw * math.sqrt(2 * math.pi)) + 1e-12)
    )


class TPEState:
    """Incremental (ask/tell) TPE search over one space.

    ``ask(take)`` proposes candidates, ``tell(params, result)`` records an
    observation. :func:`fmin` is the closed-loop wrapper; the lockstep sweep
    (``tuning.sweep.sweep_grid_lockstep``) interleaves many states so
    one batched run evaluates a round of candidates from EVERY Set12 cell at
    once.
    """

    def __init__(self, space, seed=0, n_startup=10, gamma=0.25,
                 n_candidates=24, shared_keys=()):
        self.space = space
        self.rng = np.random.default_rng(seed)
        self.n_startup = n_startup
        self.gamma = gamma
        self.n_candidates = n_candidates
        self.shared_keys = tuple(shared_keys)
        self.trials = Trials()
        self.continuous = {
            k: d for k, d in space.items()
            if isinstance(d, (Uniform, LogUniform, QUniform))
        }
        self.choices = {k: d for k, d in space.items() if isinstance(d, Choice)}

    def tell(self, params: dict, out) -> None:
        loss = out["loss"] if isinstance(out, dict) else float(out)
        extra = out if isinstance(out, dict) else {}
        self.trials.append(Trial(params=params, loss=float(loss), extra=extra))

    def ask(self, take: int = 1, forced: dict | None = None) -> list[dict]:
        """Joint TPE proposal; returns the ``take`` best-scoring candidates.

        Candidates are whole configurations: each dimension is drawn from its
        good-set Parzen density and the candidate's score is the *product*
        density ratio l(x)/g(x) over all dimensions (hyperopt's factorized
        joint), so correlated optima (e.g. eta x dstrength) are ranked on
        full configurations rather than assembled per-parameter.

        ``forced`` pins specific parameters to given values (the lockstep
        sweep uses it to share the loops' integer arguments across cells in
        a round).
        """
        rng = self.rng
        forced = forced or {}
        trials, space = self.trials, self.space
        if len(trials) < self.n_startup or not self.continuous:
            base = {k: d.sample(rng) for k, d in space.items()}
            out = [
                {
                    k: (base[k] if k in self.shared_keys else d.sample(rng))
                    for k, d in space.items()
                }
                for _ in range(take)
            ]
            for p in out:
                p.update(forced)
            return out
        obs = sorted(trials.trials, key=lambda t: t.loss)
        n_good = max(1, int(math.ceil(self.gamma * len(obs))))
        good, bad = obs[:n_good], obs[n_good:]
        cand_u: dict[str, np.ndarray] = {}
        joint_scores = np.zeros(self.n_candidates)
        for k, d in self.continuous.items():
            if k in forced:
                continue
            gu = np.asarray([d.to_unit(t.params[k]) for t in good])
            bu = np.asarray([d.to_unit(t.params[k]) for t in bad])
            bw = max(1.0 / max(len(gu), 1) ** 0.5 * 0.5, 0.05)
            u = np.clip(
                rng.normal(gu[rng.integers(len(gu), size=self.n_candidates)],
                           bw),
                0.0,
                1.0,
            )
            cand_u[k] = u
            joint_scores += np.asarray(
                [_parzen_logpdf(ui, gu, bw) - _parzen_logpdf(ui, bu, bw)
                 for ui in u]
            )
        order = np.argsort(-joint_scores)[:take]
        shared_choice = {
            k: d.sample(rng) for k, d in self.choices.items()
            if k in self.shared_keys and k not in forced
        }
        out = []
        for i in order:
            p = {}
            for k, d in self.continuous.items():
                if k in forced:
                    p[k] = forced[k]
                    continue
                # Shared keys take the round winner's value so the batch
                # runs as one program.
                src = order[0] if k in self.shared_keys else i
                p[k] = d.finalize(d.from_unit(float(cand_u[k][src])))
            for k, d in self.choices.items():
                p[k] = forced.get(k, shared_choice.get(k, d.sample(rng)))
            out.append(p)
        return out

    @property
    def best(self) -> Trial:
        return self.trials.best


def fmin(
    objective: Callable[[dict], float | dict] | None,
    space: dict[str, Any],
    max_evals: int = 50,
    seed: int = 0,
    n_startup: int = 10,
    gamma: float = 0.25,
    n_candidates: int = 24,
    trials: Trials | None = None,
    batch_size: int = 1,
    batch_objective: Callable[[list[dict]], Sequence[float | dict]] | None = None,
    shared_keys: Sequence[str] = (),
) -> tuple[dict, Trials]:
    """Minimize ``objective(params)`` over ``space``.

    ``objective`` may return a float loss or a dict with a ``"loss"`` key
    (hyperopt style). Returns (best_params, trials).

    With ``batch_size > 1``, each round proposes ``batch_size`` candidates
    (diverse top-scoring draws from the TPE proposal density) and evaluates
    them together — pass ``batch_objective(list_of_params) -> list_of_results``
    to run them as ONE batched run (see
    ``tuning.sweep.make_batched_cell_objective``); otherwise the plain
    ``objective`` is mapped over the round.

    ``shared_keys``: parameters proposed ONCE per round and shared by every
    candidate in the round's batch — use for the loops' integer arguments
    (mini_batch_size / t2 / hist_size), which every lane of one batched run
    shares.
    """
    if objective is None and batch_objective is None:
        raise ValueError("provide objective or batch_objective")
    state = TPEState(space, seed=seed, n_startup=n_startup, gamma=gamma,
                     n_candidates=n_candidates, shared_keys=shared_keys)
    if trials is not None:
        state.trials = trials
    while len(state.trials) < max_evals:
        take = min(batch_size, max_evals - len(state.trials))
        batch = state.ask(take)
        if batch_objective is not None:
            results = batch_objective(batch)
            for p, r in zip(batch, results):
                state.tell(p, r)
        else:
            for p in batch:
                state.tell(p, objective(p))

    return dict(state.trials.best.params), state.trials
