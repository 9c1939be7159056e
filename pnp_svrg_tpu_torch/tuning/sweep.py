"""Sweep orchestration: the reference's Set12 grid scripts as batched runs.

Port of ``pnp_svrg_tpu/tuning/sweep.py`` (the reference's
``script_diff_sampratio_set12.py`` / ``script_diff_snr_set12.py``). The
reference fans 12 images out over a ``multiprocessing.Pool`` and runs a
hyperopt TPE search per (problem x algorithm x denoiser x ratio x SNR x
image) cell with 30-second wall-clock trials. Here each trial is an
*iteration-budgeted* ``run_pnp`` run, and a round of TPE candidates can run
as the lanes of one batched run (``trial_batch``, and the lockstep sweep
across cells).

Every ``run_pnp`` call gets a fresh ``torch.Generator`` on the problem's
device, seeded as the JAX package seeds its key: with the cell's ``seed``
per trial, with the round number per lockstep round. So every trial of a
cell sees the same minibatch stream, as in the JAX package.
"""

from __future__ import annotations

import csv
import dataclasses
from pathlib import Path
from typing import Any, Callable, Sequence

import numpy as np
import torch

from pnp_svrg_tpu_torch.algorithms.loops import run_pnp
from pnp_svrg_tpu_torch.core.batched import stack_problems
from pnp_svrg_tpu_torch.tuning.tpe import LogUniform, QUniform, TPEState, Uniform, fmin

STATIC_KEYS = ("mini_batch_size", "t2", "hist_size")  # the loops' integer arguments
CSV_COLUMNS = ["problem", "denoiser", "algorithm", "ratio", "snr", "image",
               "best_loss", "best_psnr", "best_params"]


@dataclasses.dataclass
class SweepCell:
    problem_name: str
    algo: str
    denoiser_name: str
    image: str
    ratio: float
    snr: float
    best_loss: float
    best_params: dict
    best_psnr: float = float("nan")  # final PSNR of the best trial


# Default search spaces per algorithm, mirroring the reference's hyperopt
# spaces (script_diff_sampratio_set12.py:64-107) but in eta units matched to
# the exact-gradient scaling.
def default_space(algo: str, m: int) -> dict:
    base = {
        "eta": LogUniform(1e-2, 1e4),
        "dstrength": Uniform(0.3, 2.0),
    }
    if algo in ("sgd", "svrg", "saga", "sarah"):
        base["mini_batch_size"] = QUniform(100, min(5000, m), 100)
    if algo in ("svrg", "sarah"):
        base["t2"] = QUniform(2, 20, 1)
    if algo == "saga":
        base["hist_size"] = QUniform(5, 30, 1)
    return base


def _run_kwargs(algo: str, n_iters: int, params: dict) -> dict:
    """``run_pnp``'s budget arguments for ``algo`` at ``n_iters`` logged
    steps, with the integer hyperparameters of ``params`` as Python ints."""
    if algo in ("sgd", "saga"):
        kwargs = {"n_iters": n_iters, "mini_batch_size": int(params["mini_batch_size"])}
        if algo == "saga":
            kwargs["hist_size"] = int(params["hist_size"])
        return kwargs
    if algo in ("svrg", "sarah"):
        t2 = int(params["t2"])
        return {"n_outer": max(1, n_iters // (t2 + 1)), "t2": t2,
                "mini_batch_size": int(params["mini_batch_size"])}
    return {"n_iters": n_iters}


def _generator(problem, seed: int) -> torch.Generator:
    return torch.Generator(device=problem.device).manual_seed(int(seed))


def _finals(out) -> np.ndarray:
    """Final PSNRs on the host, a non-finite one (a diverged lane) as -100."""
    finals = out["final_psnr"].cpu().numpy().astype(float)
    return np.where(np.isfinite(finals), finals, -100.0)


def make_cell_objective(
    algo: str,
    problem,
    denoiser_factory: Callable[[float], Any],
    n_iters: int = 100,
    seed: int = 0,
):
    """Objective for one sweep cell: loss = PSNR(init) - PSNR(final) at a
    fixed iteration budget (the wall-clock-free analog of reference
    ``tune_pnp_svrg``)."""
    init_psnr = float(problem.psnr(problem.x_init)[0])

    def objective(params: dict) -> dict:
        den = denoiser_factory(params.get("dstrength", 1.0))
        out = run_pnp(algo, problem, den, eta=params["eta"], generator=_generator(problem, seed),
                      diverge_check=True, **_run_kwargs(algo, n_iters, params))
        final = float(_finals(out)[0])
        return {"loss": init_psnr - final, "final_psnr": final}

    return objective


def make_batched_cell_objective(
    algo: str,
    problem,
    denoiser_factory: Callable[[Any], Any],
    n_iters: int = 100,
    seed: int = 0,
):
    """Batch objective: evaluate a ROUND of TPE candidates in one run.

    The continuous hyperparameters (eta, denoiser strength) are per-lane
    values, so C candidates become a C-lane problem batch driven by one
    ``run_pnp`` call. Candidates are grouped by their integer keys
    (mini_batch_size / t2 / hist_size), which every lane of a run shares.

    Pass to :func:`pnp_svrg_tpu_torch.tuning.fmin` as ``batch_objective``
    together with ``batch_size``.
    """
    init_psnr = float(problem.psnr(problem.x_init)[0])

    def run_group(group: list[tuple[int, dict]]):
        batched = stack_problems([problem] * len(group))
        eta = torch.tensor([p["eta"] for _, p in group], dtype=torch.float32)
        dstr = torch.tensor([p.get("dstrength", 1.0) for _, p in group], dtype=torch.float32,
                            device=problem.device)
        out = run_pnp(algo, batched, denoiser_factory(dstr), eta=eta,
                      generator=_generator(problem, seed), diverge_check=True,
                      **_run_kwargs(algo, n_iters, group[0][1]))
        return [
            (i, {"loss": init_psnr - f, "final_psnr": float(f)})
            for (i, _), f in zip(group, _finals(out))
        ]

    def static_sig(p: dict):
        return tuple(int(p[k]) for k in STATIC_KEYS if k in p)

    def batch_objective(params_list: list[dict]):
        groups: dict[tuple, list[tuple[int, dict]]] = {}
        for i, p in enumerate(params_list):
            groups.setdefault(static_sig(p), []).append((i, p))
        results: list = [None] * len(params_list)
        for group in groups.values():
            for i, res in run_group(group):
                results[i] = res
        return results

    return batch_objective


def _write_csv(results: Sequence[SweepCell], csv_path) -> None:
    path = Path(csv_path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(CSV_COLUMNS)
        for r in results:
            writer.writerow(
                [r.problem_name, r.denoiser_name, r.algo, r.ratio, r.snr,
                 r.image, r.best_loss, r.best_psnr, r.best_params]
            )


def sweep_grid_lockstep(
    cells: Sequence[dict],
    max_evals: int = 20,
    n_iters: int = 60,
    cand_per_round: int = 3,
    max_lanes: int = 48,
    csv_path: str | Path | None = None,
    verbose: bool = True,
) -> list[SweepCell]:
    """Run MANY per-cell TPE searches in lockstep, batching a round of
    candidates from every cell into shared runs.

    The reference fans its per-image searches over a ``multiprocessing.Pool``
    (``script_diff_sampratio_set12.py:146-150``); here they are lanes: all
    cells that share (problem family, algorithm, denoiser, ratio) -- e.g.
    the 12 Set12 images of one grid cell class -- propose
    ``cand_per_round`` candidates each per round, and the whole round runs
    as ceil(lanes / max_lanes) batched ``run_pnp`` calls (the last chunk
    padded by repeating its last lane).

    The integer hyperparameters (mini_batch_size / t2 / hist_size) must
    agree across a batch, so each round designates a rotating LEADER cell
    whose TPE proposal fixes them for everyone that round (``forced``);
    cells still explore the continuous dimensions independently. Search
    spaces should quantize them coarsely.

    Cell dicts need the same keys as :func:`sweep_grid`; problems in one
    group must have the same shapes (image size, measurement count).
    """
    groups: dict[tuple, list[dict]] = {}
    for cell in cells:
        key = (cell["problem_name"], cell["algo"], cell["denoiser_name"],
               cell.get("ratio", 0.0))
        groups.setdefault(key, []).append(cell)

    results: list[SweepCell] = []
    for (prob_name, algo, den_name, _ratio), members in groups.items():
        space = members[0].get("space") or default_space(algo, members[0]["problem"].m)
        static_keys = tuple(k for k in STATIC_KEYS if k in space)
        states = [
            TPEState(space, seed=1000 * i + int(members[i].get("seed", 0)),
                     shared_keys=static_keys, n_startup=max(2, max_evals // 4))
            for i in range(len(members))
        ]
        init_psnrs = [float(c["problem"].psnr(c["problem"].x_init)[0]) for c in members]
        rounds = -(-max_evals // cand_per_round)
        for rnd in range(rounds):
            take = min(cand_per_round, max_evals - len(states[0].trials))
            if take <= 0:
                break
            leader_idx = rnd % len(states)
            lead_params = states[leader_idx].ask(take)
            forced = {k: lead_params[0][k] for k in static_keys}
            proposals: list[tuple[int, dict]] = []
            for ci, st in enumerate(states):
                if ci == leader_idx:
                    proposals += [(ci, p) for p in lead_params]
                else:
                    proposals += [(ci, p) for p in st.ask(take, forced=forced)]
            for start in range(0, len(proposals), max_lanes):
                chunk = proposals[start : start + max_lanes]
                n_real = len(chunk)
                while len(chunk) < min(max_lanes, len(proposals)):
                    chunk.append(chunk[-1])
                batched = stack_problems([members[ci]["problem"] for ci, _ in chunk])
                eta = torch.tensor([p["eta"] for _, p in chunk], dtype=torch.float32)
                dstr = torch.tensor([p.get("dstrength", 1.0) for _, p in chunk],
                                    dtype=torch.float32, device=batched.device)
                den = members[0]["denoiser_factory"](dstr)
                out = run_pnp(algo, batched, den, eta=eta, generator=_generator(batched, rnd),
                              diverge_check=True, **_run_kwargs(algo, n_iters, forced))
                for (ci, p), f in zip(chunk[:n_real], _finals(out)[:n_real]):
                    states[ci].tell(
                        p, {"loss": init_psnrs[ci] - float(f), "final_psnr": float(f)}
                    )
            if verbose:
                done = len(states[0].trials)
                best = min(st.best.loss for st in states)
                print(
                    f"[lockstep {prob_name}/{algo}/{den_name}] round "
                    f"{rnd + 1}/{rounds}: {done} evals/cell, best loss "
                    f"{best:.2f}",
                    flush=True,
                )
        for cell, st in zip(members, states):
            rec = SweepCell(
                problem_name=prob_name,
                algo=algo,
                denoiser_name=den_name,
                image=str(cell.get("image", "")),
                ratio=float(cell.get("ratio", 0.0)),
                snr=float(cell.get("snr", 0.0)),
                best_loss=st.best.loss,
                best_params=dict(st.best.params),
                best_psnr=float(st.best.extra.get("final_psnr", float("nan"))),
            )
            results.append(rec)
            if verbose:
                print(
                    f"[lockstep] {rec.problem_name}/{rec.algo}/"
                    f"{rec.denoiser_name}/{rec.image} ratio={rec.ratio}: "
                    f"best loss {rec.best_loss:.2f} params {rec.best_params}",
                    flush=True,
                )
        if csv_path is not None:
            _write_csv(results, csv_path)  # incremental checkpoint per group
    return results


def sweep_grid(
    cells: Sequence[dict],
    max_evals: int = 25,
    n_iters: int = 100,
    csv_path: str | Path | None = None,
    verbose: bool = True,
    trial_batch: int = 1,
) -> list[SweepCell]:
    """Run a TPE search per cell dict and optionally emit a CSV.

    Each cell dict needs: problem (a one-lane instance), algo (str),
    denoiser_factory (dstrength -> denoiser), and labels problem_name /
    denoiser_name / image / ratio / snr. CSV columns mirror the reference's
    sweep output (``script_diff_sampratio_set12.py:151-160``).
    ``trial_batch > 1`` evaluates that many TPE candidates per batched run.
    """
    results = []
    for cell in cells:
        problem = cell["problem"]
        algo = cell["algo"]
        space = cell.get("space") or default_space(algo, problem.m)
        if trial_batch > 1:
            # The integer hyperparameters are proposed once per round so each
            # round of trial_batch candidates runs as ONE batched run.
            best, trials = fmin(
                None,
                space,
                max_evals=max_evals,
                seed=cell.get("seed", 0),
                batch_size=trial_batch,
                batch_objective=make_batched_cell_objective(
                    algo, problem, cell["denoiser_factory"], n_iters=n_iters,
                    seed=cell.get("seed", 0),
                ),
                shared_keys=tuple(k for k in STATIC_KEYS if k in space),
            )
        else:
            objective = make_cell_objective(
                algo, problem, cell["denoiser_factory"], n_iters=n_iters,
                seed=cell.get("seed", 0),
            )
            best, trials = fmin(
                objective, space, max_evals=max_evals, seed=cell.get("seed", 0)
            )
        rec = SweepCell(
            problem_name=cell.get("problem_name", type(problem).__name__),
            algo=algo,
            denoiser_name=cell.get("denoiser_name", "denoiser"),
            image=str(cell.get("image", "")),
            ratio=float(cell.get("ratio", 0.0)),
            snr=float(cell.get("snr", 0.0)),
            best_loss=trials.best.loss,
            best_params=dict(trials.best.params),
            best_psnr=float(trials.best.extra.get("final_psnr", float("nan"))),
        )
        results.append(rec)
        if verbose:
            print(
                f"[sweep] {rec.problem_name}/{rec.algo}/{rec.denoiser_name}"
                f"/{rec.image} ratio={rec.ratio} snr={rec.snr}: "
                f"best loss {rec.best_loss:.2f} params {rec.best_params}"
            )
    if csv_path is not None:
        _write_csv(results, csv_path)
    return results
