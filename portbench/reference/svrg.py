"""PnP-SVRG's schedule and update (Reddi et al. 2016 in the PnP form of the
reference code): each outer round i takes a full-gradient snapshot
``mu = grad(w)`` at its start point w, then ``t2`` inner steps
``z <- D(z - eta_i * ((g(z, mb) - g(w, mb)) / b + mu))`` with
``eta_i = eta * lr_decay**i``; every step denoises once. The trace logs the
start and each round's snapshot and steps: ``n_outer * (t2 + 1)`` entries a
lane after the start."""

from __future__ import annotations


def entries(traffic: dict) -> int:
    return traffic["n_outer"] * (traffic["t2"] + 1)


def denoises(traffic: dict) -> int:
    return traffic["n_outer"] * traffic["t2"]


def gradients(traffic: dict) -> tuple:
    """(full gradients, minibatch gradients) a reconstruction."""
    return traffic["n_outer"], 2 * traffic["n_outer"] * traffic["t2"]


def rounds(traffic: dict) -> int:
    return traffic["n_outer"]


def round_calls(traffic: dict, i: int) -> list:
    """The denoiser calls of outer round i, by their index in a reconstruction."""
    return list(range(i * traffic["t2"], (i + 1) * traffic["t2"]))


def round_draws(traffic: dict, i: int) -> list:
    """The minibatch draws of outer round i, by their index in a reconstruction."""
    return list(range(i * traffic["t2"], (i + 1) * traffic["t2"]))


def updates(problem, inputs: dict, start, outs: list, draws: list, eta, traffic: dict, i: int,
            tf32: bool = False) -> list:
    """For each step of round i: (the iterate it starts from, the update
    ``eta_i * v`` it should subtract), from the program's own states: the
    round's start point ``start`` and each step's denoised output ``outs``,
    its minibatches ``draws``. ``problem`` is a reference problem module."""
    k = float(traffic["mini_batch_size"])
    step = eta * traffic["lr_decay"] ** i
    mu = problem.grad_full(inputs, start, tf32)
    out = []
    for j, mb in enumerate(draws):
        z = start if j == 0 else outs[j - 1]
        v = (problem.grad_stoch(inputs, z, mb, tf32) - problem.grad_stoch(inputs, start, mb, tf32)) / k + mu
        out.append((z, step[:, None].to(v.dtype) * v))
    return out
