"""PnP-GD's schedule and update (the reference code's ``pnp_gd``): each
step ``z <- D(z - eta_i * grad(z))`` with the full gradient and
``eta_i = eta * lr_decay**i``; every step denoises once. The trace logs the
start and each step: ``n_iters`` entries a lane after the start. For the
check, the steps are cut into rounds of ``check.steps``."""

from __future__ import annotations


def entries(traffic: dict) -> int:
    return traffic["n_iters"]


def denoises(traffic: dict) -> int:
    return traffic["n_iters"]


def gradients(traffic: dict) -> tuple:
    """(full gradients, minibatch gradients) a reconstruction."""
    return traffic["n_iters"], 0


def rounds(traffic: dict) -> int:
    return traffic["n_iters"] // traffic["check"]["steps"]


def round_calls(traffic: dict, i: int) -> list:
    """The denoiser calls of round i, by their index in a reconstruction."""
    s = traffic["check"]["steps"]
    return list(range(i * s, (i + 1) * s))


def round_draws(traffic: dict, i: int) -> list:
    return []


def updates(problem, inputs: dict, start, outs: list, draws: list, eta, traffic: dict, i: int,
            tf32: bool = False) -> list:
    """For each step of round i: (the iterate it starts from, the update
    ``eta_i * grad(z)`` it should subtract), from the program's own states:
    the round's start point ``start`` and each step's denoised output
    ``outs``. ``problem`` is a reference problem module."""
    out = []
    for j, call in enumerate(round_calls(traffic, i)):
        z = start if j == 0 else outs[j - 1]
        g = problem.grad_full(inputs, z, tf32)
        step = eta * traffic["lr_decay"] ** call
        out.append((z, step[:, None].to(g.dtype) * g))
    return out
