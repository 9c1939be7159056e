"""Stacking per-lane problems into one batched problem.

Port of ``pnp_svrg_tpu/core/batched.py``. The JAX side wraps stacked pytrees
and vmaps every method; the port's problems carry the batch axis natively, so
stacking is a concatenation of every field along axis 0.
"""

from __future__ import annotations

import dataclasses

import torch


def stack_problems(problems):
    """Concatenate same-shape batched problems (e.g. one-lane ``CSMRI``s)
    along the batch axis."""
    first = problems[0]
    fields = {
        f.name: torch.cat([getattr(p, f.name) for p in problems])
        for f in dataclasses.fields(first)
    }
    return type(first)(**fields)
