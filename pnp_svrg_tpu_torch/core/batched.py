"""Stacking per-lane problems into one batched problem.

Port of ``pnp_svrg_tpu/core/batched.py``. The JAX side wraps stacked pytrees
and vmaps every method; the port's problems carry the batch axis natively, so
stacking concatenates every field along axis 0 -- except a field whose
metadata marks it ``shared`` (Deblur's bilinear gather, which depends only
on the sizes), which every lane must hold equal and which is kept once.
"""

from __future__ import annotations

import dataclasses

import torch


def stack_problems(problems):
    """Concatenate same-shape batched problems (e.g. one-lane ``CSMRI``s)
    along the batch axis."""
    first = problems[0]
    fields = {}
    for f in dataclasses.fields(first):
        values = [getattr(p, f.name) for p in problems]
        if f.metadata.get("shared"):
            if not all(v is values[0] or torch.equal(v, values[0]) for v in values):
                raise ValueError(f"lanes differ in the shared field {f.name!r}")
            fields[f.name] = values[0]
        else:
            fields[f.name] = torch.cat(values)
    return type(first)(**fields)
