"""Stacking per-lane problems into one batched problem.

Port of ``pnp_svrg_tpu/core/batched.py``. The JAX side wraps stacked pytrees
and vmaps every method; the port's problems carry the batch axis natively, so
stacking concatenates every field along axis 0 -- except a field whose
metadata marks it ``shared`` (Deblur's bilinear gather, which depends only
on the sizes), which every lane must hold equal and which is kept once, and
except a field marked ``kept_once_if_same`` (phase retrieval's matrix A)
when every problem holds the very same tensor (one storage) with a leading
axis of 1, as replicas of one problem do: it is kept once, for all lanes.
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
        elif (f.metadata.get("kept_once_if_same") and values[0].shape[0] == 1
              and all(_same_tensor(v, values[0]) for v in values)):
            fields[f.name] = values[0]
        else:
            fields[f.name] = torch.cat(values)
    return type(first)(**fields)


def _same_tensor(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape and a.stride() == b.stride()
            and a.device == b.device and a.dtype == b.dtype)


def take_lanes(problem, lanes: slice):
    """The lanes ``lanes`` of a batched problem: every field sliced along
    axis 0, except a ``shared`` field and a ``kept_once_if_same`` field
    held once for all lanes (leading axis 1), which stay as they are."""
    fields = {}
    for f in dataclasses.fields(problem):
        v = getattr(problem, f.name)
        once = f.metadata.get("shared") or (f.metadata.get("kept_once_if_same") and v.shape[0] == 1)
        fields[f.name] = v if once else v[lanes]
    return type(problem)(**fields)
