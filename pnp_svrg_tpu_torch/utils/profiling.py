"""Profiling and phase timing.

Port of ``pnp_svrg_tpu/utils/profiling.py`` on ``torch.profiler``. The
reference instruments with manual wall-clock accumulators only
(``gradient_time`` / ``denoise_time`` inside every algorithm, e.g. reference
``algorithms/pnp_svrg.py:49-79``; SURVEY.md §5 "Tracing / profiling").
PyTorch returns from a CUDA call before the device has finished it, so a
host clock read after the call measures only the enqueue; the fences here
wait for the device first.

* :func:`fence` -- wait for the device holding one tensor.
* :func:`trace` -- context manager around ``torch.profiler`` writing a
  TensorBoard-loadable trace (host ops, CUDA kernels) into a directory.
* :func:`annotate` -- named trace region, visible in the profiler timeline.
* :func:`scalar_fence` -- read one element of each tensor back to the host.
* :class:`PhaseTimers` -- host-side named accumulators with a fence, for
  the gradient-vs-denoise split on paths that don't go through
  ``algorithms.compat``.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


def fence(x: torch.Tensor) -> None:
    """Wait until the device holding ``x`` has finished all queued work
    (``torch.cuda.synchronize``); nothing to wait for on the CPU."""
    if x.device.type == "cuda":
        torch.cuda.synchronize(x.device)


def _tensors(tree):
    """The tensors of a nested list, tuple or dict, depth first."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


@contextlib.contextmanager
def trace(logdir):
    """Profile the block (host ops and, where there is a card, its CUDA
    kernels) and write the trace into ``logdir`` in TensorBoard's format
    (``<worker>.<time>.pt.trace.json``, a Chrome trace). Yields the
    profiler, whose ``key_averages()`` sum the same events."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()


def annotate(name: str):
    """Named region in the profiler timeline (``record_function``)."""
    return torch.profiler.record_function(name)


def scalar_fence(tree) -> None:
    """Synchronize by reading ONE element of each tensor in ``tree`` (a
    tensor, or a nested list, tuple or dict of them) back to the host: it
    waits for the computation that produces the tensor without copying the
    whole buffer."""
    for leaf in _tensors(tree):
        if leaf.numel():
            float(leaf.reshape(-1)[0].real)


class PhaseTimers:
    """Named wall-clock accumulators with a device-synchronizing fence.

    >>> timers = PhaseTimers()
    >>> with timers.phase("gradient", fence=lambda: v):
    ...     v = grad(z)
    >>> timers.totals()["gradient"]
    """

    def __init__(self, fence_mode: str = "scalar"):
        """``fence_mode``: "scalar" (default -- host readback of one element
        per fenced tensor) or "block" (``torch.cuda.synchronize`` on each
        CUDA device the fenced tensors live on; nothing for CPU tensors)."""
        if fence_mode not in ("scalar", "block"):
            raise ValueError(f"unknown fence_mode {fence_mode!r}")
        self._fence_mode = fence_mode
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, fence=None):
        """Time a phase; ``fence`` (a tree of tensors, or a zero-arg callable
        returning one -- use a callable when the tensors are produced inside
        the block) is synchronized before the clock stops so asynchronous
        launches don't under-count."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if fence is not None:
                tree = fence() if callable(fence) else fence
                if self._fence_mode == "scalar":
                    scalar_fence(tree)
                else:
                    for dev in {t.device for t in _tensors(tree) if t.device.type == "cuda"}:
                        torch.cuda.synchronize(dev)
            self._totals[name] += time.perf_counter() - t0
            self._counts[name] += 1

    def add(self, name: str, seconds: float) -> None:
        self._totals[name] += seconds
        self._counts[name] += 1

    def totals(self) -> dict[str, float]:
        return dict(self._totals)

    def counts(self) -> dict[str, int]:
        return dict(self._counts)

    def summary(self) -> str:
        return ", ".join(
            f"{k}: {v:.3f}s/{self._counts[k]}" for k, v in self._totals.items()
        )
