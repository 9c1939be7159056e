"""Process groups, the (batch, meas) and (batch, spatial) meshes, and the
collective seam the rest of ``parallel/`` speaks through.

Port of ``pnp_svrg_tpu/parallel/mesh.py``. JAX's mesh axes become
``torch.distributed`` sub-groups of a ``DeviceMesh`` (one process a rank).
Every collective of the layer goes through an axis object with ``size``,
``shards`` (the shard indices this process holds), ``psum``,
``all_gather`` and ``broadcast``, in two forms:

* :class:`GroupAxis`: one shard a process; ``psum`` is ``dist.all_reduce``,
  ``all_gather`` ``dist.all_gather`` and ``broadcast`` ``dist.broadcast``
  over the axis's group.
* :class:`LocalAxis`: every shard in this one process, held on a leading
  tensor axis; ``psum`` is ``sum(dim=0)``. It is the counterpart of the JAX
  package's ``vmap(axis_name=...)`` emulation (``parallel/meas.py:319-329``):
  the same program on one device, with the replicated iterate computed once.

Both take a tensor whose leading axis holds this process's shards (length 1
for a group axis), so the code above them is the same for both. Two ranks
may share one card: NCCL refuses that, the ``gloo`` backend does not, and
gloo's ``all_reduce``, ``all_gather`` and ``broadcast`` take CUDA tensors
(it stages them through the host itself). Its ``send`` and ``recv`` do not,
so nothing here uses point-to-point operations.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time

import torch
import torch.distributed as dist

from pnp_svrg_tpu_torch.device import resolve_device

BATCH_AXIS = "batch"
MEAS_AXIS = "meas"
SPATIAL_AXIS = "spatial"


class LocalAxis:
    """All ``size`` shards of an axis in this process, on a leading tensor
    axis (the single-process emulation)."""

    def __init__(self, name: str, size: int):
        if size < 1:
            raise ValueError(f"axis {name!r} needs size >= 1, got {size}")
        self.name, self.size = name, size
        self.shards = range(size)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(size, ...) -> (...): the sum over the shards."""
        return x.sum(dim=0)

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """(size, ...) -> the shards' blocks concatenated along ``dim`` of a block."""
        return torch.cat(x.unbind(0), dim=dim)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor as shard 0 holds it: here, itself."""
        return x


class GroupAxis:
    """One shard of an axis a process, over a ``torch.distributed`` group.

    ``calls`` and ``host_s`` count, per collective, the calls and the host
    seconds spent in them (under gloo a CUDA tensor's collective waits for
    the device, copies to the host and back); :meth:`reset` zeroes both."""

    def __init__(self, name: str, group):
        self.name, self.group = name, group
        self.size = dist.get_world_size(group)
        self.index = dist.get_rank(group)
        self.shards = range(self.index, self.index + 1)
        self.reset()

    def reset(self) -> None:
        self.calls = {"all_reduce": 0, "all_gather": 0, "broadcast": 0}
        self.host_s = {"all_reduce": 0.0, "all_gather": 0.0, "broadcast": 0.0}

    def _count(self, op: str, t0: float) -> None:
        self.calls[op] += 1
        self.host_s[op] += time.perf_counter() - t0

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """(1, ...) -> (...): the sum over the group's shards."""
        t0 = time.perf_counter()
        y = x[0].contiguous().clone()
        dist.all_reduce(y, group=self.group)
        self._count("all_reduce", t0)
        return y

    def all_gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """(1, ...) -> the group's blocks, in rank order, concatenated along
        ``dim`` of a block."""
        t0 = time.perf_counter()
        mine = x[0].contiguous()
        parts = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(parts, mine, group=self.group)
        self._count("all_gather", t0)
        return torch.cat(parts, dim=dim)

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """A replicated tensor as the group's first shard holds it (the
        others' ``x`` only gives the shape)."""
        t0 = time.perf_counter()
        y = x.contiguous()
        dist.broadcast(y, src=dist.get_global_rank(self.group, 0), group=self.group)
        self._count("broadcast", t0)
        return y


def init_distributed(
    backend: str | None = None,
    init_method: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    timeout_s: float = 600.0,
) -> None:
    """Join the process group of a multi-process run.

    Arguments default to torchrun's environment (``MASTER_ADDR`` /
    ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, read by ``env://``). With
    none of those and no arguments this is a no-op, so drivers call it
    unconditionally; it is also a no-op in a process that has joined already.
    The backend is never guessed: ``"gloo"`` for ranks that share a card or
    run on the CPU, ``"nccl"`` for one card a rank."""
    if dist.is_initialized():
        return
    if world_size is None and "WORLD_SIZE" in os.environ:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None and "RANK" in os.environ:
        rank = int(os.environ["RANK"])
    if init_method is None and world_size is None and "MASTER_ADDR" not in os.environ:
        return  # single-process run
    if backend is None:
        raise ValueError("init_distributed needs a backend ('gloo' or 'nccl')")
    dist.init_process_group(
        backend, init_method=init_method or "env://", world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s),
    )


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank_device(device=None) -> torch.device:
    """This rank's device: the CPU if asked, else CUDA card ``LOCAL_RANK``
    (or the rank) modulo the visible cards, so that ranks share cards when
    there are fewer cards than ranks."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 2-D mesh of this process's view: the axis names in order, each
    axis's size, this process's axis objects and the device it computes on."""

    names: tuple
    shape: dict
    axes: dict
    device: torch.device

    def axis(self, name: str):
        return self.axes[name]


def _make(names: tuple, shape: tuple | None, device, emulate: bool) -> Mesh:
    dev = rank_device(device)
    if emulate:
        if shape is None or shape[0] != 1:
            raise ValueError(f"an emulated mesh runs in one process: shape (1, n), got {shape}")
        return Mesh(names, dict(zip(names, shape)), {names[0]: LocalAxis(names[0], 1),
                                                     names[1]: LocalAxis(names[1], shape[1])}, dev)
    n = world_size()
    if shape is None:
        shape = (n, 1) if names[1] == MEAS_AXIS else (1, n)
    if shape[0] * shape[1] != n:
        raise ValueError(f"mesh shape {shape} != world size {n}")
    if n == 1:
        return Mesh(names, dict(zip(names, shape)), {a: LocalAxis(a, 1) for a in names}, dev)
    from torch.distributed.device_mesh import init_device_mesh

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dm = init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)
    axes = {a: GroupAxis(a, dm.get_group(a)) if s > 1 else LocalAxis(a, 1)
            for a, s in zip(names, shape)}
    return Mesh(names, dict(zip(names, shape)), axes, dev)


def make_mesh(shape: tuple[int, int] | None = None, device=None, emulate: bool = False) -> Mesh:
    """A (batch, meas) mesh over the process group's ranks, laid out row
    major (rank = batch index x meas size + meas index). Default shape: pure
    data parallel, (world size, 1). ``emulate=True`` builds a (1, n) mesh in
    this one process, its meas axis a :class:`LocalAxis`."""
    return _make((BATCH_AXIS, MEAS_AXIS), shape, device, emulate)


def make_spatial_mesh(shape: tuple[int, int] | None = None, device=None,
                      emulate: bool = False) -> Mesh:
    """A (batch, spatial) mesh: data parallel over images plus row-sharded
    denoising with halo rows. Default shape: (1, world size)."""
    return _make((BATCH_AXIS, SPATIAL_AXIS), shape, device, emulate)


def _rank_main(rank, fn, world, backend, init_method, timeout_s, args, queue):
    import traceback

    try:
        init_distributed(backend, init_method, world, rank, timeout_s)
        queue.put((rank, fn(rank, *args), None))
    except Exception:  # reported to the parent, which fails the run
        queue.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, backend: str, args: tuple = (), timeout_s: float = 600.0,
          store_dir: str | None = None) -> list:
    """Run ``fn(rank, *args)`` in ``world`` new processes joined in a
    process group (``backend``, a ``file://`` store under ``store_dir`` or a
    fresh temporary directory) and return its results by rank. ``fn`` must
    be importable and return picklable values (numpy, not CUDA tensors). A
    rank that raises, or a run that outlasts ``timeout_s`` (set on the
    process group too), fails the whole call; every process is stopped."""
    import queue as queue_mod
    import tempfile

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results: dict = {}
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init_method = f"file://{os.path.join(tmp, 'store')}"
        q = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(r, fn, world, backend, init_method, timeout_s, args, q))
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"ranks {sorted(set(range(world)) - set(results))} did not "
                                       f"finish within {timeout_s} s")
                try:
                    rank, value, err = q.get(timeout=min(left, 5.0))
                except queue_mod.Empty:
                    dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                            and r not in results]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited with codes "
                                           f"{[procs[r].exitcode for r in dead]}")
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} failed:\n{err}")
                results[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [results[r] for r in range(world)]
