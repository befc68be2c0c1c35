"""Data-parallel meshes over ``torch.distributed`` and over the devices of
one process.

Port of ``treemorph_tpu/parallel/mesh.py``. JAX runs one program over a
``Mesh`` of devices with a ``data`` axis: batches are sharded on their
leading axis, parameters replicated, and collectives ride the axis. torch
has no global arrays, so the port has two meshes:

- :class:`Mesh`, for training: one process a rank, each on its own device,
  joined by a ``torch.distributed`` process group (NCCL between CUDA cards,
  gloo on the CPU, or the backend the caller names). A rank holds only its
  own rows of the batch (:func:`shard_batch`); the gradient and loss
  reductions are all-reduces over the group. Ranks come from ``torchrun``
  (``RANK``, ``WORLD_SIZE``), or from :func:`spawn_ranks`, which starts one
  process a device with a file store.
- :class:`LocalMesh`, for plot-scale inference: one process drives several
  devices, as JAX's single controller does
  (``pipeline/predict.py::predict_rasterized_sharded``).

Gloo reduces CUDA tensors with ``broadcast`` and ``all_reduce`` only, so the
training path uses no other collective.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

#: collectives issued by this module's helpers, by name (the chip script and
#: the tests read it to show what a step reduced)
COLLECTIVES: dict = {}


def count_collective(name: str) -> None:
    COLLECTIVES[name] = COLLECTIVES.get(name, 0) + 1


@dataclass
class Mesh:
    """This process's place in a data-parallel group: its rank, the world
    size, its device and the process group (``None``: the default one)."""

    rank: int
    world_size: int
    device: torch.device
    group: object = None

    @property
    def size(self) -> int:
        return self.world_size

    @property
    def is_main(self) -> bool:
        """Rank 0, the one that writes checkpoints and logs."""
        return self.rank == 0


@dataclass
class LocalMesh:
    """Several devices driven by one process (a device may repeat: two
    slots on one card run as two devices would, one after the other)."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def default_device(rank: int) -> torch.device:
    """Rank ``rank``'s device: its CUDA card (``LOCAL_RANK``, else the
    rank, modulo the visible cards) where there is one, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, backend: str | None = None, *,
              rank: int | None = None, init_method: str | None = None,
              device=None) -> Mesh:
    """Join (or reuse) the default process group and return this rank's
    :class:`Mesh`.

    The world size is ``n_devices``, else ``WORLD_SIZE``, else the number
    of visible CUDA cards; the rank is ``rank``, else ``RANK``, else 0.
    ``device`` defaults to :func:`default_device`; ``backend`` to NCCL for
    a CUDA device and gloo otherwise (NCCL refuses two ranks on one card:
    name gloo for that). ``init_method`` defaults to ``env://``
    (``MASTER_ADDR`` / ``MASTER_PORT``, as ``torchrun`` sets them). A group
    that fails to form raises; there is no fallback to another backend."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"the process group has {world} ranks, not "
                             f"{n_devices}")
        device = torch.device(device) if device is not None else (
            default_device(rank))
        return Mesh(rank, world, device)
    world = n_devices or int(os.environ.get("WORLD_SIZE", 0)) or (
        torch.cuda.device_count())
    if world < 1:
        raise ValueError("a mesh needs at least one device")
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    device = torch.device(device) if device is not None else (
        default_device(rank))
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    return Mesh(rank, world, device)


def make_local_mesh(n_devices: int | None = None,
                    devices=None) -> LocalMesh:
    """A :class:`LocalMesh` over ``devices``, else over the first
    ``n_devices`` visible CUDA cards (all of them by default)."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else n_devices
        if not 0 < n <= count:
            raise ValueError(f"{n} devices asked for, {count} visible")
        devices = [torch.device("cuda", i) for i in range(n)]
    return LocalMesh(tuple(torch.device(d) for d in devices))


def _rank_main(rank, fn, world, backend, init_method, devices, args):
    device = devices[rank] if devices is not None else None
    mesh = make_mesh(world, backend, rank=rank, init_method=init_method,
                     device=device)
    try:
        fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, n_devices: int, *args, backend=None,
                devices=None, store_dir: str | None = None) -> None:
    """Run ``fn(mesh, *args)`` in ``n_devices`` new processes, one a rank,
    joined through a file store (a fresh file under ``store_dir``, the
    temporary directory by default, so that no TCP port is needed).
    ``devices`` names each rank's device (default: :func:`default_device`).
    Raises if a rank fails. ``fn`` must be importable (a module-level
    function)."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        init = "file://" + os.path.join(tmp, "store")
        mp.spawn(_rank_main, nprocs=n_devices,
                 args=(fn, n_devices, backend, init, devices, args))


def pad_batch_to_multiple(batch, multiple: int):
    """Pad a PaddedBatch's leading dim with all-invalid elements so that it
    divides the mesh; masked losses make the padding contribute nothing."""
    b = batch.coords.shape[0]
    pad = (-b) % multiple
    if pad == 0:
        return batch

    def pad_leading(x):
        if x is None:  # optional fields (the noise quartet)
            return None
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return np.pad(np.asarray(x), widths)

    return type(batch)(*(pad_leading(x) for x in batch))


def shard_batch(batch, mesh: Mesh):
    """This rank's contiguous rows ``[r·B/n, (r+1)·B/n)`` of every leaf, as
    tensors on its device. B must divide over the mesh (pad first with
    :func:`pad_batch_to_multiple`)."""
    b = batch.coords.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} does not divide over "
                         f"{mesh.size} ranks")
    rows = slice(mesh.rank * (b // mesh.size),
                 (mesh.rank + 1) * (b // mesh.size))
    return batch.map(lambda a: torch.as_tensor(a[rows]).to(mesh.device))


def _tensors_of(state) -> list:
    """Parameters, buffers and optimizer state of a TrainState or module,
    in a fixed order."""
    model = getattr(state, "model", state)
    tensors = [p.data for p in model.parameters()]
    tensors += list(model.buffers())
    optimizer = getattr(state, "optimizer", None)
    if optimizer is not None:
        for group in optimizer.param_groups:
            for p in group["params"]:
                for key in sorted(optimizer.state.get(p, {})):
                    value = optimizer.state[p][key]
                    if isinstance(value, torch.Tensor):
                        tensors.append(value)
    return tensors


@torch.no_grad()
def replicate(state, mesh: Mesh):
    """Broadcast rank 0's parameters, buffers (BatchNorm statistics) and
    optimizer state to every rank, in place; returns ``state`` (a
    TrainState or a module)."""
    if mesh.size > 1:
        for t in _tensors_of(state):
            count_collective("broadcast")
            dist.broadcast(t, 0, group=mesh.group)
    return state


def rank_generator(generator, mesh: Mesh):
    """This rank's generator, derived from the step's and the rank (the
    JAX step's ``fold_in(rng, axis_index)``): every rank draws the same
    ``world`` seeds from ``generator`` and takes its own. ``None`` stays
    ``None``."""
    if generator is None:
        return None
    seeds = torch.randint(0, 2**62, (mesh.size,), generator=generator)
    return torch.Generator(device=generator.device).manual_seed(
        int(seeds[mesh.rank]))


@torch.no_grad()
def all_reduce_sum(tensors: list, mesh: Mesh) -> None:
    """Sum ``tensors`` over the ranks in place, in one all-reduce of their
    concatenation per dtype."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        count_collective("all_reduce")
        dist.all_reduce(flat, group=mesh.group)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_grads(model: torch.nn.Module, mesh: Mesh) -> None:
    """Sum every parameter's ``.grad`` over the ranks (a parameter without
    one counts as zero)."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    all_reduce_sum([p.grad for p in params], mesh)


@torch.no_grad()
def average_buffers(model: torch.nn.Module, mesh: Mesh,
                    keep: Callable[[str], bool] = lambda name: False) -> None:
    """Replace each floating buffer (BatchNorm running statistics) by its
    mean over the ranks (the JAX step's ``pmean`` of ``batch_stats``), but
    those ``keep(name)`` names, which stay as they are."""
    named = [(n, b) for n, b in model.named_buffers()
             if b.is_floating_point() and not keep(n)]
    if not named:
        return
    buffers = [b for _, b in named]
    all_reduce_sum(buffers, mesh)
    for b in buffers:
        b.div_(mesh.size)


def broadcast_flag(flag: bool, mesh: Mesh) -> bool:
    """Rank 0's ``flag`` on every rank."""
    t = torch.tensor([int(flag)], device=mesh.device)
    count_collective("broadcast")
    dist.broadcast(t, 0, group=mesh.group)
    return bool(t.item())
