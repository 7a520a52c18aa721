"""Device mesh and process-group helpers (counterpart of
fastdet/parallel/mesh.py).

The port's data parallelism is PyTorch's idiom: one process per device,
joined by `torch.distributed`, with the process group passed explicitly
to whatever communicates (nothing reads the default group implicitly).
An N-rank job computes what one process computes on the global batch:
the ranks' rows in rank order, as `jax.make_array_from_process_local_data`
assembles it.  The collectives that make it so live with the layers that
need them: BatchNorm's global two-pass statistics (models/layers.py), the
loss's global normalizers (train/loss.py), the gradient all-reduce and
the parameter broadcast (train/trainer.py).

A `Mesh` is 1-D, its one axis `DATA_AXIS`:
  * inside an initialized job (`initialize_distributed`), the world: one
    device per rank, this process driving its own (`mesh.device`);
  * in one process, a list of local devices, over which the serving
    pipelines split a batch.  A device may appear more than once (the
    counterpart of the JAX package's virtual CPU devices): the tests and a
    one-card machine exercise the padding and trimming that way.
"""

from __future__ import annotations

import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
ENV_VARS = ("FASTDET_COORDINATOR", "FASTDET_NUM_PROCESSES",
            "FASTDET_PROCESS_ID")


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> bool:
    """Start this process's part of a job (`torch.distributed`).

    Arguments default to the FASTDET_COORDINATOR (host:port) /
    FASTDET_NUM_PROCESSES / FASTDET_PROCESS_ID environment variables, as
    the JAX package's do, so launching each process of a job is

        FASTDET_COORDINATOR=localhost:1234 FASTDET_NUM_PROCESSES=2 \\
        FASTDET_PROCESS_ID=<i> python -m fastdet_torch.cli.train ...

    The backend defaults to nccl where a card is present, gloo on the CPU.
    With no coordinator it starts nothing and returns False; the count or
    the id set without a coordinator raises, so that a job never runs
    single-process by mistake.  Returns True once the job is up (also if
    it already was)."""
    coordinator_address = (coordinator_address
                           or os.environ.get("FASTDET_COORDINATOR"))
    if coordinator_address is None:
        stray = [v for v in ENV_VARS[1:] if os.environ.get(v)]
        if stray or num_processes is not None or process_id is not None:
            raise ValueError(
                f"fastdet_torch: {', '.join(stray) or 'a process count or id'}"
                " given without FASTDET_COORDINATOR (host:port of rank 0)")
        return False
    if num_processes is None:
        num_processes = int(os.environ["FASTDET_NUM_PROCESSES"])
    if process_id is None:
        process_id = int(os.environ["FASTDET_PROCESS_ID"])
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    return True


class Mesh:
    """A 1-D data mesh.  `devices` are the devices this process drives (a
    job's rank drives one), `size` the shards along `DATA_AXIS` (the world
    size in a job), `rank` this process's shard (0 in one process) and
    `group` the job's process group (None in one process)."""

    axis_names = (DATA_AXIS,)

    def __init__(self, devices: Sequence[torch.device], group=None,
                 rank: int = 0, size: Optional[int] = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self.group = group
        self.rank = rank
        self.size = len(self.devices) if size is None else size

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def shape(self):
        return {DATA_AXIS: self.size}

    def __repr__(self) -> str:
        where = (f"rank {self.rank} of {self.size}" if self.group is not None
                 else f"{self.size} local")
        return f"Mesh({where}, devices={[str(d) for d in self.devices]})"


def _default_device(index: int) -> torch.device:
    from fastdet_torch import resolve_device
    dev = resolve_device("cuda")
    return torch.device("cuda", index % torch.cuda.device_count()) \
        if dev.type == "cuda" else dev


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence[Any]] = None) -> Mesh:
    """The 1-D data mesh.  In a job: the world, this rank on `devices[0]`
    if given, else on its card (rank modulo the cards; the CPU only when
    asked for); `n_devices`, if given, must be the world size.  In one
    process: `devices` (repeats allowed), else the local cards, cut to the
    first `n_devices`."""
    if dist.is_initialized():
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_devices is not None and n_devices != world:
            raise ValueError(f"a job's mesh spans its {world} ranks, not "
                             f"{n_devices}")
        dev = torch.device(devices[0]) if devices else _default_device(rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return Mesh([dev], group=dist.group.WORLD, rank=rank, size=world)
    if devices is None:
        _default_device(0)                  # raises without a card
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = list(devices)
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(devices)


def batch_slices(mesh: Mesh, n: int) -> List[Tuple[torch.device, int, int]]:
    """A local mesh's [start, stop) of each device's rows of an n-row
    batch (n a multiple of the mesh size): equal contiguous shards in
    mesh order, the counterpart of `batch_sharding`."""
    if n % mesh.size:
        raise ValueError(f"a batch of {n} does not divide over a mesh of "
                         f"{mesh.size}")
    per = n // mesh.size
    return [(d, i * per, (i + 1) * per) for i, d in enumerate(mesh.devices)]


def replicate(mesh: Mesh, build) -> List[Any]:
    """`build(device)` once per distinct device of a local mesh → the
    replica of each mesh entry (repeated devices share theirs), the
    counterpart of `replicated_sharding`."""
    made = {}
    for d in mesh.devices:
        if d not in made:
            made[d] = build(d)
    return [made[d] for d in mesh.devices]


def _place(mesh: Mesh, x, axis: int):
    t = torch.as_tensor(x)
    if mesh.group is not None:
        return t.to(mesh.device)
    per = t.shape[axis] // mesh.size
    if t.shape[axis] % mesh.size:
        raise ValueError(f"a batch of {t.shape[axis]} does not divide over "
                         f"a mesh of {mesh.size}")
    return [t.narrow(axis, i * per, per).to(d)
            for i, d in enumerate(mesh.devices)]


def shard_batch(mesh: Mesh, tree):
    """Each leaf of a tuple with its batch axis (0) placed on the mesh: in
    a job, this rank's local rows on its device (the global batch is the
    ranks' rows in rank order); on a local mesh, a list of equal
    contiguous shards, one on each device."""
    return tuple(_place(mesh, x, 0) for x in tree)


def shard_chained_batch(mesh: Mesh, tree):
    """(K, B, ...) stacked-chain leaves: the chain axis whole, the batch
    axis (1) placed as `shard_batch` places axis 0."""
    return tuple(_place(mesh, x, 1) for x in tree)
