"""Data-parallel training: the JAX package's data mesh
(`parallel/mesh.py:1-121`) as one process per card.

The reference's only parallelism is `nn.DataParallel` with `batch_size *=
n_gpus` (processor_v2.py:167-172). The JAX package replaces it with a
`data` mesh axis: the state replicated, the batch split over the axis, the
gradients summed across it, and every value that the step defines
globally (BatchNorm's batch statistics, every random draw) computed as the
one-device step computes it. Here the axis is a `torch.distributed`
process group, one process (rank) per card:

- the state is replicated: the same seed builds the same weights on every
  rank, and `replicate_state` broadcasts them with both Adams' states from
  rank 0;
- each rank takes its rows of the global batch (`DataMesh.rows`,
  `shard_batch`);
- after each backward, each net's gradients are averaged over the ranks
  in one flat bucket (`all_reduce_mean_`), before the clipping, so that
  the clip sees the global norm, and before Adam, which then makes the
  same update on every rank;
- in train mode BatchNorm takes its statistics over the global batch
  (`models.layers`: the sums all-reduced through `AllReduceSum`, whose
  backward sums the gradient too), not per rank as DataParallel does;
- every random draw is made at the global batch's shape from the step
  generator, which every rank seeds alike, and each rank keeps its rows
  (`stepping`, `draw_local`): dropout masks, the speaker noise and the
  diversity regularizer's speakers are the one-process step's, and the
  generators stay equal.

Not DistributedDataParallel: the GAN step runs three forwards of G and
three of D for two backwards, some of them under `no_grad`, with D frozen
in G's update; DDP's reducer expects one forward a backward. An explicit
all-reduce after each backward is JAX's psum, and under NCCL it runs
inside a CUDA graph capture (`train.step_program`). Gloo cannot be
captured; on a gloo mesh the trainer runs one step at a time.

`launch` starts the ranks (`torch.multiprocessing`, spawned), each pinned
to its device; several ranks may share one device over gloo.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import datetime
import functools
import socket
import time

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(eq=False)
class DataMesh:
    """This process's place on the data axis, the default process group:
    its rank, the axis' size (`world`) and the device its tensors live
    on."""

    rank: int
    world: int
    device: torch.device

    @functools.cached_property
    def backend(self) -> str:
        return dist.get_backend()

    def rows(self, n: int) -> slice:
        """This rank's rows of a global axis of n."""
        if n % self.world:
            raise ValueError(f"a global batch of {n} does not split over {self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def local(self, x: torch.Tensor, block: int) -> torch.Tensor:
        """This rank's rows of a global tensor made of k blocks of `world *
        block` rows: its `block` rows of each block, in order. A step's
        batch is one block; the fused pass's concat of two global batches
        is two."""
        k = x.shape[0] // (self.world * block)
        return x.unflatten(0, (k, self.world, block))[:, self.rank].flatten(0, 1)

    def barrier(self) -> None:
        """Returns once every rank has reached it, on either backend: the
        host waits for a reduced value (under NCCL an all-reduce alone
        only orders the card's stream, and would not keep a rank from
        reading files that rank 0 has not written yet). The NCCL case
        needs cards: the tests on the CPU run gloo only."""
        flag = torch.zeros(1, device=self.device if self.backend == "nccl" else "cpu")
        dist.all_reduce(flag)
        flag.item()


def initialize_distributed(address: str | None = None, num_processes: int | None = None,
                           process_id: int | None = None, backend: str = "nccl",
                           device: torch.device | str | None = None) -> None:
    """Join the process group at `address` (`tcp://host:port`) as rank
    `process_id` of `num_processes`, on `device` (for NCCL, made the
    process's current card); a no-op for one process, as JAX's
    `initialize_distributed`."""
    if num_processes in (None, 1):
        return
    _init_group(address, num_processes, process_id, backend, device)


def _init_group(address, world, rank, backend, device) -> None:
    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=address, world_size=world, rank=rank,
                            timeout=datetime.timedelta(minutes=10))


def make_mesh(device: torch.device | str | None = None) -> DataMesh | None:
    """The data axis over every process of the default group, with this
    process's tensors on `device` (its current card by default). None
    without a group, which `initialize_distributed` forms only for two or
    more processes (JAX: `len(jax.devices()) > 1`); `launch` forms one
    even for a single rank, whose collectives are then real ones (under
    NCCL, those that a CUDA graph captures)."""
    if not dist.is_initialized():
        return None
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return DataMesh(dist.get_rank(), dist.get_world_size(), torch.device(device))


# ------------------------------------------------------------ collectives

# the all-reduces this process issued, and their bytes ("all_reduce",
# "all_reduce_bytes"); a CUDA graph's count once, at its capture
traffic: collections.Counter = collections.Counter()


def all_reduce_(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """t summed over the ranks, in place (through the host under gloo,
    which takes host tensors)."""
    traffic["all_reduce"] += 1
    traffic["all_reduce_bytes"] += t.numel() * t.element_size()
    if mesh.backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t


def _bucketed_(tensors, op) -> None:
    """op(flat) on one flat copy of the tensors of each (device, dtype),
    its result copied back into them."""
    buckets: dict = {}
    for t in tensors:
        buckets.setdefault((t.device, t.dtype), []).append(t)
    for bucket in buckets.values():
        flat = op(torch.cat([t.reshape(-1) for t in bucket]))
        torch._foreach_copy_(bucket, [v.view_as(t) for v, t in
                                      zip(flat.split([t.numel() for t in bucket]), bucket)])


def all_reduce_mean_(tensors, mesh: DataMesh) -> None:
    """Each tensor replaced by its mean over the ranks: one flat bucket a
    dtype, one collective each. Every rank gets the same bits."""
    _bucketed_(tensors, lambda flat: all_reduce_(flat, mesh).div_(mesh.world))


def broadcast_(tensors, mesh: DataMesh, src: int = 0) -> None:
    """Each tensor replaced by rank `src`'s, one flat bucket a (device,
    dtype); host tensors travel through the mesh's device under NCCL."""
    def op(flat):
        moved = flat.to(torch.device("cpu") if mesh.backend == "gloo" else mesh.device)
        dist.broadcast(moved, src)
        return moved.to(flat.device)

    _bucketed_(tensors, op)


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in rank order: the global
    tensor of which x holds this rank's rows."""
    on = x.device
    src = x.cpu() if mesh.backend == "gloo" else x.contiguous()
    out = src.new_empty((mesh.world * src.shape[0], *src.shape[1:]))
    if mesh.backend == "gloo":
        dist.all_gather(list(out.chunk(mesh.world)), src)
    else:
        dist.all_gather_into_tensor(out, src)
    return out.to(on)


class AllReduceSum(torch.autograd.Function):
    """x summed over the ranks, differentiably: the backward sums the
    incoming gradient over the ranks too, since each rank's loss depends on
    every rank's x through the sum (BatchNorm's global statistics)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return all_reduce_(grad.clone(), ctx.mesh), None


# --------------------------------------------------------- state and data

def replicate_state(modules, optimizers, mesh: DataMesh) -> None:
    """The modules' parameters and buffers and the optimizers' states
    broadcast from rank 0, so that every rank starts from its bits."""
    tensors = [t.detach() for m in modules for t in (*m.parameters(), *m.buffers())]
    for opt in optimizers:
        tensors += [v for s in opt.state.values() for v in s.values()
                    if isinstance(v, torch.Tensor)]
        tensors += [g["lr"] for g in opt.param_groups if isinstance(g["lr"], torch.Tensor)]
    with torch.no_grad():
        broadcast_(tensors, mesh)


def shard_batch(host_batch: dict, mesh: DataMesh) -> dict:
    """This rank's rows of a global numpy batch, as tensors on its device
    (integer arrays as int64), the only rows it uploads."""
    out = {}
    for k, v in host_batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v[mesh.rows(len(v))]))
        out[k] = (t if t.is_floating_point() else t.long()).to(mesh.device, non_blocking=True)
    return out


# ------------------------------------------------------------------ draws

_current: tuple[DataMesh, int] | None = None


@contextlib.contextmanager
def stepping(mesh: DataMesh | None, batch: int):
    """Inside the block, train-mode BatchNorm takes global statistics over
    `mesh` and every draw is made at the global shape (`draw_local`), for a
    step whose batch holds `batch` rows on each rank. A no-op without a
    mesh."""
    global _current
    prev, _current = _current, (None if mesh is None else (mesh, batch))
    try:
        yield
    finally:
        _current = prev


def current() -> tuple[DataMesh, int] | None:
    """(mesh, rows of the step's batch on each rank) inside `stepping`."""
    return _current


def draw_local(fn, shape) -> torch.Tensor:
    """fn(shape), a random draw whose first axis runs over the batch:
    inside `stepping`, fn of the global shape (this rank's rows times the
    ranks), of which this rank keeps its rows, so that the draw is the
    one-process step's and every rank's generator advances alike."""
    if _current is None:
        return fn(tuple(shape))
    mesh, block = _current
    if shape[0] % block:
        raise ValueError(f"a draw of {shape[0]} rows does not split into steps of {block}")
    return mesh.local(fn((shape[0] * mesh.world, *shape[1:])), block)


# ------------------------------------------------------------------ launch

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_rank(rank, fn, world, backend, devices, port, args):
    device = torch.device(devices[rank])
    _init_group(f"tcp://localhost:{port}", world, rank, backend, device)
    try:
        fn(make_mesh(device), *args)
    finally:
        dist.destroy_process_group()


def launch(fn, world: int, backend: str = "nccl", devices=None, args: tuple = (),
           timeout: float | None = None) -> None:
    """fn(mesh, *args) in `world` spawned processes, rank r on devices[r]
    (by default cuda:r under NCCL, the CPU under gloo), joined in one
    process group over localhost. Raises if a rank raises or exits
    abnormally (the others are stopped), and TimeoutError past `timeout`
    seconds (every rank is stopped). `fn` must be importable by name."""
    if devices is None:
        devices = [f"cuda:{r}" if backend == "nccl" else "cpu" for r in range(world)]
    devices = [str(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for {world} ranks")
    ctx = torch.multiprocessing.start_processes(
        _run_rank, args=(fn, world, backend, devices, _free_port(), args), nprocs=world,
        join=False, start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks of {fn.__name__} ran past {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
        for p in ctx.processes:
            p.join(10)
            if p.is_alive():
                p.kill()
