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

The JAX package's 2-D `(data, model)` mesh (`parallel/mesh.py:122-169`) is
`make_mesh_2d`: rank r at (d, m) = (r // n_model, r % n_model), its data
axis the ranks of its column m and its model axis those of its row d,
which hold the same batch rows. `shard_params_2d` applies JAX's placement
rule to each parameter's JAX shape: a table of `min_rows` rows or more is
split by row over the model axis, and with `tp_min_cols` a wide kernel by
column (tensor parallelism); each rank keeps its slice and its Adam
moments' slices. A row-split embedding looks up the ids in its rows and
sums over the model axis; a column-split weight is gathered whole before
its module runs, as GSPMD gathers W_hh for the GRU's custom call, so the
GRU kernels see whole weights (W_ih is gathered with it, where GSPMD may
split the input product by column instead). The data axis is a
`DataMesh` of its own group: the step's gradients, BatchNorm's
statistics, draws and metrics reduce over it alone, as on the 1-D mesh.
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
    """This process's place on one axis of ranks: its rank on the axis,
    the axis' size (`world`), the device its tensors live on, the axis'
    process group (None: the default group, every rank) and the axis'
    name, which labels its collectives in `traffic`."""

    rank: int
    world: int
    device: torch.device
    group: dist.ProcessGroup | None = None
    axis: str = "data"

    @functools.cached_property
    def backend(self) -> str:
        return dist.get_backend(self.group)

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
        dist.all_reduce(flag, group=self.group)
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

# the collectives this process issued and their bytes (an all-reduce's
# tensor, an all-gather's whole result), by axis: "data all_reduce",
# "data all_reduce bytes", "model all_gather", ...; a CUDA graph's count
# once, at its capture
traffic: collections.Counter = collections.Counter()


def _count(mesh: DataMesh, op: str, t: torch.Tensor) -> None:
    traffic[f"{mesh.axis} {op}"] += 1
    traffic[f"{mesh.axis} {op} bytes"] += t.numel() * t.element_size()


def all_reduce_(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """t summed over the axis' ranks, in place (through the host under
    gloo, which takes host tensors)."""
    _count(mesh, "all_reduce", t)
    if mesh.backend == "gloo" and t.device.type != "cpu":
        host = t.cpu()
        dist.all_reduce(host, group=mesh.group)
        t.copy_(host)
    else:
        dist.all_reduce(t, group=mesh.group)
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
    """Each tensor replaced by that of the axis' rank `src`, one flat
    bucket a (device, dtype); host tensors travel through the mesh's
    device under NCCL."""
    root = src if mesh.group is None else dist.get_global_rank(mesh.group, src)

    def op(flat):
        moved = flat.to(torch.device("cpu") if mesh.backend == "gloo" else mesh.device)
        dist.broadcast(moved, root, group=mesh.group)
        return moved.to(flat.device)

    _bucketed_(tensors, op)


def all_gather_rows(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's x concatenated along dim 0 in the axis' rank order:
    the global tensor of which x holds this rank's rows."""
    on = x.device
    src = x.cpu() if mesh.backend == "gloo" else x.contiguous()
    out = src.new_empty((mesh.world * src.shape[0], *src.shape[1:]))
    _count(mesh, "all_gather", out)
    if mesh.backend == "gloo":
        dist.all_gather(list(out.chunk(mesh.world)), src, group=mesh.group)
    else:
        dist.all_gather_into_tensor(out, src, group=mesh.group)
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


# ----------------------------------------------------------- the 2-D grid

@dataclasses.dataclass(eq=False)
class Mesh2D:
    """This process's place on a (data, model) grid (`make_mesh_2d`):
    `data`, its data axis (the ranks of its column, which split the batch
    and share each parameter slice), and `model`, its model axis (the
    ranks of its row, which hold the same batch rows and split the sharded
    parameters)."""

    n_data: int
    n_model: int
    data: DataMesh
    model: DataMesh

    @property
    def rank(self) -> int:
        return self.data.rank * self.n_model + self.model.rank

    @property
    def world(self) -> int:
        return self.n_data * self.n_model

    @property
    def device(self) -> torch.device:
        return self.data.device


def make_mesh_2d(n_data: int, n_model: int, device: torch.device | str | None = None) -> Mesh2D:
    """The (data, model) grid over every process of the default group
    (JAX `make_mesh_2d`: the devices reshaped (n_data, n_model)), with
    this process's tensors on `device` (as `make_mesh`). Raises
    ValueError unless n_data x n_model is the group's size. Every rank
    forms every group of both axes, in the same order."""
    flat = make_mesh(device)
    if flat is None:
        raise ValueError("a (data, model) grid needs a process group (`launch`)")
    if n_data < 1 or n_model < 1 or n_data * n_model != flat.world:
        raise ValueError(f"a {n_data} x {n_model} grid does not cover {flat.world} ranks")
    columns = [dist.new_group([d * n_model + m for d in range(n_data)]) for m in range(n_model)]
    rows = [dist.new_group([d * n_model + m for m in range(n_model)]) for d in range(n_data)]
    d, m = divmod(flat.rank, n_model)
    return Mesh2D(n_data, n_model, DataMesh(d, n_data, flat.device, columns[m], "data"),
                  DataMesh(m, n_model, flat.device, rows[d], "model"))


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a parameter is split over the model axis: `kind` "row" or
    "col" in the JAX package's orientation, `dim` the torch dim that is
    split, `shape` the whole tensor's torch shape."""

    kind: str
    dim: int
    shape: tuple


def _jax_shape(owner: torch.nn.Module, shape: tuple) -> tuple:
    """The JAX package's shape of a 2-D parameter of `owner` whose torch
    shape is `shape`: an embedding's (V, E) is torch's; a Linear's kernel
    (in, out) and a recurrent layer's w_ih (cin, G H) and w_hh (H, G H)
    are the transposes of torch's weights (JAX `models/layers.py:474-483`)."""
    from ..models.layers import _Recurrent

    if isinstance(owner, torch.nn.Embedding):
        return shape
    if isinstance(owner, (torch.nn.Linear, _Recurrent)):
        return shape[::-1]
    raise ValueError(f"no JAX layout known for a 2-D parameter of {type(owner).__name__}")


def placement(module: torch.nn.Module, n_model: int, min_rows: int = 1024,
              tp_min_cols: int | None = None) -> dict[str, str]:
    """{parameter name: "row" | "col" | "rep"}: JAX `shard_params_2d`'s
    rule (`parallel/mesh.py:159-169`) on each parameter's JAX shape. A 2-D
    parameter of min_rows rows or more, divisible by n_model, is split by
    row; otherwise, with tp_min_cols, one of tp_min_cols columns or more,
    divisible by n_model, by column; the rest is replicated. A split
    parameter counts at its whole shape."""
    out = {}
    for name, p in module.named_parameters():
        kind = "rep"
        shape = p.model_shard.shape if hasattr(p, "model_shard") else tuple(p.shape)
        if len(shape) == 2:
            rows, cols = _jax_shape(module.get_submodule(name.rpartition(".")[0]), shape)
            if rows >= min_rows and rows % n_model == 0:
                kind = "row"
            elif tp_min_cols is not None and cols >= tp_min_cols and cols % n_model == 0:
                kind = "col"
        out[name] = kind
    return out


def _shards(module: torch.nn.Module):
    """(owner, name, parameter) of each sharded parameter of `module`."""
    for owner in module.modules():
        for name, p in owner._parameters.items():
            if hasattr(p, "model_shard"):
                yield owner, name, p


def _gather(shards, dims, mesh: DataMesh) -> list[torch.Tensor]:
    """The whole tensors of which `shards` hold this rank's slices along
    `dims`, in one all-gather over the model axis (one flat bucket)."""
    moved = [s.movedim(d, 0) for s, d in zip(shards, dims)]
    flat = torch.cat([t.reshape(-1) for t in moved])
    every = all_gather_rows(flat, mesh).view(mesh.world, -1)
    out, at = [], 0
    for t, d in zip(moved, dims):
        n = t.numel()
        whole = torch.cat([every[r, at:at + n].view(t.shape) for r in range(mesh.world)])
        out.append(whole.movedim(0, d).contiguous() if d else whole)
        at += n
    return out


class _GatherShards(torch.autograd.Function):
    """The whole weights of the shards, gathered over the model axis. The
    backward hands each shard its own slice of its whole weight's gradient:
    the model axis' ranks compute the same whole gradient from the same
    rows, so a sum over them (an all-gather's usual reduce-scatter) would
    count it n_model times."""

    @staticmethod
    def forward(ctx, mesh: DataMesh, dims: tuple, *shards):
        ctx.mesh, ctx.dims = mesh, dims
        return tuple(_gather(shards, dims, mesh))

    @staticmethod
    def backward(ctx, *grads):
        mesh = ctx.mesh
        return (None, None, *(None if g is None else
                              g.chunk(mesh.world, d)[mesh.rank].contiguous()
                              for g, d in zip(grads, ctx.dims)))


class _SumOverModel(torch.autograd.Function):
    """x summed over the model axis; the backward is the identity: every
    rank of the axis computes the same loss from the sum, so each rank's
    term takes the sum's gradient once."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return all_reduce_(x.clone(), mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def _gather_hooks(owner: torch.nn.Module, specs: dict[str, Shard], mesh: DataMesh) -> None:
    """Before each call of `owner`, its sharded parameters (`specs`) stand
    in their slots as the whole weights (`_GatherShards`); after it, the
    slots hold what they held: the shards, or their bf16 casts under
    `builder.bf16_parameters`. Slots that already hold whole tensors
    (`gathered`) are left alone."""
    names = list(specs)
    dims = tuple(specs[n].dim for n in names)
    held = []

    def pre(module, args):
        slots = [module._parameters[n] for n in names]
        if tuple(slots[0].shape) == specs[names[0]].shape:
            return
        held.append(slots)
        for n, whole in zip(names, _GatherShards.apply(mesh, dims, *slots)):
            module._parameters[n] = whole

    def post(module, args, out):
        if held:
            for n, t in zip(names, held.pop()):
                module._parameters[n] = t

    owner.register_forward_pre_hook(pre)
    owner.register_forward_hook(post, always_call=True)


def _lookup_hooks(owner: torch.nn.Embedding, spec: Shard, mesh: DataMesh) -> None:
    """A row-split table's lookup: each rank looks up the ids in its rows
    (the others clamped to its first row), zeroes the rest and sums over
    the model axis (`_SumOverModel`), which gives the whole table's lookup
    exactly. A slot that holds the whole table (`gathered`) is looked up
    as it is."""
    if owner.padding_idx is not None or owner.max_norm is not None:
        raise ValueError("a row-split embedding takes no padding_idx or max_norm")
    rows = spec.shape[0] // mesh.world
    lo = mesh.rank * rows
    masks = []

    def pre(module, args):
        if module._parameters["weight"].shape[0] != rows:
            return None
        local = args[0] - lo
        mask = (local >= 0) & (local < rows)
        masks.append(mask)
        return (torch.where(mask, local, 0), *args[1:])

    def post(module, args, out):
        if masks:
            keep = masks.pop().unsqueeze(-1)
            return _SumOverModel.apply(torch.where(keep, out, 0), mesh)
        return None

    owner.register_forward_pre_hook(pre)
    owner.register_forward_hook(post, always_call=True)


def shard_params_2d(modules, optimizers, mesh: Mesh2D, min_rows: int = 1024,
                    tp_min_cols: int | None = None) -> list[dict[str, str]]:
    """Each module's parameters placed on the grid by `placement`, in
    place: a split parameter becomes this rank's slice of it (an
    `nn.Parameter` carrying its `Shard` as `model_shard`) in its module and
    in the optimizers, whose states of it (Adam's moments) are sliced
    alike. A row-split embedding looks up through `_lookup_hooks`; every
    other owner of split parameters gathers them before it runs
    (`_gather_hooks`). Every rank must hold the same whole parameters
    first (one seed, or `replicate_state`). Returns each module's
    placement."""
    axis = mesh.model
    swapped: dict = {}
    out = []
    for module in modules:
        kinds = placement(module, mesh.n_model, min_rows, tp_min_cols)
        out.append(kinds)
        owners: dict = {}
        for name, kind in kinds.items():
            if kind == "rep":
                continue
            path, _, attr = name.rpartition(".")
            owner = module.get_submodule(path)
            p = owner._parameters[attr]
            embedding = isinstance(owner, torch.nn.Embedding)
            dim = (0 if kind == "row" else 1) if embedding else (1 if kind == "row" else 0)
            spec = Shard(kind, dim, tuple(p.shape))
            shard = torch.nn.Parameter(p.detach().chunk(axis.world, dim)[axis.rank].clone(),
                                       requires_grad=p.requires_grad)
            shard.model_shard = spec
            owner._parameters[attr] = shard
            swapped[p] = shard
            owners.setdefault(owner, {})[attr] = spec
        for owner, specs in owners.items():
            if isinstance(owner, torch.nn.Embedding) and specs["weight"].kind == "row":
                _lookup_hooks(owner, specs["weight"], axis)
            else:
                _gather_hooks(owner, specs, axis)
    for opt in optimizers:
        for group in opt.param_groups:
            group["params"] = [swapped.get(p, p) for p in group["params"]]
        for old, new in swapped.items():
            if old in opt.state:
                spec = new.model_shard
                opt.state[new] = {
                    k: (v.chunk(axis.world, spec.dim)[axis.rank].clone()
                        if isinstance(v, torch.Tensor) and tuple(v.shape) == spec.shape else v)
                    for k, v in opt.state.pop(old).items()}
    return out


@contextlib.contextmanager
def gathered(modules, mesh: Mesh2D):
    """Inside the block each split parameter of the modules stands whole
    in its slot (gathered once, without gradient), so that the modules run
    as one process's; after it the shards are put back. A collective:
    every rank enters it."""
    held = []
    with torch.no_grad():
        for module in modules:
            found = list(_shards(module))
            if not found:
                continue
            wholes = _gather([p for _, _, p in found], [p.model_shard.dim for _, _, p in found],
                             mesh.model)
            for (owner, name, p), whole in zip(found, wholes):
                held.append((owner, name, p))
                owner._parameters[name] = whole
    try:
        yield
    finally:
        for owner, name, p in held:
            owner._parameters[name] = p


def gather_params_2d(modules, optimizers, mesh: Mesh2D) -> tuple[list[dict], list[dict]]:
    """The modules' whole state dicts and the optimizers' whole state dicts
    (the `torch.optim` form, each split state gathered), as one process
    holds them: for the tests and the card's checks. A collective: every
    rank calls it."""
    with gathered(modules, mesh):
        states = [{k: v.detach().clone() for k, v in m.state_dict().items()} for m in modules]
    opt_states = []
    for opt in optimizers:
        sd = opt.state_dict()
        sd["state"] = {i: dict(st) for i, st in sd["state"].items()}
        params = [p for group in opt.param_groups for p in group["params"]]
        split = [(i, k) for i, p in enumerate(params) if hasattr(p, "model_shard")
                 for k, v in sd["state"].get(i, {}).items()
                 if isinstance(v, torch.Tensor) and v.shape == p.shape]
        if split:
            wholes = _gather([sd["state"][i][k] for i, k in split],
                             [params[i].model_shard.dim for i, _ in split], mesh.model)
            for (i, k), whole in zip(split, wholes):
                sd["state"][i][k] = whole
        opt_states.append(sd)
    return states, opt_states


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
