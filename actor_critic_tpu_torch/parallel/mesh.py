"""Process groups and collectives (counterpart of the collective helpers and
`multihost_init` of `actor_critic_tpu/parallel/mesh.py`).

JAX expresses data parallelism as a mesh axis and lets XLA insert the
collectives; its trainers call `pmean`/`psum`/`pmean_tree` with an
`axis_name` that is None off-mesh. The port's trainers take a `group`
instead: a `torch.distributed` process group, or None, where every helper
here is the identity (no collective, no copy). The same update code then
runs single-process and as one rank of a fleet.

On the card the group is NCCL's and its all-reduces run on the current
stream's order, so they can be captured inside a CUDA graph; on the CPU it
is gloo's (`--device cpu`, the tests). `FlatGradients` is the gradient
all-reduce of a data-parallel update: every parameter's gradient copied
into ONE flat buffer allocated at the first call (one concatenation
kernel), one all-reduce, one divide by the world size, and the gradients
handed back as views of the buffer, in the order optax applies a pmean'd
gradient (before the global-norm clip and Adam).

The mesh (`MeshConfig`, `make_mesh`, `make_process_mesh`) is JAX's
`jax.sharding.Mesh` for a fleet of processes: JAX's one process holds every
device of its mesh and `shard_map` runs a function on each, where here each
rank is one device of the mesh and runs the function itself. A `Mesh` is
one rank's view: the axes' names and sizes, the rank's coordinate on each
(rank r sits at the row-major coordinate of r, the device order of
`jax.make_mesh`), and a process group per axis, the line of ranks through
this one along that axis, which the trainers take where JAX names the
axis. `group()` of every axis is the whole mesh. `PartitionSpec` is JAX's
`P`, the marker `parallel/dp.py`'s layouts are written in.

`all_gather` and `pmax` complete JAX's collectives: `pmax` is one MAX
all-reduce, `all_gather` a real gather that moves every rank's bits as they
are (NCCL's `all_gather_into_tensor`, captured in a CUDA graph too; gloo's
`all_gather`).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]

DP_AXIS = "dp"
MODEL_AXIS = "model"


@dataclasses.dataclass(frozen=True, init=False)
class PartitionSpec:
    """JAX's `PartitionSpec` for the port's layouts: `PartitionSpec()` is
    replicated on every rank, `PartitionSpec("dp")` has its leading axis
    split over the mesh's "dp" axis (`parallel/dp.py`)."""

    axes: tuple[str, ...]

    def __init__(self, *axes: str):
        object.__setattr__(self, "axes", axes)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """How to lay the processes out as a mesh (JAX's `MeshConfig`)."""

    dp: int = -1  # -1: every rank left
    model: int = 1


class Mesh:
    """One rank's view of a mesh of processes: `shape` ({axis: size}, in
    axis order), `rank` and `size` (this rank and the mesh's count of
    ranks), `index(axis)` (this rank's coordinate), `group(*axes)` (the
    process group of this rank's line along one axis, or of the whole mesh
    for every axis; None where it holds this rank alone, so that every
    collective over it is the identity)."""

    def __init__(self, shape: dict[str, int], rank: int, groups: dict[tuple[str, ...], Group]):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.rank = rank
        self.size = math.prod(shape.values())
        self._groups = groups
        coords, rest = [], rank
        for n in reversed(list(shape.values())):
            rest, c = divmod(rest, n)
            coords.append(c)
        self._coords = dict(zip(self.axis_names, reversed(coords)))

    def index(self, axis: str) -> int:
        return self._coords[axis]

    def group(self, *axes: str) -> Group:
        if len(set(axes)) != len(axes) or not set(axes) <= set(self.axis_names):
            raise ValueError(f"no axes {axes} in the mesh {self.axis_names}")
        if set(axes) == set(self.axis_names):
            return self._groups[self.axis_names]
        if len(axes) != 1:
            raise ValueError(f"the mesh has a group for one axis or for all of them, not {axes}")
        return self._groups[axes]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def make_process_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """The mesh of `shape` over the ranks of the default process group
    (`jax.make_mesh`'s counterpart; one process without one, where every
    size must be 1). Every rank calls it with the same arguments: it makes
    each axis's line groups with `dist.new_group` on every rank, in one
    order. A line of every rank is the default group; a line of one rank
    has no group."""
    shape = {name: int(n) for name, n in zip(axis_names, shape, strict=True)}
    world = dist.get_world_size() if dist.is_initialized() else 1
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape.values()))} != {world} devices")
    if not dist.is_initialized():
        return Mesh(shape, 0, {(a,): None for a in shape} | {tuple(shape): None})
    rank = dist.get_rank()
    sizes = list(shape.values())
    groups: dict[tuple[str, ...], Group] = {tuple(shape): dist.group.WORLD}
    for a, axis in enumerate(shape):
        stride = math.prod(sizes[a + 1:])
        if sizes[a] == world:
            groups[(axis,)] = dist.group.WORLD
            continue
        mine = None
        # The lines along `axis`: every rank whose coordinate on `axis` is 0
        # starts one.
        for start in range(world):
            if (start // stride) % sizes[a]:
                continue
            line = [start + i * stride for i in range(sizes[a])]
            g = dist.new_group(line) if sizes[a] > 1 else None
            if rank in line:
                mine = g
        groups[(axis,)] = mine
    return Mesh(shape, rank, groups)


def make_mesh(cfg: MeshConfig = MeshConfig()) -> Mesh:
    """The ("dp", "model") mesh of `cfg` over every rank (JAX's
    `make_mesh`)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    model = cfg.model
    dp = n // model if cfg.dp == -1 else cfg.dp
    if dp * model != n:
        raise ValueError(f"mesh {dp}x{model} != {n} devices")
    return make_process_mesh((dp, model), (DP_AXIS, MODEL_AXIS))


def multihost_init(coordinator: str, num_processes: int, process_id: int,
                   backend: str) -> None:
    """`torch.distributed.init_process_group` against an explicit
    coordinator (`HOST:PORT`, rank 0's address: `tcp://HOST:PORT`), with
    the world size and this process's rank given, never inferred. Failures
    propagate: a fleet member that cannot join must not train alone."""
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes), rank=int(process_id))


def world_group() -> dist.ProcessGroup:
    """The default process group of every rank (after `multihost_init`)."""
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialized: call distributed_init first")
    return dist.group.WORLD


def world_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def psum(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of `x` over the group's ranks (a new tensor), or `x` itself
    without a group."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out


def axis_index(group: Group) -> int:
    """This rank's index in the group (JAX's `axis_index`); 0 without one."""
    return 0 if group is None else dist.get_rank(group)


def pmax(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The elementwise maximum of `x` over the group's ranks (a new
    tensor), or `x` itself without a group."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def all_gather(x: torch.Tensor, group: Group) -> torch.Tensor:
    """[W, *x.shape]: every rank's `x` in rank order, each bit as it was
    sent (JAX's `all_gather`: a −0.0 keeps its sign, a NaN or an inf stays
    in its own slot); `x[None]` without a group. NCCL gathers into one
    [W, ...] tensor (`all_gather_into_tensor`, which a CUDA graph
    captures); gloo into a tensor a rank, stacked after."""
    if group is None:
        return x[None]
    x = x.contiguous()
    if dist.get_backend(group) == "nccl":
        out = torch.empty((world_size(group), *x.shape), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    parts = [torch.empty_like(x) for _ in range(world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def pmean(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The mean of `x` over the group's ranks: the sum divided by the world
    size (JAX's `pmean`), or `x` itself without a group."""
    if group is None:
        return x
    return psum(x, group) / world_size(group)


def pmean_tree(tree: dict[str, torch.Tensor], group: Group) -> dict[str, torch.Tensor]:
    """`pmean` of every tensor of a flat dict, through ONE all-reduce of
    their concatenation (`FlatGradients`, used once: the values keep their
    shapes and dtype, which must be one floating dtype); the dict itself
    without a group."""
    if group is None:
        return tree
    return dict(zip(tree, FlatGradients(group)(list(tree.values()))))


class FlatGradients:
    """The pmean of a list of tensors (a minibatch's gradients) through one
    all-reduce: the first call allocates one flat buffer of their total
    size (on their device and dtype) and views of it shaped like each;
    every call concatenates the tensors into the buffer, all-reduces it,
    divides it by the world size in place and returns the views. The
    buffer is rewritten by the next call, so the views are read before it
    (an optimizer step is). Without a group the tensors come back as they
    are."""

    def __init__(self, group: Group):
        self.group = group
        self.flat: Optional[torch.Tensor] = None
        self.views: list[torch.Tensor] = []

    def __call__(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        if self.group is None:
            return list(grads)
        if self.flat is None:
            total = sum(g.numel() for g in grads)
            self.flat = torch.empty(total, dtype=grads[0].dtype, device=grads[0].device)
            offset = 0
            for g in grads:
                self.views.append(self.flat[offset:offset + g.numel()].view(g.shape))
                offset += g.numel()
        if [v.shape for v in self.views] != [g.shape for g in grads]:
            raise ValueError("FlatGradients: the gradients' shapes changed since the first call")
        torch.cat([g.reshape(-1) for g in grads], out=self.flat)
        dist.all_reduce(self.flat, op=dist.ReduceOp.SUM, group=self.group)
        self.flat.div_(world_size(self.group))
        return self.views
