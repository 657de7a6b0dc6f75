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

The mesh itself (`MeshConfig`, `make_mesh`) and the sharding helpers wait
for the data-parallel slice of the fused trainers.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


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
