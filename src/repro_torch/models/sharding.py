"""FSDP for the training path: parameters live as DTensor blocks, one a
rank, and are all-gathered where a layer uses them.

A leaf's *layout* on its mesh is read from its DTensor placements along
the mesh's data axis (the one axis of more than one rank, or axis 0 on a
mesh of one rank): ``Shard(d)`` gathers along dim d, ``Replicate()``
needs no gather. Forward gathers the whole weight
(``all_gather_into_tensor``); backward reduce-scatters its gradient into
the block (``reduce_scatter_tensor``, a sum over the ranks), or
all-reduces a replicated leaf's, in the dtype :func:`grad_sync` names (the
reference's ``grad_sync_dtype``). Collectives run on a mesh of one rank
too (they are copies), so a step issues the same ones at every world
size.

:func:`for_train` prepares a parameter tree for a loss: top-level leaves
gathered once, each stacked subtree kept as plain local blocks with a
*plan* (each leaf's layout one dim lower), which :func:`gather` applies to
one block's slices inside the remat'd block function. So the recompute
gathers again and the whole weights are never saved for backward. A tree
of plain tensors passes through untouched, with no plan.

Every collective runs on the caller's thread in program order, the same
on every rank (the recompute re-issues the gathers in backward order).
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

_SYNC_DTYPE: Optional[torch.dtype] = None


@contextlib.contextmanager
def grad_sync(dtype: Optional[torch.dtype]) -> Iterator[None]:
    """Gradients reduced across ranks inside this block are cast to
    ``dtype`` first (None: the parameter's dtype). The dtype is taken when
    a gather runs forward, so the recompute under remat keeps it."""
    global _SYNC_DTYPE
    prev, _SYNC_DTYPE = _SYNC_DTYPE, dtype
    try:
        yield
    finally:
        _SYNC_DTYPE = prev


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a leaf's block sits: ``dim`` is the sharded dim (None:
    replicated) of the tensor the gather is given, over ``group``."""
    dim: Optional[int]
    group: Any

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)


def data_axis(device_mesh) -> int:
    """The mesh axis that FSDP shards over: its one axis of more than one
    rank (axis 0 when every axis has one). Raises NotImplementedError on a
    mesh with two such axes (tensor parallelism: ROADMAP 15c)."""
    big = [i for i in range(device_mesh.ndim) if device_mesh.size(i) > 1]
    if len(big) > 1:
        raise NotImplementedError(
            f"a mesh of shape {tuple(device_mesh.shape)}: sharding over more "
            f"than one axis (tensor parallelism, a multi-axis data axis) "
            f"waits for ROADMAP 15c")
    return big[0] if big else 0


def layout(x: torch.Tensor, stacked: bool = False) -> Optional[Layout]:
    """The layout of a DTensor leaf (its sharded dim one lower when
    ``stacked``: the gather gets one slice of the leading axis); None for
    a plain tensor."""
    if not isinstance(x, DTensor):
        return None
    i = data_axis(x.device_mesh)
    pl = x.placements[i]
    dim = pl.dim if isinstance(pl, Shard) else None
    if dim is not None and stacked:
        if dim == 0:
            raise ValueError("a stacked leaf sharded along its stack axis")
        dim -= 1
    return Layout(dim, x.device_mesh.get_group(i))


def _leaves(tree: Any) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _map(fn, *trees: Any) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def is_sharded(tree: Any) -> bool:
    return any(isinstance(x, DTensor) for x in _leaves(tree))


def local(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's block (differentiable: its gradient comes back with the
    DTensor's placements); a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def world_of(tree: Any) -> Tuple[Optional[Any], int, int]:
    """(group, rank in it, ranks) of the data axis of a tree's DTensor
    leaves, (None, 0, 1) for a tree of plain tensors."""
    for x in _leaves(tree):
        if isinstance(x, DTensor):
            g = x.device_mesh.get_group(data_axis(x.device_mesh))
            return g, dist.get_rank(g), dist.get_world_size(g)
    return None, 0, 1


@contextlib.contextmanager
def _quiet() -> Iterator[None]:
    """torch 2.13 renames the tensor all-gather and reduce-scatter
    (``all_gather_single``, ``reduce_scatter_single``), which 2.11 lacks."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", category=FutureWarning,
            message=".*(all_gather_into_tensor|reduce_scatter_tensor)")
        yield


class _Gather(torch.autograd.Function):
    """Forward: the whole weight from the blocks. Backward: its gradient
    summed over the ranks into this rank's block."""

    @staticmethod
    def forward(ctx, x, lay: Layout, sync: Optional[torch.dtype]):
        ctx.lay, ctx.sync = lay, sync
        moved = x.movedim(lay.dim, 0).contiguous()
        out = torch.empty((lay.world * moved.shape[0],)
                          + tuple(moved.shape[1:]),
                          dtype=x.dtype, device=x.device)
        with _quiet():
            dist.all_gather_into_tensor(out, moved, group=lay.group)
        return out.movedim(0, lay.dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        lay, dt = ctx.lay, g.dtype
        g = g.to(ctx.sync or dt).movedim(lay.dim, 0).contiguous()
        out = torch.empty((g.shape[0] // lay.world,) + tuple(g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        with _quiet():
            dist.reduce_scatter_tensor(out, g, group=lay.group)
        return out.movedim(0, lay.dim).contiguous().to(dt), None, None


class _SumGrad(torch.autograd.Function):
    """A replicated leaf: forward as it is, backward its gradient summed
    over the ranks."""

    @staticmethod
    def forward(ctx, x, lay: Layout, sync: Optional[torch.dtype]):
        ctx.lay, ctx.sync = lay, sync
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        dt = g.dtype
        # a copy: autograd may hand the same gradient to another branch
        g = g.to(ctx.sync or dt, memory_format=torch.contiguous_format,
                 copy=True)
        dist.all_reduce(g, group=ctx.lay.group)
        return g.to(dt), None, None


def gather_leaf(x: torch.Tensor, lay: Optional[Layout]) -> torch.Tensor:
    """``x`` (a block, plain) made whole for a layer, per its layout."""
    if lay is None:
        return x
    fn = _SumGrad if lay.dim is None else _Gather
    return fn.apply(x, lay, _SYNC_DTYPE)


def gather(tree: Any, plan: Any) -> Any:
    """:func:`gather_leaf` over a tree and its plan (None: the tree)."""
    if plan is None:
        return tree
    return _map(gather_leaf, tree, plan)


def gather_to_rank0(leaf: DTensor) -> Optional[torch.Tensor]:
    """A DTensor leaf made whole on rank 0 of its data axis (one
    ``dist.gather`` of the blocks), None on the other ranks."""
    lay = layout(leaf)
    block = leaf.to_local()
    root = dist.get_rank(lay.group) == 0
    if lay.dim is None:
        return block if root else None
    moved = block.movedim(lay.dim, 0).contiguous()
    parts = [torch.empty_like(moved) for _ in range(lay.world)] \
        if root else None
    dist.gather(moved, parts, dst=dist.get_global_rank(lay.group, 0),
                group=lay.group)
    return torch.cat(parts).movedim(0, lay.dim) if root else None


def refuse_moe(ranks: int) -> None:
    """MoE routing is not data-parallel-exact (the capacity, the slot
    positions and the aux loss come from the global token count and
    batch): raise where the data axis has more than one rank."""
    if ranks > 1:
        raise NotImplementedError(
            "an MoE config over a data axis of more than one rank: global "
            "routing (the per-expert counts all-gathered for positions and "
            "capacity, summed aux statistics) waits for ROADMAP 15c")


def for_train(params: Dict, stacked: Sequence[str]
              ) -> Tuple[Dict, Dict[str, Any]]:
    """``(params, plans)`` for a loss: the top-level leaves gathered once
    (their gradients reduced in backward), each subtree under a key of
    ``stacked`` as plain local blocks, and ``plans[key]`` the layouts of
    one slice of it along the stacked axis. A tree of plain tensors comes
    back as it is with no plans."""
    if not is_sharded(params):
        return params, {}
    out, plans = {}, {}
    for k, sub in params.items():
        if k in stacked:
            plans[k] = _map(lambda x: layout(x, stacked=True), sub)
            out[k] = _map(local, sub)
        else:
            out[k] = _map(lambda x: gather_leaf(local(x), layout(x)), sub)
    return out, plans
