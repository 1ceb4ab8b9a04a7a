"""The LM's sharded runtime: FSDP over the mesh's data axis and tensor
parallelism (TP) over its model axis in training, TP alone in serving.
Parameters live as DTensor blocks, one a rank.

The axes are found by the names ``launch/mesh`` gives them: "model" is
the model axis, "pod" and "data" are data axes. A leaf's *layout* is read
from its DTensor placements: ``Shard(d)`` on the data axis gathers along
dim d where a layer uses the leaf, ``Replicate()`` needs no gather; its
placement on the model axis says which block of a
column- or row-parallel weight the rank holds, and stays put. Forward
gathers the rank's TP block whole over the data group
(``all_gather_into_tensor``); backward reduce-scatters its gradient into
the block (``reduce_scatter_tensor``, a sum over the data ranks), or
all-reduces a data-replicated leaf's, in the gradient's own dtype: the
reference's GSPMD program sums in that dtype too and casts to its
``grad_sync_dtype`` after the sum (``train/train_step.py``). Collectives
over the data axis run on a mesh of one rank too (they are copies), so a
step issues the same ones at every data-axis size.

Over a model axis of more than one rank (:func:`tp_of`) the layers are
Megatron's: a column-parallel projection takes its input through
:func:`to_model` (forward identity, backward all-reduce over the model
group) and a row-parallel one gives its partial output to
:func:`from_model` (forward all-reduce, backward identity); the embedding,
the logits and the cross-entropy are vocab-parallel. The SSM layer keeps
its fused ``w_in``, ``conv_w`` and ``conv_b`` in the reference's layout,
makes them whole over the model group (:func:`gather_model`) and takes
its heads' columns; its gated norm's sum of squares is summed over the
model ranks (:func:`sum_over_model`). MLA runs on the rank's heads
(``wq``, ``w_uk``, ``w_uv`` column blocks, ``wo`` a row block); its
replicated ``w_dkv``, ``w_kpe`` and ``kv_norm`` feed only those heads, so
they pass :func:`to_model` and their gradients are summed. Every model
rank routes the same tokens (router, slot positions, aux loss, combine);
the expert FFN is split either by its FFN dim (the expert buffer enters
through :func:`to_model`, the experts' partial outputs are summed by
:func:`from_model`) or by its experts (the rank's experts run on their
slice of the buffer, and :func:`join_model` makes their outputs whole
for the combine). A model axis of one rank issues none of these.

Over a data axis of more than one rank (:func:`dp_of`) MoE routing keeps
its one-device meaning, as the reference's GSPMD program does: the
capacity, the slot positions and the aux loss are those of the global
microbatch, whose tokens are the data ranks' blocks in data-coordinate
order (``data.rank_batch_at``). Each rank counts its assignments and its
top-1 choices per expert; one all-gather over the data group
(:func:`gather_data`) makes the table from which a rank takes its slot
offsets (the lower data ranks' counts) and the aux loss's ``f_e``; the
aux loss's ``p_e`` is the data ranks' sums of the router probabilities
summed by :func:`sum_over_data` (all-reduce forward and backward: every
rank's loss holds the whole aux, and the step divides the summed gradient
by the data ranks). A ``loss_mask``'s masked sum and count are summed the
same way, so every rank's loss is the global masked mean. A (W, 1) step of
a config without experts or mask is the FSDP step alone.

:func:`for_train` prepares a parameter tree for a loss: top-level leaves
gathered once, each stacked subtree kept as plain local blocks with a
*plan* (each leaf's layout one dim lower), which :func:`gather` applies to
one block's slices inside the remat'd block function. So the recompute
gathers again and the whole weights are never saved for backward. A tree
of plain tensors passes through untouched, with no plan.

Every collective runs on the caller's thread in program order, the same
on every rank (the recompute re-issues the gathers and the model axis's
forward all-reduces in backward order).

Serving (``LM.prefill`` / ``decode_step`` and ``EncDecLM``'s) takes the
*serve tree* of :func:`for_serve`, made once at set-up: on a (1, T) mesh
each leaf's TP block as a plain tensor (a view of the DTensor's block, no
copy), and in each SSM layer the rank's own columns of ``w_in``,
``conv_w`` and ``conv_b`` and its part of ``a_log``, ``dt_bias``,
``d_skip`` and ``out_norm`` in place of their blocks. A step then issues
only the model axis's forward collectives (the row-parallel sums, the
expert outputs made whole, the SSM's sums of squares, the lookup's rows
and the logits made whole) and none over the data axis: no weight is
gathered or copied per call, where :func:`for_train`'s data-axis gathers
would copy every weight even on a data axis of one rank.
"""

from __future__ import annotations

import contextlib
import dataclasses
import warnings
from typing import Any, Dict, Iterator, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

@dataclasses.dataclass(frozen=True)
class Layout:
    """Where a leaf's block sits: ``dim`` is its dim sharded over the data
    axis (None: replicated there) in the tensor the gather is given, over
    ``group``; ``mdim`` its dim sharded over the model axis (None:
    replicated there), over ``mgroup`` (None: the mesh has no model
    axis)."""
    dim: Optional[int]
    group: Any
    mdim: Optional[int] = None
    mgroup: Any = None

    @property
    def world(self) -> int:
        return dist.get_world_size(self.group)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model axis of a tensor-parallel step: its group, this rank's
    index in it (which block of every TP-sharded leaf it holds) and its
    size. ``serving``: the layers run on a serve tree (:func:`for_serve`),
    whose SSM leaves already hold this rank's columns and parts."""
    group: Any
    rank: int
    size: int
    serving: bool = False


@dataclasses.dataclass(frozen=True)
class DataAxis:
    """The data axis of a step over more than one data rank: its group,
    this rank's data coordinate (which block of every global microbatch
    it takes, ``data.rank_batch_at``; not its global rank) and its
    size."""
    group: Any
    rank: int
    size: int


# the axis names of ``launch/mesh``'s meshes: the data axes (FSDP shards
# over the one of more than one rank) and the model axis
DATA_AXES = ("pod", "data")
MODEL_AXIS = "model"


def mesh_dims(device_mesh) -> Tuple[int, Optional[int]]:
    """(the data axis, the model axis or None) of a mesh, by its own axis
    names (:data:`DATA_AXES`, :data:`MODEL_AXIS`). Of several data axes the
    one of more than one rank is the data axis. Raises ValueError on a mesh
    with no data axis, and NotImplementedError on two data axes of more
    than one rank or another axis of more than one rank (ROADMAP 15c)."""
    names = tuple(device_mesh.mesh_dim_names or ())
    fsdp = [names.index(a) for a in DATA_AXES if a in names]
    if not fsdp:
        raise ValueError(f"no data axis {DATA_AXES} on the mesh {names}")
    big = [i for i in fsdp if device_mesh.size(i) > 1]
    if len(big) > 1:
        raise NotImplementedError(
            f"a mesh of shape {tuple(device_mesh.shape)}: a data axis over "
            f"more than one mesh axis {[names[i] for i in big]} waits for "
            f"ROADMAP 15c")
    data = big[0] if big else fsdp[-1]
    model = names.index(MODEL_AXIS) if MODEL_AXIS in names else None
    for i, n in enumerate(names):
        if i not in (data, model) and device_mesh.size(i) > 1:
            raise NotImplementedError(
                f"axis {n!r} of {device_mesh.size(i)} ranks is neither the "
                f"data axis nor the model axis: ROADMAP 15c")
    return data, model


def data_axis(device_mesh) -> int:
    """The mesh axis that FSDP shards over (:func:`mesh_dims`)."""
    return mesh_dims(device_mesh)[0]


def _placed_dim(pl, stacked: bool) -> Optional[int]:
    dim = pl.dim if isinstance(pl, Shard) else None
    if dim is not None and stacked:
        if dim == 0:
            raise ValueError("a stacked leaf sharded along its stack axis")
        dim -= 1
    return dim


def layout(x: torch.Tensor, stacked: bool = False) -> Optional[Layout]:
    """The layout of a DTensor leaf (its sharded dims one lower when
    ``stacked``: the gather gets one slice of the leading axis); None for
    a plain tensor."""
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    i, m = mesh_dims(mesh)
    if m is None:
        return Layout(_placed_dim(x.placements[i], stacked),
                      mesh.get_group(i))
    return Layout(_placed_dim(x.placements[i], stacked), mesh.get_group(i),
                  _placed_dim(x.placements[m], stacked), mesh.get_group(m))


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


def _first_dtensor(tree: Any) -> Optional[DTensor]:
    for x in _leaves(tree):
        if isinstance(x, DTensor):
            return x
    return None


def world_of(tree: Any) -> Tuple[Optional[Any], int, int]:
    """(group, rank in it, ranks) of the data axis of a tree's DTensor
    leaves, (None, 0, 1) for a tree of plain tensors. The ranks of one
    data coordinate (a row of the mesh) take the same rows of a batch."""
    x = _first_dtensor(tree)
    if x is None:
        return None, 0, 1
    g = x.device_mesh.get_group(data_axis(x.device_mesh))
    return g, dist.get_rank(g), dist.get_world_size(g)


def dp_of(tree: Any) -> Optional[DataAxis]:
    """The data axis of a tree's DTensor leaves when it has more than one
    rank (MoE routing and a ``loss_mask`` then span the data ranks), else
    None."""
    group, rank, size = world_of(tree)
    return None if size <= 1 else DataAxis(group, rank, size)


def model_ranks(mesh) -> int:
    """The size of a ``DeviceMesh``'s model axis (1 without one)."""
    m = mesh_dims(mesh)[1]
    return 1 if m is None else mesh.size(m)


def tp_of(tree: Any) -> Optional[ModelAxis]:
    """The model axis of a tree's DTensor leaves when it has more than one
    rank (the layers are then tensor-parallel), else None."""
    x = _first_dtensor(tree)
    if x is None:
        return None
    m = mesh_dims(x.device_mesh)[1]
    if m is None or x.device_mesh.size(m) == 1:
        return None
    g = x.device_mesh.get_group(m)
    return ModelAxis(g, dist.get_rank(g), dist.get_world_size(g))


def groups_of(tree: Any) -> Dict[str, Any]:
    """``{"data": group[, "model": group]}`` of a tree's mesh (what
    ``roofline/analysis.collectives_of`` names each collective's group
    by); empty for a tree of plain tensors."""
    x = _first_dtensor(tree)
    if x is None:
        return {}
    i, m = mesh_dims(x.device_mesh)
    out = {"data": x.device_mesh.get_group(i)}
    if m is not None:
        out["model"] = x.device_mesh.get_group(m)
    return out


@contextlib.contextmanager
def _quiet() -> Iterator[None]:
    """torch 2.13 renames the tensor all-gather and reduce-scatter
    (``all_gather_single``, ``reduce_scatter_single``), which 2.11 lacks."""
    with warnings.catch_warnings():
        warnings.filterwarnings(
            "ignore", category=FutureWarning,
            message=".*(all_gather_into_tensor|reduce_scatter_tensor)")
        yield


def _all_gather(x: torch.Tensor, dim: int, group, world: int
                ) -> torch.Tensor:
    """The ``world`` ranks' blocks of ``x`` concatenated along ``dim``."""
    moved = x.movedim(dim, 0).contiguous()
    out = torch.empty((world * moved.shape[0],) + tuple(moved.shape[1:]),
                      dtype=x.dtype, device=x.device)
    with _quiet():
        dist.all_gather_into_tensor(out, moved, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    """Forward: the whole weight from the blocks. Backward: its gradient
    summed over the ranks into this rank's block."""

    @staticmethod
    def forward(ctx, x, lay: Layout):
        ctx.lay = lay
        return _all_gather(x, lay.dim, lay.group, lay.world)

    @staticmethod
    def backward(ctx, g):
        lay = ctx.lay
        g = g.movedim(lay.dim, 0).contiguous()
        out = torch.empty((g.shape[0] // lay.world,) + tuple(g.shape[1:]),
                          dtype=g.dtype, device=g.device)
        with _quiet():
            dist.reduce_scatter_tensor(out, g, group=lay.group)
        return out.movedim(0, lay.dim).contiguous(), None


class _SumGrad(torch.autograd.Function):
    """A replicated leaf: forward as it is, backward its gradient summed
    over the ranks."""

    @staticmethod
    def forward(ctx, x, lay: Layout):
        ctx.lay = lay
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a copy: autograd may hand the same gradient to another branch
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.lay.group)
        return g, None


class _ToModel(torch.autograd.Function):
    """Copy to the model group: forward as it is (every model rank holds
    the same activation), backward its gradient summed over the model
    ranks (each rank's column-parallel block gave a part of it)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromModel(torch.autograd.Function):
    """Reduce from the model group: forward the row-parallel partials
    summed over the model ranks, backward as it is (the sum's gradient
    is every part's)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_model(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """``x`` entering a column-parallel layer (:class:`_ToModel`); itself
    without a model axis."""
    return x if tp is None else _ToModel.apply(x, tp.group)


def from_model(x: torch.Tensor, tp: Optional[ModelAxis]) -> torch.Tensor:
    """A row-parallel layer's partial output summed over the model ranks
    (:class:`_FromModel`); itself without a model axis."""
    return x if tp is None else _FromModel.apply(x, tp.group)


def sum_over_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """``x`` summed over the model ranks, forward and backward: a
    statistic of the whole of a dim that each rank holds a block of, such
    as the SSM's gated norm's sum of squares. Each rank's copy of the sum
    feeds only that rank's part of the layer, so its gradient is a part
    too and is summed over the model ranks: :func:`from_model` of
    :func:`to_model`, one all-reduce each way."""
    return from_model(to_model(x, tp), tp)


def sum_over_data(x: torch.Tensor, dp: Optional[DataAxis]) -> torch.Tensor:
    """``x`` summed over the data ranks, forward and backward (itself
    without ``dp``): a statistic of the global batch, such as the aux
    loss's summed router probabilities. Every rank's loss holds the whole
    statistic and the step divides the summed gradient by the data ranks,
    so the backward sums the ranks' gradients too: an identity backward
    would leave the statistic's gradient ``dp.size`` times too small. One
    all-reduce each way (:class:`_ToModel` and :class:`_FromModel` over
    the data group)."""
    if dp is None:
        return x
    return _FromModel.apply(_ToModel.apply(x, dp.group), dp.group)


def gather_data(x: torch.Tensor, dp: DataAxis) -> torch.Tensor:
    """The data ranks' ``x`` stacked in data-coordinate order, ``(size,)
    + x.shape``, out of autograd (integer tables: gloo refuses int16, so
    send int32 or int64)."""
    return _all_gather(x.detach()[None], 0, dp.group, dp.size)


def gather_model(x: torch.Tensor, dim: int, tp: ModelAxis) -> torch.Tensor:
    """This rank's TP block of a leaf made whole along ``dim`` over the
    model ranks: forward an all-gather, backward its gradient
    reduce-scattered into the block (:class:`_Gather` over the model
    group), so a part every rank uses has its gradient summed over
    them."""
    return _Gather.apply(x, Layout(dim, tp.group))


class _Join(torch.autograd.Function):
    """Forward: the model ranks' blocks all-gathered along ``dim``.
    Backward: this rank's slice of the gradient, summed with nothing:
    every model rank runs the same work on the whole tensor, so each holds
    the whole gradient."""

    @staticmethod
    def forward(ctx, x, dim: int, tp: ModelAxis):
        ctx.dim, ctx.tp = dim, tp
        return _all_gather(x, dim, tp.group, tp.size)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.tp.size
        return (g.narrow(ctx.dim, ctx.tp.rank * n, n).contiguous(), None,
                None)


def join_model(x: torch.Tensor, dim: int, tp: ModelAxis) -> torch.Tensor:
    """The model ranks' blocks of an activation made whole along ``dim``
    for work every model rank repeats on the whole (:class:`_Join`), such
    as the MoE combine of the experts each rank ran. Not
    :func:`gather_model`: its backward sums the ranks' gradients, which
    here are the same whole gradient T times."""
    return _Join.apply(x, dim, tp)


def max_over_model(x: torch.Tensor, tp: ModelAxis) -> torch.Tensor:
    """The element-wise maximum over the model ranks, out of autograd."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=tp.group)
    return out


def gather_leaf(x: torch.Tensor, lay: Optional[Layout]) -> torch.Tensor:
    """``x`` (a block, plain) made whole over the data axis for a layer,
    per its layout: its TP block on a model axis of more than one rank."""
    if lay is None:
        return x
    fn = _SumGrad if lay.dim is None else _Gather
    return fn.apply(x, lay)


def gather(tree: Any, plan: Any) -> Any:
    """:func:`gather_leaf` over a tree and its plan (None: the tree)."""
    if plan is None:
        return tree
    return _map(gather_leaf, tree, plan)


def gather_to_rank0(leaf: DTensor) -> Optional[torch.Tensor]:
    """A DTensor leaf made whole on the mesh's rank 0, None on the other
    ranks: one ``dist.gather`` over the model axis onto each data row's
    model rank 0, then one over the data axis among those (a dim sharded
    over both axes is split by data first, then by model). An axis of one
    rank, or one the leaf is replicated over, costs nothing. Each stage
    frees its input before it allocates the whole, so rank 0 holds at most
    the whole leaf and one stage's input (1/D of the leaf on a (D, T) mesh
    with D > 1) above the state."""
    lay = layout(leaf)
    x = leaf.to_local()
    for dim, group in ((lay.mdim, lay.mgroup), (lay.dim, lay.group)):
        if group is None or dist.get_world_size(group) == 1:
            continue
        root = dist.get_rank(group) == 0
        if dim is None:
            if not root:
                return None
            continue
        moved = x.movedim(dim, 0).contiguous()
        del x
        world = dist.get_world_size(group)
        whole = torch.empty((world * moved.shape[0],) + moved.shape[1:],
                            dtype=moved.dtype, device=moved.device) \
            if root else None
        dist.gather(moved, list(whole.chunk(world)) if root else None,
                    dst=dist.get_global_rank(group, 0), group=group)
        del moved
        if not root:
            return None
        x = whole.movedim(0, dim)
        del whole               # x alone keeps it: the next stage frees it
    return x


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


def for_serve(params: Dict) -> Tuple[Dict, Optional[ModelAxis]]:
    """``(tree, tp)`` for the serving steps, once at set-up: on a (1, T)
    mesh every leaf's TP block as a plain tensor (the DTensor's own block,
    not copied) and ``tp`` its model axis (None for T = 1, with
    ``serving`` set otherwise); each SSM layer's ``w_in``, ``conv_w`` and
    ``conv_b`` replaced by the rank's columns and ``a_log``, ``dt_bias``,
    ``d_skip`` and ``out_norm`` by the rank's part
    (``models/ssm.serve_leaves``: the blocks are gathered over the model
    group here, once, and freed). A tree of plain tensors comes back as it
    is with no ``tp``. A data axis of more than one rank raises
    NotImplementedError: serving over data ranks (the reference shards its
    decode caches by batch, or by sequence at one row) waits for ROADMAP
    15c."""
    x = _first_dtensor(params)
    if x is None:
        return params, None
    mesh = x.device_mesh
    data = mesh.size(data_axis(mesh))
    if data > 1:
        raise NotImplementedError(
            f"serving over a data axis of {data} ranks (the caches split by "
            f"batch or by sequence) waits for ROADMAP 15c")
    tp = tp_of(params)
    tree = _map(lambda v: local(v).detach(), params)
    if tp is None:
        return tree, None
    from .ssm import serve_leaves
    tp = dataclasses.replace(tp, serving=True)

    def walk(t: Any) -> Any:
        if not isinstance(t, dict):
            return t
        return {k: serve_leaves(v, tp) if k == "ssm" else walk(v)
                for k, v in t.items()}
    return walk(tree), tp
