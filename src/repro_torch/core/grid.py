"""Uniform-grid build, resident layout (port of the resident half of
``repro.core.grid``).

One stable sort of the linear box keys permutes the pool itself into
grid-key order: agents of a box are adjacent, boxes are adjacent along z,
and dead slots (``DEAD_KEY``) sink to the tail — grid build, memory-layout
sort and death compaction in one permutation. The per-box ``(starts,
counts)`` tables then index the permuted pool directly.

The streamed sweep (:func:`resident_apply`, :func:`resident_apply_fused`)
evaluates pair kernels over each query row's 9 stencil z-runs of the
resident pool. A Verlet pair list (:class:`PairList`, built by
:func:`build_pairlist` from the same runs) lets the fused sweep evaluate
only the candidates within ``r + skin``, and a :class:`RebuildState`
carries the build across steps under ``RebuildPolicy(mode="every_k")``.

The paper's Fig-9/Fig-11 baselines leave the pool in slot order: the
sorted build (the same tables over a key-sorted copy, queried through
:func:`neighbor_apply`), the scatter-table grid (:class:`ScatterGridState`)
and the spatial hash (:class:`HashGridState`, its 27 probes streamed
through :func:`phased_chunk_apply`), and the exact O(N²)
:func:`brute_force_apply`. :func:`make_builder` builds any of the four.
"""

from __future__ import annotations

import dataclasses
import warnings
from collections.abc import Mapping
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function

from . import compaction, morton
from .agents import AgentPool
from .lanes import Lanes
from ..kernels import pairlist as pairlist_kernel

# sort realizations of the reference; each yields the unique stable
# permutation, which the port computes with one stable sort
SORT_IMPLS = ("auto", "host", "xla", "argsort")
BUILD_METHODS = ("resident", "sorted", "scatter", "hash")

# the 27 offsets of the 3×3×3 stencil, dx major, then dy, then dz: the lane
# order of the scatter and hash environments, whose tables are not
# contiguous in z
_OFFSETS = np.array([(dx, dy, dz)
                     for dx in (-1, 0, 1)
                     for dy in (-1, 0, 1)
                     for dz in (-1, 0, 1)], dtype=np.int32)   # (27, 3)

# the hash probe's gather width is HASH_K_MULT × max_per_box (collisions
# inflate buckets); a fuller bucket truncates and raises box_overflow
HASH_K_MULT = 4


@dataclasses.dataclass(frozen=True)
class RebuildPolicy:
    """When the grid build runs: ``every_step``, or ``every_k`` — at most
    every ``k`` steps, and sooner when a structural change or an
    accumulated per-axis displacement above ``displacement_bound`` (the
    slack the grid's boxes are widened by) invalidates the cached tables.
    Validation as in the reference."""
    mode: str = "every_step"
    k: int = 1
    displacement_bound: float = 0.0

    def __post_init__(self):
        if self.mode not in ("every_step", "every_k"):
            raise ValueError(f"rebuild.mode must be 'every_step' or "
                             f"'every_k', got {self.mode!r}")
        if not isinstance(self.k, int) or self.k < 1:
            raise ValueError(f"rebuild.k must be an int ≥ 1, got {self.k!r}")
        if self.displacement_bound < 0:
            raise ValueError(f"rebuild.displacement_bound must be ≥ 0, "
                             f"got {self.displacement_bound!r}")
        if self.mode == "every_step" and (self.k != 1
                                          or self.displacement_bound != 0.0):
            raise ValueError(
                "rebuild.k and rebuild.displacement_bound only apply under "
                "rebuild.mode='every_k' (every_step rebuilds unconditionally)")

    @property
    def cell_slack(self) -> float:
        return float(self.displacement_bound) if self.mode == "every_k" \
            else 0.0


@dataclasses.dataclass(frozen=True)
class PairListConfig:
    """Verlet pair-list settings, as in the reference.

    skin:      the list is built at ``interaction_radius + skin`` and covers
               every in-range pair while each agent's euclidean displacement
               since the build is ≤ ``skin/2``; skin 0 pairs with every-step
               rebuilds.
    max_pairs: P, the table's width per agent; a larger demand raises the
               ``pair_overflow`` flag (never silent).
    """
    skin: float = 0.0
    max_pairs: int = 32

    def __post_init__(self):
        if self.skin < 0:
            raise ValueError(f"pairlist.skin must be ≥ 0, got {self.skin!r}")
        if not isinstance(self.max_pairs, int) or self.max_pairs < 1:
            raise ValueError(f"pairlist.max_pairs must be an int ≥ 1, "
                             f"got {self.max_pairs!r}")


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static grid configuration."""
    dims: Tuple[int, int, int]
    max_per_box: int = 16
    query_chunk: int = 2048
    max_per_run: Optional[int] = None

    @property
    def table_size(self) -> int:
        return morton.linear_size(self.dims)

    @property
    def run_capacity(self) -> int:
        """R: agents one 3-box z-run may hold (None → 3·max_per_box)."""
        return self.max_per_run if self.max_per_run is not None \
            else 3 * self.max_per_box


@dataclasses.dataclass
class GridState:
    """Per-iteration neighbor index: over the resident pool (keys sorted,
    order and rank the identity) or, from the sorted build, over the pool
    as laid out (keys in slot order, order the key sort, rank its
    inverse).

    An ensemble's resident build (:func:`make_builder` with ``lanes``)
    indexes L lanes of C slots at once: ``keys``/``order``/``rank`` cover
    the L·C slots, ``starts``/``counts`` are L tables of M boxes, lane
    ``l``'s at ``[l·M, (l+1)·M)`` with slot ids of the whole pool, and
    ``max_count``/``max_run_count`` are (L,). The lane count is
    ``starts.shape[0] // M``."""
    origin: torch.Tensor          # (3,) f32
    box_size: morton.BoxSize      # box edge (see morton.cell_of)
    keys: torch.Tensor            # (C,) int64 holding uint32
    order: torch.Tensor           # (C,) int32 — slots in key order
    rank: torch.Tensor            # (C,) int32 — inverse of order
    starts: torch.Tensor          # (M,) int32 — first slot of each box
    counts: torch.Tensor          # (M,) table_count_dtype(C)
    max_count: torch.Tensor       # () counts' dtype — fullest box
    max_run_count: torch.Tensor   # () counts' dtype — fullest 3-box z-run


class BuildResult(NamedTuple):
    """Result of every build method.

    pool:     the pool the tables index (permuted by "resident", else the
              input)
    grid:     GridState ("resident", "sorted"), ScatterGridState or
              HashGridState
    order:    (C,) int32 old→new gather permutation applied to the pool
              (the identity for the methods that keep slot order)
    overflow: () int32 agents beyond the method's capacity: run_capacity
              (uniform), max_per_box (scatter), the probe width (hash)
    demand:   () int32 the peak occupancy behind ``overflow`` (fullest
              3-box z-run, box or bucket)
    """
    pool: AgentPool
    grid: Any
    order: torch.Tensor
    overflow: torch.Tensor
    demand: torch.Tensor


def table_count_dtype(capacity: int) -> torch.dtype:
    """int16 while the pool fits int16, else int32 (as the reference)."""
    return torch.int16 if capacity < 2 ** 15 else torch.int32


@dataclasses.dataclass
class PairList:
    """Compacted per-agent candidate table (the reference's Verlet list).

    Rows list the candidates of the 9 streamed z-runs within the build's
    radius, run-major and lane-minor (the order the streamed sweep adds
    them), so the sweep can replay its per-run sums over the pruned set.

    idx:     (C, P) int32 — sorted-pool candidate positions, row-packed
    run_off: (C, 10) int32 — cumulative per-run offsets into idx, capped at
             P (run_off[:, 0] = 0, run_off[:, 9] = the row's stored count)
    count:   (C,) int32 — the row's demand, not capped
    demand:  () int32 — the largest ``count``; overflow ⇔ demand > P

    An ensemble's list holds its L lanes' rows lane-major (L·C rows), its
    entries slot ids of the whole pool, and ``demand`` (L,).
    """
    idx: torch.Tensor
    run_off: torch.Tensor
    count: torch.Tensor
    demand: torch.Tensor


def initial_pairlist(capacity: int, max_pairs: int,
                     device: torch.device | str = "cpu",
                     lanes: Optional[Lanes] = None) -> PairList:
    """Zero tables — what a build writes for rows it never lists. With
    ``lanes`` an ensemble's: (L·C, ...) rows and a demand per lane."""
    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=device)
    rows, dem = capacity, ()
    if lanes is not None and not lanes.solo:
        rows, dem = lanes.n * lanes.capacity, (lanes.n,)
    return PairList(idx=z(rows, max_pairs), run_off=z(rows, 10),
                    count=z(rows), demand=z(*dem))


def grow_pairlist(pairs: PairList, new_capacity: int, new_max_pairs: int,
                  lanes: Optional[Lanes] = None) -> PairList:
    """Pad a cached list to a larger capacity and/or width with zeros —
    what a build at that size would have written (a list that overflowed
    is never carried: the ladder rewinds that step). Leading axes (shards)
    are kept. With ``lanes`` (an ensemble's lane-major list, lanes of
    ``lanes.capacity``) each lane grows to ``new_capacity`` rows."""
    if lanes is not None and not lanes.solo:
        return _flat_pairs(grow_pairlist(_stacked_pairs(pairs, lanes),
                                         new_capacity, new_max_pairs))
    old_c, old_p = pairs.idx.shape[-2], pairs.idx.shape[-1]
    if new_capacity < old_c or new_max_pairs < old_p:
        raise ValueError(f"grow_pairlist: ({new_capacity}, {new_max_pairs}) "
                         f"< ({old_c}, {old_p})")
    if new_capacity == old_c and new_max_pairs == old_p:
        return pairs
    dc, dp = new_capacity - old_c, new_max_pairs - old_p
    return PairList(idx=F.pad(pairs.idx, (0, dp, 0, dc)),
                    run_off=F.pad(pairs.run_off, (0, 0, 0, dc)),
                    count=F.pad(pairs.count, (0, dc)), demand=pairs.demand)


@dataclasses.dataclass
class RebuildState:
    """The build carried across steps under ``RebuildPolicy("every_k")``.

    grid:        the last build's tables (they index the pool's layout as
                 that build left it; a death or birth marks them dirty)
    steps_since: () int32 — steps served by ``grid`` so far
    disp_accum:  () float32 — the largest per-agent per-axis |Δposition|
                 of each step, summed since the build
    dirty:       () bool — a structural change invalidated ``grid``
    pairs:       the pair list built beside ``grid`` (None without one)
    pair_disp:   () float32 — the largest per-agent euclidean ‖Δposition‖
                 of each step, summed since the build; the list is reused
                 while 2·pair_disp ≤ skin

    An ensemble's cache (``lanes``) holds every lane in the lane-major
    layout of its pool: the grid as :class:`GridState` describes it, the
    pair list's rows lane-major with slot ids of the whole pool, and the
    counters, flags and demands (L,). :func:`stack_rebuild_state` and
    :func:`flatten_rebuild_state` convert to and from the reference's
    ``(L, ...)`` layout, whose ids are each lane's own.
    """
    grid: GridState
    steps_since: torch.Tensor
    disp_accum: torch.Tensor
    dirty: torch.Tensor
    pairs: Optional[PairList] = None
    pair_disp: Optional[torch.Tensor] = None


def initial_rebuild_state(spec: GridSpec, capacity: int,
                          origin: torch.Tensor, box_size: float,
                          pairlist: Optional[PairListConfig] = None,
                          lanes: Optional[Lanes] = None) -> RebuildState:
    """The cache before the first step: empty tables, dirty, so step 0
    builds. Tensors on ``origin``'s device. With ``lanes``, L such caches
    in the lane-major layout."""
    dev = origin.device
    cdt = table_count_dtype(capacity)
    n = 1 if lanes is None else lanes.n
    shape = () if n == 1 else (n,)
    rows = n * capacity
    ident = torch.arange(rows, dtype=torch.int32, device=dev)
    # an empty lane's boxes all start at its first slot
    starts = torch.arange(n, dtype=torch.int32, device=dev).mul_(
        capacity).repeat_interleave(spec.table_size)
    grid = GridState(
        origin=origin.to(torch.float32), box_size=float(box_size),
        keys=torch.full((rows,), morton.DEAD_KEY, dtype=torch.int64,
                        device=dev),
        order=ident, rank=ident, starts=starts,
        counts=torch.zeros(n * spec.table_size, dtype=cdt, device=dev),
        max_count=torch.zeros(shape, dtype=cdt, device=dev),
        max_run_count=torch.zeros(shape, dtype=cdt, device=dev))
    f32 = torch.zeros(shape, dtype=torch.float32, device=dev)
    pairs = pair_disp = None
    if pairlist is not None:
        pairs = initial_pairlist(capacity, pairlist.max_pairs, dev, lanes)
        pair_disp = f32.clone()
    return RebuildState(grid=grid,
                        steps_since=torch.zeros(shape, dtype=torch.int32,
                                                device=dev),
                        disp_accum=f32, dirty=torch.ones(shape,
                                                         dtype=torch.bool,
                                                         device=dev),
                        pairs=pairs, pair_disp=pair_disp)


def grow_grid_state(grid: GridState, new_capacity: int,
                    lanes: Optional[Lanes] = None) -> GridState:
    """Grow cached resident tables to a larger pool capacity, as a build at
    that capacity would have made them: dead keys pad ``keys``, the
    identity ``order``/``rank`` extend, and the counts take the new
    capacity's table dtype. Leading axes (shards) are kept. With ``lanes``
    (an ensemble's lane-major tables, lanes of ``lanes.capacity``) each
    lane grows to ``new_capacity`` slots."""
    if lanes is not None and not lanes.solo:
        return _flat_grid(grow_grid_state(_stacked_grid(grid, lanes),
                                          new_capacity))
    old = grid.keys.shape[-1]
    if new_capacity == old:
        return grid
    if new_capacity < old:
        raise ValueError(f"grow_grid_state: {new_capacity} < {old}")
    pad = new_capacity - old
    ident = torch.arange(old, new_capacity, dtype=torch.int32,
                         device=grid.keys.device).expand(
        *grid.keys.shape[:-1], pad)
    cdt = table_count_dtype(new_capacity)
    return dataclasses.replace(
        grid, keys=F.pad(grid.keys, (0, pad), value=morton.DEAD_KEY),
        order=torch.cat([grid.order, ident], -1),
        rank=torch.cat([grid.rank, ident], -1),
        counts=grid.counts.to(cdt), max_count=grid.max_count.to(cdt),
        max_run_count=grid.max_run_count.to(cdt))


# ---------------------------------------------------------------------------
# An ensemble's cache: the lane-major layout and the reference's (L, ...)
# ---------------------------------------------------------------------------

def _lane_base(n: int, capacity: int, device) -> torch.Tensor:
    """(L, 1) int32 first slot of each lane."""
    return torch.arange(n, dtype=torch.int32, device=device)[:, None] \
        * capacity


def _shift_stored(idx: torch.Tensor, run_off: torch.Tensor,
                  shift: torch.Tensor) -> torch.Tensor:
    """``idx`` (..., C, P) with ``shift`` (..., 1, 1) added to each row's
    stored entries; the zeros past a row's stored count stay zeros, as a
    build writes them."""
    col = torch.arange(idx.shape[-1], dtype=torch.int32, device=idx.device)
    return torch.where(col < run_off[..., 9:], idx + shift,
                       torch.zeros((), dtype=idx.dtype, device=idx.device))


def _stacked_grid(grid: GridState, lanes: Lanes) -> GridState:
    """Lane-major tables → the reference's (L, ...) tables with each
    lane's own slot ids (origin (L, 3), box_size (L,) float32)."""
    n, c = lanes.n, lanes.capacity
    dev = grid.keys.device
    base = _lane_base(n, c, dev)
    box = grid.box_size
    box = (box.reshape(-1)[:1] if isinstance(box, torch.Tensor)
           else torch.tensor([box], dtype=torch.float32, device=dev))
    return GridState(
        origin=grid.origin.reshape(-1, 3)[:1].expand(n, 3).clone(),
        box_size=box.to(torch.float32).expand(n).clone(),
        keys=grid.keys.reshape(n, c),
        order=grid.order.reshape(n, c) - base,
        rank=grid.rank.reshape(n, c) - base,
        starts=grid.starts.reshape(n, -1) - base,
        counts=grid.counts.reshape(n, -1),
        max_count=grid.max_count.reshape(n),
        max_run_count=grid.max_run_count.reshape(n))


def _lane_shape(n: int) -> tuple:
    """The shape of a per-lane leaf in the lane-major layout: () for one
    lane (the solo cache), (L,) otherwise."""
    return () if n == 1 else (n,)


def _flat_grid(grid: GridState) -> GridState:
    """Inverse of :func:`_stacked_grid`: (L, ...) tables → lane-major, the
    box size a Python float."""
    n, c = grid.keys.shape
    base = _lane_base(n, c, grid.keys.device)
    box = grid.box_size
    return GridState(
        origin=grid.origin.reshape(-1, 3)[0].clone(),
        box_size=float(box.reshape(-1)[0]) if isinstance(
            box, torch.Tensor) else float(box),
        keys=grid.keys.reshape(-1),
        order=(grid.order + base).reshape(-1),
        rank=(grid.rank + base).reshape(-1),
        starts=(grid.starts + base).reshape(-1),
        counts=grid.counts.reshape(-1),
        max_count=grid.max_count.reshape(_lane_shape(n)),
        max_run_count=grid.max_run_count.reshape(_lane_shape(n)))


def _stacked_pairs(pairs: PairList, lanes: Lanes) -> PairList:
    n, c = lanes.n, lanes.capacity
    run_off = pairs.run_off.reshape(n, c, 10)
    base = _lane_base(n, c, pairs.idx.device)[:, :, None]
    return PairList(
        idx=_shift_stored(pairs.idx.reshape(n, c, -1), run_off, -base),
        run_off=run_off, count=pairs.count.reshape(n, c),
        demand=pairs.demand.reshape(n))


def _flat_pairs(pairs: PairList) -> PairList:
    n, c, p = pairs.idx.shape
    base = _lane_base(n, c, pairs.idx.device)[:, :, None]
    return PairList(
        idx=_shift_stored(pairs.idx, pairs.run_off, base).reshape(n * c, p),
        run_off=pairs.run_off.reshape(n * c, 10),
        count=pairs.count.reshape(n * c),
        demand=pairs.demand.reshape(_lane_shape(n)))


def stack_rebuild_state(env: RebuildState, lanes: Lanes) -> RebuildState:
    """An ensemble's cache in the reference's ``(L, ...)`` layout: every
    leaf with a leading lane axis and each lane's ids its own (what the
    reference's vmapped step carries, and its checkpoints store)."""
    return RebuildState(
        grid=_stacked_grid(env.grid, lanes),
        steps_since=env.steps_since.reshape(lanes.n),
        disp_accum=env.disp_accum.reshape(lanes.n),
        dirty=env.dirty.reshape(lanes.n),
        pairs=None if env.pairs is None else _stacked_pairs(env.pairs,
                                                            lanes),
        pair_disp=None if env.pair_disp is None
        else env.pair_disp.reshape(lanes.n))


def flatten_rebuild_state(env: RebuildState) -> RebuildState:
    """Inverse of :func:`stack_rebuild_state`: the lane-major cache an
    ensemble steps with (one lane's is the solo cache)."""
    shape = _lane_shape(env.dirty.shape[0])
    return RebuildState(
        grid=_flat_grid(env.grid),
        steps_since=env.steps_since.reshape(shape),
        disp_accum=env.disp_accum.reshape(shape),
        dirty=env.dirty.reshape(shape),
        pairs=None if env.pairs is None else _flat_pairs(env.pairs),
        pair_disp=None if env.pair_disp is None
        else env.pair_disp.reshape(shape))


_GRID_LEAVES = ("keys", "order", "rank", "starts", "counts", "max_count",
                "max_run_count")
_PAIR_LEAVES = ("idx", "run_off", "count", "demand")


def map_rebuild_state(fn: Callable, env: RebuildState,
                      *others: RebuildState) -> RebuildState:
    """``fn`` applied leaf by leaf to caches of one structure
    (``fn(leaf, *other_leaves)``); the grid's origin and box size are
    ``env``'s."""
    def leaves(get):
        return fn(get(env), *(get(o) for o in others))

    grid = dataclasses.replace(env.grid, **{
        f: leaves(lambda e, f=f: getattr(e.grid, f)) for f in _GRID_LEAVES})
    pairs = None if env.pairs is None else PairList(**{
        f: leaves(lambda e, f=f: getattr(e.pairs, f)) for f in _PAIR_LEAVES})
    return RebuildState(
        grid=grid, pairs=pairs,
        pair_disp=None if env.pair_disp is None
        else leaves(lambda e: e.pair_disp),
        **{f: leaves(lambda e, f=f: getattr(e, f))
           for f in ("steps_since", "disp_accum", "dirty")})


def lane_rebuild_state(env: RebuildState, lanes: Lanes,
                       lane: int) -> RebuildState:
    """Lane ``lane``'s cache as its solo run carries it (copies)."""
    one = map_rebuild_state(lambda t: t[lane].clone(),
                            stack_rebuild_state(env, lanes))
    return dataclasses.replace(one, grid=dataclasses.replace(
        one.grid, origin=env.grid.origin.clone(),
        box_size=env.grid.box_size))


def with_lane_rebuild_state(env: RebuildState, lanes: Lanes, lane: int,
                            solo: RebuildState) -> RebuildState:
    """``env`` with lane ``lane``'s cache replaced by a solo run's."""
    def put(stacked: torch.Tensor, one: torch.Tensor) -> torch.Tensor:
        out = stacked.clone()
        out[lane] = one
        return out
    return flatten_rebuild_state(map_rebuild_state(
        put, stack_rebuild_state(env, lanes), solo))


def counting_sort_order(keys: torch.Tensor, table_size: int, *,
                        impl: str = "auto") -> torch.Tensor:
    """Stable sort permutation of box keys, (C,) int32.

    The reference's counting sort returns the unique stable permutation of
    its keys, so one stable ``torch.sort`` reproduces it exactly whatever
    ``impl`` names. ``table_size`` is kept for the reference's signature.
    """
    if impl not in SORT_IMPLS:
        raise ValueError(f"sort_impl must be one of {SORT_IMPLS}, "
                         f"got {impl!r}")
    return torch.sort(keys, stable=True).indices.to(torch.int32)


def lane_sort(keys: torch.Tensor, table_size: int, sort_impl: str = "auto",
              lanes: Optional[Lanes] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each lane's keys sorted on their own, stably: ``(sorted_keys (L, C),
    order (L·C,) int32)``, ``order`` listing slot ids of the whole pool,
    lane by lane. One lane (``lanes`` None or solo) is
    :func:`counting_sort_order`; more are one batched stable sort."""
    if lanes is None or lanes.solo:
        order = counting_sort_order(keys, table_size, impl=sort_impl)
        return keys.index_select(0, order.to(torch.int64))[None], order
    if sort_impl not in SORT_IMPLS:
        raise ValueError(f"sort_impl must be one of {SORT_IMPLS}, "
                         f"got {sort_impl!r}")
    sorted_keys, local = torch.sort(lanes.view(keys), dim=1, stable=True)
    order = (local + lanes.offsets(keys.device)[:, None]).reshape(-1)
    return sorted_keys, order.to(torch.int32)


def box_tables(sorted_keys: torch.Tensor, table_size: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense per-box ``(starts, counts)`` from the key-sorted keys."""
    box_ids = torch.arange(table_size + 1, dtype=sorted_keys.dtype,
                           device=sorted_keys.device)
    bounds = torch.searchsorted(sorted_keys, box_ids, side="left"
                                ).to(torch.int32)
    counts = (bounds[1:] - bounds[:-1]).to(
        table_count_dtype(sorted_keys.shape[0]))
    return bounds[:-1], counts


def _index_tables(spec: GridSpec, sorted_keys: torch.Tensor):
    """(starts, counts, max_count, max_run_count) from the sorted keys."""
    starts, counts = box_tables(sorted_keys, spec.table_size)
    c3 = counts.reshape(spec.dims)
    cp = F.pad(c3, (1, 1))
    runs = cp[:, :, :-2] + cp[:, :, 1:-1] + cp[:, :, 2:]
    return starts, counts, counts.max(), runs.max()


def _lane_index_tables(spec: GridSpec, sorted_keys: torch.Tensor,
                       lanes: Lanes):
    """:func:`_index_tables` of each lane's sorted keys (L, C) at once:
    starts (L·M,) as slot ids of the lane-major pool, counts (L·M,), and
    each lane's fullest box and 3-box z-run (L,)."""
    m = spec.table_size
    box_ids = torch.arange(m + 1, dtype=sorted_keys.dtype,
                           device=sorted_keys.device)
    bounds = torch.searchsorted(sorted_keys, box_ids.expand(lanes.n, m + 1)
                                .contiguous(), side="left")
    counts = (bounds[:, 1:] - bounds[:, :-1]).to(
        table_count_dtype(lanes.capacity))
    starts = (bounds[:, :-1] + lanes.offsets(sorted_keys.device)[:, None]
              ).to(torch.int32)
    cp = F.pad(counts.reshape(lanes.n, *spec.dims), (1, 1))
    runs = cp[..., :-2] + cp[..., 1:-1] + cp[..., 2:]
    return (starts.reshape(-1), counts.reshape(-1), counts.amax(1),
            runs.reshape(lanes.n, -1).amax(1))


def _build_resident_impl(spec: GridSpec, pool: AgentPool,
                         origin: torch.Tensor, box_size: float,
                         sort_impl: str = "auto",
                         lanes: Optional[Lanes] = None
                         ) -> Tuple[AgentPool, GridState, torch.Tensor]:
    """Permute the pool into grid-key order and index it in place.

    Returns ``(pool, grid, order)``: the reordered pool, its tables (order
    and rank the identity), and the applied gather permutation. With
    ``lanes`` each lane's segment is sorted on its own (one batched stable
    sort: dead slots sink to the end of their own lane) and indexed by its
    own table.
    """
    keys = morton.grid_sort_keys(pool.position, pool.alive, origin, box_size,
                                 spec.dims)
    if lanes is not None and not lanes.solo:
        lane_sorted, order = lane_sort(keys, spec.table_size, sort_impl,
                                       lanes)
        pool = compaction.apply_permutation(pool, order)
        starts, counts, max_count, max_run = _lane_index_tables(
            spec, lane_sorted, lanes)
        sorted_keys = lane_sorted.reshape(-1)
    else:
        order = counting_sort_order(keys, spec.table_size, impl=sort_impl)
        pool = compaction.apply_permutation(pool, order)
        sorted_keys = keys.index_select(0, order.to(torch.int64))
        starts, counts, max_count, max_run = _index_tables(spec,
                                                           sorted_keys)
    ident = torch.arange(order.shape[0], dtype=torch.int32,
                         device=order.device)
    grid = GridState(origin=origin, box_size=box_size, keys=sorted_keys,
                     order=ident, rank=ident, starts=starts, counts=counts,
                     max_count=max_count, max_run_count=max_run)
    return pool, grid, order


def _build_sorted_impl(spec: GridSpec, pool: AgentPool,
                       origin: torch.Tensor, box_size: morton.BoxSize,
                       sort_impl: str = "auto") -> GridState:
    """The grid tables over the pool as laid out (slot order kept):
    ``keys`` in slot order, ``order`` their stable sort and ``rank`` its
    inverse; queries gather through :func:`sort_channels`."""
    keys = morton.grid_sort_keys(pool.position, pool.alive, origin, box_size,
                                 spec.dims)
    order = counting_sort_order(keys, spec.table_size, impl=sort_impl)
    o64 = order.to(torch.int64)
    sorted_keys = keys.index_select(0, o64)
    rank = torch.empty_like(order).index_copy_(
        0, o64, torch.arange(order.shape[0], dtype=torch.int32,
                             device=order.device))
    starts, counts, max_count, max_run = _index_tables(spec, sorted_keys)
    return GridState(origin=origin, box_size=box_size, keys=keys, order=order,
                     rank=rank, starts=starts, counts=counts,
                     max_count=max_count, max_run_count=max_run)


def make_builder(spec: GridSpec, *, method: str = "resident",
                 sort_impl: str = "auto", n_buckets: int = 1 << 14,
                 lanes: Optional[Lanes] = None
                 ) -> Callable[[AgentPool, torch.Tensor, morton.BoxSize],
                               BuildResult]:
    """``build_fn(pool, origin, box_size) -> BuildResult`` for ``method``:

    - "resident": the key sort's permutation applied to the pool itself
      (the engine's uniform grid);
    - "sorted": the same tables over the pool as laid out;
    - "scatter": the dense (boxes × max_per_box) member table, the paper's
      'standard implementation';
    - "hash": a spatial hash over ``n_buckets`` buckets.

    ``overflow`` and ``demand`` as the reference reports them for each
    method. ``box_size`` follows ``morton.cell_of``: a float multiplies by
    its float32 reciprocal, a tensor divides. ``lanes`` builds an
    ensemble's L lanes at once, each indexed by tables of its own (the
    "resident", "scatter" and "hash" methods, which the engine runs);
    ``overflow`` and ``demand`` are then (L,).
    """
    if method not in BUILD_METHODS:
        raise ValueError(
            f"method must be one of {BUILD_METHODS}, got {method!r}")
    if lanes is not None and not lanes.solo and method == "sorted":
        raise ValueError("the sorted build indexes one lane only")
    if sort_impl not in SORT_IMPLS:
        raise ValueError(
            f"sort_impl must be one of {SORT_IMPLS}, got {sort_impl!r}")

    def ident(pool: AgentPool) -> torch.Tensor:
        return torch.arange(pool.capacity, dtype=torch.int32,
                            device=pool.device)

    def result(pool, grid, order, demand, cap) -> BuildResult:
        demand = demand.to(torch.int32)
        return BuildResult(pool, grid, order,
                           torch.clamp(demand - cap, min=0), demand)

    def build_fn(pool: AgentPool, origin: torch.Tensor,
                 box_size: morton.BoxSize) -> BuildResult:
        if method == "resident":
            pool, grid, order = _build_resident_impl(spec, pool, origin,
                                                     box_size, sort_impl,
                                                     lanes)
            return result(pool, grid, order, grid.max_run_count,
                          spec.run_capacity)
        if method == "sorted":
            grid = _build_sorted_impl(spec, pool, origin, box_size, sort_impl)
            return result(pool, grid, ident(pool), grid.max_run_count,
                          spec.run_capacity)
        if method == "scatter":
            grid = _build_scatter_impl(spec, pool, origin, box_size,
                                       sort_impl, lanes)
            return result(pool, grid, ident(pool),
                          (lanes or Lanes()).max(grid.counts),
                          spec.max_per_box)
        grid = _build_hash_impl(spec, pool, origin, box_size, n_buckets,
                                sort_impl, lanes)
        return result(pool, grid, ident(pool), grid.max_bucket_count,
                      HASH_K_MULT * spec.max_per_box)
    return build_fn


class GridBuilderDeprecationWarning(DeprecationWarning):
    """A legacy direct grid-build entry point was called (use
    :func:`make_builder`); a category of its own so that these alone can
    be made errors."""


def _builder_deprecated(name: str, repl: str) -> None:
    warnings.warn(
        f"grid.{name} is deprecated and will be removed next release; use "
        f"grid.make_builder(spec, method={repl!r}) instead",
        GridBuilderDeprecationWarning, stacklevel=3)


def build(spec: GridSpec, pool: AgentPool, origin: torch.Tensor,
          box_size: morton.BoxSize) -> GridState:
    """Deprecated: ``make_builder(spec, method='sorted')(...).grid``."""
    _builder_deprecated("build", "sorted")
    return _build_sorted_impl(spec, pool, origin, box_size)


def build_resident(spec: GridSpec, pool: AgentPool, origin: torch.Tensor,
                   box_size: morton.BoxSize
                   ) -> Tuple[AgentPool, GridState, torch.Tensor]:
    """Deprecated: ``make_builder(spec, method='resident')``."""
    _builder_deprecated("build_resident", "resident")
    return _build_resident_impl(spec, pool, origin, box_size)


def build_scatter_grid(spec: GridSpec, pool: AgentPool, origin: torch.Tensor,
                       box_size: morton.BoxSize) -> "ScatterGridState":
    """Deprecated: ``make_builder(spec, method='scatter')(...).grid``."""
    _builder_deprecated("build_scatter_grid", "scatter")
    return _build_scatter_impl(spec, pool, origin, box_size)


def build_hash_grid(spec: GridSpec, pool: AgentPool, origin: torch.Tensor,
                    box_size: morton.BoxSize, n_buckets: int = 1 << 14
                    ) -> "HashGridState":
    """Deprecated: ``make_builder(spec, method='hash')(...).grid``."""
    _builder_deprecated("build_hash_grid", "hash")
    return _build_hash_impl(spec, pool, origin, box_size, n_buckets)


# ---------------------------------------------------------------------------
# The streamed sweep over the resident pool
# ---------------------------------------------------------------------------

# candidate lanes (rows × 9 runs × run_capacity) per chunk of the sweep:
# bounds its temporaries to a few hundred bytes per lane (about 4 GB for the
# force kernel at this budget) whatever the pool's size
SWEEP_LANES = 2 ** 25


def _run_offsets(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 9 (dx, dy) stencil columns, dx major, made on the device."""
    j = torch.arange(9, dtype=torch.int32, device=device)
    return torch.div(j, 3, rounding_mode="floor") - 1, j % 3 - 1


def run_bounds(spec: GridSpec, grid: GridState, query_pos: torch.Tensor,
               rows: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-query ``(start, length)`` of the 9 contiguous stencil z-runs.

    query_pos (Q, 3). Returns ``(s, n)``, each (Q, 9) int32: for every
    (dx, dy) stencil column the resident range ``[s, s + n)`` covering its
    z-run of ≤ 3 boxes, zero-length where the column falls outside the grid.
    Candidates are box-level; callers apply the radius test.

    Over an ensemble's tables ``rows`` (Q,) gives each query's slot: the
    stencil boxes are found in the lane's own coordinates, with the solo
    bounds, and only then moved to the lane's table, so no run leaves the
    query's lane and each sees its candidates in the solo order.
    """
    dims = spec.dims
    cell = morton.cell_of(query_pos, grid.origin, grid.box_size, dims)
    dx, dy = _run_offsets(query_pos.device)
    nx = cell[:, None, 0] + dx
    ny = cell[:, None, 1] + dy
    inside = (nx >= 0) & (nx < dims[0]) & (ny >= 0) & (ny < dims[1])
    nx = nx.clamp(0, dims[0] - 1)
    ny = ny.clamp(0, dims[1] - 1)
    z_lo = (cell[:, 2] - 1).clamp(min=0)[:, None].expand_as(nx)
    z_hi = (cell[:, 2] + 1).clamp(max=dims[2] - 1)[:, None].expand_as(nx)
    k_lo = morton.linear_encode3(nx, ny, z_lo, dims)
    k_hi = morton.linear_encode3(nx, ny, z_hi, dims)
    n_lanes = grid.starts.shape[0] // spec.table_size
    if n_lanes > 1:
        if rows is None:
            raise ValueError("an ensemble's run bounds need the query rows")
        per = grid.keys.shape[0] // n_lanes
        off = torch.div(rows.to(torch.int64), per,
                        rounding_mode="floor")[:, None] * spec.table_size
        k_lo, k_hi = k_lo + off, k_hi + off
    s = grid.starts[k_lo]
    e = grid.starts[k_hi] + grid.counts[k_hi].to(torch.int32)
    n = torch.where(inside, e - s, torch.zeros_like(s))
    return s.to(torch.int32), n.to(torch.int32)


@dataclasses.dataclass(frozen=True)
class PairKernel:
    """One pair kernel of a fused resident sweep.

    name:       unique key; the sweep returns its outputs under it.
    pair_fn:    ``(q, nbr, valid, q_slot) -> dict`` of per-query reductions:
                q entries (B, ...), nbr entries (B, W, ...), valid (B, W)
                bool, q_slot (B,) int32; outputs additive across splits of
                the candidate axis.
    out_specs:  output name → (shape_suffix, dtype).
    reads:      every pool channel the pair_fn reads (``extra.*`` names
                included); the sweep streams only their union, and a read
                outside it raises ``KeyError``.
    query_mask: this kernel's query rows (None → the sweep's default);
                outputs are zero outside it.
    """
    name: str
    pair_fn: Callable
    out_specs: Dict[str, Tuple[Tuple[int, ...], Any]]
    reads: Tuple[str, ...]
    query_mask: Optional[torch.Tensor] = None


def fused_reads(kernels: Sequence[PairKernel]) -> Tuple[str, ...]:
    """Union of the kernels' channel footprints, first-appearance order."""
    return tuple(dict.fromkeys(ch for k in kernels for ch in k.reads))


class _OnRead(Mapping):
    """Channels made on first read: ``make(channels[name])``. A pair kernel
    reads a few of the channels it is offered, and eager PyTorch would
    otherwise gather every one (XLA drops the unread gathers)."""

    def __init__(self, channels: Mapping, make: Callable):
        self._src, self._make, self._made = channels, make, {}

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._made:
            self._made[name] = self._make(self._src[name])
        return self._made[name]

    def __iter__(self):
        return iter(self._src)

    def __len__(self) -> int:
        return len(self._src)


def _row_step(spec: GridSpec, c: int, chunk: Optional[int],
              width: int) -> Tuple[int, int]:
    """(block, rows per chunk): whole ``chunk``-row blocks within
    ``SWEEP_LANES`` lanes of 9 runs × ``width``."""
    b = max(min(chunk if chunk is not None else spec.query_chunk, c), 1)
    return b, b * max(1, SWEEP_LANES // (9 * width * b))


def _stream_candidates(spec: GridSpec, grid: GridState,
                       position: torch.Tensor):
    """The streamed sweep's candidates: each (row, run) pair is one row of
    width R, its run's slots past the run's length or equal to the row's
    own slot invalid."""
    r_cap = spec.run_capacity
    lane = torch.arange(r_cap, dtype=torch.int32, device=position.device)

    def rows_of(r0: int, r1: int):
        nb = r1 - r0
        rows = torch.arange(r0, r1, dtype=torch.int32,
                            device=position.device)
        s, n = run_bounds(spec, grid, position[r0:r1], rows)
        n = n.clamp(max=r_cap)
        pos = s[:, :, None] + lane                          # (nb, 9, R)
        valid = lane < n[:, :, None]
        valid &= pos != rows[:, None, None]      # resident: position == slot
        pos = torch.where(valid, pos, torch.zeros_like(pos))
        idx = pos.reshape(-1).to(torch.int64)

        def gather(v):
            return v.index_select(0, idx).reshape(nb * 9, r_cap,
                                                  *v.shape[1:])
        return gather, valid.reshape(nb * 9, r_cap)
    return r_cap, rows_of


def _pair_candidates(pairs: PairList):
    """The pair-list sweep's candidates: each row's stored entries gathered
    once at width P, then presented to each of the 9 runs with only that
    run's segment ``[run_off[j], run_off[j+1])`` valid."""
    p = pairs.idx.shape[-1]
    lane = torch.arange(p, dtype=torch.int32, device=pairs.idx.device)

    def rows_of(r0: int, r1: int):
        nb = r1 - r0
        off = pairs.run_off[r0:r1]
        stored = lane < off[:, 9:]
        idx = torch.where(stored, pairs.idx[r0:r1],
                          torch.zeros((), dtype=torch.int32,
                                      device=off.device))
        idx = idx.reshape(-1).to(torch.int64)
        valid = (lane >= off[:, :9, None]) & (lane < off[:, 1:, None])

        def gather(v):
            g = v.index_select(0, idx).reshape(nb, 1, p, *v.shape[1:])
            return g.expand(nb, 9, p, *v.shape[1:]).reshape(
                nb * 9, p, *v.shape[1:])
        return gather, valid.reshape(nb * 9, p)
    return p, rows_of


def _stream(spec: GridSpec, q_src: Mapping, nbr_src: Mapping,
            kernels: Sequence[PairKernel], masks: Sequence[torch.Tensor],
            chunk: Optional[int], candidates
            ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Every row of the pool against its 9 runs of candidates, chunk by
    chunk (``candidates`` is :func:`_stream_candidates` or
    :func:`_pair_candidates`).

    The reference loops over the blocks that hold a masked row, a trip
    count on the device. Here every row is evaluated, in chunks whose count
    the host knows, and each kernel's outputs are kept on its own mask: a
    row's output is a function of the channels alone, so the grouping
    changes no value and the sweep reads nothing back from the card. A
    chunk is a whole number of ``chunk``-row blocks within ``SWEEP_LANES``
    lanes. Each (row, run) pair is one row of the pair kernel's input, so
    one call covers all 9 runs; the runs' partial sums are then added in
    the reference's order, run 0 first.
    """
    c = q_src["position"].shape[0]
    dev = q_src["position"].device
    width, rows_of = candidates
    _, step = _row_step(spec, c, chunk, width)
    outs = {k.name: {name: torch.zeros((c, *sfx), dtype=dt, device=dev)
                     for name, (sfx, dt) in k.out_specs.items()}
            for k in kernels}
    for r0 in range(0, c, step):
        r1 = min(r0 + step, c)
        nb = r1 - r0
        gather, valid = rows_of(r0, r1)

        def per_run(v, r0=r0, r1=r1, nb=nb):
            v = v[r0:r1]
            return v[:, None].expand(nb, 9, *v.shape[1:]).reshape(
                nb * 9, *v.shape[1:])

        q = _OnRead(q_src, per_run)
        nbr = _OnRead(nbr_src, gather)
        q_slot = torch.arange(r0, r1, dtype=torch.int32, device=dev)[
            :, None].expand(nb, 9).reshape(-1)
        for k, m in zip(kernels, masks):
            res = k.pair_fn(q, nbr, valid, q_slot)
            km = m[r0:r1]
            for name, (sfx, dt) in k.out_specs.items():
                if name not in res:
                    continue
                part = res[name].to(dt).reshape(nb, 9, *sfx)
                acc = torch.zeros((nb, *sfx), dtype=dt, device=dev)
                for j in range(9):
                    acc = acc + part[:, j]
                outs[k.name][name][r0:r1] = torch.where(
                    km.reshape(nb, *(1,) * len(sfx)), acc,
                    torch.zeros((), dtype=dt, device=dev))
    return outs


def pair_radius_sq(radius: float) -> float:
    """The pair list's inclusive bound: ``float32(radius)`` squared in
    float32, as the reference forms it."""
    r = np.float32(radius)
    return float(r * r)


def build_pairlist(spec: GridSpec, grid: GridState, position: torch.Tensor,
                   alive: torch.Tensor, *, radius: float, max_pairs: int,
                   chunk: Optional[int] = None) -> PairList:
    """Distance-filter the streamed candidate runs into a packed PairList.

    The candidates are the streamed sweep's (the same 9 z-runs truncated
    at ``run_capacity``, self excluded); a candidate is kept when ‖Δpos‖²
    ≤ ``radius``² (inclusive; ‖Δpos‖² rounded as x² + y², then + z²) and
    the row is alive. Each row's kept candidates are packed in run-major,
    lane-minor order; entries past ``max_pairs`` are dropped and counted in
    ``count``/``demand`` (never silent). ``position``/``alive`` are the
    resident channels of the build.

    Over an ensemble's tables (L·M boxes, :func:`make_builder` with
    ``lanes``) each row lists candidates of its own lane only, as slot ids
    of the whole pool, and ``demand`` is (L,), each lane's largest count.

    On CUDA tensors the pair-list kernel builds it
    (``kernels/pairlist.build_list``), on CPU tensors
    :func:`build_pairlist_plain`.
    """
    if position.device.type == "cpu":
        return build_pairlist_plain(spec, grid, position, alive,
                                    radius=radius, max_pairs=max_pairs,
                                    chunk=chunk)
    idx, run_off, count, demand = pairlist_kernel.build_list(
        position, alive, grid.origin, grid.box_size, grid.starts,
        grid.counts, spec.dims, spec.run_capacity, pair_radius_sq(radius),
        max_pairs, lanes=grid.starts.shape[0] // spec.table_size)
    return PairList(idx=idx, run_off=run_off, count=count, demand=demand)


def build_pairlist_plain(spec: GridSpec, grid: GridState,
                         position: torch.Tensor, alive: torch.Tensor, *,
                         radius: float, max_pairs: int,
                         chunk: Optional[int] = None) -> PairList:
    """:func:`build_pairlist` in plain PyTorch, on any device: every row,
    in chunks the host counts (as the streamed sweep), each packing its
    kept candidates with one scatter."""
    c = position.shape[0]
    dev = position.device
    p = max_pairs
    r_cap = spec.run_capacity
    r2 = pair_radius_sq(radius)
    _, step = _row_step(spec, c, chunk, r_cap)
    _, rows_of = _stream_candidates(spec, grid, position)
    idx_t = torch.zeros((c, p), dtype=torch.int32, device=dev)
    off_t = torch.zeros((c, 10), dtype=torch.int32, device=dev)
    cnt_t = torch.zeros((c,), dtype=torch.int32, device=dev)
    for r0 in range(0, c, step):
        r1 = min(r0 + step, c)
        nb = r1 - r0
        gather, valid = rows_of(r0, r1)
        slot = gather(torch.arange(c, dtype=torch.int32, device=dev))
        d = gather(position) - position[r0:r1, None].expand(
            nb, 9, 3).reshape(nb * 9, 1, 3)
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
            + d[..., 2] * d[..., 2]
        keep = (valid & (d2 <= r2)).reshape(nb, 9 * r_cap)
        keep &= alive[r0:r1, None]
        inc = torch.cumsum(keep, 1, dtype=torch.int32)
        # packed position inc - 1; dropped and overflowing lanes park in
        # column p, which is cut off
        dst = torch.where(keep & (inc <= p), inc - 1,
                          torch.full_like(inc, p)).to(torch.int64)
        buf = torch.zeros((nb, p + 1), dtype=torch.int32, device=dev)
        buf.scatter_(1, dst, slot.reshape(nb, 9 * r_cap))
        idx_t[r0:r1] = buf[:, :p]
        off_t[r0:r1, 1:] = inc.reshape(nb, 9, r_cap)[:, :, -1].clamp(max=p)
        cnt_t[r0:r1] = inc[:, -1]
    n_lanes = grid.starts.shape[0] // spec.table_size
    demand = (cnt_t.reshape(n_lanes, -1).amax(1) if n_lanes > 1
              else cnt_t.max() if c else cnt_t.sum(dtype=torch.int32))
    return PairList(idx=idx_t, run_off=off_t, count=cnt_t, demand=demand)


def resident_apply(spec: GridSpec, grid: GridState,
                   channels: Dict[str, torch.Tensor],
                   query_mask: torch.Tensor, pair_fn: Callable,
                   out_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                   chunk: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Run-streaming neighbor apply over the resident grid-ordered pool.

    ``channels`` must be in grid-key order (sorted position == slot id).
    ``pair_fn`` sees every channel on both sides; its outputs are summed
    over the 9 z-runs (at most ``run_capacity`` candidates each, self
    excluded) and written for ``query_mask`` rows, zeros elsewhere.
    """
    k = PairKernel("apply", pair_fn, out_specs, tuple(channels))
    with record_function("grid/sweep"):
        return _stream(spec, channels, channels, [k], [query_mask], chunk,
                       _stream_candidates(spec, grid,
                                          channels["position"]))["apply"]


def resident_apply_fused(spec: GridSpec, grid: GridState,
                         channels: Dict[str, torch.Tensor],
                         kernels: Sequence[PairKernel],
                         default_mask: torch.Tensor,
                         chunk: Optional[int] = None,
                         pairs: Optional[PairList] = None
                         ) -> Dict[str, Dict[str, torch.Tensor]]:
    """Multi-kernel :func:`resident_apply`: one candidate stream for every
    registered :class:`PairKernel`, pruned to the union of their declared
    footprints. Each kernel's outputs equal, bit for bit, those of its own
    :func:`resident_apply` sweep, and are zero outside its own mask.

    With ``pairs`` (a :class:`PairList` of this pool) the candidates are the
    list's: each row's stored entries are gathered once at width P and
    every kernel is evaluated once per run segment ``[run_off[j],
    run_off[j+1])``, the runs summed in the streamed order. The list keeps
    the streamed order and drops only candidates that add exact zeros, so
    with skin 0 and a list built this step integer outputs equal the
    streamed sweep's; floats may differ in the last bits, as the
    reference's two modes do (their lane sums group differently).

    Raises ``ValueError`` on duplicate kernel names or a list of another
    pool's size and ``KeyError`` when a footprint names a channel the pool
    lacks or a kernel reads a channel it did not declare.
    """
    if not kernels:
        return {}
    names = [k.name for k in kernels]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate PairKernel names: {names} — give each "
                         f"registered kernel (behavior) a unique name")
    reads = fused_reads(kernels)
    missing = [ch for ch in reads if ch not in channels]
    if missing:
        raise KeyError(f"PairKernel footprint names channels not in the "
                       f"pool: {missing} (have {sorted(channels)})")
    c = channels["position"].shape[0]
    if pairs is not None and (pairs.idx.dim() != 2
                              or pairs.idx.shape[0] != c
                              or pairs.run_off.shape != (c, 10)):
        raise ValueError(f"pairs must list the {c} rows of the pool, got "
                         f"idx {tuple(pairs.idx.shape)}, run_off "
                         f"{tuple(pairs.run_off.shape)}")
    gather_ch = {ch: channels[ch] for ch in reads}       # the pruned stream
    q_src = dict(gather_ch)
    q_src.setdefault("position", channels["position"])    # its row count
    masks = [k.query_mask if k.query_mask is not None else default_mask
             for k in kernels]
    candidates = (_pair_candidates(pairs) if pairs is not None else
                  _stream_candidates(spec, grid, channels["position"]))
    with record_function("grid/sweep"):
        return _stream(spec, q_src, gather_ch, kernels, masks, chunk,
                       candidates)


# ---------------------------------------------------------------------------
# Non-resident queries: the sorted build's compat path and the Fig-9/Fig-11
# baselines (scatter table, spatial hash, brute force)
# ---------------------------------------------------------------------------

def neighbor_runs(spec: GridSpec, grid: GridState, query_pos: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates as key-sorted positions, the 9 runs materialized:
    ``(pos, valid)``, each (Q, 9·R), run-major and lane-minor."""
    r_cap = spec.run_capacity
    s, n = run_bounds(spec, grid, query_pos)
    lane = torch.arange(r_cap, dtype=torch.int32, device=query_pos.device)
    pos = s[..., None] + lane                                  # (Q, 9, R)
    valid = lane < n.clamp(max=r_cap)[..., None]
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    q = query_pos.shape[0]
    return pos.reshape(q, 9 * r_cap), valid.reshape(q, 9 * r_cap)


def neighbor_candidates(spec: GridSpec, grid: GridState,
                        query_pos: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`neighbor_runs` as slot ids: ``(ids, valid)``, (Q, 9·R)."""
    pos, valid = neighbor_runs(spec, grid, query_pos)
    return grid.order[pos.to(torch.int64)], valid


def sort_channels(grid: GridState, channels: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The channels in grid-key order (the sorted build's query copy)."""
    o = grid.order.to(torch.int64)
    return {k: v.index_select(0, o) for k, v in channels.items()}


def _query_rows(c: int, chunk: int, width: Optional[int]) -> int:
    """Query rows per chunk of :func:`phased_chunk_apply`: whole
    ``chunk``-row blocks within ``SWEEP_LANES`` candidate lanes of
    ``width``, or fewer rows where one block alone exceeds them (brute
    force: the candidate axis, which fixes each row's sum, stays whole)."""
    b = max(1, min(chunk, c))
    if width is None:
        return b
    fit = max(1, SWEEP_LANES // max(width, 1))
    return b * (fit // b) if fit >= b else fit


def phased_chunk_apply(channels: Dict[str, torch.Tensor],
                       gather_channels: Dict[str, torch.Tensor],
                       query_idx: torch.Tensor, n_query,
                       phase_fn: Callable, n_phases: int, pair_fn: Callable,
                       out_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                       chunk: int, width: Optional[int] = None
                       ) -> Dict[str, torch.Tensor]:
    """Apply ``pair_fn`` to each query row against ``n_phases`` candidate
    slabs, the slabs' results added in phase order.

    ``query_idx`` (C,) lists the query slots (``compaction.
    active_index_list``), the first ``n_query`` of them real;
    ``phase_fn(q_pos, q_slot, j) -> (idx, valid)`` gives phase ``j``'s
    candidates as rows of ``gather_channels``, ``width`` their count per
    row (it sizes the chunks). ``pair_fn`` is the resident sweep's: ``(q,
    nbr, valid, q_slot) -> dict``; outputs are written to the query slots,
    zeros elsewhere.

    The reference loops over ⌈n_query / chunk⌉ chunks, a trip count on the
    device. On the card every chunk of the capacity is evaluated with the
    lanes past ``n_query`` masked, so nothing is read back; on the CPU,
    where reading ``n_query`` waits for no device, the chunks wholly past
    it are skipped. A row's output is a function of the channels alone, so
    neither the grouping nor the skip changes a value. The
    reference adds each chunk's results into the output at the query slots
    (masked lanes add zeros); the slots of real lanes are distinct, so the
    port writes each real lane to its own slot once and parks the masked
    lanes in a row that is cut off — no write order or atomic decides a
    value.
    """
    c = channels["position"].shape[0]
    dev = channels["position"].device
    step = _query_rows(c, chunk, width)
    qi = query_idx.to(torch.int64)
    lane_ok = torch.arange(c, device=dev) < n_query
    outs = {name: torch.zeros((c + 1, *sfx), dtype=dt, device=dev)
            for name, (sfx, dt) in out_specs.items()}
    end = min(c, int(n_query)) if dev.type == "cpu" else c
    for r0 in range(0, end, step):
        q_slot = qi[r0:min(r0 + step, end)]
        ok = lane_ok[r0:min(r0 + step, end)]
        b = q_slot.shape[0]
        q = _OnRead(channels, lambda v, q_slot=q_slot: v.index_select(
            0, q_slot))
        q_slot32 = q_slot.to(torch.int32)
        acc = {name: torch.zeros((b, *sfx), dtype=dt, device=dev)
               for name, (sfx, dt) in out_specs.items()}
        for j in range(n_phases):
            idx, valid = phase_fn(q["position"], q_slot32, j)
            valid = valid & ok[:, None]
            flat = idx.reshape(-1).to(torch.int64)
            shape = tuple(idx.shape)
            nbr = _OnRead(gather_channels,
                          lambda v, flat=flat, shape=shape: v.index_select(
                              0, flat).reshape(*shape, *v.shape[1:]))
            res = pair_fn(q, nbr, valid, q_slot32)
            acc = {name: acc[name] + res[name].to(acc[name].dtype)
                   if name in res else acc[name] for name in acc}
        dst = torch.where(ok, q_slot, torch.full_like(q_slot, c))
        for name, val in acc.items():
            outs[name].index_copy_(0, dst, val)
    return {name: v[:c] for name, v in outs.items()}


def chunk_apply(channels: Dict[str, torch.Tensor],
                gather_channels: Dict[str, torch.Tensor],
                query_idx: torch.Tensor, n_query, cand_fn: Callable,
                pair_fn: Callable,
                out_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                chunk: int, width: Optional[int] = None
                ) -> Dict[str, torch.Tensor]:
    """:func:`phased_chunk_apply` with one slab:
    ``cand_fn(q_pos, q_slot) -> (idx, valid)`` of ``width`` per row."""
    return phased_chunk_apply(channels, gather_channels, query_idx, n_query,
                              lambda q_pos, q_slot, j: cand_fn(q_pos, q_slot),
                              1, pair_fn, out_specs, chunk, width)


def neighbor_apply(spec: GridSpec, grid: GridState,
                   channels: Dict[str, torch.Tensor],
                   query_idx: torch.Tensor, n_query, pair_fn: Callable,
                   out_specs: Dict[str, Tuple[Tuple[int, ...], Any]]
                   ) -> Dict[str, torch.Tensor]:
    """``pair_fn`` over each query's 9 stencil runs of a sorted build
    (slot order kept): candidates are gathered from a key-sorted copy of
    the channels, self excluded, in chunks of ``spec.query_chunk``."""
    sorted_ch = sort_channels(grid, channels)

    def cand_fn(q_pos, q_slot):
        pos, valid = neighbor_runs(spec, grid, q_pos)
        valid = valid & (pos != grid.rank[q_slot.to(torch.int64)][:, None])
        return pos, valid

    return chunk_apply(channels, sorted_ch, query_idx, n_query, cand_fn,
                       pair_fn, out_specs, spec.query_chunk,
                       9 * spec.run_capacity)


def brute_force_apply(channels: Dict[str, torch.Tensor], alive: torch.Tensor,
                      pair_fn: Callable,
                      out_specs: Dict[str, Tuple[Tuple[int, ...], Any]],
                      chunk: int = 512) -> Dict[str, torch.Tensor]:
    """Exact O(N²) apply (the oracle): every live agent but the row itself
    is a candidate; ``pair_fn``'s own distance test does the rest."""
    c = channels["position"].shape[0]
    ids = torch.arange(c, dtype=torch.int32, device=alive.device)

    def cand_fn(q_pos, q_slot):
        b = q_slot.shape[0]
        idx = ids[None].expand(b, c)
        return idx, alive[None] & (idx != q_slot[:, None])

    return chunk_apply(channels, channels, ids, c, cand_fn, pair_fn,
                       out_specs, min(chunk, c), c)


def _stencil_cells(cell: torch.Tensor, dims: Tuple[int, int, int],
                   j: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The stencil cells of each query cell (Q, 3): all 27 in ``_OFFSETS``
    order, or the ``j``-th alone. Returns ``(clipped (Q, O, 3) int32,
    inside (Q, O) bool)``; the offsets are made on the device (a table
    copied from the host would wait for the card on every call)."""
    if j is None:
        o = torch.arange(27, dtype=torch.int32, device=cell.device)
        off = (torch.div(o, 9, rounding_mode="floor") - 1,
               torch.div(o, 3, rounding_mode="floor") % 3 - 1, o % 3 - 1)
    else:
        off = tuple(int(v) for v in _OFFSETS[j])
    nc, inside = [], None
    for a in range(3):
        v = cell[:, a, None] + off[a]
        ok = (v >= 0) & (v < dims[a])
        inside = ok if inside is None else inside & ok
        nc.append(v.clamp(0, dims[a] - 1))
    return torch.stack(nc, -1), inside


@dataclasses.dataclass
class ScatterGridState:
    """The 'standard implementation' grid: a dense (boxes × max_per_box)
    member table, rebuilt every step.

    table:  (M, K) int32 slot ids, -1 empty; a box holding more than K
            agents keeps its first K-1 in column order and its last in
            column K-1 (what the reference's scatter leaves)
    counts: (M,) int32 live agents per box

    An ensemble's build holds L such tables, lane ``l``'s rows at
    ``[l·M, (l+1)·M)`` with slot ids of the whole pool: ``table`` (L·M, K),
    ``counts`` (L·M,).
    """
    origin: torch.Tensor
    box_size: morton.BoxSize
    table: torch.Tensor
    counts: torch.Tensor


def _build_scatter_impl(spec: GridSpec, pool: AgentPool, origin: torch.Tensor,
                        box_size: morton.BoxSize, sort_impl: str = "auto",
                        lanes: Optional[Lanes] = None) -> ScatterGridState:
    """The member table, built by construction.

    The reference writes ``table[key, min(rank_in_box, K-1)] = slot`` in
    sorted order with one scatter: in a box of more than K agents every
    agent from the K-th on writes column K-1 and, on XLA, the last write
    wins. A CUDA scatter picks an unspecified winner among duplicates, so
    here each written cell has one writer: the columns below K-1 their own
    agent, column K-1 the box's last agent in sorted order. Every other
    write, and every dead agent, lands in row L·M, which is cut off.

    With ``lanes`` each lane's keys are sorted on their own and its boxes
    written to its own rows ``lane·M + key``, one writer per cell as above.
    """
    ln = lanes or Lanes(1, pool.capacity)
    m, k = spec.table_size, spec.max_per_box
    dev = pool.position.device
    keys = morton.linear_keys(pool.position, origin, box_size, spec.dims)
    keys = torch.where(pool.alive, keys, torch.full_like(keys, m))
    sk, order = lane_sort(keys, m, sort_impl, lanes)         # (L, C)
    c = sk.shape[1]
    first = torch.searchsorted(sk, sk, side="left")
    in_box = torch.arange(c, device=dev) - first
    last = torch.ones_like(sk, dtype=torch.bool)
    last[:, :-1] = sk[:, 1:] != sk[:, :-1]
    keep = ((in_box < k - 1) | last) & (sk < m)
    lane_row = torch.arange(ln.n, dtype=sk.dtype, device=dev)[:, None] * m
    row = torch.where(keep, sk + lane_row, torch.full_like(sk, ln.n * m))
    col = in_box.clamp(max=k - 1)
    table = torch.full((ln.n * m + 1, k), -1, dtype=torch.int32, device=dev)
    table.index_put_((row.reshape(-1), col.reshape(-1)), order)
    box_ids = torch.arange(m + 1, dtype=sk.dtype, device=dev)
    bounds = torch.searchsorted(sk, box_ids.expand(ln.n, m + 1).contiguous(),
                                side="left")
    counts = (bounds[:, 1:] - bounds[:, :-1]).to(torch.int32).reshape(-1)
    return ScatterGridState(origin=origin, box_size=box_size,
                            table=table[:ln.n * m], counts=counts)


def scatter_grid_candidates(spec: GridSpec, g: ScatterGridState,
                            query_pos: torch.Tensor,
                            lane: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's 27 stencil boxes' table rows: ``(ids, valid)``, (Q,
    27·K) in ``_OFFSETS`` order, -1 entries and boxes outside the grid
    invalid. ``lane`` (Q,): each query's lane in an ensemble's build, whose
    tables it reads."""
    k = spec.max_per_box
    cell = morton.cell_of(query_pos, g.origin, g.box_size, spec.dims)
    ncell, inside = _stencil_cells(cell, spec.dims)
    codes = morton.linear_encode3(ncell[..., 0], ncell[..., 1],
                                  ncell[..., 2], spec.dims)
    if lane is not None:
        codes = codes + lane.to(codes.dtype)[:, None] * spec.table_size
    members = g.table[codes]                                  # (Q, 27, K)
    valid = (members >= 0) & inside[..., None]
    q = query_pos.shape[0]
    return members.clamp(min=0).reshape(q, 27 * k), valid.reshape(q, 27 * k)


@dataclasses.dataclass
class HashGridState:
    """Spatial hash over a fixed bucket table.

    keys:      (C,) int64 each slot's bucket (dead → n_buckets)
    cell_keys: (C,) int64 each slot's unhashed linear cell (dead →
               DEAD_KEY): a bucket mixes every cell that hashes to it, so
               a probe keeps only the probed cell's agents — else two
               stencil cells of one bucket would count its agents twice
    order:     (C,) int32 slots sorted by bucket
    starts, counts: (n_buckets,) per bucket, in ``order``
    max_bucket_count: () the fullest bucket
    n_buckets: buckets of one lane

    An ensemble's build hashes each lane into buckets of its own: ``order``
    lists each lane's slots (ids of the whole pool) lane by lane,
    ``starts``/``counts`` are (L·n_buckets,), lane ``l``'s at
    ``[l·n_buckets, (l+1)·n_buckets)``, and ``max_bucket_count`` is (L,);
    ``keys`` and ``cell_keys`` stay each lane's own.
    """
    origin: torch.Tensor
    box_size: morton.BoxSize
    keys: torch.Tensor
    cell_keys: torch.Tensor
    order: torch.Tensor
    starts: torch.Tensor
    counts: torch.Tensor
    max_bucket_count: torch.Tensor
    n_buckets: int


def _hash_cell(cell: torch.Tensor, n_buckets: int) -> torch.Tensor:
    """The 3-prime spatial hash (Teschner et al.) of cells, in uint32
    arithmetic held in int64: each product wraps at 2^32 before the XOR."""
    c = cell.to(torch.int64) & morton.DEAD_KEY
    h = ((c[..., 0] * 73856093) & morton.DEAD_KEY) \
        ^ ((c[..., 1] * 19349663) & morton.DEAD_KEY) \
        ^ ((c[..., 2] * 83492791) & morton.DEAD_KEY)
    return h % n_buckets


def _build_hash_impl(spec: GridSpec, pool: AgentPool, origin: torch.Tensor,
                     box_size: morton.BoxSize, n_buckets: int = 1 << 14,
                     sort_impl: str = "auto",
                     lanes: Optional[Lanes] = None) -> HashGridState:
    cell = morton.cell_of(pool.position, origin, box_size, spec.dims)
    keys = _hash_cell(cell, n_buckets)
    keys = torch.where(pool.alive, keys, torch.full_like(keys, n_buckets))
    lin = morton.linear_encode3(cell[..., 0], cell[..., 1], cell[..., 2],
                                spec.dims)
    cell_keys = torch.where(pool.alive, lin,
                            torch.full_like(lin, morton.DEAD_KEY))
    ln = lanes or Lanes(1, pool.capacity)
    sk, order = lane_sort(keys, n_buckets, sort_impl, lanes)  # (L, C)
    ids = torch.arange(n_buckets, dtype=sk.dtype, device=sk.device).expand(
        ln.n, n_buckets).contiguous()
    lo = torch.searchsorted(sk, ids, side="left")
    counts = (torch.searchsorted(sk, ids, side="right") - lo).to(
        table_count_dtype(ln.capacity)).reshape(-1)
    # each lane's positions in ``order`` follow the lanes before it
    starts = (lo + ln.offsets(sk.device)[:, None]).to(torch.int32)
    return HashGridState(origin=origin, box_size=box_size, keys=keys,
                         cell_keys=cell_keys, order=order,
                         starts=starts.reshape(-1), counts=counts,
                         max_bucket_count=ln.max(counts),
                         n_buckets=n_buckets)


def hash_grid_probe(spec: GridSpec, g: HashGridState, query_pos: torch.Tensor,
                    j: int, k_mult: int = HASH_K_MULT,
                    lane: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The candidates of stencil box ``j`` alone (one phase of
    :func:`phased_chunk_apply`): its bucket's first ``k_mult·max_per_box``
    agents, kept where their own cell is the probed one. ``(ids, valid)``,
    (Q, k_mult·max_per_box). ``lane`` (Q,): each query's lane in an
    ensemble's build, whose buckets it probes (so it reaches only slots of
    its own lane, and the cell test stays lane-local)."""
    k = spec.max_per_box * k_mult
    cell = morton.cell_of(query_pos, g.origin, g.box_size, spec.dims)
    ncell, inside = _stencil_cells(cell, spec.dims, j)
    ncell, inside = ncell[:, 0], inside[:, 0]
    h = _hash_cell(ncell, g.n_buckets)
    if lane is not None:
        h = h + lane.to(h.dtype) * g.n_buckets
    k_true = morton.linear_encode3(ncell[..., 0], ncell[..., 1],
                                   ncell[..., 2], spec.dims)
    s = g.starts[h]
    n = torch.where(inside, g.counts[h].to(torch.int32),
                    torch.zeros_like(s))
    lane = torch.arange(k, dtype=torch.int32, device=query_pos.device)
    pos = s[:, None] + lane
    valid = lane < n.clamp(max=k)[:, None]
    pos = torch.where(valid, pos, torch.zeros_like(pos))
    ids = g.order[pos.to(torch.int64)]
    valid = valid & (g.cell_keys[ids.to(torch.int64)] == k_true[:, None])
    return ids, valid


def hash_grid_candidates(spec: GridSpec, g: HashGridState,
                         query_pos: torch.Tensor, k_mult: int = HASH_K_MULT
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """All 27 probes of :func:`hash_grid_probe` at once, (Q, 27·k): the
    Fig-11 'hash wide' baseline."""
    probes = [hash_grid_probe(spec, g, query_pos, j, k_mult)
              for j in range(27)]
    return (torch.cat([ids for ids, _ in probes], 1),
            torch.cat([valid for _, valid in probes], 1))
