"""Uniform-grid build, resident layout (port of the resident half of
``repro.core.grid``).

One stable sort of the linear box keys permutes the pool itself into
grid-key order: agents of a box are adjacent, boxes are adjacent along z,
and dead slots (``DEAD_KEY``) sink to the tail — grid build, memory-layout
sort and death compaction in one permutation. The per-box ``(starts,
counts)`` tables then index the permuted pool directly.

The sorted / scatter / hash builds and the streamed fused sweep are later
slices (ROADMAP.md Queue 1 items 6 and 12).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import compaction, morton
from .agents import AgentPool

# sort realizations of the reference; each yields the unique stable
# permutation, which the port computes with one stable sort
SORT_IMPLS = ("auto", "host", "xla", "argsort")
BUILD_METHODS = ("resident", "sorted", "scatter", "hash")


@dataclasses.dataclass(frozen=True)
class RebuildPolicy:
    """When the grid build runs. Only ``every_step`` is ported; ``every_k``
    is ROADMAP.md Queue 1 item 11. Validation as in the reference."""
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
    """Verlet pair-list settings (the stage itself is ROADMAP.md Queue 1
    item 11). Validation as in the reference."""
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
    """Per-iteration neighbor index over the resident pool."""
    origin: torch.Tensor          # (3,) f32
    box_size: float               # box edge
    keys: torch.Tensor            # (C,) int64 holding uint32, sorted
    order: torch.Tensor           # (C,) int32 — identity (resident)
    rank: torch.Tensor            # (C,) int32 — identity (resident)
    starts: torch.Tensor          # (M,) int32 — first slot of each box
    counts: torch.Tensor          # (M,) table_count_dtype(C)
    max_count: torch.Tensor       # () counts' dtype — fullest box
    max_run_count: torch.Tensor   # () counts' dtype — fullest 3-box z-run


class BuildResult(NamedTuple):
    """pool (permuted), grid, order (old→new gather permutation applied),
    overflow (() int32 agents beyond run_capacity), demand (() int32)."""
    pool: AgentPool
    grid: GridState
    order: torch.Tensor
    overflow: torch.Tensor
    demand: torch.Tensor


def table_count_dtype(capacity: int) -> torch.dtype:
    """int16 while the pool fits int16, else int32 (as the reference)."""
    return torch.int16 if capacity < 2 ** 15 else torch.int32


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


def _build_resident_impl(spec: GridSpec, pool: AgentPool,
                         origin: torch.Tensor, box_size: float,
                         sort_impl: str = "auto"
                         ) -> Tuple[AgentPool, GridState, torch.Tensor]:
    """Permute the pool into grid-key order and index it in place.

    Returns ``(pool, grid, order)``: the reordered pool, its tables (order
    and rank the identity), and the applied gather permutation.
    """
    keys = morton.grid_sort_keys(pool.position, pool.alive, origin, box_size,
                                 spec.dims)
    order = counting_sort_order(keys, spec.table_size, impl=sort_impl)
    pool = compaction.apply_permutation(pool, order)
    sorted_keys = keys.index_select(0, order.to(torch.int64))
    starts, counts, max_count, max_run = _index_tables(spec, sorted_keys)
    ident = torch.arange(order.shape[0], dtype=torch.int32,
                         device=order.device)
    grid = GridState(origin=origin, box_size=box_size, keys=sorted_keys,
                     order=ident, rank=ident, starts=starts, counts=counts,
                     max_count=max_count, max_run_count=max_run)
    return pool, grid, order


def make_builder(spec: GridSpec, *, method: str = "resident",
                 sort_impl: str = "auto"
                 ) -> Callable[[AgentPool, torch.Tensor, float], BuildResult]:
    """``build_fn(pool, origin, box_size) -> BuildResult``; only the
    resident method is ported."""
    if method not in BUILD_METHODS:
        raise ValueError(
            f"method must be one of {BUILD_METHODS}, got {method!r}")
    if sort_impl not in SORT_IMPLS:
        raise ValueError(
            f"sort_impl must be one of {SORT_IMPLS}, got {sort_impl!r}")
    if method != "resident":
        raise NotImplementedError(
            f"grid build method {method!r} is not ported yet (ROADMAP.md "
            f"Queue 1 item 12)")

    def build_fn(pool: AgentPool, origin: torch.Tensor, box_size: float
                 ) -> BuildResult:
        pool, grid, order = _build_resident_impl(spec, pool, origin,
                                                 box_size, sort_impl)
        demand = grid.max_run_count.to(torch.int32)
        return BuildResult(pool, grid, order,
                           torch.clamp(demand - spec.run_capacity, min=0),
                           demand)
    return build_fn
