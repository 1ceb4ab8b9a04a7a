"""Distributed ABM engine (port of ``repro.core.distributed``): quantile
x-slabs, ring halos, ring migration, sharded diffusion and the distributed
capacity ladder.

As in the reference, nothing here computes a force, a query or a behavior:
every slab runs the shared iteration core (``engine.make_iteration_core``)
over a pool of ``total_capacity`` rows, its owned slots followed by two
ghost bands. The wrapper only distributes:

* **Slabs.** Shard ``i`` owns the agents with x in ``[b_i, b_{i+1})``; the
  boundaries are population quantiles (the paper's §4.2 balancing), re-derived
  every ``rebalance_frequency`` steps.
* **Ring halos.** Every agent within the band width of a slab face is packed
  (every channel, behavior extras included) and shipped to the neighboring
  shard, where it joins the pool as a ghost row (``owned`` False): a gather
  source only.
* **Ring migration.** An owned agent whose x left its slab after the step is
  shipped one hop and appended on the other side through the birth-commit
  path, with every channel it carries.
* **Sharded diffusion.** The substance grid is split into x-slabs; each FTCS
  substep reads one-voxel face halos from the neighboring slabs.

**Shards as lanes, blocks of shards as ranks.** The reference runs one
``shard_map`` program over a device mesh, one shard a device. Here the
shards a process holds are the lanes of one lane-major pool on its device
(``core/lanes.py``): lane ``i`` is shard ``i``'s in-step pool, stepped
exactly as its own solo step, and the core's kernels (K1 and its column
map, the pair-list build and the pairs map, secretion) launch once a step
for all of them. Every move between shards goes through one object:
:class:`ShardAxis` when every shard is a lane of one device (``ppermute``
a shift with a zero fill, ``all_gather`` a reshape, ``psum_scatter`` a sum
over the shards and a slice), or :class:`~.transport.GroupShardAxis` over
a ``torch.distributed`` group, rank ``r`` of ``W`` holding the block of
shards ``[r·S/W, (r+1)·S/W)`` (NCCL between cards, gloo between CPU
processes). The step is the same code either way, and a rank's state is
bit for bit its block of the one-device run's.

The state keeps the reference's layout for the shards it holds: every
channel one ``(n_local·local_capacity, ...)`` tensor, local shard ``i``'s
agents in ``[i·C, i·C + n_i)`` (``n_local = n_shards`` on one device).
:func:`gather_state` assembles the whole run on every rank, or on one
(a checkpoint's writer). At init every rank stages the whole input and
keeps a copy of its block; the step holds only the rank's shards, but for
the rebalance's gather of every row's x and liveness. The step reads
nothing from the card on the host but, under every_k, the rank's
(n_local,) rebuild flags in one transfer; the rebalance branch is taken on
``DistState.iteration``, which lives on the host, so every rank takes it
on the same step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import compaction, diffusion as diff_mod, grid as grid_mod, rand
from .agents import pool_from_channels
from .behaviors import Behavior
from .engine import (CapacityExhausted, EngineConfig, LadderConfig,
                     LadderDriverBase, make_iteration_core, next_rung,
                     stage_pool)
from .lanes import Lanes, row_cumsum
from .stats import StepStats
from ..device import DeviceLike, resolve_device

OWNED = "owned"          # bool extra channel: local agent (True) vs ghost


class SlabCapacityError(ValueError):
    """An initial slab population exceeds local_capacity (the init-time
    never-silent check). Typed so the distributed capacity ladder can catch
    exactly this condition and grow."""


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Static distributed-run configuration.

    local_capacity:      slots per shard (live agents per slab must fit)
    halo_capacity:       ghost rows shipped per face per step
    migrate_capacity:    migrating agents shipped per face per step
    rebalance_frequency: re-derive the quantile slab boundaries every this
                         many steps (0: keep the boundaries of init)
    """
    engine: EngineConfig
    n_shards: int
    local_capacity: int
    halo_capacity: int = 1024
    migrate_capacity: int = 256
    rebalance_frequency: int = 0

    @property
    def halo_width(self) -> float:
        """Ghost band thickness: r, or 2·r under detect_static, plus the
        rebuild policy's cell slack and the pair-list skin, so the band
        covers every cross-shard candidate the step can query."""
        skin = (self.engine.pairlist.skin
                if self.engine.pairlist is not None else 0.0)
        return self.engine.interaction_radius * (
            2.0 if self.engine.detect_static else 1.0
        ) + self.engine.rebuild.cell_slack + skin

    @property
    def total_capacity(self) -> int:
        """A shard's in-step pool: owned slots + two ghost bands."""
        return self.local_capacity + 2 * self.halo_capacity


@dataclasses.dataclass
class DistState:
    """Sharded simulation state, the reference's leaves in its global
    layout, of the ``n_local`` shards a rank holds (every shard on one
    device: ``n_local = n_shards``).

    channels:   every pool channel as one (n_local·local_capacity, ...)
                tensor, local shard i's agents in [i·C, i·C + n_i)
    conc:       the local shards' x-slabs of the substance grid (the
                whole (X, Y, Z) grid on one device), shard i's slab its
                x-rows [i·X/n, (i+1)·X/n); (n_local, 1, 1) when unused
    rng:        (n_local, 2) int64 holding uint32 keys, one per shard
    boundaries: (n_shards + 1,) float32 slab edges, on every rank
    iteration:  () int32 ON THE HOST: the step branches on it (rebalance)
                without a read from the card
    stats:      StepStats, (n_local,) per field
    env:        every_k: one cache per local shard in the lane-major
                layout of :class:`~.grid.RebuildState` (lanes of
                total_capacity); None under every_step
    """
    channels: Dict[str, torch.Tensor]
    conc: torch.Tensor
    rng: torch.Tensor
    boundaries: torch.Tensor
    iteration: torch.Tensor
    stats: StepStats
    env: Optional[grid_mod.RebuildState] = None


class ShardAxis:
    """The moves along the shard axis of the stacked (n_shards, ...)
    tensors: the reference's collectives over its mesh axis. Nothing else
    in this module moves data between shards. Every shard is local here;
    :class:`~.transport.GroupShardAxis` makes the same moves over a
    process group, each rank holding a block of the shards.

    A move takes one tensor or a dict of tensors (moved alike)."""

    def __init__(self, n_shards: int):
        self.n = self.n_local = n_shards
        self.first = 0
        self.shard_ids = torch.arange(n_shards)

    @staticmethod
    def _each(fn: Callable, x):
        return _tree(fn, x) if isinstance(x, dict) else fn(x)

    def shift_forward(self, x):
        """Shard i receives shard i-1's rows; shard 0 receives zeros in
        every element (``ppermute`` over i → i+1)."""
        return self._each(
            lambda t: torch.cat([torch.zeros_like(t[:1]), t[:-1]]), x)

    def shift_backward(self, x):
        """Shard i receives shard i+1's rows; the last receives zeros
        (``ppermute`` over i+1 → i)."""
        return self._each(
            lambda t: torch.cat([t[1:], torch.zeros_like(t[:1])]), x)

    def gather(self, x, dst: Optional[int] = None):
        """(n_shards, k, ...) → (n_shards·k, ...): every shard's rows in
        shard order (a tiled ``all_gather``; ``dst`` is the one rank's)."""
        return self._each(
            lambda t: t.reshape(self.n * t.shape[1], *t.shape[2:]), x)

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(n_shards, n_shards·k, ...) → (n_shards, k, ...): the sum over
        the shards, added in shard order, each shard keeping its own k rows
        (a tiled ``psum_scatter``)."""
        acc = x[0]
        for i in range(1, self.n):
            acc = acc + x[i]
        return acc.reshape(self.n, -1, *acc.shape[1:])

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """A global tensor's rows of the local shards: all of them."""
        return x


def rank_device(device: DeviceLike, group) -> torch.device:
    """``resolve_device``, but with a group and no device the rank's
    current CUDA card (raising without one)."""
    dev = resolve_device(device)
    if group is not None and device is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_axis(n_shards: int, group, device: torch.device):
    """The moves for ``n_shards`` shards: :class:`ShardAxis` on one device
    (``group`` None), else a :class:`~.transport.GroupShardAxis` over the
    group, whose backend must suit ``device`` (gloo on the CPU, NCCL on
    the cards)."""
    if group is None:
        return ShardAxis(n_shards)
    import torch.distributed as tdist
    from .transport import GroupShardAxis
    want = "gloo" if device.type == "cpu" else "nccl"
    backend = tdist.get_backend(group)
    if backend != want:
        raise ValueError(f"a {device.type} run needs a {want} group, got "
                         f"{backend}")
    return GroupShardAxis(n_shards, group, device)


def _tree(fn: Callable, d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: fn(v) for k, v in d.items()}


def quantile_boundaries(x: torch.Tensor, alive: torch.Tensor, n_shards: int,
                        lo: float, hi: float) -> torch.Tensor:
    """Equal-population slab boundaries (paper §4.2 balancing).

    With no live agents the inner boundaries collapse to ``hi``; a skewed
    population (a single cluster) gives clamped, non-decreasing
    boundaries: possibly empty slabs, never an inverted or out-of-domain
    one.
    """
    big = torch.where(alive, x, torch.full_like(x, float("inf")))
    xs = torch.sort(big).values
    n = alive.sum(dtype=torch.int64)
    qs = torch.div(torch.arange(1, n_shards, dtype=torch.int64,
                                device=x.device) * n, n_shards,
                   rounding_mode="floor")
    inner = xs[qs.clamp(0, x.shape[0] - 1)]
    inner = inner.clamp(lo, hi)                     # n == 0 → inf → hi
    if n_shards > 1:
        inner = torch.cummax(inner, 0).values      # monotone under skew
    edge = lambda v: torch.full((1,), v, dtype=inner.dtype,  # noqa: E731
                                device=x.device)
    return torch.cat([edge(lo), inner, edge(hi)])


def _shard_of(x: torch.Tensor, boundaries: torch.Tensor,
              n_shards: int) -> torch.Tensor:
    return torch.searchsorted(boundaries[1:-1].contiguous(), x.contiguous(),
                              right=True).clamp(0, n_shards - 1)


def partition_global(pool_channels: Dict[str, torch.Tensor],
                     boundaries: torch.Tensor, dcfg: DistConfig
                     ) -> Dict[str, torch.Tensor]:
    """Scatter agents into per-shard slots.

    Returns channels of ``n_shards·local_capacity`` rows, shard i's agents
    (in input order) in ``[i·C, i·C + n_i)``, every other slot zero and
    dead. Live rows need not form a prefix (a restored checkpoint has dead
    gaps). Agents past a slab's ``local_capacity`` are dropped: size the
    capacity for the post-balance maximum (``init_state`` refuses instead).
    """
    x = pool_channels["position"][:, 0]
    alive = pool_channels["alive"]
    s, c = dcfg.n_shards, dcfg.local_capacity
    dev = x.device
    shard = _shard_of(x, boundaries, s)
    # rank within a shard by a stable sort on (shard, index); dead rows
    # sort to key n_shards
    order = torch.sort(torch.where(alive, shard, s), stable=True).indices
    sorted_shard = torch.where(alive[order], shard[order], s)
    first = torch.searchsorted(sorted_shard,
                               torch.arange(s, dtype=sorted_shard.dtype,
                                            device=dev))
    rank = torch.arange(x.shape[0], device=dev) - first[
        sorted_shard.clamp(0, s - 1)]
    ok = alive[order] & (rank < c)
    dst = torch.where(ok, sorted_shard * c + rank,
                      torch.full_like(rank, s * c))     # parked: dropped
    out = {}
    for k, v in pool_channels.items():
        buf = torch.zeros((s * c + 1, *v.shape[1:]), dtype=v.dtype,
                          device=dev)
        buf[dst] = v[order]
        out[k] = buf[:s * c]
    alive_out = torch.zeros(s * c + 1, dtype=torch.bool, device=dev)
    alive_out[dst] = ok
    out["alive"] = alive_out[:s * c]
    return out


def pack_channels(mask: torch.Tensor, channels: Dict[str, torch.Tensor],
                  cap: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Pack each shard's masked agents, in slot order, into ``cap`` rows.

    ``mask`` (n_shards, T) and channels (n_shards, T, ...) give buffers
    (n_shards, cap, ...) and the (n_shards,) int32 count that did not fit.
    The buffer layout is the pool's channel spec, dtypes kept; rows past a
    shard's count are zero, and the packed ``alive`` doubles as the row
    validity. The j-th packed row of a shard is its first slot whose
    running count of masked slots reaches j + 1 (one per-shard cumulative
    sum and a search, no scatter).
    """
    s, t = mask.shape
    dev = mask.device
    csum = row_cumsum(mask.to(torch.int32))
    n = csum[:, -1]
    want = torch.arange(1, cap + 1, dtype=torch.int32,
                        device=dev).expand(s, cap).contiguous()
    take = torch.searchsorted(csum, want).clamp(max=t - 1)
    ok = want <= n[:, None]
    flat = (take + torch.arange(s, device=dev)[:, None] * t).reshape(-1)
    buf = {}
    for k, v in channels.items():
        g = v.reshape(s * t, *v.shape[2:]).index_select(0, flat).reshape(
            s, cap, *v.shape[2:])
        keep = ok.reshape(s, cap, *(1,) * (g.dim() - 2))
        buf[k] = torch.where(keep, g, torch.zeros((), dtype=g.dtype,
                                                  device=dev))
    buf["alive"] = ok & buf["alive"]
    return buf, torch.clamp(n - cap, min=0)


class _ShardedDiffusionOps(diff_mod.DiffusionOps):
    """:class:`~.diffusion.DiffusionOps` over the x-slabs of the grid.

    ``conc`` is the whole (X, Y, Z) grid, shard i's slab its x-rows
    ``[i·X/n, (i+1)·X/n)``. ``step`` runs each slab's FTCS step with face
    halos from its neighbors and Neumann edges at the global faces
    (``diffusion.step_slab``: bit-identical per voxel to the full-grid
    step). Agents couple across slab lines because the quantile agent
    slabs need not align with the voxel slabs: every shard samples the
    gathered grid, and secretes into a zeroed full-size grid of its own;
    the grids are summed over the shards and each slab keeps its x-range.
    """

    def __init__(self, spec: diff_mod.DiffusionSpec, origin: torch.Tensor,
                 shards, lanes: Lanes):
        super().__init__(spec, origin)     # full-grid reads: lane offset 0
        self.shards = shards
        self.shard_lanes = lanes
        sid = shards.shard_ids.to(origin.device)      # global ids
        self.first = (sid == 0)[:, None, None]
        self.last = (sid == shards.n - 1)[:, None, None]

    def _slabs(self, conc: torch.Tensor) -> torch.Tensor:
        x, y, z = self.spec.dims
        return conc.reshape(self.shards.n_local, x // self.shards.n, y, z)

    def _gathered(self, conc: torch.Tensor) -> torch.Tensor:
        return self.shards.gather(self._slabs(conc))

    def step(self, conc: torch.Tensor, dt) -> torch.Tensor:
        slabs = self._slabs(conc)
        recv_l = self.shards.shift_forward(slabs[:, -1])
        recv_r = self.shards.shift_backward(slabs[:, 0])
        x_lo = torch.where(self.first, slabs[:, 0], recv_l)   # Neumann edge
        x_hi = torch.where(self.last, slabs[:, -1], recv_r)
        return diff_mod.step_slab(self.spec, slabs, dt, x_lo,
                                  x_hi).reshape(conc.shape)

    def sample(self, conc: torch.Tensor, position: torch.Tensor
               ) -> torch.Tensor:
        return diff_mod.sample(self.spec, self._gathered(conc), position,
                               self.origin)

    def gradient(self, conc: torch.Tensor, position: torch.Tensor
                 ) -> torch.Tensor:
        return diff_mod.gradient(self.spec, self._gathered(conc), position,
                                 self.origin)

    def add_sources(self, conc: torch.Tensor, position: torch.Tensor,
                    amount: torch.Tensor) -> torch.Tensor:
        # one secretion launch: local shard i's rows into grid i of the
        # stack, then every shard's grid summed in shard order
        g = torch.zeros((self.shards.n_local, *self.spec.dims),
                        dtype=torch.float32, device=conc.device)
        g = diff_mod.add_sources(self.spec, g, position, amount, self.origin,
                                 self.shard_lanes)
        return conc + self.shards.reduce_scatter(g).reshape(conc.shape)


def _pad_rows(v: torch.Tensor, rows: int) -> torch.Tensor:
    """(S, k, ...) → (S·rows, ...), each shard's k rows followed by zeros:
    a per-shard queue in the lane-aware birth-commit layout."""
    out = torch.zeros((v.shape[0], rows, *v.shape[2:]), dtype=v.dtype,
                      device=v.device)
    out[:, :v.shape[1]] = v
    return out.reshape(-1, *v.shape[2:])


def make_distributed_step(dcfg: DistConfig, behaviors: Sequence[Behavior]
                          = (), device: DeviceLike = None, shards=None
                          ) -> Callable[[DistState], DistState]:
    """The distributed step ``DistState → DistState`` over the local
    shards at once: every shard, unless ``shards`` is a
    :class:`~.transport.GroupShardAxis`, whose rank steps its block.

    Halo exchange (ghost rows appended to each shard's pool, owned False)
    → the shared iteration core over the local shards as lanes of
    ``total_capacity`` rows → the quantile rebalance on its iterations →
    ring migration through the birth-commit path → repack to
    ``local_capacity``. The step leaves its input state unchanged.
    """
    cfg = dcfg.engine
    c_local, t = dcfg.local_capacity, dcfg.total_capacity
    hcap, mcap = dcfg.halo_capacity, dcfg.migrate_capacity
    if not 0 < hcap <= c_local or not 0 < mcap <= c_local:
        raise ValueError(
            "halo/migrate capacity must be in (0, local_capacity]")
    if cfg.diffusion is not None and cfg.diffusion.dims[0] % dcfg.n_shards:
        raise ValueError(f"diffusion dims[0]={cfg.diffusion.dims[0]} must be "
                         f"divisible by n_shards={dcfg.n_shards} (x-slab "
                         f"sharding)")
    dev = resolve_device(device)
    x_lo_dom, x_hi_dom = float(cfg.domain_lo[0]), float(cfg.domain_hi[0])
    # the reference adds the band width as a float32 constant
    hw = float(np.float32(dcfg.halo_width))
    shards = shards or ShardAxis(dcfg.n_shards)
    s, lo = shards.n_local, shards.first           # the local block
    ln = Lanes(s, t)
    diff_ops = None
    if cfg.diffusion is not None:
        diff_ops = _ShardedDiffusionOps(
            cfg.diffusion, torch.tensor(cfg.domain_lo, dtype=torch.float32,
                                        device=dev), shards, ln)
    # each shard's in-step pool is one lane of total_capacity rows
    core = make_iteration_core(dataclasses.replace(cfg, capacity=t),
                               behaviors, dev, n_lanes=s,
                               owned_channel=OWNED, diff_ops=diff_ops)
    use_cache = cfg.rebuild.mode == "every_k"
    # global shard ids: a block that does not start at shard 0 has a left
    # neighbor
    sid = shards.shard_ids.to(dev)
    not_first, not_last = sid > 0, sid < dcfg.n_shards - 1
    owned_rows = torch.cat([torch.ones((s, c_local), dtype=torch.bool,
                                       device=dev),
                            torch.zeros((s, 2 * hcap), dtype=torch.bool,
                                        device=dev)], 1).reshape(-1)

    def per_shard(v: torch.Tensor, rows: int) -> torch.Tensor:
        return v.reshape(s, rows, *v.shape[1:])

    def lane_count(m: torch.Tensor) -> torch.Tensor:
        return m.sum(1, dtype=torch.int32)

    def slab_edges(bounds: torch.Tensor):
        """The local shards' lower and upper slab edges, (s, 1) each."""
        return bounds[lo:lo + s, None], bounds[lo + 1:lo + s + 1, None]

    def step(state: DistState) -> DistState:
        it = int(state.iteration)                 # a host tensor: no sync
        bounds = state.boundaries
        my_lo, my_hi = slab_edges(bounds)
        ch = {k: per_shard(v, c_local) for k, v in state.channels.items()}
        alive = ch["alive"]
        x = ch["position"][..., 0]

        # ---- halo exchange: boundary bands → the neighbors' ghost rows ----
        band_l, ovf_hl = pack_channels(alive & (x < my_lo + hw), ch, hcap)
        band_r, ovf_hr = pack_channels(alive & (x > my_hi - hw), ch, hcap)
        ghosts_l = shards.shift_forward(band_r)      # from shard i-1
        ghosts_r = shards.shift_backward(band_l)     # from shard i+1
        # an edge shard's outer band is never shipped: a pile-up against
        # the wall must not flag overflow
        ovf_hl = torch.where(not_first, ovf_hl, 0)
        ovf_hr = torch.where(not_last, ovf_hr, 0)
        # a one-hop ring is exact only while every interior slab is at
        # least one band wide (the first and last may be thinner)
        thin = ((my_hi - my_lo)[:, 0] < hw) & not_first & not_last

        full = {k: torch.cat([ch[k], ghosts_l[k], ghosts_r[k]], 1).reshape(
            s * t, *ch[k].shape[2:]) for k in ch}
        full["extra." + OWNED] = owned_rows
        pool = pool_from_channels(full)

        # ---- the shared iteration core, every local shard a lane ----
        env = state.env
        if use_cache:
            # a cached build indexes a layout whose ghost slots were all
            # dead (a build that saw live ghosts marks itself dirty below):
            # live ghosts arriving now force a rebuild
            n_ghosts = (lane_count(ghosts_l["alive"])
                        + lane_count(ghosts_r["alive"]))
            env = dataclasses.replace(
                env, dirty=env.dirty | (n_ghosts > 0).reshape(
                    env.dirty.shape))
        it_dev = torch.full((s,), it, dtype=torch.int32, device=dev)
        if s == 1:          # one lane: the solo core on the shard's leaves
            pool, conc, rng, stats, env = core(pool, state.conc,
                                               state.rng[0], it_dev[0], env)
            rng = rng[None]
            stats = StepStats(**{f: v.reshape(1) for f, v in stats.items()})
        else:
            pool, conc, rng, stats, env = core(pool, state.conc, state.rng,
                                               it_dev, env)
        v = {k: per_shard(a, t) for k, a in pool.channels().items()}
        alive2 = v["alive"] & v["extra." + OWNED]
        x2 = v["position"][..., 0]

        # ---- quantile rebalance on its iterations (a host branch) ----
        if (dcfg.rebalance_frequency > 0
                and (it + 1) % dcfg.rebalance_frequency == 0):
            every = shards.gather({"x": x2, "alive": alive2})
            bounds = quantile_boundaries(every["x"], every["alive"],
                                         dcfg.n_shards, x_lo_dom, x_hi_dom)
            my_lo, my_hi = slab_edges(bounds)

        # ---- ring migration: leavers append through the birth commit ----
        go_l = alive2 & (x2 < my_lo) & not_first[:, None]
        go_r = alive2 & (x2 >= my_hi) & not_last[:, None]
        mig_l, ovf_ml = pack_channels(go_l, v, mcap)
        mig_r, ovf_mr = pack_channels(go_r, v, mcap)
        arrivals = (shards.shift_forward(mig_r),
                    shards.shift_backward(mig_l))
        v["alive"] = alive2 & ~go_l & ~go_r        # drop ghosts + leavers
        pool = compaction.compact(pool_from_channels(
            {k: a.reshape(s * t, *a.shape[2:]) for k, a in v.items()}), ln)
        ovf_in = torch.zeros(s, dtype=torch.int32, device=dev)
        n_arrive = torch.zeros(s, dtype=torch.int32, device=dev)
        for arr in arrivals:
            # every shipped channel kept: agents born this step migrate
            # with their birth step and behavior state
            q = _tree(lambda a: _pad_rows(a, t), arr)
            ovf_in = ovf_in + compaction.birth_overflow(pool, q["alive"], ln)
            n_arrive = n_arrive + lane_count(arr["alive"])
            pool = compaction.commit_births(
                pool, q, q["alive"], it_dev if s > 1 else it_dev[0], ln)

        if use_cache:
            # live ghosts (their slots churn), leavers (the compaction
            # permutes) and arrivals (slots the tables call dead) leave
            # the cached tables describing another layout
            n_leave = lane_count(go_l | go_r)
            env = dataclasses.replace(env, dirty=env.dirty | (
                (n_ghosts > 0) | (n_leave > 0) | (n_arrive > 0)).reshape(
                    env.dirty.shape))

        n_final = lane_count(per_shard(pool.alive, t))
        ovf_cap = torch.clamp(n_final - c_local, min=0)  # clipped on repack
        out = {k: per_shard(a, t)[:, :c_local]
               for k, a in pool.channels().items()}
        # an owned agent still outside its slab after this step's one hop
        # (a rebalance moved a boundary by more than a slab) starts the
        # next step with an incomplete neighborhood: nothing is dropped,
        # but it is counted
        xf = out["position"][..., 0]
        in_flight = lane_count(out["alive"] & (
            ((xf < my_lo) & not_first[:, None])
            | ((xf >= my_hi) & not_last[:, None])))
        # which knob each flag grows: halo_overflow → halo_capacity,
        # migrate_overflow → migrate_capacity, birth_overflow (newborns,
        # arrivals, repack clipping) → local_capacity with capacity_demand
        # its target; thin_slab is geometry, not a buffer
        i32 = torch.int32
        stats = dataclasses.replace(
            stats, n_live=lane_count(out["alive"]),
            halo_overflow=(ovf_hl + ovf_hr).to(i32),
            migrate_overflow=(ovf_ml + ovf_mr).to(i32),
            birth_overflow=(stats.birth_overflow + ovf_in + ovf_cap).to(i32),
            capacity_demand=(n_final + ovf_in
                             + stats.birth_overflow).to(i32),
            thin_slab=thin.to(i32), in_flight=in_flight)
        return DistState(
            channels={k: a.reshape(s * c_local, *a.shape[2:])
                      for k, a in out.items()},
            conc=conc, rng=rng, boundaries=bounds,
            iteration=state.iteration + 1, stats=stats, env=env)

    return step


def initial_dist_env(dcfg: DistConfig, device: torch.device,
                     n_lanes: Optional[int] = None
                     ) -> Optional[grid_mod.RebuildState]:
    """One empty, dirty every_k cache per shard (lane-major) for
    ``n_lanes`` shards (default: all of them), or None."""
    cfg = dcfg.engine
    if cfg.rebuild.mode != "every_k":
        return None
    return grid_mod.initial_rebuild_state(
        cfg.grid_spec, dcfg.total_capacity,
        torch.tensor(cfg.domain_lo, dtype=torch.float32, device=device),
        cfg.cell_size, pairlist=cfg.pairlist,
        lanes=Lanes(n_lanes or dcfg.n_shards, dcfg.total_capacity))


def gather_state(state: DistState, dcfg: DistConfig, shards,
                 dst: Optional[int] = None) -> Optional[DistState]:
    """The whole run's state on every rank, in the reference's layout (as
    its checkpoints store it): every channel ``(n_shards·C, ...)``, the
    whole grid, ``(n_shards, ...)`` keys and stats, and the every_k caches
    stacked ``(n_shards, ...)``, each shard's slot ids its own. One
    gather; with ``dst`` onto that rank of the group only (None on the
    others)."""
    s = shards.n_local
    per = lambda v: v.reshape(s, -1, *v.shape[1:])        # noqa: E731
    leaves = {"ch." + k: per(v) for k, v in state.channels.items()}
    leaves.update({"conc": per(state.conc), "rng": per(state.rng)})
    leaves.update({"stats." + f: per(v) for f, v in state.stats.items()})
    env = state.env
    env_leaves: list = []
    if env is not None:
        env = grid_mod.stack_rebuild_state(env, Lanes(s, dcfg.total_capacity))
        grid_mod.map_rebuild_state(lambda t: env_leaves.append(t) or t, env)
        leaves.update({f"env.{i}": t[:, None]
                       for i, t in enumerate(env_leaves)})
    got = shards.gather(leaves, dst)
    if got is None:
        return None
    if env is not None:
        it = iter(got[f"env.{i}"] for i in range(len(env_leaves)))
        env = grid_mod.map_rebuild_state(lambda t: next(it), env)
        n = dcfg.n_shards
        env = dataclasses.replace(env, grid=dataclasses.replace(
            env.grid, origin=env.grid.origin[:1].expand(n, 3).clone(),
            box_size=env.grid.box_size[:1].expand(n).clone()))
    return DistState(
        channels={k[3:]: v for k, v in got.items() if k.startswith("ch.")},
        conc=got["conc"], rng=got["rng"], boundaries=state.boundaries,
        iteration=state.iteration,
        stats=StepStats(**{f: got["stats." + f] for f in StepStats.FIELDS}),
        env=env)


def block_state(state: DistState, shards) -> DistState:
    """Inverse of :func:`gather_state`: this rank's block of a whole run's
    state (the caches back in the lane-major layout it steps with)."""
    env = state.env
    if env is not None:
        env = grid_mod.flatten_rebuild_state(grid_mod.map_rebuild_state(
            shards.block, dataclasses.replace(env, grid=dataclasses.replace(
                env.grid, origin=shards.block(env.grid.origin),
                box_size=shards.block(env.grid.box_size)))))
    return DistState(
        channels=_tree(shards.block, state.channels),
        conc=shards.block(state.conc), rng=shards.block(state.rng),
        boundaries=state.boundaries, iteration=state.iteration,
        stats=StepStats(**_tree(shards.block, dict(state.stats.items()))),
        env=env)


def shard_keys(seed: int, n_shards: int, device: torch.device
               ) -> torch.Tensor:
    """(n_shards, 2): ``fold_in(PRNGKey(seed), i)`` for shard i."""
    return rand.fold_in(rand.prng_key(seed, device),
                        torch.arange(n_shards, device=device))


class DistributedSimulation:
    """The distributed counterpart of ``engine.Simulation``: the same
    config and behaviors, the state sharded over ``dcfg.n_shards`` slabs.
    Any scenario ``Simulation`` runs runs here unchanged: forces,
    behaviors, births and deaths, statics and diffusion.

    Without ``group`` every shard is a lane of one device. With a
    ``torch.distributed`` group of W ranks, rank r steps the block of
    shards ``[r·S/W, (r+1)·S/W)`` on its own device and the moves between
    shards go over the group (:mod:`.transport`); every rank must call
    every method in the same order. The states are the rank's block of
    the one-device run's, bit for bit.

    ``device=None`` means the CUDA card (with a group, the rank's current
    one) and raises without one; pass ``device="cpu"`` for the plain path,
    over a gloo group with ranks.
    """

    def __init__(self, dcfg: DistConfig, behaviors: Sequence[Behavior] = (),
                 device: DeviceLike = None, group=None):
        self.device = rank_device(device, group)
        self.dcfg = dcfg
        self.group = group
        self.behaviors = list(behaviors)
        self.shards = shard_axis(dcfg.n_shards, group, self.device)
        self._step_fn = make_distributed_step(dcfg, self.behaviors,
                                              self.device, self.shards)

    # -- state construction -------------------------------------------------
    def init_state(self, position, diameter=None, agent_type=None,
                   extra_init: Dict | None = None,
                   seed: int = 0) -> DistState:
        """Every rank partitions the same global input and keeps its
        block."""
        dcfg, cfg = self.dcfg, self.dcfg.engine
        staging = stage_pool(position.shape[0], self.behaviors, position,
                             diameter, agent_type, extra_init,
                             extra_specs={OWNED: ((), torch.bool, True)},
                             policy=cfg.dtypes, device=self.device)
        ch = staging.channels()
        boundaries = quantile_boundaries(ch["position"][:, 0], ch["alive"],
                                         dcfg.n_shards,
                                         float(cfg.domain_lo[0]),
                                         float(cfg.domain_hi[0]))
        # never silent at init either: partition_global drops agents past
        # a slab's local_capacity, so refuse instead (heavy ties can pile a
        # whole cluster into one quantile slab)
        shard = _shard_of(ch["position"][:, 0], boundaries, dcfg.n_shards)
        per_shard = torch.bincount(shard[ch["alive"]],
                                   minlength=dcfg.n_shards).tolist()
        if max(per_shard, default=0) > dcfg.local_capacity:
            raise SlabCapacityError(
                f"slab populations {per_shard} exceed "
                f"local_capacity={dcfg.local_capacity}; raise it (heavy ties "
                f"in x can defeat quantile balancing)")
        dspec = cfg.diffusion
        block = self.shards.block
        return DistState(
            channels=_tree(block, partition_global(ch, boundaries, dcfg)),
            conc=block(torch.zeros(
                dspec.dims if dspec else (dcfg.n_shards, 1, 1),
                dtype=torch.float32, device=self.device)),
            rng=block(shard_keys(seed, dcfg.n_shards, self.device)),
            boundaries=boundaries,
            iteration=torch.zeros((), dtype=torch.int32),
            stats=StepStats.zeros(self.device, (self.shards.n_local,)),
            env=initial_dist_env(dcfg, self.device, self.shards.n_local))

    # -- public API ----------------------------------------------------------
    def step(self, state: DistState) -> DistState:
        return self._step_fn(state)

    def run(self, state: DistState, n_iterations: int,
            check_overflow: bool = False) -> DistState:
        """Run ``n_iterations``; with ``check_overflow`` the host reads
        every shard's flags after each step (one gather over the ranks, one
        transfer) and raises on the first set one, in severity order: every
        rank the same error at the same step."""
        for i in range(n_iterations):
            state = self._step_fn(state)
            if check_overflow:
                # every rank reads every shard's flags: all raise alike
                stats = self.global_stats(state.stats)
                flags = stats.flags()
                if flags:
                    self._raise_overflow(i, flags, stats)
        return state

    def global_stats(self, stats: StepStats) -> StepStats:
        """Every shard's stats (n_shards,) from the local ones, on every
        rank."""
        return StepStats(**self.shards.gather(
            {f: v[:, None] for f, v in stats.items()}))

    def _raise_overflow(self, i: int, flags: Dict[str, int],
                        s: StepStats) -> None:
        d = self.dcfg
        remediation = {
            "halo_overflow": (
                f"halo overflow (ghost band exceeded "
                f"halo_capacity={d.halo_capacity}); raise halo_capacity"),
            "thin_slab": (
                f"an interior slab is thinner than the {d.halo_width:.3g} "
                f"ghost band (one-hop ring cannot ship every cross-shard "
                f"pair); revisit boundaries / fewer shards"),
            "migrate_overflow": (
                f"migration overflow (ring buffer "
                f"migrate_capacity={d.migrate_capacity} exceeded)"),
            "in_flight": (
                f"{flags.get('in_flight', 0)} agents in flight across >1 "
                f"slab (a rebalance moved a boundary further than one slab "
                f"width; their next step sees an incomplete neighborhood) "
                f"— lower rebalance_frequency or accept the transient by "
                f"polling stats.in_flight instead of check_overflow"),
            "box_overflow": ("grid run overflow on a shard; raise "
                             "EngineConfig.max_per_run / max_per_box"),
            "pair_overflow": (
                f"pair-list overflow on a shard (an agent has more "
                f"in-range(+skin) candidates than max_pairs; per-shard "
                f"demand {s.pair_demand.tolist()}); raise "
                f"PairListConfig.max_pairs"),
            "birth_overflow": (
                f"local pool overflow on a shard (staged newborns / "
                f"migration arrivals / repack exceeded local_capacity="
                f"{d.local_capacity}; per-shard demand "
                f"{s.capacity_demand.tolist()}); raise "
                f"DistConfig.local_capacity"),
        }
        for f in ("halo_overflow", "thin_slab", "migrate_overflow",
                  "in_flight", "box_overflow", "pair_overflow",
                  "birth_overflow"):
            if f in flags:
                raise RuntimeError(f"iteration {i}: {remediation[f]}")

    def gather_channels(self, state: DistState) -> Dict[str, np.ndarray]:
        """The global channels on the host, on every rank (only live rows
        are meaningful; the order across shards is arbitrary). bfloat16
        channels come back as float32 (numpy has no bfloat16)."""
        s = self.shards.n_local
        out = {}
        for k, v in self.shards.gather({k: v.reshape(s, -1, *v.shape[1:])
                                        for k, v in state.channels.items()}
                                       ).items():
            v = v.detach().cpu()
            out[k] = (v.float() if v.dtype == torch.bfloat16 else v).numpy()
        return out


# ---------------------------------------------------------------------------
# Distributed capacity ladder: agreed global rungs
# ---------------------------------------------------------------------------

class DistributedCapacityLadder(LadderDriverBase):
    """``DistributedSimulation.run`` with automatic growth, one global rung.

    Every capacity knob (local slots, halo band, migration ring,
    max_per_run / max_per_box, max_pairs) is shared by the shards, so one
    shard's overflow grows it for all (an agreed global rung sized from the
    worst shard's demand). The overflowing iteration re-runs from its
    pre-step state, which keeps the trajectory bit-identical to a pre-sized
    run. ``thin_slab`` and ``in_flight`` are not buffer sizes: they raise
    with the remedy instead of growing. Each step reads every flag and
    demand in one host transfer; over a process group every rank reads
    every shard's (one gather first), so all ranks take the same rung.
    """

    def __init__(self, dcfg: DistConfig, behaviors: Sequence[Behavior] = (),
                 ladder: Optional[LadderConfig] = None,
                 device: DeviceLike = None, group=None):
        self.ladder = ladder or LadderConfig()
        self.dcfg = dcfg
        self.behaviors = list(behaviors)
        self.rungs: list = []
        self.recompiles = 0
        self._sim = DistributedSimulation(dcfg, self.behaviors, device, group)
        self.device = self._sim.device
        self.group = group

    @property
    def sim(self) -> DistributedSimulation:
        return self._sim

    def init_state(self, *args, **kwargs) -> DistState:
        """``init_state`` with ladder semantics: an initial population too
        big for a slab grows local_capacity instead of raising."""
        for _ in range(self.ladder.max_grows_per_step):
            try:
                return self._sim.init_state(*args, **kwargs)
            except SlabCapacityError:
                d = self.dcfg
                new_local = next_rung(d.local_capacity, d.local_capacity + 1,
                                      self.ladder.growth_factor,
                                      self.ladder.round_to)
                self._rebuild(dataclasses.replace(d, local_capacity=new_local),
                              iteration=-1)
        raise RuntimeError("init_state: local_capacity growth did not "
                           "converge (pathological initial distribution)")

    # -- growth policy -------------------------------------------------------
    _TOTAL = ("thin_slab", "in_flight", "box_overflow", "pair_overflow",
              "halo_overflow", "migrate_overflow", "birth_overflow")
    _PEAK = ("box_demand", "pair_demand", "halo_overflow",
             "migrate_overflow", "capacity_demand")

    def _diagnose(self, stats: StepStats) -> Optional[DistConfig]:
        # every shard's stats on every rank: all ranks take the same rung
        stats = self._sim.global_stats(stats)
        vals = torch.stack(
            [stats[f].to(torch.int64).sum() for f in self._TOTAL]
            + [stats[f].to(torch.int64).max() for f in self._PEAK]).tolist()
        tot = dict(zip(self._TOTAL, vals))
        peak = dict(zip(self._PEAK, vals[len(self._TOTAL):]))
        d, lad = self.dcfg, self.ladder
        if tot["thin_slab"]:
            raise RuntimeError(
                "thin interior slab (quantile geometry, not a buffer size) — "
                "the ladder cannot grow past it; use fewer shards or a wider "
                "domain")
        if tot["in_flight"]:
            raise RuntimeError(
                "agents in flight across >1 slab after a rebalance — lower "
                "rebalance_frequency (not a capacity problem)")
        changes = {}
        eng = d.engine
        if tot["box_overflow"]:
            demand = peak["box_demand"]
            if eng.environment == "hash_grid":
                need = -(-demand // grid_mod.HASH_K_MULT)
                eng = dataclasses.replace(eng, max_per_box=next_rung(
                    eng.max_per_box, need, lad.growth_factor))
            else:
                eng = dataclasses.replace(eng, max_per_run=next_rung(
                    eng.grid_spec.run_capacity, demand, lad.growth_factor))
        if tot["pair_overflow"]:
            eng = dataclasses.replace(eng, pairlist=dataclasses.replace(
                eng.pairlist, max_pairs=next_rung(
                    eng.pairlist.max_pairs, peak["pair_demand"],
                    lad.growth_factor)))
        if eng is not d.engine:
            changes["engine"] = eng
        if tot["halo_overflow"]:
            changes["halo_capacity"] = next_rung(
                d.halo_capacity, d.halo_capacity + peak["halo_overflow"],
                lad.growth_factor, lad.round_to)
        if tot["migrate_overflow"]:
            changes["migrate_capacity"] = next_rung(
                d.migrate_capacity,
                d.migrate_capacity + peak["migrate_overflow"],
                lad.growth_factor, lad.round_to)
        if tot["birth_overflow"]:
            demand = peak["capacity_demand"]
            new_local = next_rung(d.local_capacity, demand,
                                  lad.growth_factor, lad.round_to)
            if (lad.max_capacity is not None
                    and new_local * d.n_shards > lad.max_capacity):
                raise CapacityExhausted(
                    f"capacity ladder exhausted: per-shard demand {demand} "
                    f"needs {new_local}×{d.n_shards} slots > "
                    f"max_capacity={lad.max_capacity}",
                    demand=demand, rung=new_local * d.n_shards,
                    max_capacity=lad.max_capacity)
            changes["local_capacity"] = new_local
        if not changes:
            return None
        new_d = dataclasses.replace(d, **changes)
        # halo/migrate buffers never exceed local_capacity
        if new_d.local_capacity < max(new_d.halo_capacity,
                                      new_d.migrate_capacity):
            new_d = dataclasses.replace(
                new_d, local_capacity=max(new_d.halo_capacity,
                                          new_d.migrate_capacity))
        return new_d

    def _rebuild(self, new_d: DistConfig, iteration: int) -> None:
        pls = (new_d.engine.pairlist, self.dcfg.engine.pairlist)
        self._log_rungs(
            iteration,
            [(f, getattr(self.dcfg, f), getattr(new_d, f))
             for f in ("local_capacity", "halo_capacity", "migrate_capacity")]
            + [(f, getattr(self.dcfg.engine, f), getattr(new_d.engine, f))
               for f in ("max_per_box", "max_per_run")]
            + ([("max_pairs", pls[1].max_pairs, pls[0].max_pairs)]
               if None not in pls else []))
        self.dcfg = new_d
        self._sim = DistributedSimulation(new_d, self.behaviors, self.device,
                                          self.group)

    def _grow(self, new_d: DistConfig, prev: DistState,
              iteration: int) -> DistState:
        old_local, old_total = self.dcfg.local_capacity, \
            self.dcfg.total_capacity
        old_pl = self.dcfg.engine.pairlist
        self._rebuild(new_d, iteration)
        n_local = self._sim.shards.n_local
        if new_d.local_capacity != old_local:
            prev = dataclasses.replace(prev, channels=compaction.repack_slabs(
                prev.channels, n_local, old_local, new_d.local_capacity))
        env = prev.env
        if env is None:
            return prev
        old_lanes = Lanes(n_local, old_total)
        new_pl = new_d.engine.pairlist
        if (env.pairs is not None and new_pl is not None
                and old_pl is not None
                and (new_d.total_capacity != old_total
                     or new_pl.max_pairs != old_pl.max_pairs)):
            # an overflowed list never survives a kept step (the rewind
            # discards it), so zero padding is what a pre-sized build holds
            env = dataclasses.replace(env, pairs=grid_mod.grow_pairlist(
                env.pairs, new_d.total_capacity, new_pl.max_pairs,
                old_lanes))
        if new_d.total_capacity != old_total:
            # the cache spans the in-step pool (owned + ghost bands): grown
            # as a pre-sized build over the wider pool would lay it out
            env = dataclasses.replace(env, grid=grid_mod.grow_grid_state(
                env.grid, new_d.total_capacity, old_lanes))
        return dataclasses.replace(prev, env=env)
