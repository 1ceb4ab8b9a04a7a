"""Simulation engine — one Algorithm-1 iteration per step (port of
``repro.core.engine``).

An iteration: resident grid build (one stable key sort permutes the pool
into grid order and compacts the dead) → diffusion substeps → static flags
→ the fused neighbor sweep (forces in K1, or in the streamed sweep, beside
every behavior's pair kernels) → overdamped integration → behaviors and
secretion → health watchdog → death compaction and birth commit →
statistics.

PyTorch runs eagerly, so the step is plain Python over tensors on one
device. With every-step rebuilds it never reads a device value on the host
(no synchronisation) except where ``run(check_overflow=True)`` reads the
flags. Under ``RebuildPolicy(mode="every_k")`` each step reads one flag,
whether to rebuild, from the carried cache at its start: the reference
skips the build with ``lax.cond``, and computing both branches would pay
for the build it means to skip. The capacity ladder (:class:`CapacityLadder`)
reads every flag and demand of a step in one host transfer after it, so a
ladder run costs one host read a step (two under every_k). The
distributed engine (:mod:`.distributed`) steps its shards as lanes: under
every_k it reads the (n_shards,) rebuild flags in one transfer a step, as
an ensemble does, and nothing else.

Every environment of the reference runs: the resident ``uniform_grid``
(every-step or every_k rebuilds, with or without a Verlet pair list), and
the paper's baselines ``scatter_grid``, ``hash_grid`` (both with the
periodic Morton sort under ``sort_frequency``) and ``brute_force``, under
any :class:`DtypePolicy`. Forces come from K1 (``force_impl="k1"``: the
CUDA kernel on the card, its plain version on the CPU; uniform grid only)
or from the streamed sweep (``"streamed"``, the reference's ``"xla"``).
The periodic Morton sort, which the reference runs under ``lax.cond``, is
computed every step and applied as the identity on the steps that do not
sort, so it reads nothing back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from . import compaction, diffusion as diff_mod, forces as force_mod
from . import grid as grid_mod, morton, rand, statics as statics_mod
from . import health as health_mod
from .agents import AgentPool, DtypePolicy, make_pool, weak
from .behaviors import Behavior
from .lanes import Lanes
from .stats import StepStats
from ..device import DeviceLike, resolve_device

# "xla" is the reference's name for the streamed fused sweep
FORCE_IMPLS = ("k1", "streamed", "xla")

# EngineConfig.environment → grid.make_builder method
_ENV_METHOD = {
    "uniform_grid": "resident",
    "brute_force": "resident",   # its tables serve the static detection
    "scatter_grid": "scatter",
    "hash_grid": "hash",
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration; the reference's fields and checks.

    ``force_impl``: ``"k1"`` computes forces with the K1 kernel — the
    hand-written CUDA kernel on the card, its plain version on the CPU —
    and needs the uniform grid. ``"streamed"`` (or the reference's name
    ``"xla"``) computes them in the streamed sweep, beside the behaviors'
    pair kernels. ``None`` (the default) means ``"k1"`` on the uniform grid
    and ``"streamed"`` on every other environment, so that a config naming
    only its environment runs the path the reference's default (``"xla"``)
    runs there; the field holds the resolved name after construction.
    """
    capacity: int
    domain_lo: Tuple[float, float, float]
    domain_hi: Tuple[float, float, float]
    interaction_radius: float
    dt: float = 1.0
    use_forces: bool = True
    fused_sweep: bool = True
    detect_static: bool = False
    sort_frequency: int = 0
    environment: str = "uniform_grid"
    force_impl: Optional[str] = None
    max_per_box: int = 16
    max_per_run: Optional[int] = None
    query_chunk: int = 2048
    adhesion: Optional[Tuple[Tuple[float, ...], ...]] = None
    force: force_mod.ForceParams = dataclasses.field(
        default_factory=force_mod.ForceParams)
    diffusion: Optional[diff_mod.DiffusionSpec] = None
    diffusion_substeps: int = 1
    rebuild: grid_mod.RebuildPolicy = dataclasses.field(
        default_factory=grid_mod.RebuildPolicy)
    pairlist: Optional[grid_mod.PairListConfig] = None
    sort_impl: str = "auto"
    dtypes: DtypePolicy = dataclasses.field(default_factory=DtypePolicy)
    health: Optional[health_mod.HealthConfig] = dataclasses.field(
        default_factory=health_mod.HealthConfig)

    def __post_init__(self):
        if self.sort_impl not in grid_mod.SORT_IMPLS:
            raise ValueError(f"sort_impl must be one of {grid_mod.SORT_IMPLS},"
                             f" got {self.sort_impl!r}")
        if self.force_impl is None:
            object.__setattr__(self, "force_impl",
                               "k1" if self.environment == "uniform_grid"
                               else "streamed")
        if self.force_impl not in FORCE_IMPLS:
            raise ValueError(f"force_impl must be one of {FORCE_IMPLS}, got "
                             f"{self.force_impl!r}")
        if self.rebuild.mode == "every_k":
            if self.environment != "uniform_grid":
                raise ValueError(
                    f"rebuild.mode='every_k' requires "
                    f"environment='uniform_grid', got "
                    f"environment={self.environment!r}")
            if self.detect_static:
                raise ValueError(
                    "rebuild.mode='every_k' is incompatible with "
                    "detect_static=True")
        if self.pairlist is not None:
            if self.environment != "uniform_grid" or not self.fused_sweep:
                raise ValueError(
                    "pairlist requires environment='uniform_grid' and "
                    "fused_sweep=True")
            if self.detect_static:
                raise ValueError(
                    "pairlist is incompatible with detect_static=True")
            if self.pairlist.skin > 0 and self.rebuild.mode != "every_k":
                raise ValueError(
                    "pairlist.skin > 0 only pays off under "
                    "rebuild.mode='every_k'; use skin=0 with every-step "
                    "rebuilds")

    @property
    def cell_size(self) -> float:
        """Grid box edge: the interaction radius plus the rebuild slack or
        pair-list skin, whichever is larger."""
        skin = self.pairlist.skin if self.pairlist is not None else 0.0
        return self.interaction_radius + max(self.rebuild.cell_slack, skin)

    @property
    def grid_spec(self) -> grid_mod.GridSpec:
        dims = tuple(max(1, int(math.ceil((hi - lo) / self.cell_size)))
                     for lo, hi in zip(self.domain_lo, self.domain_hi))
        return grid_mod.GridSpec(dims=dims, max_per_box=self.max_per_box,
                                 max_per_run=self.max_per_run,
                                 query_chunk=self.query_chunk)


@dataclasses.dataclass
class EngineState:
    pool: AgentPool
    conc: torch.Tensor              # diffusion grid ((1,1,1) when unused)
    rng: torch.Tensor               # (2,) int64 holding a uint32 key
    iteration: torch.Tensor         # () int32
    stats: StepStats
    env: Optional[grid_mod.RebuildState] = None
    # the cached build carried across steps (every_k); None under every_step


def _as_knob(v, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A knob as ``jnp.asarray`` makes it without x64 (a Python int as
    int32, a float as float32, a bool as bool), on the CPU
    (:meth:`ScenarioParams.to` moves it)."""
    t = v.detach() if isinstance(v, torch.Tensor) else torch.as_tensor(
        np.asarray(v))
    if dtype is None:
        dtype = {torch.int64: torch.int32,
                 torch.float64: torch.float32}.get(t.dtype, t.dtype)
    return t.to(dtype)


@dataclasses.dataclass
class ScenarioParams:
    """Per-run scenario knobs passed INTO the iteration core as tensors.

    ``EngineConfig`` is static: its floats are constants of the step. These
    knobs may differ per run, so one step serves any parameter point, which
    is what lets the ensemble engine (ensemble.py) step differently
    parameterised lanes together and the simulation service admit a new
    parameter point into a free lane.

    dt:    () float32 — replaces ``cfg.dt`` (None: the static value).
    force: ForceParams field overrides (e.g. ``{"k_rep": x}``) as float32
           tensors; empty: the static ``cfg.force``. Refused under
           ``force_impl="k1"``, whose kernel takes its constants at launch,
           as the reference refuses them under its Pallas kernel.
    rates: free-form behavior knobs, exposed to behaviors as ``ctx.params``
           — a behavior opts in through a callable parameter
           (``Infection(beta=lambda ctx: ctx.params["beta"])``).

    In an ensemble every leaf has a leading lane axis (L,); the step hands
    each row its lane's value, so a behavior sees (L·C,) knobs where a
    solo step sees 0-dim ones.
    """
    dt: Optional[torch.Tensor] = None
    force: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)
    rates: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    @classmethod
    def of(cls, dt: Optional[float] = None,
           force: Optional[Dict[str, float]] = None,
           **rates) -> "ScenarioParams":
        """Scalar-tensor ScenarioParams from plain Python numbers, with the
        reference's dtypes (``jnp.asarray``: int32, float32, bool)."""
        return cls(
            dt=None if dt is None else _as_knob(dt, torch.float32),
            force={k: _as_knob(v, torch.float32)
                   for k, v in (force or {}).items()},
            rates={k: _as_knob(v) for k, v in rates.items()})

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ScenarioParams":
        """``fn`` applied to every leaf."""
        return ScenarioParams(
            dt=None if self.dt is None else fn(self.dt),
            force={k: fn(v) for k, v in self.force.items()},
            rates={k: fn(v) for k, v in self.rates.items()})

    def to(self, device) -> "ScenarioParams":
        return self.map(lambda t: t.to(device))


@dataclasses.dataclass
class StepContext:
    """What behaviors may read during one iteration. ``dt`` is the
    config's float, a 0-dim tensor from ``ScenarioParams.dt``, or (L·C,)
    per row in an ensemble; ``params`` holds the rates likewise."""
    config: EngineConfig
    dt: Any
    domain_lo: torch.Tensor
    domain_hi: torch.Tensor
    iteration: torch.Tensor
    owned: torch.Tensor
    neighbor_apply: Callable
    substance_gradient: Callable
    substance_value: Callable
    neighbor_results: Dict[str, Dict[str, torch.Tensor]] = dataclasses.field(
        default_factory=dict)
    params: Dict[str, torch.Tensor] = dataclasses.field(default_factory=dict)


def build_env(cfg: EngineConfig, spec: grid_mod.GridSpec, pool: AgentPool,
              origin: torch.Tensor, box_size: float,
              lanes: Optional[Lanes] = None) -> grid_mod.BuildResult:
    """The iteration's environment build. The resident environments
    (``uniform_grid``, and ``brute_force``, which keeps the tables for the
    static detection) return the pool permuted into grid order; scatter
    and hash leave it as it is. ``lanes``: an ensemble's lane-major pool,
    each lane built on its own."""
    builder = grid_mod.make_builder(spec, method=_ENV_METHOD[cfg.environment],
                                    sort_impl=cfg.sort_impl, lanes=lanes)
    return builder(pool, origin, box_size)


def make_neighbor_apply(cfg: EngineConfig, spec: grid_mod.GridSpec, grid_env,
                        channels: Dict[str, torch.Tensor],
                        default_mask: torch.Tensor,
                        lanes: Optional[Lanes] = None) -> Callable:
    """The step's ``ctx.neighbor_apply``: ``apply(pair_fn, out_specs,
    query_mask=None)``, the mask defaulting to ``default_mask``.

    The uniform grid runs one streamed sweep over the resident pool
    (``grid.resident_apply``); the hash grid streams its 27 probes through
    ``grid.phased_chunk_apply``; the scatter grid (27 table rows) and brute
    force (every slot) run ``grid.chunk_apply`` over their wide candidate
    rows. Each excludes the query's own slot.

    ``lanes``: an ensemble's lane-major pool. A query slot's lane is
    ``q_slot // C``; the scatter and hash queries read that lane's tables,
    and brute force's candidates are that lane's C slots in slot order, so
    each row sees its solo candidates in its solo order.
    """
    ln = lanes or Lanes(1, channels["position"].shape[0])

    def lane_of(q_slot: torch.Tensor) -> Optional[torch.Tensor]:
        return (None if ln.solo else
                torch.div(q_slot, ln.capacity, rounding_mode="floor"))

    if cfg.environment == "uniform_grid":
        def apply(pair_fn, out_specs, query_mask=None):
            mask = default_mask if query_mask is None else query_mask
            return grid_mod.resident_apply(spec, grid_env, channels, mask,
                                           pair_fn, out_specs,
                                           cfg.query_chunk)
        return apply

    if cfg.environment == "hash_grid":
        def phase_fn(q_pos, q_slot, j):
            ids, valid = grid_mod.hash_grid_probe(
                spec, grid_env, q_pos, j, lane=lane_of(q_slot))
            return ids, valid & (ids != q_slot[:, None])
        n_phases, width = 27, grid_mod.HASH_K_MULT * spec.max_per_box
    else:
        if cfg.environment == "scatter_grid":
            def box_cand(q_pos, q_slot):
                return grid_mod.scatter_grid_candidates(
                    spec, grid_env, q_pos, lane=lane_of(q_slot))
            width = 27 * spec.max_per_box
        else:                                   # brute_force
            c = ln.capacity
            ids_all = torch.arange(c, dtype=torch.int32,
                                   device=default_mask.device)
            alive = ln.view(channels["alive"])

            def box_cand(q_pos, q_slot):
                q = q_pos.shape[0]
                if ln.solo:
                    return (ids_all[None].expand(q, c),
                            alive[0][None].expand(q, c))
                lane = lane_of(q_slot).to(torch.int64)
                return (ids_all[None] + (lane * c).to(torch.int32)[:, None],
                        alive.index_select(0, lane))
            width = c

        def phase_fn(q_pos, q_slot, j):
            ids, valid = box_cand(q_pos, q_slot)
            return ids, valid & (ids != q_slot[:, None])
        n_phases = 1

    def apply(pair_fn, out_specs, query_mask=None):
        mask = default_mask if query_mask is None else query_mask
        query_idx, n_query = compaction.active_index_list(mask)
        with record_function("grid/sweep"):
            return grid_mod.phased_chunk_apply(
                channels, channels, query_idx, n_query, phase_fn, n_phases,
                pair_fn, out_specs, cfg.query_chunk, width)
    return apply


def _adhesion(cfg: EngineConfig, device) -> Optional[torch.Tensor]:
    if cfg.adhesion is None:
        return None
    return torch.tensor(cfg.adhesion, dtype=torch.float32, device=device)


def registered_kernels(cfg: EngineConfig, behaviors: Sequence[Behavior],
                       device: torch.device | str
                       ) -> List[grid_mod.PairKernel]:
    """The PairKernels the step registers into its fused sweep, their
    tensors on ``device`` (masks unresolved: they are per-step values)."""
    kernels: List[grid_mod.PairKernel] = []
    if cfg.use_forces:
        kernels.append(grid_mod.PairKernel(
            "force", force_mod.make_force_pair_fn(cfg.force,
                                                  _adhesion(cfg, device)),
            force_mod.FORCE_OUT_SPECS, reads=force_mod.FORCE_READS))
    for b in behaviors:
        kernels.extend(b.neighbor_kernels())
    return kernels


def realized_footprint(cfg: EngineConfig, behaviors: Sequence[Behavior]
                       ) -> Tuple[str, ...]:
    """Union of the channels the step's fused sweep streams."""
    return grid_mod.fused_reads(registered_kernels(cfg, behaviors, "cpu"))


def check_kernel_footprints(cfg: EngineConfig, behaviors: Sequence[Behavior],
                            block: int = 4, width: int = 8
                            ) -> Tuple[str, ...]:
    """Run every registered kernel on zeros that hold ONLY its declared
    channels, so an undeclared read raises ``KeyError`` even where another
    kernel's declaration would have streamed the channel. Also checks the
    declared reads and outputs against the pool. Returns the footprint."""
    pool = stage_pool(max(block, 1), behaviors,
                      torch.zeros((1, 3), dtype=torch.float32),
                      policy=cfg.dtypes, device="cpu")
    channels = pool.channels()
    for k in registered_kernels(cfg, behaviors, "cpu"):
        missing = [ch for ch in k.reads if ch not in channels]
        if missing:
            raise KeyError(
                f"kernel {k.name!r} declares channels the pool does not "
                f"have: {missing} (pool has {sorted(channels)})")
        # the sweep always slices position for run_bounds, declared or not
        q = {ch: torch.zeros((block, *channels[ch].shape[1:]),
                             dtype=channels[ch].dtype)
             for ch in dict.fromkeys(("position",) + tuple(k.reads))}
        nbr = {ch: torch.zeros((block, width, *channels[ch].shape[1:]),
                               dtype=channels[ch].dtype) for ch in k.reads}
        try:
            out = k.pair_fn(q, nbr, torch.zeros((block, width),
                                                dtype=torch.bool),
                            torch.zeros(block, dtype=torch.int32))
        except KeyError as e:
            raise KeyError(
                f"kernel {k.name!r} reads channel {e} it did not declare — "
                f"add it to PairKernel.reads (declared: {k.reads})") from None
        undeclared = sorted(set(out) - set(k.out_specs))
        if undeclared:
            raise KeyError(f"kernel {k.name!r} returns outputs {undeclared} "
                           f"missing from its out_specs "
                           f"{sorted(k.out_specs)}")
    return realized_footprint(cfg, behaviors)


def make_iteration_core(cfg: EngineConfig, behaviors: Sequence[Behavior],
                        device: torch.device, n_lanes: int = 1,
                        owned_channel: Optional[str] = None,
                        diff_ops: Optional[diff_mod.DiffusionOps] = None):
    """The Algorithm-1 iteration body.

    Returns ``core(pool, conc, rng, it, env=None, params=None, active=None)
    -> (pool, conc, rng, StepStats, env)`` over tensors on ``device``.

    ``params`` (a :class:`ScenarioParams`) replaces the static dt, force
    constants and behavior rates; ``params=None`` runs the static config,
    bit-identical to a core without the argument.

    ``n_lanes`` > 1 makes it an ensemble's step: ``pool`` holds L lanes of
    ``cfg.capacity`` slots (:mod:`lanes`), ``rng`` (L, 2), ``it`` (L,), the
    params' leaves (L,), and every stat comes back (L,). Each lane takes
    exactly the values its solo step would, RNG keys included: the build
    sorts and indexes each lane on its own, the sweep's runs stay in the
    query's lane (the scatter and hash tables a query reads, and brute
    force's candidates, are its own lane's; the periodic Morton sort
    orders each lane on its own iterations), K1's column map packs every
    lane at whole row blocks,
    and every reduction is per lane. The operations do not grow with L
    beyond the streamed sweep's extra query chunks. With one lane this is
    the solo step itself.

    An ensemble's every_k cache (``env``) is per lane, in the lane-major
    layout of :class:`~.grid.RebuildState`. The step reads the (L,)
    rebuild flags in one host transfer: no lane set skips the build, every
    lane set builds, and a mix builds every lane and keeps, per lane, the
    fresh or the cached pool order, tables, pair list and counters — what
    the reference's vmapped ``lax.cond`` selects. ``active`` (L,) bool
    names the lanes whose results the caller keeps; the flags of the
    others are not read. The diffusion grid ``conc`` is (L, X, Y, Z).

    ``owned_channel`` names a bool extra channel that tells the agents the
    pool owns from ghost rows a distributed wrapper appended (None: every
    live agent is owned). Ghosts are gather sources only: they are never
    queried, acted on by behaviors, killed or counted in the stats, and
    newborns are committed owned. ``diff_ops`` replaces the full-grid
    :class:`~.diffusion.DiffusionOps` (the distributed engine's x-slabs).
    With both None the core is the one without them, bit for bit.
    """
    if n_lanes < 1:
        raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
    ln = Lanes(n_lanes, cfg.capacity)
    lane_shape = () if ln.solo else (n_lanes,)
    if cfg.environment not in _ENV_METHOD:
        raise ValueError(f"unknown environment {cfg.environment!r}")
    if cfg.force_impl == "k1" and cfg.environment != "uniform_grid":
        raise ValueError("force_impl='k1' requires the uniform_grid "
                         "environment (the kernel consumes its resident "
                         "grid tables)")
    behaviors = list(behaviors)
    # the fused sweep's registry: names key ctx.neighbor_results, so they
    # must be unique ("force" is the engine's own kernel)
    registry = registered_kernels(cfg, behaviors, device)
    knames = [k.name for b in behaviors for k in b.neighbor_kernels()]
    if len(set(knames)) != len(knames) or "force" in knames:
        raise ValueError(
            f"behavior neighbor_kernels() names must be unique and must not "
            f"shadow the engine's 'force' kernel, got {knames} — give each "
            f"behavior instance a distinct .name")
    fused = cfg.fused_sweep and cfg.environment == "uniform_grid"
    spec = cfg.grid_spec
    box_size = cfg.cell_size
    dlo = torch.tensor(cfg.domain_lo, dtype=torch.float32, device=device)
    dhi = torch.tensor(cfg.domain_hi, dtype=torch.float32, device=device)
    origin = dlo
    adhesion = _adhesion(cfg, device)
    fp = cfg.force
    use_k1 = cfg.force_impl == "k1"
    if diff_ops is None and cfg.diffusion is not None:
        diff_ops = diff_mod.DiffusionOps(cfg.diffusion, origin, ln)

    def owned_of(pool: AgentPool) -> torch.Tensor:
        if owned_channel is None:
            return pool.alive
        return pool.extra[owned_channel].to(torch.bool) & pool.alive

    def zeros_i32():
        return torch.zeros(lane_shape, dtype=torch.int32, device=device)

    use_cache = cfg.rebuild.mode == "every_k"
    # the reference's every_k queries read the box size that lax.cond
    # returns with the cached tables, a traced value, and XLA divides by it
    # (its builds multiply by the constant's reciprocal): a tensor box size
    # makes morton.cell_of divide
    traced_box = (torch.tensor(box_size, dtype=torch.float32, device=device)
                  if use_cache else None)
    pl = cfg.pairlist
    pair_radius = cfg.interaction_radius + pl.skin if pl is not None else 0.0
    sort_every = (cfg.sort_frequency
                  if cfg.environment in ("scatter_grid", "hash_grid") else 0)

    def sort_pool(pool: AgentPool, it: torch.Tensor) -> AgentPool:
        """The §4.2 Morton sort on the steps ``it % sort_frequency == 0``.
        The reference branches with ``lax.cond``; here the sort is computed
        every step and the identity kept on the others, so no device value
        is read on the host. Over lanes each lane sorts its own slots on
        its own iterations, as the reference's vmapped ``lax.cond``."""
        keys = morton.morton_keys(pool.position, origin, box_size, spec.dims)
        keys = torch.where(pool.alive, keys,
                           torch.full_like(keys, morton.DEAD_KEY))
        due = (it % sort_every) == 0
        if ln.solo:
            order = torch.sort(keys, stable=True).indices
        else:
            local = torch.sort(ln.view(keys), dim=1, stable=True).indices
            order = (local + ln.offsets(device)[:, None]).reshape(-1)
            due = ln.rows(due)
        ident = torch.arange(pool.capacity, device=device)
        return compaction.apply_permutation(
            pool, torch.where(due, order, ident))

    def build_pairs(pool: AgentPool, grid_env: grid_mod.GridState
                    ) -> Optional[grid_mod.PairList]:
        if pl is None:
            return None
        with record_function("step/pairlist_build"):
            return grid_mod.build_pairlist(
                spec, grid_env, pool.position, pool.alive,
                radius=pair_radius, max_pairs=pl.max_pairs,
                chunk=cfg.query_chunk)

    def rebuild_flags(env: grid_mod.RebuildState) -> torch.Tensor:
        """The reference's rebuild test, () or (L,): the cache is dirty,
        its k steps are spent, the per-axis displacement exceeds the
        widened boxes' slack, or the euclidean one half the skin."""
        flag = (env.dirty | (env.steps_since >= cfg.rebuild.k)
                | (env.disp_accum > cfg.rebuild.displacement_bound))
        if pl is not None:
            flag = flag | (2.0 * env.pair_disp > pl.skin)
        return flag

    def core(pool: AgentPool, conc: torch.Tensor, rng: torch.Tensor,
             it: torch.Tensor, env: Optional[grid_mod.RebuildState] = None,
             params: Optional[ScenarioParams] = None,
             active: Optional[torch.Tensor] = None):
        # under every_k the step's one host read, first, from the carried
        # cache: every value it needs was computed by the previous step
        # (an ensemble's (L,) flags in one transfer)
        rebuild, mixed = True, False
        if use_cache:
            flags = rebuild_flags(env)
            if ln.solo:
                rebuild = bool(flags)
            else:
                if active is not None:
                    flags = flags & active
                lane_flags = flags.tolist()
                rebuild, mixed = any(lane_flags), not all(lane_flags)
        keys = rand.split(rng, 2 + len(behaviors))
        rng, bkeys = keys[0], keys[2:]           # keys[1]: the force key
        stats = StepStats.zeros(device, lane_shape)

        # the scenario knobs: with params=None the static config's values
        dt, fp_step, rates = cfg.dt, fp, {}
        dt_lane = dt                  # () solo, (L,) per lane: diffusion's
        force_fn = None
        if params is not None:
            params = params.to(device)
            if params.dt is not None:
                dt_lane = params.dt
            if not ln.solo:                     # each row its lane's knob
                params = params.map(ln.rows)
            if params.dt is not None:
                dt = params.dt
            if params.force:
                if use_k1:
                    raise ValueError(
                        "ScenarioParams.force overrides require "
                        "force_impl='xla' (the Pallas kernel bakes its force "
                        "constants)")
                # an ensemble's (L·C,) overrides: the pair function reads
                # each query row's own (forces.make_force_pair_fn)
                fp_step = dataclasses.replace(fp, **params.force)
                force_fn = force_mod.make_force_pair_fn(fp_step, adhesion)
            rates = params.rates

        # ---------------- pre standalone ops ----------------
        # the resident environments reorder the pool at every build; the
        # periodic Morton sort serves scatter and hash
        if sort_every > 0:
            with record_function("step/morton_sort"):
                pool = sort_pool(pool, it)
        if rebuild:
            with record_function("step/grid_build"):
                res = build_env(cfg, spec, pool, origin, box_size, ln)
            old_pool, pool, grid_env = pool, res.pool, res.grid
            pairs = build_pairs(pool, grid_env)
            if use_cache:
                f32 = torch.zeros(lane_shape, dtype=torch.float32,
                                  device=device)
                fresh = grid_mod.RebuildState(
                    grid=grid_env, steps_since=zeros_i32(), disp_accum=f32,
                    dirty=torch.zeros(lane_shape, dtype=torch.bool,
                                      device=device),
                    pairs=pairs, pair_disp=f32 if pl is not None else None)
                if mixed:
                    # per lane, this build or the cache (the pool's order
                    # with its tables, pair list and counters): what the
                    # reference's vmapped lax.cond selects
                    pick = ln.selector(flags)
                    env = grid_mod.map_rebuild_state(pick, fresh, env)
                    old = old_pool.channels()
                    pool = pool.with_channels({
                        k: pick(v, old[k])
                        for k, v in pool.channels().items()})
                    grid_env, pairs = env.grid, env.pairs
                else:
                    env = fresh
        else:
            # the cached tables index the layout their build left: no death
            # or birth since (either marks the cache dirty)
            grid_env, pairs = env.grid, env.pairs
        if use_cache:
            grid_env = dataclasses.replace(grid_env, box_size=traced_box)
        box_overflow, box_demand = stats.box_overflow, stats.box_demand
        if cfg.environment == "uniform_grid":
            # query exactness bound: every 3-box z-run fits run_capacity
            box_demand = grid_env.max_run_count.to(torch.int32)
            box_overflow = (grid_env.max_run_count
                            > spec.run_capacity).to(torch.int32)
        elif cfg.environment == "hash_grid":
            # the same contract: a bucket fuller than the probe's width
            # would lose candidates (scatter's truncation is the baseline's
            # own and stays unflagged, as in the reference)
            box_demand = grid_env.max_bucket_count.to(torch.int32)
            box_overflow = (grid_env.max_bucket_count
                            > grid_mod.HASH_K_MULT * spec.max_per_box
                            ).to(torch.int32)
        pair_overflow, pair_demand = stats.pair_overflow, stats.pair_demand
        if pairs is not None:
            # never silent: a row demanding more than max_pairs entries
            # lost the rest of its list
            pair_demand = pairs.demand
            pair_overflow = (pairs.demand > pl.max_pairs).to(torch.int32)

        if diff_ops is not None:
            with record_function("step/diffusion"):
                sub_dt = dt_lane / cfg.diffusion_substeps
                for _ in range(cfg.diffusion_substeps):
                    conc = diff_ops.step(conc, sub_dt)

        # the snapshot the sequential sweeps read (before forces move it)
        channels = {k: v for k, v in pool.channels().items()
                    if not k.startswith("extra.")}
        owned_alive = owned_of(pool)
        nbr_apply = make_neighbor_apply(cfg, spec, grid_env, channels,
                                        owned_alive, ln)

        # static flags from last iteration's bookkeeping (paper §5), box
        # granular over this build's resident tables
        if cfg.detect_static and cfg.environment in ("uniform_grid",
                                                     "brute_force"):
            with record_function("step/statics"):
                static = statics_mod.update_static_flags(pool, spec,
                                                         grid_env, it, ln)
            pool = dataclasses.replace(pool, static=static)

        pos0 = pool.position
        dia0 = pool.diameter

        # ---------------- agent ops: the fused neighbor sweep ----------------
        active = None
        if cfg.use_forces:
            active = (owned_alive & ~pool.static if cfg.detect_static
                      else owned_alive)
        nbr_results: Dict[str, Dict[str, torch.Tensor]] = {}
        # the force kernel's mask is this step's active rows
        registry_now = [
            dataclasses.replace(k, query_mask=active, **(
                {"pair_fn": force_fn} if force_fn is not None else {}))
            if k.name == "force" else k for k in registry]
        # the fused sweep runs on the uniform grid; the other environments
        # run each kernel's own sweep through ctx.neighbor_apply
        kernels = registry_now if fused else []
        if kernels:
            # extra.* channels are streamed only by kernels declaring them
            channels_full = pool.channels()
            with record_function("step/forces" if cfg.use_forces
                                 else "step/sweep"):
                if cfg.use_forces and use_k1:
                    from ..kernels import ops as kops
                    nbr_results, ovf = kops.fused_resident_sweep(
                        spec, grid_env, channels_full, kernels,
                        default_mask=owned_alive, origin=origin,
                        box_size=box_size, k_rep=fp.k_rep, adhesion=adhesion,
                        adhesion_band=fp.adhesion_band, chunk=cfg.query_chunk,
                        pairs=pairs, lanes=ln)
                    # a column-map overflow means possibly-missed pairs: the
                    # same never-silent flag as a run overflow
                    box_overflow = torch.maximum(box_overflow, ovf)
                else:
                    nbr_results = grid_mod.resident_apply_fused(
                        spec, grid_env, channels_full, kernels,
                        default_mask=owned_alive, chunk=cfg.query_chunk,
                        pairs=pairs)

        # ---------------- agent ops: forces ----------------
        force_arr = None                  # kept for the health guard below
        if cfg.use_forces:
            with record_function("step/forces"):
                if "force" in nbr_results:
                    fres = nbr_results["force"]
                elif use_k1:
                    from ..kernels import ops as kops
                    f, nnz, ovf = kops.collision_force_resident(
                        pool.position, pool.diameter, pool.agent_type,
                        pool.alive, active, grid_env.starts, grid_env.counts,
                        origin, box_size, dims=spec.dims, k_rep=fp.k_rep,
                        adhesion=adhesion, adhesion_band=fp.adhesion_band,
                        lanes=ln)
                    box_overflow = torch.maximum(box_overflow,
                                                 ovf.to(torch.int32))
                    fres = {"force": f, "force_nnz": nnz}
                else:                   # the force kernel comes first
                    fres = nbr_apply(registry_now[0].pair_fn,
                                     force_mod.FORCE_OUT_SPECS,
                                     query_mask=active)
            force_arr = fres["force"]
            with record_function("step/integrate"):
                dx = force_mod.displacement(force_arr, fp_step, dt)
                new_pos = torch.clamp(pool.position + dx, min=dlo, max=dhi)
                new_pos = torch.where(active[:, None], new_pos,
                                      pool.position)
                # K1 and the sweep count in int32; the channel keeps the
                # policy's dtype (int16 under compact_ints)
                force_nnz = torch.where(active, fres["force_nnz"],
                                        pool.force_nnz).to(
                                            pool.force_nnz.dtype)
            pool = dataclasses.replace(pool, position=new_pos,
                                       force_nnz=force_nnz)

        # ---------------- agent ops: behaviors ----------------
        # the substance lambdas read `conc` when called, so a behavior sees
        # the secretion of the behaviors before it (as in the reference)
        ctx = StepContext(
            config=cfg, dt=dt, domain_lo=dlo, domain_hi=dhi, iteration=it,
            owned=owned_alive, neighbor_apply=nbr_apply,
            neighbor_results=nbr_results, params=rates,
            substance_gradient=(
                (lambda p: diff_ops.gradient(conc, p)) if diff_ops
                else torch.zeros_like),
            substance_value=(
                (lambda p: diff_ops.sample(conc, p)) if diff_ops
                else (lambda p: torch.zeros(p.shape[:-1], device=p.device))))
        birth_queues: List[Tuple[Dict[str, torch.Tensor], torch.Tensor]] = []
        death_mask = None
        for b, bk in zip(behaviors, bkeys):
            with record_function(f"step/behavior/{b.name}"):
                eff = b(ctx, pool, bk)
            if eff.set_channels:
                ch = pool.channels()
                for name, val in eff.set_channels.items():
                    ch[name] = val.to(ch[name].dtype)
                pool = pool.with_channels(ch)
            if eff.birth_channels is not None:
                birth_queues.append((eff.birth_channels, eff.birth_valid))
            if eff.death_mask is not None:
                death_mask = eff.death_mask if death_mask is None \
                    else death_mask | eff.death_mask
            if eff.secretion is not None and diff_ops is not None:
                with record_function("step/secretion"):
                    conc = diff_ops.add_sources(conc, pool.position,
                                                eff.secretion)

        # bookkeeping for the next static detection
        move_d = pool.position - pos0
        moved = (move_d * move_d).sum(-1) > fp_step.move_eps ** 2
        grew = pool.diameter > dia0 + weak(1e-12, dia0)
        pool = dataclasses.replace(pool, moved=moved & pool.alive,
                                   grew=grew & pool.alive)
        if use_cache:
            # the displacement budget spent this step: the largest per-axis
            # |Δposition| (what the widened stencil's coverage consumes) and,
            # for the pair list's skin, the largest euclidean ‖Δposition‖
            zero = torch.zeros((), dtype=move_d.dtype, device=device)
            step_disp = ln.max(torch.where(pool.alive[:, None],
                                           move_d.abs(), zero))
            if pl is not None:
                d2 = move_d[:, 0] * move_d[:, 0] + move_d[:, 1] * move_d[
                    :, 1] + move_d[:, 2] * move_d[:, 2]
                step_disp_eu = torch.sqrt(ln.max(torch.where(pool.alive, d2,
                                                             zero)))

        # ---------------- health watchdog ----------------
        health = stats.health
        if cfg.health is not None and cfg.health.any_enabled:
            health = health_mod.step_health(
                cfg.health, owned_of(pool), pool.position, dlo, dhi,
                force=force_arr, move_d=move_d, lanes=ln)

        # ---------------- post standalone ops: commit ----------------
        deaths = zeros_i32()
        if death_mask is not None:
            # ghosts are their own shard's to kill
            death_mask = death_mask & owned_of(pool)
            deaths = ln.sum(death_mask)
            pool = dataclasses.replace(pool, alive=pool.alive & ~death_mask)
        # force-computed agents still alive at iteration end
        n_active = ln.sum(active & pool.alive if active is not None
                          else owned_of(pool))
        if death_mask is not None:
            # the build left the live agents in front, so with no deaths
            # this permutation is the identity: compacting unconditionally
            # equals the reference's `cond(deaths > 0, compact)` without a
            # host read of `deaths`. A step that skipped its build keeps
            # that layout: the step before it had no death or birth, or its
            # cache would be dirty and this step would have rebuilt
            pool = compaction.compact(pool, ln)

        births = zeros_i32()
        birth_overflow = zeros_i32()
        for q, valid in birth_queues:
            if owned_channel is not None:
                # the shard that staged a newborn commits it
                q = {**q, "extra." + owned_channel: torch.ones_like(valid)}
            with record_function("step/commit_births"):
                birth_overflow = birth_overflow + compaction.birth_overflow(
                    pool, valid, ln)
                births = births + ln.sum_queue(valid)
                pool = compaction.commit_births(pool, q, valid, it, ln)

        if use_cache:
            # a death ran the compaction permutation and a birth filled a
            # tail slot: either way the cached tables no longer describe the
            # pool, so the next step rebuilds
            env = dataclasses.replace(
                env, steps_since=env.steps_since + 1,
                disp_accum=env.disp_accum + step_disp,
                dirty=(deaths > 0) | (births > 0),
                **({"pairs": pairs, "pair_disp": env.pair_disp + step_disp_eu}
                   if pl is not None else {}))

        n_live_end = ln.sum(owned_of(pool))
        if use_cache and not ln.solo:
            rebuilt = flags.to(torch.int32)
        else:
            rebuilt = (torch.ones if rebuild else torch.zeros)(
                lane_shape, dtype=torch.int32, device=device)
        stats = dataclasses.replace(
            stats, n_live=n_live_end, n_active=n_active, births=births,
            deaths=deaths, box_overflow=box_overflow,
            birth_overflow=birth_overflow, box_demand=box_demand,
            capacity_demand=n_live_end + birth_overflow,
            pair_overflow=pair_overflow, pair_demand=pair_demand,
            rebuilds=rebuilt, rebuild_skips=1 - rebuilt, health=health)
        return pool, conc, rng, stats, env

    return core


def stage_pool(capacity: int, behaviors: Sequence[Behavior], position,
               diameter=None, agent_type=None,
               extra_init: Dict[str, Any] | None = None,
               extra_specs: Dict[str, tuple] | None = None,
               policy: DtypePolicy | None = None,
               device: DeviceLike = None) -> AgentPool:
    """Initial pool with every behavior's extra channels (``device=None``:
    the CUDA card, raising without one)."""
    specs: Dict[str, tuple] = {}
    for b in behaviors:
        specs.update(b.extra_specs())
    if extra_specs:
        specs.update(extra_specs)
    pool = make_pool(capacity, position=position, diameter=diameter,
                     agent_type=agent_type, extra_specs=specs, policy=policy,
                     device=device)
    if extra_init:
        n = position.shape[0]
        for k, v in extra_init.items():
            pool.extra[k][:n] = torch.as_tensor(v).to(
                device=pool.device, dtype=pool.extra[k].dtype)
    return pool


class Simulation:
    """Runs the iteration for a config and behavior list on one device.

    ``device=None`` means the CUDA card and raises on a host without one;
    pass ``device="cpu"`` for the plain CPU path.
    """

    def __init__(self, config: EngineConfig,
                 behaviors: Sequence[Behavior] = (),
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.config = config
        self.behaviors = list(behaviors)
        self.spec = config.grid_spec
        self._core = make_iteration_core(config, self.behaviors, self.device)

    def init_state(self, position, diameter=None, agent_type=None,
                   extra_init: Dict[str, Any] | None = None,
                   seed: int = 0) -> EngineState:
        pool = stage_pool(self.config.capacity, self.behaviors, position,
                          diameter, agent_type, extra_init,
                          policy=self.config.dtypes, device=self.device)
        dspec = self.config.diffusion
        env = None
        if self.config.rebuild.mode == "every_k":
            env = grid_mod.initial_rebuild_state(
                self.spec, self.config.capacity,
                torch.tensor(self.config.domain_lo, dtype=torch.float32,
                             device=self.device),
                self.config.cell_size, pairlist=self.config.pairlist)
        return EngineState(
            pool=pool,
            conc=torch.zeros(dspec.dims if dspec else (1, 1, 1),
                             dtype=torch.float32, device=self.device),
            rng=rand.prng_key(seed, self.device),
            iteration=torch.zeros((), dtype=torch.int32, device=self.device),
            stats=StepStats.zeros(self.device), env=env)

    def step(self, state: EngineState) -> EngineState:
        pool, conc, rng, stats, env = self._core(
            state.pool, state.conc, state.rng, state.iteration, state.env)
        return EngineState(pool=pool, conc=conc, rng=rng,
                           iteration=state.iteration + 1, stats=stats,
                           env=env)

    def run(self, state: EngineState, n_iterations: int,
            callback: Callable[[int, EngineState], None] | None = None,
            check_overflow: bool = False) -> EngineState:
        """Run ``n_iterations``. With ``check_overflow`` the host reads the
        overflow flags after every iteration and raises, as the reference
        does: the engine never drops interactions silently."""
        for i in range(n_iterations):
            state = self.step(state)
            if check_overflow:
                flags = state.stats.flags()
                if "box_overflow" in flags:
                    if self.config.environment == "hash_grid":
                        raise RuntimeError(
                            f"iteration {i}: hash bucket overflow (a bucket "
                            f"holds > {grid_mod.HASH_K_MULT}×max_per_box = "
                            f"{grid_mod.HASH_K_MULT * self.spec.max_per_box} "
                            f"agents); raise EngineConfig.max_per_box")
                    raise RuntimeError(
                        f"iteration {i}: grid run overflow (a 3-box z-run "
                        f"holds > {self.spec.run_capacity} agents); raise "
                        f"EngineConfig.max_per_run / max_per_box")
                if "birth_overflow" in flags:
                    raise RuntimeError(
                        f"iteration {i}: birth overflow; raise "
                        f"EngineConfig.capacity")
                if "pair_overflow" in flags:
                    raise RuntimeError(
                        f"iteration {i}: pair-list overflow (an agent has > "
                        f"{self.config.pairlist.max_pairs} in-range(+skin) "
                        f"candidates); raise PairListConfig.max_pairs")
            if callback is not None:
                callback(i, state)
        return state

    def run_supervised(self, state: EngineState, n_iterations: int,
                       ckpt_dir: str, **kwargs):
        """Run under the fault-tolerant supervisor (``simcheck``).

        Wraps this config and its behaviors in a :class:`CapacityLadder`
        and hands them to ``simcheck.SupervisedRunner``: checkpoints every
        ``checkpoint_every`` steps, rollback to the last one on a health
        fault or ladder exhaustion, retries under the degradation policy.
        Returns ``(state, RunReport)``.
        """
        from . import simcheck
        runner = simcheck.SupervisedRunner(
            CapacityLadder(self.config, self.behaviors, device=self.device),
            ckpt_dir, **kwargs)
        return runner.run(state, n_iterations)


# ---------------------------------------------------------------------------
# Capacity ladder: automatic pool growth across rungs
# ---------------------------------------------------------------------------

class CapacityExhausted(RuntimeError):
    """The ladder hit ``max_capacity``.

    Carries the last-good pre-step state and the overflowing step's
    ``StepStats`` (attached by :meth:`LadderDriverBase.step` before it
    re-raises), so a supervisor can checkpoint the trajectory and retry
    under a degradation policy instead of losing the run.
    """

    def __init__(self, message: str, demand: int = 0, rung: int = 0,
                 max_capacity: Optional[int] = None):
        super().__init__(message)
        self.demand = demand
        self.rung = rung
        self.max_capacity = max_capacity
        self.state = None      # last-good pre-step state (driver attaches)
        self.stats = None      # StepStats of the overflowing execution
        self.iteration = None  # iteration index the state is rewound to


@dataclasses.dataclass(frozen=True)
class LadderConfig:
    """How the capacity ladder grows on overflow.

    growth_factor:      geometric rung ratio.
    max_capacity:       ceiling on the pool capacity; a rung beyond it
                        raises :class:`CapacityExhausted` (never silent).
    max_grows_per_step: bound on grow → re-run cycles for one iteration.
    round_to:           capacities round up to a multiple of this.
    """

    growth_factor: float = 2.0
    max_capacity: Optional[int] = None
    max_grows_per_step: int = 16
    round_to: int = 64


def next_rung(old: int, demand: int, factor: float, round_to: int = 1) -> int:
    """Smallest geometric rung ≥ demand (always at least one rung up)."""
    new = max(int(math.ceil(old * factor)), old + 1)
    while new < demand:
        new = int(math.ceil(new * factor))
    return -(-new // round_to) * round_to


class LadderDriverBase:
    """The overflow → grow → re-run loop.

    Subclass contract: ``self._sim`` is the current rung's engine (anything
    with a ``step``), ``_diagnose(stats)`` returns the next rung's config or
    None, and ``_grow(new_cfg, prev_state, iteration)`` rebuilds the engine
    at the new rung and returns the (possibly restaged) pre-step state to
    re-run.
    """

    ladder: "LadderConfig"

    def _iter_of(self, state) -> int:
        """The step index a rewind rewinds to."""
        return int(state.iteration)

    def step(self, state):
        """One iteration with automatic growth.

        The overflowing execution dropped work (newborns, candidate pairs),
        so its output is discarded and the iteration re-runs from its
        pre-step state at the new rung. ``Simulation.step`` leaves its input
        untouched, so ``state`` stays valid; on a growing step the restage
        copies it into the larger rung.
        """
        prev = state
        state = self._sim.step(prev)
        grows = 0
        while True:
            try:
                new_cfg = self._diagnose(state.stats)   # the one host read
            except CapacityExhausted as e:
                # the last-good pre-step state, so a supervisor can
                # checkpoint it and degrade instead of losing the run
                e.state = prev
                e.stats = state.stats
                e.iteration = self._iter_of(prev)
                raise
            if new_cfg is None:
                return state
            grows += 1
            if grows > self.ladder.max_grows_per_step:
                raise RuntimeError(
                    f"iteration {self._iter_of(prev)}: still overflowing "
                    f"after {grows - 1} grows — demand outruns "
                    f"growth_factor={self.ladder.growth_factor}")
            # drop the overflowing output before the restage allocates
            state = None
            prev = self._grow(new_cfg, prev, self._iter_of(prev))
            state = self._sim.step(prev)

    def run(self, state, n_iterations: int,
            callback: Callable | None = None):
        for i in range(n_iterations):
            state = self.step(state)
            if callback is not None:
                callback(i, state)
        return state

    def _log_rungs(self, iteration: int, triples) -> None:
        """Record the (field, old, new) growth events and count the
        restage."""
        for field, old, new in triples:
            if old != new:
                self.rungs.append({"iteration": iteration, "field": field,
                                   "old": old, "new": new})
        self.recompiles += 1


class CapacityLadder(LadderDriverBase):
    """``Simulation.run`` with automatic capacity growth.

    The paper's pool allocator lets a population grow without per-agent
    allocation; here the pool is a ladder of fixed-shape rungs. After each
    step the driver reads the never-silent overflow flags; when one fires
    it grows the affected capacity geometrically, restages the pool into
    the larger shape, builds the Simulation of the new rung and re-runs the
    very iteration that overflowed from its pre-step state. The rewind
    makes the trajectory equal, bit for bit, to a run pre-sized at the
    final rung.

    Which knob grows is read off the stats:

      birth_overflow → ``capacity``            (target: capacity_demand)
      box_overflow   → ``max_per_run``         (target: box_demand)
                       ``max_per_box``         (hash grid: ⌈box_demand / 4⌉)
      pair_overflow  → ``pairlist.max_pairs``  (target: pair_demand)

    Growth events are recorded in ``self.rungs``. ``self.recompiles`` keeps
    the reference's name, where each rung costs a jit compile; the port
    compiles nothing, and the count is of rung changes, each of which
    builds the new rung's Simulation and restages what the rung resizes.
    ``device=None`` means the CUDA card and raises without one.
    """

    def __init__(self, config: EngineConfig, behaviors: Sequence[Behavior] = (),
                 ladder: LadderConfig | None = None,
                 device: DeviceLike = None):
        self.ladder = ladder or LadderConfig()
        self.behaviors = list(behaviors)
        self.config = config
        self.rungs: List[Dict] = []
        self.recompiles = 0
        self._sim = Simulation(config, self.behaviors, device=device)
        self.device = self._sim.device

    @property
    def sim(self) -> Simulation:
        """The current rung's Simulation (rebuilt at every grow)."""
        return self._sim

    def init_state(self, *args, **kwargs) -> EngineState:
        return self._sim.init_state(*args, **kwargs)

    # -- growth policy -------------------------------------------------------
    _READ = ("pair_overflow", "pair_demand", "box_overflow", "box_demand",
             "birth_overflow", "capacity_demand")

    def _diagnose(self, stats: StepStats) -> Optional[EngineConfig]:
        """The next rung's config for the overflow in ``stats`` (None: no
        grow). Every flag and demand comes over in one host transfer."""
        v = dict(zip(self._READ, torch.stack(
            [stats[f].reshape(()).to(torch.int64) for f in self._READ]
        ).tolist()))
        cfg, lad = self.config, self.ladder
        changes: Dict = {}
        if v["pair_overflow"]:
            changes["pairlist"] = dataclasses.replace(
                cfg.pairlist,
                max_pairs=next_rung(cfg.pairlist.max_pairs, v["pair_demand"],
                                    lad.growth_factor))
        if v["box_overflow"]:
            if cfg.environment == "hash_grid":
                # the probe gathers HASH_K_MULT × max_per_box a bucket
                need = -(-v["box_demand"] // grid_mod.HASH_K_MULT)
                changes["max_per_box"] = next_rung(
                    cfg.max_per_box, need, lad.growth_factor)
            else:
                changes["max_per_run"] = next_rung(
                    cfg.grid_spec.run_capacity, v["box_demand"],
                    lad.growth_factor)
        if v["birth_overflow"]:
            demand = v["capacity_demand"]
            new_cap = next_rung(cfg.capacity, demand, lad.growth_factor,
                                lad.round_to)
            if lad.max_capacity is not None and new_cap > lad.max_capacity:
                raise CapacityExhausted(
                    f"capacity ladder exhausted: demand {demand} needs rung "
                    f"{new_cap} > max_capacity={lad.max_capacity}",
                    demand=demand, rung=new_cap,
                    max_capacity=lad.max_capacity)
            changes["capacity"] = new_cap
        if not changes:
            return None
        return dataclasses.replace(cfg, **changes)

    def _grow(self, new_cfg: EngineConfig, prev: EngineState,
              iteration: int) -> EngineState:
        rungs = [(f, getattr(self.config, f), getattr(new_cfg, f))
                 for f in ("capacity", "max_per_box", "max_per_run")]
        if new_cfg.pairlist is not None and self.config.pairlist is not None:
            rungs.append(("max_pairs", self.config.pairlist.max_pairs,
                          new_cfg.pairlist.max_pairs))
        self._log_rungs(iteration, rungs)
        old_cfg, self.config = self.config, new_cfg
        self._sim = Simulation(new_cfg, self.behaviors, device=self.device)
        cap_grew = new_cfg.capacity != prev.pool.capacity
        pairs_grew = (new_cfg.pairlist is not None
                      and old_cfg.pairlist is not None
                      and (cap_grew or new_cfg.pairlist.max_pairs
                           != old_cfg.pairlist.max_pairs))
        if cap_grew or pairs_grew:
            env = prev.env
            if env is not None:
                # the rewound step re-runs with this cache: grown as a
                # pre-sized build would have laid it out, so the grown
                # trajectory stays bit-identical
                if cap_grew:
                    env = dataclasses.replace(
                        env, grid=grid_mod.grow_grid_state(env.grid,
                                                           new_cfg.capacity))
                if pairs_grew and env.pairs is not None:
                    env = dataclasses.replace(
                        env, pairs=grid_mod.grow_pairlist(
                            env.pairs, new_cfg.capacity,
                            new_cfg.pairlist.max_pairs))
            pool = (compaction.grow_pool(prev.pool, new_cfg.capacity)
                    if cap_grew else prev.pool)
            prev = dataclasses.replace(prev, pool=pool, env=env)
        return prev
