"""Simulation engine — one Algorithm-1 iteration per step (port of the
main-path slice of ``repro.core.engine``).

An iteration: resident grid build (one stable key sort permutes the pool
into grid order and compacts the dead) → K1 collision forces over the
block-sparse column map → overdamped integration → behaviors → health
watchdog → death compaction and birth commit → statistics.

PyTorch runs eagerly, so the step is plain Python over tensors on one
device; it never reads a device value on the host (no synchronisation)
except where ``run(check_overflow=True)`` reads the flags.

This slice runs ``environment="uniform_grid"`` with every-step rebuilds,
no pair list, no static detection, no diffusion and the float32 dtype
policy, with forces from K1 (``force_impl="k1"``). Every other option raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from . import compaction, forces as force_mod, grid as grid_mod, rand
from . import health as health_mod
from .agents import AgentPool, DtypePolicy, make_pool
from .behaviors import Behavior
from .stats import StepStats
from ..device import DeviceLike, resolve_device

# "xla" is the reference's name for the streamed fused sweep
FORCE_IMPLS = ("k1", "streamed", "xla")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static engine configuration; the reference's fields and checks.

    ``force_impl``: ``"k1"`` (default) computes forces with the K1 kernel —
    the hand-written CUDA kernel on the card, its plain version on the CPU.
    ``"streamed"``, the counterpart of the reference's XLA fused sweep, is a
    later slice.
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
    force_impl: str = "k1"
    max_per_box: int = 16
    max_per_run: Optional[int] = None
    query_chunk: int = 2048
    adhesion: Optional[Tuple[Tuple[float, ...], ...]] = None
    force: force_mod.ForceParams = dataclasses.field(
        default_factory=force_mod.ForceParams)
    diffusion: Optional[Any] = None
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
    conc: torch.Tensor              # diffusion grid ((1,1,1) dummy)
    rng: torch.Tensor               # (2,) int64 holding a uint32 key
    iteration: torch.Tensor         # () int32
    stats: StepStats
    env: Optional[Any] = None       # cached build (every_k; later slice)


@dataclasses.dataclass
class StepContext:
    """What behaviors may read during one iteration."""
    config: EngineConfig
    dt: float
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
              origin: torch.Tensor, box_size: float) -> grid_mod.BuildResult:
    """The iteration's grid build (resident: the pool comes back permuted)."""
    if cfg.environment != "uniform_grid":
        raise NotImplementedError(
            f"environment {cfg.environment!r} is not ported yet (ROADMAP.md "
            f"Queue 1 item 12)")
    builder = grid_mod.make_builder(spec, method="resident",
                                    sort_impl=cfg.sort_impl)
    return builder(pool, origin, box_size)


def _check_slice(cfg: EngineConfig, behaviors: Sequence[Behavior]) -> None:
    """Raise NotImplementedError for every option this slice does not run."""
    todo = []
    if cfg.environment != "uniform_grid":
        todo.append(f"environment={cfg.environment!r} (item 12)")
    if cfg.force_impl != "k1":
        todo.append(f"force_impl={cfg.force_impl!r}: the streamed fused "
                    f"sweep (item 6)")
    if cfg.rebuild.mode != "every_step":
        todo.append("rebuild.mode='every_k' (item 11)")
    if cfg.pairlist is not None:
        todo.append("pairlist (item 11)")
    if cfg.detect_static:
        todo.append("detect_static (item 10, core/statics.py)")
    if cfg.diffusion is not None:
        todo.append("diffusion (item 10)")
    kernels = [b.name for b in behaviors if b.neighbor_kernels()]
    if kernels:
        todo.append(f"behaviors with neighbor kernels {kernels} (items 6 "
                    f"and 10)")
    if todo:
        raise NotImplementedError(
            "not ported yet (ROADMAP.md Queue 1): " + "; ".join(todo))


def _no_neighbor_apply(*args, **kwargs):
    raise NotImplementedError("ctx.neighbor_apply (the streamed resident "
                              "sweep) is not ported yet (ROADMAP.md Queue 1 "
                              "item 6)")


def make_iteration_core(cfg: EngineConfig, behaviors: Sequence[Behavior],
                        device: torch.device):
    """The Algorithm-1 iteration body for this slice.

    Returns ``core(pool, conc, rng, it, env=None) -> (pool, conc, rng,
    StepStats, env)`` over tensors on ``device``.
    """
    behaviors = list(behaviors)
    _check_slice(cfg, behaviors)
    spec = cfg.grid_spec
    box_size = cfg.cell_size
    dlo = torch.tensor(cfg.domain_lo, dtype=torch.float32, device=device)
    dhi = torch.tensor(cfg.domain_hi, dtype=torch.float32, device=device)
    origin = dlo
    adhesion = (torch.tensor(cfg.adhesion, dtype=torch.float32, device=device)
                if cfg.adhesion is not None else None)
    fp = cfg.force

    def zeros_i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    def core(pool: AgentPool, conc: torch.Tensor, rng: torch.Tensor,
             it: torch.Tensor, env=None):
        keys = rand.split(rng, 2 + len(behaviors))
        rng, bkeys = keys[0], keys[2:]           # keys[1]: the force key
        stats = StepStats.zeros(device)
        dt = cfg.dt

        # ---------------- pre standalone ops: resident build ----------------
        with record_function("step/grid_build"):
            res = build_env(cfg, spec, pool, origin, box_size)
        pool, grid_env = res.pool, res.grid
        # query exactness bound: every 3-box z-run must fit run_capacity
        box_demand = grid_env.max_run_count.to(torch.int32)
        box_overflow = (grid_env.max_run_count
                        > spec.run_capacity).to(torch.int32)

        owned_alive = pool.alive
        pos0 = pool.position
        dia0 = pool.diameter

        # ---------------- agent ops: forces (K1) ----------------
        active = owned_alive if cfg.use_forces else None
        force_arr = None
        if cfg.use_forces:
            from ..kernels import ops as kops
            with record_function("step/forces"):
                f, nnz, ovf = kops.collision_force_resident(
                    pool.position, pool.diameter, pool.agent_type,
                    pool.alive, active, grid_env.starts, grid_env.counts,
                    origin, box_size, dims=spec.dims, k_rep=fp.k_rep,
                    adhesion=adhesion, adhesion_band=fp.adhesion_band)
            # a column-map overflow means possibly-missed pairs: the same
            # never-silent flag as a run overflow
            box_overflow = torch.maximum(box_overflow, ovf.to(torch.int32))
            force_arr = f
            with record_function("step/integrate"):
                dx = force_mod.displacement(f, fp, dt)
                new_pos = torch.clamp(pool.position + dx, min=dlo, max=dhi)
                new_pos = torch.where(active[:, None], new_pos,
                                      pool.position)
                force_nnz = torch.where(active, nnz, pool.force_nnz)
            pool = dataclasses.replace(pool, position=new_pos,
                                       force_nnz=force_nnz)

        # ---------------- agent ops: behaviors ----------------
        ctx = StepContext(
            config=cfg, dt=dt, domain_lo=dlo, domain_hi=dhi, iteration=it,
            owned=owned_alive, neighbor_apply=_no_neighbor_apply,
            substance_gradient=torch.zeros_like,
            substance_value=lambda p: torch.zeros(p.shape[:-1],
                                                  device=p.device))
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

        # bookkeeping for static detection (a later slice reads it)
        move_d = pool.position - pos0
        moved = (move_d * move_d).sum(-1) > fp.move_eps ** 2
        grew = pool.diameter > dia0 + 1e-12
        pool = dataclasses.replace(pool, moved=moved & pool.alive,
                                   grew=grew & pool.alive)

        # ---------------- health watchdog ----------------
        health = stats.health
        if cfg.health is not None and cfg.health.any_enabled:
            health = health_mod.step_health(
                cfg.health, pool.alive, pool.position, dlo, dhi,
                force=force_arr, move_d=move_d)

        # ---------------- post standalone ops: commit ----------------
        deaths = zeros_i32()
        if death_mask is not None:
            death_mask = death_mask & pool.alive
            deaths = death_mask.sum(dtype=torch.int32)
            pool = dataclasses.replace(pool, alive=pool.alive & ~death_mask)
        # force-computed agents still alive at iteration end
        n_active = ((active & pool.alive).sum(dtype=torch.int32)
                    if active is not None
                    else pool.alive.sum(dtype=torch.int32))
        if death_mask is not None:
            # the build left the live agents in front, so with no deaths
            # this permutation is the identity: compacting unconditionally
            # equals the reference's `cond(deaths > 0, compact)` without a
            # host read of `deaths`
            pool = compaction.compact(pool)

        births = zeros_i32()
        birth_overflow = zeros_i32()
        for q, valid in birth_queues:
            with record_function("step/commit_births"):
                birth_overflow = birth_overflow + compaction.birth_overflow(
                    pool, valid)
                births = births + valid.sum(dtype=torch.int32)
                pool = compaction.commit_births(pool, q, valid, it)

        n_live_end = pool.alive.sum(dtype=torch.int32)
        stats = dataclasses.replace(
            stats, n_live=n_live_end, n_active=n_active, births=births,
            deaths=deaths, box_overflow=box_overflow,
            birth_overflow=birth_overflow, box_demand=box_demand,
            capacity_demand=n_live_end + birth_overflow,
            rebuilds=torch.ones((), dtype=torch.int32, device=device),
            health=health)
        return pool, conc, rng, stats, env

    return core


def stage_pool(capacity: int, behaviors: Sequence[Behavior], position,
               diameter=None, agent_type=None,
               extra_init: Dict[str, Any] | None = None,
               extra_specs: Dict[str, tuple] | None = None,
               policy: DtypePolicy | None = None,
               device: torch.device | str = "cpu") -> AgentPool:
    """Initial pool with every behavior's extra channels."""
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
        return EngineState(
            pool=pool,
            conc=torch.zeros((1, 1, 1), dtype=torch.float32,
                             device=self.device),
            rng=rand.prng_key(seed, self.device),
            iteration=torch.zeros((), dtype=torch.int32, device=self.device),
            stats=StepStats.zeros(self.device))

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
                    raise RuntimeError(
                        f"iteration {i}: grid run overflow (a 3-box z-run "
                        f"holds > {self.spec.run_capacity} agents); raise "
                        f"EngineConfig.max_per_run / max_per_box")
                if "birth_overflow" in flags:
                    raise RuntimeError(
                        f"iteration {i}: birth overflow; raise "
                        f"EngineConfig.capacity")
            if callback is not None:
                callback(i, state)
        return state
