"""Ensemble engine — one device steps L independent simulations together
(port of ``repro.core.ensemble``).

Users of the simulation run sweeps — calibration, uncertainty
quantification, epidemic what-ifs — whose members are small: hundreds of
lanes of a few hundred agents. The reference vmaps its iteration core over
a lane axis so one program advances every member. PyTorch's ``vmap``
cannot trace the core's data-dependent shapes, so the port carries the
lane axis itself: L lanes of C slots are one lane-major pool of L·C slots
(:mod:`lanes`), and ``make_iteration_core(..., n_lanes=L)`` steps them all
in one pass whose operations do not grow with L (K1 and its column map
launch once a tick for every lane).

* **Per-lane everything.** RNG keys (L, 2), ``ScenarioParams`` leaves (L,),
  iteration counters and ``StepStats`` are per lane. Lane ``l``'s
  trajectory equals, bit for bit, a solo :class:`~.engine.Simulation` run
  with the same seed and params (tests/test_torch_ensemble.py).
* **Lane masking.** ``active`` (L,) bool: inactive lanes ride through the
  step, but every write is undone with ``torch.where`` and their stats
  are zeroed, so a retired lane holds its final state bit for bit until an
  admit overwrites it.
* **Shared-rung ladder.** Capacity knobs are shared by every lane;
  :class:`EnsembleCapacityLadder` sizes the next rung from the worst lane
  and re-runs the overflowing tick at the new rung, bit-identical to a
  pre-sized ensemble.

* **Per-lane caches.** Under every_k each lane carries its own rebuild
  cache, pair list and counters; one host read a tick fetches the (L,)
  rebuild flags, and a tick whose lanes disagree builds every lane and
  keeps each lane's choice. A lane's diffusion grid, static flags and
  force overrides are its own too.
* **Every environment.** The scatter and hash grids build L tables at
  once, each lane's boxes or buckets its own, and brute force offers a
  query its own lane's C slots; the periodic Morton sort orders each
  lane on that lane's iterations.

In memory a lane's channels are rows ``[l·C, (l+1)·C)`` of the pool and
its cache is the lane-major :class:`~.grid.RebuildState`; checkpoints and
:mod:`convert` present both as the reference's ``(L, C, ...)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, List, Optional, Sequence

import torch

from . import grid as grid_mod
from .agents import AgentPool
from .behaviors import Behavior
from .engine import (CapacityExhausted, EngineConfig, EngineState,
                     LadderConfig, LadderDriverBase, ScenarioParams,
                     Simulation, make_iteration_core, next_rung)
from .lanes import Lanes
from .stats import StepStats
from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class EnsembleState:
    """State of L lanes stepping together, the reference's fields. The pool
    is lane-major (L·C rows); every other per-lane leaf has a leading (L,)
    axis. ``tick`` counts ensemble steps; a lane's ``iteration`` advances
    only while it is active, so it matches the solo run the lane
    reproduces."""

    pool: AgentPool                      # channels (L·C, ...), lane-major
    conc: torch.Tensor                   # (L, ...) diffusion grids
    rng: torch.Tensor                    # (L, 2) int64 holding uint32 keys
    iteration: torch.Tensor              # (L,) int32
    stats: StepStats                     # (L,) per lane
    active: torch.Tensor                 # (L,) bool
    params: Optional[ScenarioParams]     # leaves (L, ...)
    tick: torch.Tensor                   # () int32
    env: Optional[grid_mod.RebuildState] = None   # lane-major caches

    @property
    def n_lanes(self) -> int:
        return self.active.shape[0]


def make_ensemble_core(config: EngineConfig,
                       behaviors: Sequence[Behavior] = (), n_lanes: int = 1,
                       device: DeviceLike = None):
    """The iteration core over ``n_lanes`` lanes, with lane masking.

    Returns ``ecore(pool, conc, rng, iteration, active, env=None,
    params=None) -> (pool, conc, rng, stats, env)``: ``pool`` and ``env``
    lane-major, every other argument and result with a leading (L,) axis.
    Lanes with ``active`` False are frozen — their state and cache pass
    through unchanged and their stats are zero — so a retired lane can
    neither drift nor trip the ladder.
    """
    dev = resolve_device(device)
    core = make_iteration_core(config, behaviors, dev, n_lanes)
    ln = Lanes(n_lanes, config.capacity)

    def ecore(pool: AgentPool, conc: torch.Tensor, rng: torch.Tensor,
              iteration: torch.Tensor, active: torch.Tensor,
              env: Optional[grid_mod.RebuildState] = None,
              params: Optional[ScenarioParams] = None):
        if ln.solo:      # the solo core itself, on lane 0's leaves
            one = None if params is None else params.map(lambda t: t[0])
            npool, nconc, nrng, stats, nenv = core(pool, conc[0], rng[0],
                                                   iteration[0], env, one)
            nconc, nrng = nconc[None], nrng[None]
            stats = StepStats(**{f: v.reshape(1) for f, v in stats.items()})
            # one lane: its cache has the solo cache's () leaves
            freeze = functools.partial(torch.where, active[0])
        else:
            npool, nconc, nrng, stats, nenv = core(
                pool, conc, rng, iteration, env, params, active=active)
            freeze = ln.selector(active)

        old = pool.channels()
        pool = npool.with_channels({k: freeze(v, old[k])
                                    for k, v in npool.channels().items()})
        conc = freeze(nconc, conc)
        rng = freeze(nrng, rng)
        if env is not None:
            env = grid_mod.map_rebuild_state(freeze, nenv, env)
        zero = torch.zeros((), dtype=torch.int32, device=active.device)
        stats = StepStats(**{f: torch.where(active, v, zero)
                             for f, v in stats.items()})
        return pool, conc, rng, stats, env

    return ecore


def grow_stacked_pool(pool: AgentPool, new_capacity: int,
                      n_lanes: int) -> AgentPool:
    """Grow every lane of a lane-major pool to ``new_capacity`` slots.

    The counterpart of ``compaction.grow_channels`` for lanes: each lane's
    slots ``[C, new_capacity)`` are zero-filled (dead), as the tail of a
    freshly staged pool, so the ladder's rewound trajectory matches a
    pre-sized ensemble bit for bit. The lanes are re-strided: lane ``l``
    moves to ``[l·new_capacity, ...)``."""
    old = pool.capacity // n_lanes
    if new_capacity < old:
        raise ValueError(f"cannot shrink pool {old} -> {new_capacity}")
    if new_capacity == old:
        return pool
    ch = {}
    for k, v in pool.channels().items():
        g = torch.zeros((n_lanes, new_capacity, *v.shape[1:]), dtype=v.dtype,
                        device=v.device)
        g[:, :old] = v.reshape(n_lanes, old, *v.shape[1:])
        ch[k] = g.reshape(n_lanes * new_capacity, *v.shape[1:])
    return pool.with_channels(ch)


def _check_params(params: Optional[ScenarioParams],
                  template: Optional[ScenarioParams]) -> None:
    def keys(p):
        return (p.dt is None, tuple(sorted(p.force)), tuple(sorted(p.rates)))
    if (params is None) != (template is None) or (
            params is not None and keys(params) != keys(template)):
        raise ValueError(
            "admit params must match the engine's params_template "
            f"(template {'set' if template is not None else 'None'}, "
            f"got {'params' if params is not None else 'None'})")


class EnsembleEngine:
    """L lanes of one EngineConfig: the lockstep step and lane IO.

    ``params_template`` fixes the per-lane :class:`ScenarioParams`
    structure (its key sets); pass e.g. ``ScenarioParams.of(beta=0.0)`` and
    every admit supplies one of the same structure. ``None``: no per-lane
    knobs (lanes share the static config; seeds still differ). ``device``:
    None means the CUDA card and raises without one.

    ``admit`` and ``retire`` write the lane's segment of the state's
    tensors in place (no host read; an every_k cache is replaced by one
    holding the admitted lane's) and return the state; ``read_lane``
    returns copies, which later writes leave alone.
    """

    def __init__(self, config: EngineConfig,
                 behaviors: Sequence[Behavior] = (), n_lanes: int = 1,
                 params_template: Optional[ScenarioParams] = None,
                 device: DeviceLike = None):
        if n_lanes < 1:
            raise ValueError(f"n_lanes must be >= 1, got {n_lanes}")
        self.config = config
        self.behaviors = list(behaviors)
        self.n_lanes = n_lanes
        self.params_template = params_template
        self._solo = Simulation(config, self.behaviors, device=device)
        self.device = self._solo.device
        self._core = make_ensemble_core(config, self.behaviors, n_lanes,
                                        self.device)
        self._lanes = Lanes(n_lanes, config.capacity)

    @property
    def capacity(self) -> int:
        return self.config.capacity

    # -- lane staging --------------------------------------------------------
    def stage_lane(self, position, diameter=None, agent_type=None,
                   extra_init: Optional[Dict] = None,
                   seed: int = 0) -> EngineState:
        """A solo initial state, ready to admit into a lane."""
        return self._solo.init_state(position, diameter, agent_type,
                                     extra_init, seed=seed)

    def blank_lane(self) -> EngineState:
        """An idle lane: an empty pool (no live agents), a fresh dirty
        cache under every_k."""
        return self._solo.init_state(torch.zeros((0, 3)))

    def init_state(self) -> EnsembleState:
        """All-idle ensemble: every lane blank and inactive."""
        n = self.n_lanes
        lane = self.blank_lane()
        rep = lambda t: t[None].expand(n, *t.shape).clone()  # noqa: E731
        params = None
        if self.params_template is not None:
            params = self.params_template.to(self.device).map(rep)
        env = lane.env
        if env is not None and n > 1:
            env = grid_mod.flatten_rebuild_state(
                grid_mod.map_rebuild_state(rep, env))
        return EnsembleState(
            pool=lane.pool.with_channels({
                k: v.repeat(n, *(1,) * (v.dim() - 1))
                for k, v in lane.pool.channels().items()}),
            conc=rep(lane.conc), rng=rep(lane.rng),
            iteration=torch.zeros((n,), dtype=torch.int32,
                                  device=self.device),
            stats=StepStats.zeros(self.device, (n,)),
            active=torch.zeros((n,), dtype=torch.bool, device=self.device),
            params=params,
            tick=torch.zeros((), dtype=torch.int32, device=self.device),
            env=env)

    # -- the lockstep iteration ---------------------------------------------
    def step(self, state: EnsembleState) -> EnsembleState:
        """Advance every active lane one iteration (one pass for all)."""
        pool, conc, rng, stats, env = self._core(
            state.pool, state.conc, state.rng, state.iteration,
            state.active, state.env, state.params)
        return EnsembleState(
            pool=pool, conc=conc, rng=rng,
            iteration=torch.where(state.active, state.iteration + 1,
                                  state.iteration),
            stats=stats, active=state.active, params=state.params,
            tick=state.tick + 1, env=env)

    # -- lane admit / retire / read ------------------------------------------
    def _segment(self, lane: int) -> slice:
        if not 0 <= lane < self.n_lanes:
            raise IndexError(f"lane {lane} outside [0, {self.n_lanes})")
        c = self.capacity
        return slice(lane * c, (lane + 1) * c)

    def admit(self, state: EnsembleState, lane: int, lane_state: EngineState,
              params: Optional[ScenarioParams] = None) -> EnsembleState:
        """Write a solo state into lane ``lane`` and mark it active. Its
        cache comes with it: a staged lane's is fresh and dirty, so its
        first tick rebuilds."""
        _check_params(params, self.params_template)
        lane = int(lane)
        seg = self._segment(lane)
        src = lane_state.pool.channels()
        for k, v in state.pool.channels().items():
            v[seg].copy_(src[k])
        state.conc[lane].copy_(lane_state.conc)
        state.rng[lane].copy_(lane_state.rng)
        state.iteration[lane].copy_(lane_state.iteration)
        if state.env is not None:
            state.env = (grid_mod.map_rebuild_state(torch.clone,
                                                    lane_state.env)
                         if self.n_lanes == 1 else
                         grid_mod.with_lane_rebuild_state(
                             state.env, self._lanes, lane, lane_state.env))
        state.active[lane] = True
        if params is not None:
            new = params.to(self.device)
            for dst, val in ((state.params.dt, new.dt),
                             *((state.params.force[k], new.force[k])
                               for k in new.force),
                             *((state.params.rates[k], new.rates[k])
                               for k in new.rates)):
                if dst is not None:
                    dst[lane].copy_(val)
        return state

    def retire(self, state: EnsembleState, lane: int) -> EnsembleState:
        """Deactivate lane ``lane``: its state freezes (readable until the
        next admit overwrites it)."""
        self._segment(int(lane))
        state.active[int(lane)] = False
        return state

    def read_lane(self, state: EnsembleState, lane: int) -> EngineState:
        """Lane ``lane``'s state as a solo EngineState (copies, on the
        device), its cache included."""
        seg = self._segment(int(lane))
        env = state.env
        if env is not None:
            env = (grid_mod.map_rebuild_state(torch.clone, env)
                   if self.n_lanes == 1 else grid_mod.lane_rebuild_state(
                       env, self._lanes, int(lane)))
        return EngineState(
            env=env, pool=state.pool.with_channels({
                k: v[seg].clone() for k, v in state.pool.channels().items()}),
            conc=state.conc[lane].clone(), rng=state.rng[lane].clone(),
            iteration=state.iteration[lane].clone(),
            stats=StepStats(**{f: v[lane].clone()
                               for f, v in state.stats.items()}))


class EnsembleCapacityLadder(LadderDriverBase):
    """Capacity ladder over an ensemble: shared rungs, worst-lane demand.

    One step serves every lane, so capacity knobs cannot differ per lane:
    the next rung is sized from the largest per-lane demand, read with the
    flags in one host transfer a tick, and the overflowing tick re-runs
    from its pre-step state at the new rung. The overflowing execution
    dropped work, so discarding its output keeps every lane bit-identical
    to a pre-sized ensemble.
    """

    def __init__(self, config: EngineConfig,
                 behaviors: Sequence[Behavior] = (), n_lanes: int = 1,
                 params_template: Optional[ScenarioParams] = None,
                 ladder: Optional[LadderConfig] = None,
                 device: DeviceLike = None):
        self.ladder = ladder or LadderConfig()
        self.behaviors = list(behaviors)
        self.config = config
        self.n_lanes = n_lanes
        self.params_template = params_template
        self.rungs: List[Dict] = []
        self.recompiles = 0
        self._sim = EnsembleEngine(config, self.behaviors, n_lanes,
                                   params_template, device=device)
        self.device = self._sim.device

    @property
    def engine(self) -> EnsembleEngine:
        """The current rung's EnsembleEngine (rebuilt at every grow)."""
        return self._sim

    def init_state(self) -> EnsembleState:
        return self._sim.init_state()

    def _iter_of(self, state: EnsembleState) -> int:
        return int(state.tick)

    # -- growth policy -------------------------------------------------------
    _TOTAL = ("pair_overflow", "box_overflow", "birth_overflow")
    _PEAK = ("pair_demand", "box_demand", "capacity_demand")

    def _diagnose(self, stats: StepStats) -> Optional[EngineConfig]:
        """The next rung's config for the worst lane (None: no grow); the
        lanes' flags summed and demands maxed, in one host transfer."""
        v = dict(zip(self._TOTAL + self._PEAK, torch.stack(
            [stats[f].to(torch.int64).sum() for f in self._TOTAL]
            + [stats[f].to(torch.int64).max() for f in self._PEAK]
        ).tolist()))
        cfg, lad = self.config, self.ladder
        changes: Dict = {}
        if v["pair_overflow"]:
            changes["pairlist"] = dataclasses.replace(
                cfg.pairlist, max_pairs=next_rung(
                    cfg.pairlist.max_pairs, v["pair_demand"],
                    lad.growth_factor))
        if v["box_overflow"]:
            demand = v["box_demand"]
            if cfg.environment == "hash_grid":
                need = -(-demand // grid_mod.HASH_K_MULT)
                changes["max_per_box"] = next_rung(
                    cfg.max_per_box, need, lad.growth_factor)
            else:
                changes["max_per_run"] = next_rung(
                    cfg.grid_spec.run_capacity, demand, lad.growth_factor)
        if v["birth_overflow"]:
            demand = v["capacity_demand"]
            new_cap = next_rung(cfg.capacity, demand, lad.growth_factor,
                                lad.round_to)
            if lad.max_capacity is not None and new_cap > lad.max_capacity:
                raise CapacityExhausted(
                    f"ensemble capacity ladder exhausted: worst-lane demand "
                    f"{demand} needs rung {new_cap} > "
                    f"max_capacity={lad.max_capacity}", demand=demand,
                    rung=new_cap, max_capacity=lad.max_capacity)
            changes["capacity"] = new_cap
        if not changes:
            return None
        return dataclasses.replace(cfg, **changes)

    def _grow(self, new_cfg: EngineConfig, prev: EnsembleState,
              iteration: int) -> EnsembleState:
        rungs = [(f, getattr(self.config, f), getattr(new_cfg, f))
                 for f in ("capacity", "max_per_box", "max_per_run")]
        if new_cfg.pairlist is not None and self.config.pairlist is not None:
            rungs.append(("max_pairs", self.config.pairlist.max_pairs,
                          new_cfg.pairlist.max_pairs))
        self._log_rungs(iteration, rungs)
        old_cfg, self.config = self.config, new_cfg
        self._sim = EnsembleEngine(new_cfg, self.behaviors, self.n_lanes,
                                   self.params_template, device=self.device)
        cap_grew = new_cfg.capacity != old_cfg.capacity
        pairs_grew = (new_cfg.pairlist is not None
                      and old_cfg.pairlist is not None
                      and (cap_grew or new_cfg.pairlist.max_pairs
                           != old_cfg.pairlist.max_pairs))
        if cap_grew or pairs_grew:
            env = prev.env
            if env is not None:
                # every lane's cache grown as L pre-sized builds would have
                # laid it out, so the grown trajectory stays bit-identical
                old_lanes = Lanes(self.n_lanes, old_cfg.capacity)
                if cap_grew:
                    env = dataclasses.replace(
                        env, grid=grid_mod.grow_grid_state(
                            env.grid, new_cfg.capacity, old_lanes))
                if pairs_grew and env.pairs is not None:
                    env = dataclasses.replace(
                        env, pairs=grid_mod.grow_pairlist(
                            env.pairs, new_cfg.capacity,
                            new_cfg.pairlist.max_pairs, old_lanes))
            pool = (grow_stacked_pool(prev.pool, new_cfg.capacity,
                                      self.n_lanes)
                    if cap_grew else prev.pool)
            prev = dataclasses.replace(prev, pool=pool, env=env)
        return prev
