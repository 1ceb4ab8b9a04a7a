"""Simulation checkpoint/resume and the supervised run loop (port of
``repro.core.simcheck``, its single-device part).

* :func:`save_state` / :func:`restore_state` — the complete run state
  (pool channels, RNG key, every_k cache, step index, stats) as one
  checkpoint in the reference's format (``train/checkpoint.py``), with the
  rung and degradation knobs in the manifest, so the resuming process
  builds the same step. The step is deterministic, so a resumed run
  replays the uninterrupted trajectory bit for bit. A checkpoint written
  by either package restores in the other.
* :class:`SupervisedRunner` — checkpoints every ``checkpoint_every``
  steps, reads the step's health bitmask, and on a health fault or
  :class:`CapacityExhausted` rolls back to the last checkpoint and retries
  under a :class:`DegradationPolicy`. Every intervention lands in a
  :class:`RunReport`.

* :func:`save_ensemble_state` / :func:`restore_ensemble_state` — a whole
  ensemble (every lane, the active mask, per-lane params, the tick) in the
  reference's format, lanes stored ``(L, C, ...)`` whatever the port's
  lane-major layout in memory, so an ensemble checkpoint crosses between
  the packages both ways.

* :func:`save_dist_state` / :func:`restore_dist_state` — a distributed
  run (every shard's slab, keys, boundaries and caches) in the reference's
  format, the caches stored ``(n_shards, ...)``; a restore onto another
  shard count re-partitions the live agents. Over a process group the
  ranks gather the whole run and rank 0 writes it, so the file does not
  depend on the rank count: every rank of any group (or one device)
  restores it and keeps its block. The supervisor drives a
  :class:`DistributedCapacityLadder` as it drives a single-device one,
  over a group too.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from ..train import checkpoint as ckpt_mod
from . import grid as grid_mod, rand
from .behaviors import Behavior
from .compaction import repack_slabs
from .distributed import (OWNED, DistConfig, DistributedCapacityLadder,
                          DistributedSimulation, DistState, block_state,
                          gather_state, initial_dist_env, partition_global,
                          quantile_boundaries, rank_device, shard_axis,
                          shard_keys)
from .engine import (CapacityExhausted, CapacityLadder, EngineConfig,
                     EngineState, ScenarioParams, Simulation, stage_pool)
from .ensemble import EnsembleEngine, EnsembleState
from .health import HealthFault, describe
from .lanes import Lanes
from .stats import StepStats

_FORMAT = 1            # manifest extras schema version

# force_impl as the reference's knobs name it, and back
_REF_FORCE_IMPL = {"k1": "pallas", "streamed": "xla", "xla": "xla"}
_PORT_FORCE_IMPL = {"pallas": "k1", "xla": "xla"}


# ---------------------------------------------------------------------------
# Knob snapshots — what the arrays alone cannot carry
# ---------------------------------------------------------------------------

def _engine_knobs(cfg: EngineConfig) -> Dict:
    """The knobs a resume must reproduce: rung sizes (shapes depend on
    them) and the degradation knobs (the trajectory depends on them)."""
    return {"capacity": cfg.capacity,
            "max_per_box": cfg.max_per_box,
            "max_per_run": cfg.max_per_run,
            "dt": cfg.dt,
            "fused_sweep": cfg.fused_sweep,
            "force_impl": _REF_FORCE_IMPL[cfg.force_impl],
            "rebuild": {"mode": cfg.rebuild.mode, "k": cfg.rebuild.k,
                        "displacement_bound": cfg.rebuild.displacement_bound}}


def _apply_engine_knobs(cfg: EngineConfig, knobs: Dict,
                        mode: str) -> EngineConfig:
    """Apply recorded knobs onto ``cfg``.

    mode="all":   rungs and degradation knobs — a plain resume runs the
                  step the checkpoint ran under (bit-exact).
    mode="rungs": rung sizes only — the supervisor's rollback, which keeps
                  its degraded dt/sweep/rebuild knobs.
    """
    if mode not in ("all", "rungs"):
        raise ValueError(f"apply_knobs must be 'all' or 'rungs', got {mode!r}")
    changes: Dict[str, Any] = {k: knobs[k] for k in
                               ("capacity", "max_per_box", "max_per_run")}
    if mode == "all":
        impl = _PORT_FORCE_IMPL[knobs["force_impl"]]
        if impl == "xla" and cfg.force_impl in ("streamed", "xla"):
            impl = cfg.force_impl               # one path, either name
        changes.update(dt=knobs["dt"], fused_sweep=knobs["fused_sweep"],
                       force_impl=impl,
                       rebuild=grid_mod.RebuildPolicy(**knobs["rebuild"]))
    return dataclasses.replace(cfg, **changes)


def _dist_knobs(dcfg: DistConfig) -> Dict:
    return {"n_shards": dcfg.n_shards,
            "local_capacity": dcfg.local_capacity,
            "halo_capacity": dcfg.halo_capacity,
            "migrate_capacity": dcfg.migrate_capacity,
            "rebalance_frequency": dcfg.rebalance_frequency,
            "engine": _engine_knobs(dcfg.engine)}


def _apply_dist_knobs(dcfg: DistConfig, knobs: Dict, mode: str
                      ) -> DistConfig:
    return dataclasses.replace(
        dcfg, engine=_apply_engine_knobs(dcfg.engine, knobs["engine"], mode),
        n_shards=knobs["n_shards"], local_capacity=knobs["local_capacity"],
        halo_capacity=knobs["halo_capacity"],
        migrate_capacity=knobs["migrate_capacity"])


# ---------------------------------------------------------------------------
# Templates — a zero state with the checkpoint's structure and shapes
# ---------------------------------------------------------------------------

def _template_state(cfg: EngineConfig, behaviors: Sequence[Behavior],
                    device: torch.device) -> EngineState:
    """Structural twin of ``Simulation.init_state``'s output."""
    pool = stage_pool(cfg.capacity, list(behaviors),
                      torch.zeros((1, 3), dtype=torch.float32),
                      policy=cfg.dtypes, device=device)
    dspec = cfg.diffusion
    conc = torch.zeros(dspec.dims if dspec else (1, 1, 1),
                       dtype=torch.float32, device=device)
    env = None
    if cfg.rebuild.mode == "every_k":
        env = grid_mod.initial_rebuild_state(
            cfg.grid_spec, cfg.capacity,
            torch.tensor(cfg.domain_lo, dtype=torch.float32, device=device),
            cfg.cell_size, pairlist=cfg.pairlist)
    return EngineState(pool=pool, conc=conc, rng=rand.prng_key(0, device),
                       iteration=torch.zeros((), dtype=torch.int32,
                                             device=device),
                       stats=StepStats.zeros(device), env=env)


def _template_dist_state(dcfg: DistConfig, behaviors: Sequence[Behavior],
                         device: torch.device) -> DistState:
    """Structural twin of ``DistributedSimulation.init_state``'s output."""
    cfg = dcfg.engine
    staging = stage_pool(1, list(behaviors),
                         torch.zeros((1, 3), dtype=torch.float32),
                         extra_specs={OWNED: ((), torch.bool, True)},
                         policy=cfg.dtypes, device=device)
    n = dcfg.n_shards * dcfg.local_capacity
    dspec = cfg.diffusion
    return DistState(
        channels={k: torch.zeros((n, *v.shape[1:]), dtype=v.dtype,
                                 device=device)
                  for k, v in staging.channels().items()},
        conc=torch.zeros(dspec.dims if dspec else (dcfg.n_shards, 1, 1),
                         dtype=torch.float32, device=device),
        rng=torch.zeros((dcfg.n_shards, 2), dtype=torch.int64,
                        device=device),
        boundaries=torch.zeros(dcfg.n_shards + 1, dtype=torch.float32,
                               device=device),
        iteration=torch.zeros((), dtype=torch.int32),
        stats=StepStats.zeros(device, (dcfg.n_shards,)),
        env=initial_dist_env(dcfg, device))


def _adapt_env(state, saved_mode: str, cfg: EngineConfig,
               template_fn: Callable):
    """Reconcile the cache's presence when the target rebuild mode differs
    from the checkpoint's (a supervisor may have degraded every_k to
    every_step)."""
    if (cfg.rebuild.mode == "every_k") == (saved_mode == "every_k"):
        return state
    if cfg.rebuild.mode == "every_step":
        return dataclasses.replace(state, env=None)
    # the target wants a cache the checkpoint lacks: a dirty initial cache,
    # so the first step rebuilds
    return dataclasses.replace(state, env=template_fn().env)


def _stored(state: EngineState) -> EngineState:
    """The state as the reference stores it: the RNG key and the grid keys
    as uint32 (the port holds them in int64)."""
    def u32(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy().astype(np.uint32)
    env = state.env
    if env is not None:
        env = dataclasses.replace(env, grid=dataclasses.replace(
            env.grid, keys=u32(env.grid.keys)))
    return dataclasses.replace(state, rng=u32(state.rng), env=env)


def _meta(cfg: EngineConfig, extras: Optional[Dict]) -> Dict:
    meta = {"format": _FORMAT, "kind": "engine", "knobs": _engine_knobs(cfg)}
    if extras:
        meta.update(extras)
    return meta


# ---------------------------------------------------------------------------
# Single-device save / restore
# ---------------------------------------------------------------------------

def save_state(ckpt_dir: str, state: EngineState, cfg: EngineConfig,
               extras: Optional[Dict] = None) -> str:
    """Atomic checkpoint of a complete single-device run state."""
    return ckpt_mod.save(ckpt_dir, int(state.iteration), _stored(state),
                         extras=_meta(cfg, extras))


def restore_state(ckpt_dir: str, cfg: EngineConfig,
                  behaviors: Sequence[Behavior], step: Optional[int] = None,
                  apply_knobs: str = "all", device: DeviceLike = None
                  ) -> Tuple[EngineState, EngineConfig]:
    """Restore ``(state, config)`` on ``device`` (None: the CUDA card);
    resume with ``Simulation(config)``.

    ``step=None`` restores the latest checkpoint. ``apply_knobs`` decides
    which recorded knobs overwrite ``cfg`` (:func:`_apply_engine_knobs`):
    with "all", stepping the returned state under the returned config is
    bit-exact with the uninterrupted run.
    """
    dev = resolve_device(device)
    if step is None:
        step = ckpt_mod.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    meta = ckpt_mod.load_manifest(ckpt_dir, step).get("extras", {})
    knobs = meta.get("knobs")
    if knobs is None:
        raise ValueError(f"{ckpt_dir} step {step}: not a simulation "
                         f"checkpoint (no knobs in manifest extras)")
    cfg = _apply_engine_knobs(cfg, knobs, apply_knobs)
    saved_mode = knobs["rebuild"]["mode"]
    # the template mirrors the config the checkpoint was SAVED under (the
    # cache's presence), then adapts to the target config
    tmpl_cfg = cfg
    if (cfg.rebuild.mode == "every_k") != (saved_mode == "every_k"):
        tmpl_cfg = dataclasses.replace(
            cfg, rebuild=grid_mod.RebuildPolicy(**knobs["rebuild"]))
    state = ckpt_mod.restore(ckpt_dir, step,
                             _template_state(tmpl_cfg, behaviors, dev))
    state = _adapt_env(state, saved_mode, cfg,
                       lambda: _template_state(cfg, behaviors, dev))
    return state, cfg


def _lanes_stacked(state: EnsembleState) -> EnsembleState:
    """The ensemble with its pool and caches as the reference stacks them,
    (L, C, ...), each lane's cache with its own slot ids."""
    n = state.n_lanes
    env = state.env
    if env is not None:
        env = grid_mod.stack_rebuild_state(
            env, Lanes(n, state.pool.capacity // n))
    return dataclasses.replace(state, env=env, pool=state.pool.with_channels({
        k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
        for k, v in state.pool.channels().items()}))


def _lanes_flat(state: EnsembleState) -> EnsembleState:
    """Inverse of :func:`_lanes_stacked`: the lane-major pool and caches."""
    env = state.env
    if env is not None:
        env = grid_mod.flatten_rebuild_state(env)
    return dataclasses.replace(state, env=env, pool=state.pool.with_channels({
        k: v.reshape(v.shape[0] * v.shape[1], *v.shape[2:])
        for k, v in state.pool.channels().items()}))


def save_ensemble_state(ckpt_dir: str, state: EnsembleState,
                        cfg: EngineConfig,
                        extras: Optional[Dict] = None) -> str:
    """Atomic checkpoint of a whole ensemble — every lane's state, the
    active mask, per-lane params and the tick — keyed as the reference
    keys it. The step index is the ensemble's ``tick``; callers with
    host-side lane bookkeeping (``serve/sim_service.py``'s request table)
    record it through ``extras``."""
    meta = {"format": _FORMAT, "kind": "ensemble",
            "knobs": _engine_knobs(cfg), "n_lanes": state.n_lanes}
    if extras:
        meta.update(extras)
    stored = _stored(_lanes_stacked(state))
    return ckpt_mod.save(ckpt_dir, int(state.tick), stored, extras=meta)


def restore_ensemble_state(ckpt_dir: str, cfg: EngineConfig,
                           behaviors: Sequence[Behavior],
                           params_template: Optional[ScenarioParams] = None,
                           step: Optional[int] = None,
                           apply_knobs: str = "all",
                           device: DeviceLike = None
                           ) -> Tuple[EnsembleState, EngineConfig, Dict]:
    """Restore ``(state, config, manifest extras)`` of an ensemble on
    ``device`` (None: the CUDA card).

    With ``apply_knobs="all"`` the returned config builds the step the
    checkpoint ran under, so stepping the restored ensemble replays the
    uninterrupted trajectory bit for bit on every lane.
    ``params_template`` must have the structure the run was saved with.
    The extras give a service its lane table back.
    """
    dev = resolve_device(device)
    if step is None:
        step = ckpt_mod.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    meta = ckpt_mod.load_manifest(ckpt_dir, step).get("extras", {})
    knobs = meta.get("knobs")
    if knobs is None or meta.get("kind") != "ensemble":
        raise ValueError(f"{ckpt_dir} step {step}: not an ensemble "
                         f"simulation checkpoint")
    cfg = _apply_engine_knobs(cfg, knobs, apply_knobs)
    saved_mode = knobs["rebuild"]["mode"]
    tmpl_cfg = cfg
    if (cfg.rebuild.mode == "every_k") != (saved_mode == "every_k"):
        tmpl_cfg = dataclasses.replace(
            cfg, rebuild=grid_mod.RebuildPolicy(**knobs["rebuild"]))

    def template(c: EngineConfig) -> EnsembleState:
        return EnsembleEngine(c, behaviors, meta["n_lanes"], params_template,
                              device=dev).init_state()
    state = ckpt_mod.restore(ckpt_dir, step,
                             _lanes_stacked(template(tmpl_cfg)))
    state = _adapt_env(_lanes_flat(state), saved_mode, cfg,
                       lambda: template(cfg))
    return state, cfg, meta


def _dist_stacked(state: DistState, dcfg: DistConfig,
                  group=None) -> Optional[DistState]:
    """The distributed state as the reference stores it: the whole run
    (gathered from every rank of ``group`` onto its rank 0, the writer;
    None on the others), every cache leaf with a leading (n_shards,) axis
    and each shard's slot ids its own."""
    dev = state.channels["alive"].device
    return gather_state(state, dcfg, shard_axis(dcfg.n_shards, group, dev),
                        dst=0)


def _dist_flat(state: DistState) -> DistState:
    env = state.env
    if env is not None:
        env = grid_mod.flatten_rebuild_state(env)
    return dataclasses.replace(state, env=env)


def _is_writer(group) -> bool:
    """Rank 0 writes a distributed checkpoint; one device always does."""
    return group is None or torch.distributed.get_rank(group) == 0


def _barrier(group, device: torch.device) -> None:
    """Every rank of ``group`` waits here for the others (a one-element
    sum read on the host): after it, a file rank 0 wrote is there."""
    if group is not None:
        one = torch.ones(1, device=device)
        torch.distributed.all_reduce(one, group=group)
        one.item()


def _dist_meta(dcfg: DistConfig, extras: Optional[Dict]) -> Dict:
    meta = {"format": _FORMAT, "kind": "dist", "knobs": _dist_knobs(dcfg)}
    if extras:
        meta.update(extras)
    return meta


def save_dist_state(ckpt_dir: str, state: DistState, dcfg: DistConfig,
                    extras: Optional[Dict] = None, group=None
                    ) -> Optional[str]:
    """Atomic checkpoint of a distributed run: every shard's slab at once.
    With ``group`` every rank must call it: the ranks gather the whole run
    onto rank 0, which writes it (and gets the path; the others None), and
    all wait until the file is there."""
    whole = _dist_stacked(state, dcfg, group)
    path = None
    if _is_writer(group):
        path = ckpt_mod.save(ckpt_dir, int(state.iteration), _stored(whole),
                             extras=_dist_meta(dcfg, extras))
    _barrier(group, state.channels["alive"].device)
    return path


def restore_dist_state(ckpt_dir: str, dcfg: DistConfig,
                       behaviors: Sequence[Behavior],
                       step: Optional[int] = None, apply_knobs: str = "all",
                       seed: int = 0, device: DeviceLike = None, group=None
                       ) -> Tuple[DistState, DistConfig]:
    """Restore ``(state, dist_config)`` on ``device`` (None: the CUDA
    card, with ``group`` the rank's), across shard counts. With ``group``
    every rank reads the file and keeps its block of the shards, whatever
    the rank count that wrote it.

    The checkpoint's ``n_shards``: an exact restore, so the resumed run is
    bit-exact (a larger ``local_capacity`` in ``dcfg`` re-packs the slabs
    as the ladder's restage does). Another ``n_shards``: the live agents
    are re-partitioned through the init path (fresh quantile boundaries,
    per-shard keys folded from ``seed``, dirty caches) — the same
    population, another layout and stream, so not bit-exact.
    """
    dev = rank_device(device, group)
    state, target = _restore_whole_run(ckpt_dir, dcfg, behaviors, step,
                                       apply_knobs, seed, dev)
    shards = shard_axis(target.n_shards, group, dev)
    return block_state(_dist_stacked(state, target), shards), target


def _restore_whole_run(ckpt_dir: str, dcfg: DistConfig,
                       behaviors: Sequence[Behavior], step: Optional[int],
                       apply_knobs: str, seed: int, dev: torch.device
                       ) -> Tuple[DistState, DistConfig]:
    """:func:`restore_dist_state` of every shard on one device."""
    if step is None:
        step = ckpt_mod.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    meta = ckpt_mod.load_manifest(ckpt_dir, step).get("extras", {})
    knobs = meta.get("knobs")
    if knobs is None or meta.get("kind") != "dist":
        raise ValueError(f"{ckpt_dir} step {step}: not a distributed "
                         f"simulation checkpoint")
    saved_mode = knobs["engine"]["rebuild"]["mode"]

    def restored(saved: DistConfig) -> DistState:
        return _dist_flat(ckpt_mod.restore(ckpt_dir, step, _dist_stacked(
            _template_dist_state(saved, behaviors, dev), saved)))

    if dcfg.n_shards == knobs["n_shards"]:
        target = _apply_dist_knobs(dcfg, knobs, apply_knobs)
        grow_local = max(dcfg.local_capacity, target.local_capacity)
        tmpl_cfg = target
        if (target.engine.rebuild.mode == "every_k") != (saved_mode
                                                         == "every_k"):
            tmpl_cfg = dataclasses.replace(
                target, engine=dataclasses.replace(
                    target.engine, rebuild=grid_mod.RebuildPolicy(
                        **knobs["engine"]["rebuild"])))
        state = _adapt_env(restored(tmpl_cfg), saved_mode, target.engine,
                           lambda: _template_dist_state(target, behaviors,
                                                        dev))
        if grow_local > target.local_capacity:
            # the caller's rung outgrew the checkpoint's: repack, keep it
            state = dataclasses.replace(state, channels=repack_slabs(
                state.channels, target.n_shards, target.local_capacity,
                grow_local))
            target = dataclasses.replace(target, local_capacity=grow_local)
        return state, target

    # reshard: restore at the saved topology, re-partition the live agents
    state = restored(_apply_dist_knobs(dcfg, knobs, "all"))
    target = dcfg if apply_knobs == "rungs" else dataclasses.replace(
        dcfg, engine=_apply_engine_knobs(dcfg.engine, knobs["engine"], "all"))
    cfg = target.engine
    ch = state.channels
    boundaries = quantile_boundaries(ch["position"][:, 0], ch["alive"],
                                     target.n_shards,
                                     float(cfg.domain_lo[0]),
                                     float(cfg.domain_hi[0]))
    channels = partition_global(ch, boundaries, target)
    n_live, kept = (int(v) for v in torch.stack(
        [ch["alive"].sum(), channels["alive"].sum()]).tolist())
    if kept != n_live:
        raise ValueError(
            f"reshard onto n_shards={target.n_shards} drops "
            f"{n_live - kept} agents (a slab exceeds local_capacity="
            f"{target.local_capacity}); raise local_capacity")
    conc = (state.conc if cfg.diffusion is not None
            else torch.zeros((target.n_shards, 1, 1), dtype=torch.float32,
                             device=dev))
    return DistState(channels=channels, conc=conc,
                     rng=shard_keys(seed, target.n_shards, dev),
                     boundaries=boundaries, iteration=state.iteration,
                     stats=StepStats.zeros(dev, (target.n_shards,)),
                     env=initial_dist_env(target, dev)), target


class SimCheckpointer:
    """Async simulation checkpointer: the host copy is taken on the
    caller's thread, the file written on a background thread. Saves are
    serialised (a new save waits for the previous write)."""

    def __init__(self, ckpt_dir: str, keep: int = 3, group=None):
        self.ckpt_dir = ckpt_dir
        self.group = group
        self._device: Optional[torch.device] = None
        self._async = ckpt_mod.AsyncCheckpointer(ckpt_dir, keep=keep)

    def save_async(self, state, config, extras: Optional[Dict] = None
                   ) -> int:
        """Save an ``EngineState`` under its ``EngineConfig`` or a
        ``DistState`` under its ``DistConfig``. With a group (a
        ``DistState``), every rank calls it: the ranks gather the whole
        run onto rank 0 on this thread and rank 0 writes it."""
        step = int(state.iteration)
        if isinstance(config, DistConfig):
            self._device = state.channels["alive"].device
            whole = _dist_stacked(state, config, self.group)
            if _is_writer(self.group):
                self._async.save_async(step, _stored(whole),
                                       extras=_dist_meta(config, extras))
        else:
            self._async.save_async(step, _stored(state),
                                   extras=_meta(config, extras))
        return step

    def wait(self) -> None:
        """The last write has ended (with a group, on every rank)."""
        self._async.wait()
        if self._device is not None:
            _barrier(self.group, self._device)


# ---------------------------------------------------------------------------
# Degradation policy + run report
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DegradationPolicy:
    """Ordered remedies the supervisor tries after a rollback.

    By trajectory impact: (1) drop the every_k cache — positions are
    unchanged, only the skip schedule resets; (2) the sequential streamed
    sweep (the reference's sequential XLA path); (3) shrink dt, the only
    remedy that changes the trajectory, at most ``max_dt_shrinks`` times.
    """

    dt_shrink: float = 0.5
    max_dt_shrinks: int = 2

    def next_remedy(self, cfg: EngineConfig, applied: Sequence[str]
                    ) -> Optional[Tuple[str, EngineConfig]]:
        """(name, degraded config), or None when out of remedies."""
        if cfg.rebuild.mode == "every_k":
            return "rebuild_every_step", dataclasses.replace(
                cfg, rebuild=grid_mod.RebuildPolicy())
        if cfg.fused_sweep or cfg.force_impl not in ("xla", "streamed"):
            return "sequential_sweep", dataclasses.replace(
                cfg, fused_sweep=False, force_impl="xla")
        if sum(1 for a in applied if a == "shrink_dt") < self.max_dt_shrinks:
            return "shrink_dt", dataclasses.replace(
                cfg, dt=cfg.dt * self.dt_shrink)
        return None


@dataclasses.dataclass
class RunReport:
    """Everything the supervisor did to keep the run alive: no
    intervention is silent."""

    interventions: List[Dict] = dataclasses.field(default_factory=list)
    checkpoints: List[int] = dataclasses.field(default_factory=list)
    rungs: List[Dict] = dataclasses.field(default_factory=list)
    retries: int = 0
    completed: bool = False
    final_iteration: int = 0

    def to_dict(self) -> Dict:
        return dataclasses.asdict(self)


# ---------------------------------------------------------------------------
# The supervised run loop
# ---------------------------------------------------------------------------

class SupervisedRunner:
    """Fault-tolerant driver around a :class:`CapacityLadder` or a
    :class:`DistributedCapacityLadder`.

    Runs it step by step, checkpoints every ``checkpoint_every`` iterations
    (and once up front, so there is always a rollback target), and reads
    the health bitmask after every step. On a health fault or
    ``CapacityExhausted``:

      1. the failing state is discarded (on capacity exhaustion the
         last-good pre-step state carried by the exception is checkpointed
         first, so no progress is lost);
      2. the engine config is degraded one remedy down the policy;
      3. the run rolls back to the latest checkpoint (rung knobs from the
         checkpoint, degraded knobs kept) and continues.

    When remedies run out the fault is re-raised with the ``RunReport``
    attached.

    ``fault_hook(iteration, state) -> state | None`` is a test-only
    injection point, called on the input state of each iteration.
    """

    def __init__(self, driver, ckpt_dir: str,
                 checkpoint_every: int = 50, keep: int = 3,
                 policy: Optional[DegradationPolicy] = None,
                 max_retries: int = 8,
                 fault_hook: Optional[Callable] = None):
        if not isinstance(driver, (CapacityLadder,
                                   DistributedCapacityLadder)):
            raise TypeError(f"the supervisor drives a CapacityLadder or a "
                            f"DistributedCapacityLadder, got "
                            f"{type(driver).__name__}")
        self.driver = driver
        self._dist = isinstance(driver, DistributedCapacityLadder)
        self.ckpt_dir = ckpt_dir
        self.checkpoint_every = checkpoint_every
        self.policy = policy or DegradationPolicy()
        self.max_retries = max_retries
        self.fault_hook = fault_hook
        self.report = RunReport()
        self._ckpt = SimCheckpointer(
            ckpt_dir, keep=keep, group=driver.group if self._dist else None)
        self._applied: List[str] = []

    # -- driver plumbing (CapacityLadder vs DistributedCapacityLadder) ------
    def _config(self):
        return self.driver.dcfg if self._dist else self.driver.config

    def _engine_cfg(self) -> EngineConfig:
        return self._config().engine if self._dist else self._config()

    def _reconfigure(self, new_cfg) -> None:
        d = self.driver
        if self._dist:
            d.dcfg = new_cfg
            d._sim = DistributedSimulation(new_cfg, d.behaviors, d.device,
                                           d.group)
        else:
            d.config = new_cfg
            d._sim = Simulation(new_cfg, d.behaviors, device=d.device)

    def _save(self, state) -> None:
        step = self._ckpt.save_async(state, self._config())
        if step not in self.report.checkpoints:
            self.report.checkpoints.append(step)

    def _rollback(self):
        """The latest checkpoint under the current (degraded) config."""
        self._ckpt.wait()
        restore, kw = ((restore_dist_state, {"group": self.driver.group})
                       if self._dist else (restore_state, {}))
        state, cfg = restore(self.ckpt_dir, self._config(),
                             self.driver.behaviors, apply_knobs="rungs",
                             device=self.driver.device, **kw)
        self._reconfigure(cfg)
        return state

    def _handle_fault(self, kind: str, detail: Dict, fault):
        self.report.retries += 1
        if self.report.retries > self.max_retries:
            fault.report = self.report
            raise fault
        remedy = self.policy.next_remedy(self._engine_cfg(), self._applied)
        if remedy is None:
            fault.report = self.report
            raise fault
        name, new_eng = remedy
        self._applied.append(name)
        self._reconfigure(dataclasses.replace(self._config(), engine=new_eng)
                          if self._dist else new_eng)
        state = self._rollback()
        self.report.interventions.append(
            {"kind": kind, "remedy": name,
             "rolled_back_to": int(state.iteration), **detail})
        return state

    def run(self, state, n_iterations: int):
        """Returns ``(final_state, RunReport)``."""
        target = int(state.iteration) + n_iterations
        self._save(state)                       # always a rollback target
        while int(state.iteration) < target:
            it = int(state.iteration)
            if self.fault_hook is not None:
                injected = self.fault_hook(it, state)
                if injected is not None:
                    state = injected
            try:
                nxt = self.driver.step(state)
                # over ranks, every shard's health on every rank: all
                # roll back together
                stats = (self.driver.sim.global_stats(nxt.stats)
                         if self._dist else nxt.stats)
                bits = stats.health_bits()
                if bits:
                    raise HealthFault(
                        f"iteration {it}: health guard fired "
                        f"{describe(bits)}", bits=bits)
            except HealthFault as e:
                state = self._handle_fault(
                    "health", {"iteration": it, "flags": list(e.flags)}, e)
                continue
            except CapacityExhausted as e:
                if e.state is not None:
                    # emergency checkpoint of the last-good pre-step state
                    self._ckpt.wait()
                    self._save(e.state)
                state = self._handle_fault(
                    "capacity_exhausted",
                    {"iteration": it, "demand": e.demand,
                     "max_capacity": e.max_capacity}, e)
                continue
            state = nxt
            if int(state.iteration) % self.checkpoint_every == 0:
                self._save(state)
        self._save(state)
        self._ckpt.wait()
        self.report.completed = True
        self.report.final_iteration = int(state.iteration)
        self.report.rungs = list(self.driver.rungs)
        return state, self.report
