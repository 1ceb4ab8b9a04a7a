"""Simulation-as-a-service — continuous batching over ensemble lanes (port
of ``repro.serve.sim_service``).

The token batcher (batching.py) keeps a fixed-slot decode batch full:
finished sequences retire, queued requests take the freed slots, and the
step always runs at a fixed shape with idle slots masked. This module is
the same loop with a simulation as the unit of work and an ensemble lane
(core/ensemble.py) as the slot:

  request = initial agents + seed + per-request ScenarioParams + step budget
  admit   = stage a solo initial state and write it into a free lane
  step    = ONE ensemble iteration advances every occupied lane, under the
            ensemble capacity ladder (a worst-lane overflow grows the shared
            rung and re-runs the tick)
  stream  = per-tick, per-lane metrics (a user ``metrics_fn`` mapped over
            the lanes with ``torch.func.vmap``) flow back to the caller
  retire  = converged or budget-spent lanes freeze, their final state is
            read out, and the lane returns to the free pool

A tick reads two things from the card: the ladder's flags and demands (one
transfer) and the metrics (one transfer). Admission blocks, never drops:
with every lane busy a request stays queued. Checkpoints hold the whole
ensemble and the lane table (core/simcheck.py), so a killed service
resumes mid-churn with every occupied lane bit-exact; the queue is the
caller's to re-submit.

A tissue configuration (every_k rebuilds, a pair list, a diffusion grid,
static detection) serves as any other: an admitted lane brings a fresh
dirty cache, so its first tick rebuilds, and a retired lane freezes with
its cache and field.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.agents import pool_from_channels
from ..core.behaviors import Behavior
from ..core.engine import (EngineConfig, EngineState, LadderConfig,
                           ScenarioParams)
from ..core.ensemble import (EnsembleCapacityLadder, EnsembleEngine,
                             EnsembleState)
from ..core.simcheck import restore_ensemble_state, save_ensemble_state
from ..device import DeviceLike


@dataclasses.dataclass
class SimRequest:
    """One simulation to run: initial agents, RNG seed, per-request knobs."""
    uid: int
    position: Any                              # (N, 3) initial positions
    diameter: Any = None
    agent_type: Any = None
    extra_init: Optional[Dict[str, Any]] = None
    seed: int = 0
    params: Optional[ScenarioParams] = None    # structure must match the
                                               # service's params_template
    max_steps: int = 100


@dataclasses.dataclass
class FinishedSim:
    """A retired simulation: identity, why it ended, and what it produced."""
    uid: int
    lane: int
    steps: int
    reason: str                                # "converged" | "max_steps"
    final: EngineState                         # lane state at retirement
    trajectory: List[Any]                      # per-step metrics_fn values


def lane_metrics(metrics_fn: Callable, state: EnsembleState) -> torch.Tensor:
    """``metrics_fn(pool, params)`` (one lane's pool, its params) mapped
    over every lane with ``torch.func.vmap`` on a (L, C, ...) view of the
    lane-major pool: one result per lane, stacked. A metric vmap cannot
    trace raises; nothing loops over the lanes."""
    n = state.n_lanes
    channels = {k: v.reshape(n, v.shape[0] // n, *v.shape[1:])
                for k, v in state.pool.channels().items()}
    p = state.params
    if p is None:
        return torch.func.vmap(
            lambda ch: metrics_fn(pool_from_channels(ch), None))(channels)
    leaves = {"force": p.force, "rates": p.rates}
    if p.dt is not None:
        leaves["dt"] = p.dt
    return torch.func.vmap(lambda ch, lv: metrics_fn(
        pool_from_channels(ch),
        ScenarioParams(dt=lv.get("dt"), force=lv["force"],
                       rates=lv["rates"])))(channels, leaves)


class SimService:
    """Host-side orchestrator around the ensemble step.

    ``metrics_fn(pool, params) -> value`` sees one lane (the reference's
    signature) and is mapped over the lanes, read back once a tick;
    ``converged_fn(value) -> bool`` decides early retirement from the latest
    metric. Both optional: without them lanes run to their step budget.
    ``device``: None means the CUDA card and raises without one.
    """

    def __init__(self, config: EngineConfig,
                 behaviors: Sequence[Behavior] = (), n_lanes: int = 4,
                 params_template: Optional[ScenarioParams] = None,
                 metrics_fn: Optional[Callable] = None,
                 converged_fn: Optional[Callable] = None,
                 ladder: Optional[LadderConfig] = None,
                 device: DeviceLike = None):
        self.driver = EnsembleCapacityLadder(config, behaviors, n_lanes,
                                             params_template, ladder,
                                             device=device)
        self.device = self.driver.device
        self.n_lanes = n_lanes
        self.metrics_fn = metrics_fn
        self.converged_fn = converged_fn
        self.state = self.driver.init_state()
        self.queue: List[SimRequest] = []
        self.lanes: List[Optional[dict]] = [None] * n_lanes
        self.finished: List[FinishedSim] = []

    @property
    def engine(self) -> EnsembleEngine:
        return self.driver.engine

    def _metrics(self, state: EnsembleState) -> Optional[np.ndarray]:
        if self.metrics_fn is None:
            return None
        return lane_metrics(self.metrics_fn, state).cpu().numpy()

    # -- admission -----------------------------------------------------------
    def submit(self, req: SimRequest) -> None:
        self.queue.append(req)

    def _admit(self) -> int:
        n = 0
        for i in range(self.n_lanes):
            if self.lanes[i] is not None:
                continue
            if not self.queue:
                break
            req = self.queue.pop(0)            # full lanes → stays queued
            lane_state = self.engine.stage_lane(
                req.position, req.diameter, req.agent_type, req.extra_init,
                seed=req.seed)
            self.state = self.engine.admit(self.state, i, lane_state,
                                           req.params)
            self.lanes[i] = {"req": req, "steps": 0, "trajectory": []}
            n += 1
        return n

    # -- retirement ----------------------------------------------------------
    def _retire(self, lane: int, reason: str) -> None:
        info = self.lanes[lane]
        final = self.engine.read_lane(self.state, lane)
        self.finished.append(FinishedSim(
            uid=info["req"].uid, lane=lane, steps=info["steps"],
            reason=reason, final=final, trajectory=info["trajectory"]))
        self.state = self.engine.retire(self.state, lane)
        self.lanes[lane] = None

    # -- one service tick ----------------------------------------------------
    def step(self) -> int:
        """Admit waiting requests, advance every occupied lane one
        iteration, stream metrics, retire finished lanes. Returns the
        number of lanes stepped; 0 with everything idle — that tick
        launches nothing."""
        self._admit()
        if all(info is None for info in self.lanes):
            return 0
        self.state = self.driver.step(self.state)
        metrics = self._metrics(self.state)
        n = 0
        for i, info in enumerate(self.lanes):
            if info is None:
                continue
            n += 1
            info["steps"] += 1
            m = None if metrics is None else metrics[i]
            if m is not None:
                info["trajectory"].append(m)
            if (self.converged_fn is not None and m is not None
                    and self.converged_fn(m)):
                self._retire(i, "converged")
            elif info["steps"] >= info["req"].max_steps:
                self._retire(i, "max_steps")
        return n

    def run_until_drained(self, max_ticks: int = 100_000) -> int:
        """Tick until the queue and every lane are empty. Returns ticks."""
        for t in range(max_ticks):
            if not self.queue and all(info is None for info in self.lanes):
                return t
            self.step()
        raise RuntimeError(f"service not drained after {max_ticks} ticks "
                           f"({len(self.queue)} queued, "
                           f"{sum(i is not None for i in self.lanes)} busy)")

    # -- occupancy -----------------------------------------------------------
    def occupancy(self) -> float:
        """Fraction of lanes currently running a simulation."""
        return sum(i is not None for i in self.lanes) / self.n_lanes

    # -- checkpoint / resume --------------------------------------------------
    def checkpoint(self, ckpt_dir: str,
                   extras: Optional[Dict] = None) -> str:
        """Snapshot the ensemble and the lane table (uid, steps and budget
        per occupied lane). Queued requests are NOT checkpointed — they are
        the caller's inputs; re-submit them after a restore (``extras``
        records what a caller needs for that, e.g. finished uids, and comes
        back in ``restored_meta``)."""
        table = [None if info is None else
                 {"uid": info["req"].uid, "steps": info["steps"],
                  "max_steps": info["req"].max_steps}
                 for info in self.lanes]
        meta = {"lanes": table}
        if extras:
            meta.update(extras)
        return save_ensemble_state(ckpt_dir, self.state, self.driver.config,
                                   extras=meta)

    def restore(self, ckpt_dir: str, step: Optional[int] = None) -> int:
        """Restore the ensemble and the lane table; returns the restored
        tick. The recorded rung knobs rebuild the step the checkpoint ran
        under, so occupied lanes pick up mid-trajectory bit-exact (their
        streamed trajectories restart empty: the history went to the
        caller)."""
        state, cfg, meta = restore_ensemble_state(
            ckpt_dir, self.driver.config, self.driver.behaviors,
            self.driver.params_template, step=step, device=self.device)
        if meta["n_lanes"] != self.n_lanes:
            raise ValueError(f"checkpoint has {meta['n_lanes']} lanes, "
                             f"service has {self.n_lanes}")
        self.driver.config = cfg
        self.driver._sim = EnsembleEngine(cfg, self.driver.behaviors,
                                          self.n_lanes,
                                          self.driver.params_template,
                                          device=self.device)
        self.state = state
        self.restored_meta = meta
        self.lanes = [
            None if entry is None else
            {"req": SimRequest(uid=entry["uid"],
                               position=np.zeros((0, 3), np.float32),
                               max_steps=entry["max_steps"]),
             "steps": entry["steps"], "trajectory": []}
            for entry in meta["lanes"]]
        return int(state.tick)
