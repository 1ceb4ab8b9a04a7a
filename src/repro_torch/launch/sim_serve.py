"""Simulation service driver (counterpart of ``repro.launch.sim_serve``): a
lane pool serving an SIR request stream.

    PYTHONPATH=src python -m repro_torch.launch.sim_serve --lanes 8 \
        --requests 32 --agents 256 --steps 100 --beta-min 0.1 --beta-max 0.5

Submits ``--requests`` SIR simulations (per-request seed and infection rate
from the beta range) to a :class:`~repro_torch.serve.SimService` with
``--lanes`` ensemble lanes, then ticks until drained — continuous batching
at iteration granularity. ``--ckpt-dir`` with ``--checkpoint-every``
snapshots the whole ensemble periodically; ``--resume`` picks a killed
service back up mid-churn (occupied lanes bit-exact; the requests not yet
admitted are re-submitted from the request list). The flags are the
reference's, plus ``--device`` (default: the CUDA card; ``cpu`` for the
plain path) and ``--report PATH``, a JSON file of every simulation this
process retired (uid, steps, reason, final infected count).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..core import EngineConfig, ScenarioParams
from ..core.behaviors import INFECTED, Infection, RandomWalk
from ..device import DeviceLike
from ..serve import SimRequest, SimService


def make_service(n_lanes: int, agents: int, side: float,
                 device: DeviceLike = None) -> SimService:
    """The reference's service configuration, ``sort_impl="argsort"``
    included (one stable sort in the port, whatever the name)."""
    cfg = EngineConfig(
        capacity=-(-agents // 64) * 64,
        domain_lo=(0.0,) * 3, domain_hi=(side,) * 3,
        interaction_radius=3.0, use_forces=False, query_chunk=2048,
        max_per_box=32, sort_impl="argsort")
    behaviors = [
        RandomWalk(sigma=0.8),
        Infection(radius=3.0, beta=lambda ctx: ctx.params["beta"],
                  recovery_time=lambda ctx: ctx.params["recovery_time"]),
    ]

    def infected_count(pool, params):
        return ((pool.agent_type == INFECTED) & pool.alive).sum()

    return SimService(cfg, behaviors, n_lanes=n_lanes,
                      params_template=ScenarioParams.of(beta=0.0,
                                                        recovery_time=1),
                      metrics_fn=infected_count,
                      converged_fn=lambda m: int(m) == 0, device=device)


def make_request(uid: int, agents: int, side: float, beta: float,
                 recovery_time: int, max_steps: int) -> SimRequest:
    r = np.random.RandomState(1000 + uid)
    pos = r.uniform(0, side, (agents, 3)).astype(np.float32)
    types = np.zeros(agents, np.int32)
    n0 = max(agents // 50, 2)
    types[:n0] = INFECTED
    timer = np.zeros(agents, np.int32)
    timer[:n0] = recovery_time
    return SimRequest(
        uid=uid, position=pos,
        diameter=np.full(agents, 1.0, np.float32), agent_type=types,
        extra_init={"infect_timer": timer}, seed=uid,
        params=ScenarioParams.of(beta=beta, recovery_time=recovery_time),
        max_steps=max_steps)


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lanes", type=int, default=8)
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--agents", type=int, default=256)
    ap.add_argument("--steps", type=int, default=100,
                    help="per-request step budget")
    ap.add_argument("--beta-min", type=float, default=0.1)
    ap.add_argument("--beta-max", type=float, default=0.5)
    ap.add_argument("--recovery-time", type=int, default=40)
    ap.add_argument("--side", type=float, default=None,
                    help="cubic domain edge (default: density-scaled)")
    ap.add_argument("--report-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint the ensemble every K ticks (0 = off)")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--report", default=None,
                    help="write every retired simulation to this JSON file")
    args = ap.parse_args(argv)

    side = args.side or max(40.0, (args.agents ** (1 / 3)) * 5)
    svc = make_service(args.lanes, args.agents, side, device=args.device)
    betas = np.linspace(args.beta_min, args.beta_max, args.requests)

    busy_uids, done_uids = set(), set()
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt-dir")
        tick = svc.restore(args.ckpt_dir)
        busy_uids = {info["req"].uid for info in svc.lanes
                     if info is not None}
        done_uids = set(svc.restored_meta.get("finished_uids", []))
        print(f"resumed at tick {tick}: busy={sorted(busy_uids)} "
              f"finished={len(done_uids)}")

    for uid in range(args.requests):
        if uid in busy_uids or uid in done_uids:
            continue
        svc.submit(make_request(uid, args.agents, side, float(betas[uid]),
                                args.recovery_time, args.steps))

    t0 = time.time()
    ticks = 0
    agent_steps = 0
    while svc.queue or any(info is not None for info in svc.lanes):
        stepped = svc.step()
        ticks += 1
        agent_steps += stepped * args.agents
        if args.checkpoint_every and args.ckpt_dir \
                and ticks % args.checkpoint_every == 0:
            svc.checkpoint(args.ckpt_dir, extras={
                "finished_uids": sorted(done_uids | {
                    f.uid for f in svc.finished})})
        if ticks % args.report_every == 0:
            dt = time.time() - t0
            print(f"tick {ticks:5d}  occupancy={svc.occupancy():4.2f}  "
                  f"finished={len(svc.finished):3d}/{args.requests}  "
                  f"{agent_steps / dt:,.0f} agent-steps/s")
    if svc.device.type == "cuda":
        torch.cuda.synchronize(svc.device)
    dt = time.time() - t0
    if args.ckpt_dir:
        svc.checkpoint(args.ckpt_dir, extras={
            "finished_uids": sorted(done_uids | {
                f.uid for f in svc.finished})})
    print(f"drained {len(svc.finished)} simulations in {ticks} ticks "
          f"({dt:.1f} s, {agent_steps / max(dt, 1e-9):,.0f} "
          f"agent-steps/s)")
    for f in sorted(svc.finished, key=lambda f: f.uid)[:10]:
        peak = max(int(m) for m in f.trajectory) if f.trajectory else 0
        print(f"  uid={f.uid:3d} beta={betas[f.uid]:.3f} steps={f.steps:4d} "
              f"reason={f.reason:9s} peak_infected={peak}")
    if args.report:
        with open(args.report, "w") as fh:
            json.dump([{"uid": f.uid, "steps": f.steps, "reason": f.reason,
                        "final_infected": int(
                            ((f.final.pool.agent_type == INFECTED)
                             & f.final.pool.alive).sum())}
                       for f in sorted(svc.finished, key=lambda f: f.uid)],
                      fh)
    print("done")


if __name__ == "__main__":
    main()
