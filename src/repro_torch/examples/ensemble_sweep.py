"""SIR parameter sweep on the ensemble engine, the port's counterpart of
examples/ensemble_sweep.py.

One iteration core advances every sweep member in lockstep: N lanes, each
a small SIR world with its own (beta, gamma) drawn from a grid, served
through the continuous-batching SimService — more parameter points than
lanes, so lanes retire and re-admit as members finish. Prints the
epidemic-size surface over the (beta, gamma) grid.

    PYTHONPATH=src python -m repro_torch.examples.ensemble_sweep [--device cpu]

Environment knobs (CI smoke caps size):
    EXAMPLE_N       agents per lane        (default 400)
    EXAMPLE_LANES   ensemble lanes         (default 8)
    EXAMPLE_POINTS  sweep points           (default 16)
    EXAMPLE_STEPS   per-member step budget (default 120)
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..core import EngineConfig, ScenarioParams
from ..core.behaviors import INFECTED, SUSCEPTIBLE, Infection, RandomWalk
from ..device import DeviceLike
from ..serve import SimRequest, SimService
from ._common import env_int, parser


def n_agents() -> int:
    return env_int("EXAMPLE_N", 400)


def side() -> float:
    return max(30.0, (n_agents() ** (1 / 3)) * 4.2)


def make_config() -> EngineConfig:
    # sweep regime: the reference's comparison sort (one stable sort in the
    # port, whatever the name)
    n = n_agents()
    return EngineConfig(capacity=-(-n // 64) * 64,
                        domain_lo=(0, 0, 0), domain_hi=(side(),) * 3,
                        interaction_radius=3.0, use_forces=False,
                        query_chunk=2048, max_per_box=32,
                        sort_impl="argsort")


def behaviors():
    return [
        RandomWalk(sigma=0.8),
        # per-lane rates flow through ScenarioParams → ctx.params: one
        # step serves every (beta, gamma) point
        Infection(radius=3.0, beta=lambda ctx: ctx.params["beta"],
                  recovery_time=lambda ctx: ctx.params["recovery_time"]),
    ]


def make_service(device: DeviceLike = None) -> SimService:
    def infected(pool, params):
        return ((pool.agent_type == INFECTED) & pool.alive).sum()

    return SimService(make_config(), behaviors(),
                      n_lanes=env_int("EXAMPLE_LANES", 8),
                      params_template=ScenarioParams.of(beta=0.0,
                                                        recovery_time=1),
                      metrics_fn=infected,
                      converged_fn=lambda m: int(m) == 0, device=device)


def make_request(uid: int, beta: float, recovery_time: int) -> SimRequest:
    n, s = n_agents(), side()
    r = np.random.RandomState(7000 + uid)
    pos = r.uniform(0, s, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    n0 = max(n // 50, 2)
    types[:n0] = INFECTED
    timer = np.zeros(n, np.int32)
    timer[:n0] = recovery_time
    return SimRequest(uid=uid, position=pos,
                      diameter=np.full(n, 1.0, np.float32),
                      agent_type=types,
                      extra_init={"infect_timer": timer}, seed=uid,
                      params=ScenarioParams.of(beta=beta,
                                               recovery_time=recovery_time),
                      max_steps=env_int("EXAMPLE_STEPS", 120))


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser(__doc__).parse_args(argv)
    n_points = env_int("EXAMPLE_POINTS", 16)
    # (beta, gamma) grid: gamma realized as integer recovery_time = 1/gamma
    n_beta = max(int(np.sqrt(n_points)), 2)
    n_rec = -(-n_points // n_beta)
    betas = np.linspace(0.1, 0.6, n_beta)
    recoveries = np.unique(np.linspace(10, 60, n_rec).astype(int))
    points = [(float(b), int(rt)) for rt in recoveries for b in betas]

    svc = make_service(args.device)
    for uid, (beta, rt) in enumerate(points):
        svc.submit(make_request(uid, beta, rt))
    print(f"sweep: {len(points)} members ({n_beta} beta × {len(recoveries)} "
          f"recovery), {svc.n_lanes} lanes, {n_agents()} agents/lane")

    ticks = svc.run_until_drained()
    assert len(svc.finished) == len(points)

    print(f"drained in {ticks} ticks "
          f"(vs {sum(f.steps for f in svc.finished)} sequential steps)")
    print(f"{'beta':>6} {'1/gamma':>8} {'steps':>6} {'reason':>10} "
          f"{'peak_I':>7} {'attack_rate':>12}")
    attack = {}
    for f in sorted(svc.finished, key=lambda f: f.uid):
        beta, rt = points[f.uid]
        alive = f.final.pool.alive.cpu().numpy()
        t = f.final.pool.agent_type.cpu().numpy()[alive]
        rate = float((t != SUSCEPTIBLE).sum()) / max(len(t), 1)
        peak = max(int(np.asarray(m)) for m in f.trajectory)
        attack[(beta, rt)] = rate
        print(f"{beta:6.2f} {rt:8d} {f.steps:6d} {f.reason:>10} "
              f"{peak:7d} {rate:12.3f}")

    # aggregate trajectory sanity: infectivity must matter — the most
    # aggressive corner of the sweep infects more than the mildest
    lo = attack[(float(betas[0]), int(recoveries[0]))]
    hi = attack[(float(betas[-1]), int(recoveries[-1]))]
    assert hi >= lo, f"attack rate not increasing with (beta, 1/gamma): " \
                     f"{lo:.3f} -> {hi:.3f}"
    assert hi > 0, "no epidemic anywhere in the sweep"
    print(f"OK: attack rate {lo:.3f} (mild corner) -> {hi:.3f} "
          f"(aggressive corner) over {len(points)} members")


if __name__ == "__main__":
    main()
