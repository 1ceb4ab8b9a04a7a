"""Where one step's time goes on the card: ``torch.profiler`` over a set-up
of ``launch/simulate.py`` (default: the Fig-6 proliferation configuration).

    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --agents 1048576 --steps 5 --out chiprun_out/profile_step.json
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --scenario epidemiology --config breakdown --agents 1048576
    PYTHONPATH=src python -m repro_torch.launch.profile_step \
        --scenario epidemiology --config breakdown --pairlist reuse

Reports, per step: wall time without and with the profiler (the cost of
tracing); the device's busy time (union of kernel, copy and memset
intervals) and idle share over the profiled steps (the profiler slows the
host, so unprofiled steps idle less); and, for each named range of the step
(``step/*``, ``k1/*`` and ``grid/sweep``, recorded with ``record_function``
in engine.py, kernels/ops.py and core/grid.py; ``step/pairlist_build`` is
the pair-list build of ``--pairlist`` set-ups), the device time and the
number of launches of the work it issued — a device operation belongs to
the innermost range open on the host when it was launched — and the
rebuilds and rebuild skips of the profiled steps. Runs on the CUDA card
only.
"""

from __future__ import annotations

import argparse
import collections
import json
import tempfile
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

from ..device import card_description, resolve_device
from . import simulate

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _timed_steps(sim, st, steps: int, rebuilds: list | None = None):
    """``steps`` steps; appends each step's (rebuilds, rebuild_skips)
    tensors to ``rebuilds`` (read after the timing)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        st = sim.step(st)
        if rebuilds is not None:
            rebuilds.append((st.stats["rebuilds"], st.stats["rebuild_skips"]))
    torch.cuda.synchronize()
    return st, (time.perf_counter() - t0) * 1e3 / steps


def analyze_trace(events: list, steps: int) -> dict:
    """Busy time, idle share and per-range device time from a Chrome trace
    (``traceEvents`` of ``export_chrome_trace``), per step."""
    ranges = [e for e in events if e.get("cat") == "user_annotation"]
    # cuBLASLt launches its GEMMs with cuLaunchKernelEx, traced as cuda_driver
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in _DEVICE_CATS]
    per_range = collections.defaultdict(lambda: [0.0, 0])
    by_name = collections.defaultdict(lambda: [0.0, 0])
    for d in device:
        launch = launches.get(d.get("args", {}).get("correlation"))
        name = "(outside ranges)"
        if launch is not None:
            open_ = [r for r in ranges
                     if r["ts"] <= launch["ts"] <= r["ts"] + r["dur"]]
            if open_:
                name = min(open_, key=lambda r: r["dur"])["name"]
        per_range[name][0] += d["dur"]
        per_range[name][1] += 1
        by_name[d["name"]][0] += d["dur"]
        by_name[d["name"]][1] += 1
    spans = sorted((d["ts"], d["ts"] + d["dur"]) for d in device)
    busy, cur = 0.0, None
    for s, e in spans:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    wall = (spans[-1][1] - spans[0][0]) if spans else 0.0
    per_step = lambda us: us / 1e3 / steps            # noqa: E731
    return {
        "device_busy_ms": per_step(busy),
        "device_span_ms": per_step(wall),
        "launches": len(device) / steps,
        "ranges": {k: {"device_ms": per_step(v[0]), "launches": v[1] / steps}
                   for k, v in sorted(per_range.items(),
                                      key=lambda kv: -kv[1][0])},
        "top_device_ops": [
            {"name": k, "device_ms": per_step(v[0]), "calls": v[1] / steps}
            for k, v in sorted(by_name.items(), key=lambda kv: -kv[1][0])
        ][:15]}


def profile_steps(sim, st, steps: int, trace: str | None = None):
    """Run ``steps`` steps under ``torch.profiler``; returns the state and
    :func:`analyze_trace`'s numbers, with the profiled wall time per step
    and the idle share: 1 − busy / that wall, both from the same steps.
    Keeps the Chrome trace at ``trace`` if given. ``sim`` is anything with
    ``step(state) -> state`` whose stats carry rebuilds and skips (an
    ensemble's are summed over its lanes)."""
    counts = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        st, prof_ms = _timed_steps(sim, st, steps, counts)
    with tempfile.TemporaryDirectory() as tmp:
        path = trace or str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    stats = analyze_trace(events, steps)
    return st, {"ms_per_step_profiled": prof_ms,
                "device_idle_share": 1.0 - stats["device_busy_ms"] / prof_ms,
                "rebuilds": sum(int(r.sum()) for r, _ in counts),
                "rebuild_skips": sum(int(k.sum()) for _, k in counts),
                **stats}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scenario", choices=simulate.SCENARIOS,
                    default="proliferation")
    ap.add_argument("--config", choices=simulate.CONFIGS, default="fig6")
    ap.add_argument("--force-impl", choices=simulate.FORCE_IMPLS,
                    default="k1")
    ap.add_argument("--pairlist", choices=simulate.PAIRLIST_MODES,
                    default="off")
    ap.add_argument("--agents", type=int, default=1_048_576)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", default=None, help="write the report as JSON")
    ap.add_argument("--trace", default=None,
                    help="keep the Chrome trace of the profiled steps here")
    args = ap.parse_args()

    resolve_device(None)                      # the card, or raise
    sim, st = simulate.build(args.scenario, args.agents, args.config,
                             force_impl=args.force_impl,
                             pairlist=args.pairlist)
    st, _ = _timed_steps(sim, st, args.warmup)
    st, plain_ms = _timed_steps(sim, st, args.steps)
    st, stats = profile_steps(sim, st, args.steps, args.trace)
    prof_ms = stats["ms_per_step_profiled"]
    report = {"card": card_description(), "scenario": args.scenario,
              "config": args.config, "force_impl": args.force_impl,
              "pairlist": args.pairlist,
              "agents": args.agents,
              "capacity": sim.config.capacity, "steps": args.steps,
              "ms_per_step": plain_ms, **stats}
    print(f"card: {report['card']}")
    print(f"{args.scenario}/{args.config}/{args.force_impl}/pairlist "
          f"{args.pairlist}, {args.agents} agents: {plain_ms:.3f} ms/step "
          f"({prof_ms:.3f} profiled); device busy "
          f"{stats['device_busy_ms']:.3f} ms/step, idle share "
          f"{report['device_idle_share']:.3f} (profiled); "
          f"{stats['launches']:.0f} device ops/step; rebuilds "
          f"{stats['rebuilds']}, skips {stats['rebuild_skips']} in the "
          f"profiled steps")
    for name, r in stats["ranges"].items():
        print(f"  {name:28s} {r['device_ms']:9.3f} ms  "
              f"{r['launches']:7.0f} launches")
    for k in stats["top_device_ops"]:
        print(f"  {k['device_ms']:9.3f} ms  x{k['calls']:6.1f}  "
              f"{k['name'][:90]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
