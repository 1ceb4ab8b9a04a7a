#!/usr/bin/env python3
"""Where the time of one secretion call and one pair-list build goes on
the card, launch by launch, printed and written to
chiprun_out/probe_slot_kernels.json:

1. the ptxas report (registers, spills, shared memory) of the
   ``secretion`` and ``pairlist`` kernels as ``kernels/build.py`` builds
   them;
2. ``core/diffusion.add_sources`` on the card at chip_smoke.py phase 15's
   three shapes (4,000 agents into 32³ voxels, 65,536 into 8, 1,048,576
   into 32³) and over 8 lanes of 4,000 agents into 8 grids of 32³: the
   call's mean time (CUDA events, 20 calls after 3) and, from
   ``torch.profiler`` over 20 more calls, every device operation it
   launches with its device ms and launches a call; then the mean of
   STEADY calls after 5 (CUDA events and the host clock), of the call
   and of the bare C entry point on the same inputs (the kernel's launch
   with its outputs' allocation, none of the wrapper's checks): what the
   wrapper costs on the host;
3. ``core/grid.build_pairlist`` on phase 12's pool (the forces + SIR
   workload at 1,048,576 agents after the engine's build, radius 4,
   max_pairs 64 and 16), timed and profiled the same way.

    python3 scripts/probe_slot_kernels.py

Runs on the CUDA card only.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402

CALLS = 20
STEADY = 200
SECRETION_SHAPES = ((1, 4000, (32, 32, 32)), (1, 65_536, (2, 2, 2)),
                    (1, 1_048_576, (32, 32, 32)), (8, 4000, (32, 32, 32)))


def _profiled(fn) -> dict:
    """Mean CUDA-event ms of ``fn()`` and its device operations by name,
    per call."""
    import json as _json
    import tempfile
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.profile_step import analyze_trace
    ms = chip_smoke.cuda_ms(fn, iters=CALLS, warmup=3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        events = _json.loads(Path(path).read_text())["traceEvents"]
    stats = analyze_trace(events, CALLS)
    return {"ms": ms, "device_busy_ms": stats["device_busy_ms"],
            "launches": stats["launches"], "ops": stats["top_device_ops"]}


def _print(tag: str, rec: dict) -> None:
    print(f"{tag}: {rec['ms']:.4f} ms a call (events), device busy "
          f"{rec['device_busy_ms']:.4f} ms, {rec['launches']:.0f} device "
          f"ops a call", flush=True)
    for op in rec["ops"]:
        print(f"    {op['device_ms']:.4f} ms  x{op['calls']:.0f}  "
              f"{op['name'][:110]}", flush=True)


def _bare_secretion(spec, conc, pos, amount, origin, lane_rows):
    """The secretion kernel's C entry point on these inputs, called as
    ``kernels/secretion.add`` calls it, without its checks."""
    import torch
    from repro_torch.core import diffusion
    from repro_torch.kernels import secretion as sec
    fn, scratch_fn = sec._kernel_fns()
    n = pos.shape[0]
    size = scratch_fn(n, lane_rows, conc.numel())
    recip = diffusion._recip(spec.voxel)

    def call():
        out = torch.empty_like(conc)
        scratch = (torch.empty((size,), dtype=torch.uint8, device="cuda")
                   if size else None)
        err = fn(pos.data_ptr(), amount.data_ptr(), n, origin.data_ptr(),
                 recip, *spec.dims, lane_rows, conc.data_ptr(),
                 conc.numel(), out.data_ptr(),
                 scratch.data_ptr() if size else None, size,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return call


def secretion(report: dict) -> None:
    import torch
    from repro_torch.core import diffusion
    from repro_torch.core.lanes import Lanes
    recs = []
    for n_lanes, n, dims in SECRETION_SHAPES:
        spec = diffusion.DiffusionSpec(dims=dims, voxel=1.0)
        parts = [chip_smoke._secretion_inputs(n, dims, 3 + lane)
                 for lane in range(n_lanes)]
        conc = torch.stack([torch.from_numpy(p[2]) for p in parts]).cuda()
        pos = torch.cat([torch.from_numpy(p[0]) for p in parts]).cuda()
        amount = torch.cat([torch.from_numpy(p[1]) for p in parts]).cuda()
        lanes = None
        if n_lanes == 1:
            conc = conc[0]
        else:
            lanes = Lanes(n_lanes, n)
        origin = torch.zeros(3, device="cuda")
        def call():
            return diffusion.add_sources(spec, conc, pos, amount, origin,
                                         lanes)
        rec = _profiled(call)
        rec.update(lanes=n_lanes, agents=n, voxels=int(conc.numel()))
        rec["steady_ms"], rec["steady_host_ms"] = chip_smoke._both_clocks(
            call, STEADY, warmup=5)
        rec["bare_ms"], rec["bare_host_ms"] = chip_smoke._both_clocks(
            _bare_secretion(spec, conc, pos, amount, origin, n), STEADY,
            warmup=5)
        recs.append(rec)
        _print(f"secretion, {n_lanes} x {n} agents into {conc.numel()} "
               f"voxels", rec)
        print(f"    {STEADY} calls: {rec['steady_ms']:.4f} ms a call "
              f"(events), {rec['steady_host_ms']:.4f} (host); the bare C "
              f"call {rec['bare_ms']:.4f}, {rec['bare_host_ms']:.4f}",
              flush=True)
    report["secretion"] = recs


def pairlist(report: dict) -> None:
    import torch
    from repro_torch.core import grid as grid_mod
    sim, _, res, _ = chip_smoke._breakdown_build(chip_smoke.MAIN_AGENTS)
    cfg, spec, pool, g = sim.config, sim.spec, res.pool, res.grid
    recs = []
    for mp in (64, 16):
        kw = dict(radius=cfg.interaction_radius, max_pairs=mp,
                  chunk=cfg.query_chunk)
        rec = _profiled(lambda: grid_mod.build_pairlist(
            spec, g, pool.position, pool.alive, **kw))
        got = grid_mod.build_pairlist(spec, g, pool.position, pool.alive,
                                      **kw)
        bound_ms, bound_by, work = chip_smoke.pairlist_bound(spec, g, pool,
                                                             got)
        rec.update(max_pairs=mp, bound_ms=bound_ms, bound_by=bound_by,
                   dims=list(spec.dims), **work)
        recs.append(rec)
        _print(f"pair-list build, {chip_smoke.MAIN_AGENTS} agents, "
               f"max_pairs {mp} (bound {bound_ms:.4f} ms, {bound_by}; "
               f"grid {tuple(spec.dims)})", rec)
        del got
    torch.cuda.synchronize()
    report["pairlist"] = recs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("probe_slot_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.device import card_description
    from repro_torch.kernels import build
    report = {"card": card_description()}
    print(f"card: {report['card']}", flush=True)
    build.build_all(["secretion", "pairlist"])
    report["ptxas"] = {}
    for name in ("secretion", "pairlist"):
        lines = [ln.strip() for ln in build.BUILD_LOGS[name].splitlines()
                 if "ptxas info" in ln]
        report["ptxas"][name] = lines
        for ln in lines:
            print(f"    {name}: {ln}", flush=True)
    secretion(report)
    pairlist(report)
    out = ROOT / "chiprun_out" / "probe_slot_kernels.json"
    out.parent.mkdir(exist_ok=True)
    out.write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
