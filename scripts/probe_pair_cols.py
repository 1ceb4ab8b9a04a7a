#!/usr/bin/env python3
"""The pairs column-map kernel beside its first design on the card, with
no wrapper on the host; printed and written to
chiprun_out/probe_pair_cols.json.

On chip_smoke.py phase 13's inputs (the forces + SIR workload at
1,048,576 agents after the engine's build, a skin-0 pair list at
max_pairs 64, the map fused with the pack as ``ops.k1_inputs`` runs it),
the committed ``kernels/csrc/pair_cols.cu`` and its first design
(``launch/variants/pair_cols_row_walk.cu``) are each called through their
bare C entry point on arguments prepared once, timed in turns (CUDA
events, 50 calls after 5, each twice: a b b a), and their kernel's device
ms a call read from ``torch.profiler`` over 20 more calls. The wrapper's
call (``ops.k1_inputs``) is timed by events beside them. Both kernels are
held ≡ the wrapper's output.

    python3 scripts/probe_pair_cols.py

Runs on the CUDA card only.
"""

from __future__ import annotations

import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402

AGENTS = 1_048_576


def _device_ms(fn, calls: int = 20) -> float:
    """Device ms a call of the kernels whose name holds ``pair_cols``,
    from ``torch.profiler`` over ``calls`` calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = sum(e.device_time_total for e in prof.key_averages()
             if "pair_cols" in e.key)
    return us / 1e3 / calls


def main() -> int:
    import torch
    from repro_torch.core import grid as grid_mod
    from repro_torch.device import card_description
    from repro_torch.kernels import build, ops, pair_cols
    from repro_torch.launch import kernel_variants

    if not torch.cuda.is_available():
        print("probe_pair_cols: no CUDA device", file=sys.stderr)
        return 2
    card = card_description()
    fns = {"committed": pair_cols._kernel_fn(),
           "first_design": kernel_variants._functions()["pair_cols_row_walk"]}
    sim, _, res, origin = chip_smoke._breakdown_build(AGENTS)
    cfg, spec, pool, g = sim.config, sim.spec, res.pool, res.grid
    pairs = grid_mod.build_pairlist(spec, g, pool.position, pool.alive,
                                    radius=cfg.interaction_radius,
                                    max_pairs=64, chunk=cfg.query_chunk)
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            pool.alive, g.starts, g.counts, origin, cfg.cell_size,
            spec.dims, 64, pairs)
    n_pad = ops.lane_stride(None, pool.position.shape[0])
    a, held = pair_cols.launch_args(pairs.idx, pairs.run_off, n_pad, 64,
                                    pool=args[:5], lanes=1)
    stream = torch.cuda.current_stream().cuda_stream

    def bare(fn):
        def call():
            err = fn(*a, stream)
            if err != 0:
                raise RuntimeError(f"CUDA error {err}")
        return call

    want = [x.clone() for x in ops.k1_inputs(*args)]
    for name, fn in fns.items():
        bare(fn)()
        torch.cuda.synchronize()
        chip_smoke.check(torch.equal(held[0], want[1])
                         and torch.equal(held[2], want[0]),
                         f"{name} differs from ops.k1_inputs")
    calls = {k: bare(fn) for k, fn in fns.items()}
    calls["wrapper"] = lambda: ops.k1_inputs(*args)
    seq = list(calls) + list(reversed(list(calls)))
    turns = {k: [] for k in calls}
    for k in seq:
        turns[k].append(chip_smoke.cuda_ms(calls[k], iters=50, warmup=5))
    device = {k: _device_ms(calls[k]) for k in calls}
    rec = {"card": card, "agents": AGENTS,
           "stored_entries": int(pairs.run_off[:, 9].sum()),
           "ms": {k: statistics.fmean(v) for k, v in turns.items()},
           "ms_turns": turns, "device_ms": device,
           "ptxas": [line.strip() for line in
                     build.BUILD_LOGS.get("pair_cols", "").splitlines()
                     if "registers" in line or "spill" in line]}
    for k, v in rec["ms"].items():
        print(f"{k:>14}: {v:.4f} ms by events (turns {turns[k][0]:.4f}, "
              f"{turns[k][1]:.4f}), device {device[k]:.4f} ms", flush=True)
    print(f"    pair_cols: {' '.join(rec['ptxas'])}", flush=True)
    print(card, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_pair_cols.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
