#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and hold every
kernel of that path against its plain PyTorch version.

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result line):
  0. build: compile every kernel under src/repro_torch/kernels/csrc with
     nvcc for sm_90a, all sources at once;
  1. kernel vs plain: K1 against its plain version at the Fig-6
     proliferation shapes (65,536 and 1,048,576 agents, column map from
     the port's own resident build): force atol 1e-4, nnz exact; kernel and
     plain times (CUDA events) and the kernel's lower bound on this card;
  2. the engine on the card ≡ the engine on the CPU, one step at 8,192
     agents (integers exact, floats atol/rtol 1e-4);
  3. main path: ``Simulation`` with the Fig-6 configuration at 1,048,576
     live agents, ``run(check_overflow=True)`` for 10 steps; every kernel's
     launch count is reset just before and read just after;
  4. births: examples/quickstart.py's configuration (128 agents, capacity
     32,768) for 60 steps must grow the population.

Prints the card's name and power limit, a JSON line of per-kernel numbers,
and last ``{"ok": true, "device": {...}}``. Writes the same numbers to
chiprun_out/chip_smoke.json. Needs the repository around it (src/) and a
CUDA device; exits non-zero otherwise.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
FORCE_ATOL = 1e-4
K1_SIZES = (65_536, 1_048_576)       # agents for the kernel-vs-plain phase
MAIN_AGENTS, MAIN_STEPS = 1_048_576, 10
PARITY_AGENTS = 8192


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def k1_bound(data_t, block_cols, adhesion) -> tuple[float, str, dict]:
    """Least time this card could take for one K1 call on these inputs."""
    from repro_torch.kernels import collision_force as k1
    tiles = int((block_cols >= 0).sum())
    pairs = tiles * k1.BLOCK * k1.BLOCK
    ops_per_pair = k1.OPS_PER_PAIR + (k1.OPS_PER_PAIR_ADHESION
                                      if adhesion is not None else 0)
    n_pad = data_t.shape[1]
    moved = (data_t.numel() * 4 + block_cols.numel() * 4 + 4 * n_pad * 4
             + (0 if adhesion is None else adhesion.numel() * 4))
    t_ops = pairs * ops_per_pair / PEAK_FP32_FLOPS * 1e3
    t_bytes = moved / PEAK_HBM_BYTES * 1e3
    by = "operations" if t_ops >= t_bytes else "bytes"
    return max(t_ops, t_bytes), by, {"tiles": tiles, "pairs": pairs,
                                     "ops_per_pair": ops_per_pair,
                                     "bytes": moved}


def phase_kernel_vs_plain(n: int, report: dict) -> dict:
    import torch
    from repro_torch.core import engine as eng
    from repro_torch.kernels import collision_force as k1, ops
    from repro_torch.launch import simulate

    sim, st = simulate.build("proliferation", n, "fig6", device="cuda")
    cfg, spec = sim.config, sim.spec
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device="cuda")
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    pool, g = res.pool, res.grid
    data_t, cols, ovf, _ = ops.k1_inputs(
        pool.position, pool.diameter, pool.agent_type, pool.alive,
        pool.alive, g.starts, g.counts, origin, cfg.cell_size, spec.dims)
    check(not bool(ovf), f"K1 column map overflow at {n} agents")
    kw = dict(k_rep=cfg.force.k_rep, adhesion=None,
              adhesion_band=cfg.force.adhesion_band)
    out = k1.collision_force(data_t, cols, **kw)
    torch.cuda.synchronize()
    plain = k1.collision_force_plain(data_t, cols, **kw)
    torch.cuda.synchronize()
    err = float((out[:3] - plain[:3]).abs().max())
    nnz_equal = bool(torch.equal(out[3], plain[3]))
    check(err <= FORCE_ATOL, f"K1 force differs from plain by {err} at {n}")
    check(nnz_equal, f"K1 nnz differs from plain at {n} agents")
    check(bool(torch.isfinite(out).all()), "K1 output not finite")
    ms = cuda_ms(lambda: k1.collision_force(data_t, cols, **kw), iters=20,
                 warmup=3)
    plain_ms = cuda_ms(lambda: k1.collision_force_plain(data_t, cols, **kw),
                       iters=2, warmup=0)
    bound_ms, bound_by, work = k1_bound(data_t, cols, None)
    listed = (cols >= 0).sum(1)
    rec = {"agents": n, "capacity": cfg.capacity, "n_pad": data_t.shape[1],
           "dims": list(spec.dims), "max_abs_err": err, "nnz_equal": True,
           "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
           "bound_by": bound_by,
           "cols_per_row_block_mean": float(listed[listed > 0].float().mean()),
           "cols_per_row_block_max": int(listed.max()),
           "active_row_blocks": int((listed > 0).sum()),
           "row_blocks": int(cols.shape[0]), **work}
    print(f"[1] K1 at {n} agents: kernel {ms:.4f} ms, plain {plain_ms:.2f} ms,"
          f" bound {bound_ms:.4f} ms ({bound_by}); max|Δf| {err:.3g}, nnz "
          f"equal; column blocks per active row block "
          f"{rec['cols_per_row_block_mean']:.2f} (max "
          f"{rec['cols_per_row_block_max']}), {rec['tiles']} tiles",
          flush=True)
    report.setdefault("k1_vs_plain", []).append(rec)
    return rec


def phase_engine_cpu_parity(n: int, report: dict) -> None:
    import numpy as np
    import torch
    from repro_torch import convert
    from repro_torch.launch import simulate

    sim_g, st_g = simulate.build("proliferation", n, "fig6", device="cuda")
    sim_c, st_c = simulate.build("proliferation", n, "fig6", device="cpu")
    for _ in range(3):                     # leave the initial layout
        st_g = sim_g.step(st_g)
    st_c = convert.state_from_numpy(convert.state_to_numpy(st_g), "cpu")
    # one CPU thread: multi-threaded torch CPU kernels were seen to return a
    # worker's whole chunk of float32 sqrt results ~3e-4 off on some hosts
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        want = convert.state_to_numpy(sim_c.step(st_c))
    finally:
        torch.set_num_threads(threads)
    got = convert.state_to_numpy(sim_g.step(st_g))
    torch.cuda.synchronize()
    worst = {}
    for k, w in want["pool"].items():
        g = got["pool"][k]
        check(g.dtype == w.dtype, f"dtype of {k} differs")
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=k)
            worst[k] = float(np.abs(g - w).max())
        else:
            check(np.array_equal(g, w), f"integer channel {k} differs")
    for f, w in want["stats"].items():
        check(np.array_equal(got["stats"][f], w), f"stat {f} differs")
    report["engine_gpu_vs_cpu"] = {"agents": n, "max_abs_diff": worst,
                                   "integers_equal": True}
    print(f"[2] engine step on the card ≡ on the CPU at {n} agents: "
          f"max|Δ| {worst}, integer channels and stats equal", flush=True)


def phase_main_path(n: int, steps: int, report: dict) -> dict:
    import torch
    from repro_torch.kernels import collision_force as k1
    from repro_torch.launch import simulate

    sim, st = simulate.build("proliferation", n, "fig6", device="cuda")
    torch.cuda.synchronize()
    stamps = []

    def tick(i, state):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    k1.collision_force.launches = 0
    t0 = time.perf_counter()
    st = sim.run(st, steps, callback=tick, check_overflow=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"k1_collision_force": k1.collision_force.launches}
    check(launches["k1_collision_force"] == steps,
          f"K1 launched {launches['k1_collision_force']} times in {steps} "
          f"steps")
    check(st.stats.health_bits() == 0, "health flags set")
    check(not st.stats.flags(), f"overflow flags {st.stats.flags()}")
    n_live = int(st.stats["n_live"])
    check(n_live >= n, f"population shrank to {n_live}")
    live = st.pool.position[:n_live]
    check(bool(torch.isfinite(live).all()), "non-finite positions")
    steps_ms = [(b - a) * 1e3 for a, b in zip([t0] + stamps[:-1], stamps)]
    rec = {"agents": n, "capacity": sim.config.capacity, "steps": steps,
           "launches": launches, "ms_per_step": wall * 1e3 / steps,
           "ms_per_step_median": statistics.median(steps_ms),
           "ms_first_step": steps_ms[0],
           "agent_steps_per_s": n * steps / wall, "n_live_end": n_live}
    report["main_path"] = rec
    print(f"[3] main path: {n} agents x {steps} steps, "
          f"{rec['ms_per_step']:.2f} ms/step (median "
          f"{rec['ms_per_step_median']:.2f}, first {steps_ms[0]:.2f}), "
          f"{rec['agent_steps_per_s']:.4g} agent-steps/s, K1 launches "
          f"{launches['k1_collision_force']}", flush=True)
    return rec


def phase_births(report: dict) -> None:
    import numpy as np
    from repro_torch.core import (EngineConfig, ForceParams, GrowDivide,
                                  Simulation)
    cfg = EngineConfig(capacity=32768, domain_lo=(0, 0, 0),
                       domain_hi=(120, 120, 120), interaction_radius=14.0,
                       dt=0.2, sort_frequency=10, max_per_box=64,
                       force=ForceParams(max_displacement=1.0))
    sim = Simulation(cfg, [GrowDivide(rate=1.0, threshold_diameter=12.0)],
                     device="cuda")
    pos = np.random.default_rng(0).uniform(50, 70, (128, 3)).astype(
        np.float32)
    st = sim.init_state(pos, diameter=np.full(128, 8.0, np.float32))
    births = []
    st = sim.run(st, 60, check_overflow=True,
                 callback=lambda i, s: births.append(s.stats["births"]))
    total = int(sum(int(b) for b in births))
    n_live = int(st.stats["n_live"])
    check(n_live > 128 and total > 0,
          f"population did not grow: n_live {n_live}, births {total}")
    check(n_live == 128 + total, "n_live != 128 + births")
    report["births"] = {"steps": 60, "n_live": n_live, "births": total}
    print(f"[4] births: n_live {n_live} after 60 steps ({total} births)",
          flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.device import card_description
    from repro_torch.kernels import build

    card = card_description()
    nvcc = subprocess.run([build.nvcc_path(), "--version"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"nvcc: {nvcc}", flush=True)
    report = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda,
              "nvcc": nvcc}

    t0 = time.perf_counter()
    libs = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"[0] built {sorted(libs)} in {report['build_s']:.1f} s", flush=True)
    for name, log in build.BUILD_LOGS.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}", flush=True)

    recs = [phase_kernel_vs_plain(n, report) for n in K1_SIZES]
    phase_engine_cpu_parity(PARITY_AGENTS, report)
    main_rec = phase_main_path(MAIN_AGENTS, MAIN_STEPS, report)
    phase_births(report)

    big = recs[-1]
    kernels = [{
        "name": "k1_collision_force", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/collision_force.cu",
        "replaces": "src/repro/kernels/collision_force.py:118",
        "launches": main_rec["launches"]["k1_collision_force"],
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": big["bound_by"],
        "library_ms": None}]
    report["kernels"] = kernels
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_description(), flush=True)      # as nvidia-smi prints it
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
