"""K1's pair sweep against variants of its own source, on the card:
registers, spills, agreement with the committed kernel and time at the
Fig-6 shapes of ``chip_smoke.py`` phase 1.

    PYTHONPATH=src python -m repro_torch.launch.k1_variants \\
        --out chiprun_out/k1_variants.json --sass chiprun_out/k1.sass

The variants are made from ``kernels/csrc/collision_force.cu`` by text
substitution, so they follow the source:

* ``committed``: the source as it is;
* ``rows1``, ``rows4``: 1 or 4 rows per thread (128 or 32 threads per
  row block) instead of 2;
* ``no_exact``: the queued pairs' exact arithmetic left out (their
  results are zero): the reject loop, the queue and the owner's sums;
* ``test_only``: no queue either; each lane counts its passing pairs into
  nnz: the reject loop alone.

The last two are not K1: they time parts of it. Each is compiled with the
build's flags into ``build/kernels/variants/``; the report gives ptxas's
registers and spills, the largest force difference from the committed
kernel and whether nnz is equal (for the exact variants), and the mean of
20 calls timed with CUDA events, the variants in turn and then in reverse
order. ``--sass`` writes the committed kernel's SASS. Runs on the CUDA card
only.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from ..device import card_description, resolve_device
from ..kernels import build, collision_force as k1
from ..kernels import ops
from . import simulate

SIZES = (65_536, 1_048_576)
EXACT = ("committed", "rows1", "rows4")

_ROWS = "constexpr int kRows = 2;"
_EXACT = "      const float4 a = srow[lr];"
_PUSH = "      if (!__any_sync(0xffffffffu, any != 0)) continue;"


def _replace(src: str, old: str, new: str) -> str:
    if old not in src:
        raise RuntimeError(f"k1_variants: source no longer holds {old!r}")
    return src.replace(old, new)


def variant_sources() -> dict:
    """{name: .cu text} of every variant."""
    src = (build.CSRC / "collision_force.cu").read_text()
    return {
        "committed": src,
        "rows1": _replace(src, _ROWS, "constexpr int kRows = 1;"),
        "rows4": _replace(src, _ROWS, "constexpr int kRows = 4;"),
        "no_exact": _replace(src, _EXACT, "      qc[e] = make_float4(0.f, 0.f"
                             ", 0.f, 0.f);\n      continue;\n" + _EXACT),
        "test_only": _replace(src, _PUSH, "      nnz[0] += __popc(any);\n"
                              "      continue;")}


def _compile(name: str, text: str) -> dict:
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"k1_{name}.cu", out_dir / f"k1_{name}.so"
    cu.write_text(text)
    res = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                          str(so), str(cu)], capture_output=True, text=True,
                         check=True)
    rec = {"so": str(so)}
    log = res.stdout + res.stderr
    if m := re.search(r"Used (\d+) registers", log):
        rec["registers"] = int(m.group(1))
    if m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      log):
        rec["spill_bytes"] = int(m.group(1)) + int(m.group(2))
    return rec


def _inputs(n: int):
    """K1's inputs as phase 1 of chip_smoke.py makes them."""
    from ..core import engine as eng
    sim, st = simulate.build("proliferation", n, "fig6", device="cuda")
    cfg, spec = sim.config, sim.spec
    origin = torch.tensor(cfg.domain_lo, dtype=torch.float32, device="cuda")
    res = eng.build_env(cfg, spec, st.pool, origin, cfg.cell_size)
    pool, g = res.pool, res.grid
    data_t, cols, _, _ = ops.k1_inputs(
        pool.position, pool.diameter, pool.agent_type, pool.alive,
        pool.alive, g.starts, g.counts, origin, cfg.cell_size, spec.dims)
    return data_t, cols, cfg.force


def _call(fn, data_t, cols, force) -> torch.Tensor:
    out = torch.empty((4, data_t.shape[1]), dtype=torch.float32,
                      device=data_t.device)
    err = fn(data_t.data_ptr(), data_t.shape[1], cols.data_ptr(),
             cols.shape[1], 0, 0, force.k_rep, force.adhesion_band,
             k1.REACH_SLACK, out.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"k1_variants: launch failed with {err}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the report here")
    ap.add_argument("--sass", default=None,
                    help="write the committed kernel's SASS here")
    args = ap.parse_args()
    resolve_device(None)                      # the card, or raise
    recs, fns = {}, {}
    for name, text in variant_sources().items():
        recs[name] = _compile(name, text)
        fn = ctypes.CDLL(recs[name]["so"]).k1_collision_force
        fn.argtypes, fn.restype = k1.ARGTYPES, ctypes.c_int
        fns[name] = fn
    if args.sass:
        cuobjdump = Path(build.nvcc_path()).parent / "cuobjdump"
        Path(args.sass).parent.mkdir(parents=True, exist_ok=True)
        Path(args.sass).write_text(subprocess.run(
            [str(cuobjdump), "-sass", recs["committed"]["so"]],
            capture_output=True, text=True, check=True).stdout)
    order = list(fns) + list(reversed(list(fns)))
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for n in SIZES:
        data_t, cols, force = _inputs(n)
        want = _call(fns["committed"], data_t, cols, force)
        for name in EXACT:
            got = _call(fns[name], data_t, cols, force)
            recs[name][f"max_abs_diff_{n}"] = float(
                (got[:3] - want[:3]).abs().max())
            recs[name][f"nnz_equal_{n}"] = bool(torch.equal(got[3], want[3]))
        for name in order:
            for _ in range(3):
                _call(fns[name], data_t, cols, force)
            torch.cuda.synchronize()
            start.record()
            for _ in range(20):
                _call(fns[name], data_t, cols, force)
            stop.record()
            torch.cuda.synchronize()
            recs[name].setdefault(f"ms_{n}", []).append(
                start.elapsed_time(stop) / 20)
        del data_t, cols
    report = {"card": card_description(), "variants": recs}
    print(f"card: {report['card']}")
    for name, rec in recs.items():
        print(name, json.dumps({k: v for k, v in rec.items() if k != "so"}))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
