"""Dry run of every (architecture × input shape) cell (port of
``repro.launch.dryrun``).

For each cell: build the step with ``ShapeDtype`` inputs and their specs
(``cells.build_cell``), trace it once under fake tensors on the CPU
(``roofline.analysis.trace_step``: FLOPs, bytes moved, peak live bytes),
reckon each device's argument bytes on the mesh, and write one JSON record
under ``results/dryrun_torch/``.

What a record holds depends on the mesh:
- on the 1 × 1 host mesh (``--host``) the trace is one device's step, so
  the record has the temp and total bytes against the H100's memory, the
  bytes moved and the memory term;
- on a mesh of more than one device (16 × 16, or 2 × 16 × 16 with
  ``--multi-pod``) a trace of whole weights at the global batch is not one
  device's step, so temp, bytes moved and the memory term are null
  (``"pending"`` says why). ``argument_bytes_per_device`` is exact there
  too: each input's shard shape on the mesh.
The collective term is null here: a real mesh's comes from counting
the collectives of a sharded step on its ranks
(``roofline/analysis.collectives_of``), and the production mesh's waits
for a trace of one device's shard of the step. The compute term is
``cells.analytic_step_flops`` over the devices, as in the reference.

The reference's ``lower_s`` and ``compile_s`` become one ``trace_s``;
its ``--hlo-dir`` has no counterpart (there is no HLO).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2-1.5b --shape train_4k
        [--multi-pod | --host]
  python -m repro_torch.launch.dryrun --all [--multi-pod | --host]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import Optional

from ..configs import ARCHS, SHAPES, shape_applicable
from ..roofline import analysis as roofline
from .cells import analytic_step_flops, build_cell, leaves_with_specs
from .mesh import Mesh, make_host_mesh, make_production_mesh, mesh_axes

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")
PENDING = ("waits for ROADMAP 15c: temp bytes, the memory term and the "
           "collective term need a trace of one device's shard of the step "
           "under a fake process group")


def argument_bytes_per_device(cell, mesh: Mesh) -> int:
    """Bytes of one device's shard of every input of ``cell``."""
    total = 0
    for _, sd, spec in leaves_with_specs(cell.args, cell.in_shardings):
        shard = mesh.shard_shape(sd.shape, spec)
        total += math.prod(shard) * sd.dtype.itemsize
    return total


def measure(cfg, shape, mesh: Mesh, axes, **build_kw) -> dict:
    """Build, trace and reckon one cell on ``mesh``: the numbers of a
    record (``run_cell``) or of a hill-climb variant (``hillclimb``)."""
    n_dev = mesh.size
    t0 = time.time()
    cell = build_cell(cfg, shape, mesh, axes, **build_kw)
    cost = roofline.trace_step(cell.fn, *cell.args)
    trace_s = time.time() - t0
    one = n_dev == 1
    args = argument_bytes_per_device(cell, mesh)
    temp = cost.peak_bytes - cost.argument_bytes if one else None
    analytic = analytic_step_flops(cfg, shape)
    rl = roofline.analyze({"flops": analytic / n_dev,
                           "bytes accessed": cost.bytes_moved if one
                           else None})
    step = rl.step_time_bound_s
    return {
        "cell": cell, "trace_s": trace_s,
        "memory": {
            "argument_bytes_per_device": args,
            "temp_bytes_per_device": temp,
            "total_bytes_per_device": None if temp is None else args + temp,
            "hbm_budget_bytes": roofline.HBM_BYTES,
        },
        "cost_raw": {"flops": cost.flops / n_dev,
                     "bytes accessed": cost.bytes_moved if one else None},
        "traced_ops": cost.n_ops,
        "roofline": rl.as_dict(),
        "model_flops": cell.model_flops,
        "analytic_flops_global": analytic,
        "useful_flops_ratio": cell.model_flops / analytic,
        # fraction of the peak doing model FLOPs during the bound step time
        "roofline_fraction": (cell.model_flops / n_dev / roofline.PEAK_FLOPS
                              / step),
        "step_time_bound_s": step,
        **({} if one else {"pending": PENDING}),
    }


def _tag(arch: str, shape_name: str, mesh: Mesh, multi_pod: bool) -> str:
    where = "host" if mesh.size == 1 else ("pod2" if multi_pod else "pod1")
    return f"{arch}__{shape_name}__{where}"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             save: bool = True, results_dir: Optional[str] = None,
             mesh: Optional[Mesh] = None) -> dict:
    """Dry-run one cell on ``mesh`` (None: the production mesh of
    ``multi_pod``) and return its record, also written to
    ``results_dir/<cell>.json`` with ``save``."""
    cfg = ARCHS[arch]
    shape = SHAPES[shape_name]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    tag = _tag(arch, shape_name, mesh, multi_pod)
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        rec = {"cell": tag, "status": "skipped", "reason": why}
        if save:
            _save(tag, rec, results_dir)
        print(json.dumps(rec))
        return rec

    m = measure(cfg, shape, mesh, mesh_axes(multi_pod))
    cell = m.pop("cell")
    rec = {"cell": tag, "status": "ok", "arch": arch, "shape": shape_name,
           "mesh": list(mesh.shape), "n_devices": mesh.size,
           "n_params": int(cell.n_params),
           "n_active_params": int(cell.n_active_params),
           "note": cell.note, **m}
    if save:
        _save(tag, rec, results_dir)
    print(json.dumps({k: rec[k] for k in
                      ("cell", "status", "trace_s", "roofline_fraction")}))
    return rec


def _save(tag: str, rec: dict, results_dir: Optional[str] = None) -> None:
    d = results_dir or RESULTS_DIR
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    where = ap.add_mutually_exclusive_group()
    where.add_argument("--multi-pod", action="store_true")
    where.add_argument("--host", action="store_true",
                       help="the 1 x 1 host mesh: one device's whole step")
    ap.add_argument("--all", action="store_true")
    args = ap.parse_args()

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        cells = [(args.arch, args.shape)]
    mesh = make_host_mesh() if args.host else None

    failures = []
    for a, s in cells:
        try:
            run_cell(a, s, args.multi_pod, mesh=mesh)
        except Exception as e:  # noqa: BLE001 — record the cell, go on
            traceback.print_exc()
            failures.append((a, s, repr(e)))
            tag = _tag(a, s, mesh or make_production_mesh(
                multi_pod=args.multi_pod), args.multi_pod)
            _save(tag, {"cell": tag, "status": "error", "error": repr(e)})
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")


if __name__ == "__main__":
    main()
