"""Recompute the roofline terms of existing results/dryrun_torch records
with the H100 constants of ``analysis`` and the analytic compute term (no
new trace: the recorded bytes moved and wire bytes are reused).

Usage: PYTHONPATH=src python -m repro_torch.roofline.refresh [results_dir]
"""

from __future__ import annotations

import json
import os
import sys

from ..configs import ARCHS, SHAPES
from ..launch.cells import analytic_step_flops
from . import analysis as A


def refresh_record(rec: dict) -> dict:
    if rec.get("status") != "ok":
        return rec
    cfg = ARCHS[rec["arch"]]
    shape = SHAPES[rec["shape"]]
    n_dev = rec["n_devices"]
    analytic = analytic_step_flops(cfg, shape)
    rl = rec["roofline"]
    mem_bytes = rl["bytes_per_device"]
    wire = rl["wire_bytes_per_device"]
    new = A.analyze({"flops": analytic / n_dev, "bytes accessed": mem_bytes},
                    None if wire is None else rl["collective_breakdown"])
    rl.update(new.as_dict())
    step = new.step_time_bound_s
    rec["memory"]["hbm_budget_bytes"] = A.HBM_BYTES
    rec["analytic_flops_global"] = analytic
    rec["useful_flops_ratio"] = rec["model_flops"] / analytic
    rec["roofline_fraction"] = rec["model_flops"] / n_dev / A.PEAK_FLOPS \
        / step
    rec["step_time_bound_s"] = step
    return rec


def main() -> None:
    results_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results",
        "dryrun_torch")
    for name in sorted(os.listdir(results_dir)):
        if not name.endswith(".json"):
            continue
        path = os.path.join(results_dir, name)
        with open(path) as f:
            rec = json.load(f)
        rec = refresh_record(rec)
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print("refreshed", results_dir)


if __name__ == "__main__":
    main()
