"""Render the dry-run and roofline tables from the port's records
(port of ``repro.roofline.report``).

Usage: PYTHONPATH=src python -m repro_torch.roofline.report [results_dir]
Prints markdown to stdout. A term the record leaves null prints as "-".
"""

from __future__ import annotations

import json
import os
import sys
from typing import Dict, List, Optional


def load(results_dir: str) -> List[Dict]:
    recs = []
    for name in sorted(os.listdir(results_dir)):
        if name.endswith(".json"):
            with open(os.path.join(results_dir, name)) as f:
                recs.append(json.load(f))
    return recs


def _fmt_bytes(n) -> str:
    if n is None:
        return "-"
    return f"{n / 2**30:.2f}"


def _fmt(x: Optional[float], spec: str) -> str:
    return "-" if x is None else format(x, spec)


def _budget(recs: List[Dict], pod: str) -> str:
    """The card's memory as a header, from the records' budget."""
    for r in recs:
        if r["cell"].endswith(pod) and r["status"] == "ok":
            return f"fits {r['memory']['hbm_budget_bytes'] / 1e9:.0f}G"
    return "fits"


def dryrun_table(recs: List[Dict], pod: str) -> str:
    rows = [f"| cell | status | params | bytes/dev (GiB) | {_budget(recs, pod)}"
            " | trace s | note |",
            "|---|---|---|---|---|---|---|"]
    for r in recs:
        if not r["cell"].endswith(pod):
            continue
        if r["status"] != "ok":
            reason = r.get("reason", r.get("error", ""))[:60]
            rows.append(f"| {r['cell']} | {r['status']} | - | - | - | - "
                        f"| {reason} |")
            continue
        mem = r["memory"]["total_bytes_per_device"]
        fits = "yes"
        if mem is None:     # only the arguments are reckoned: "NO" or "-"
            mem = r["memory"]["argument_bytes_per_device"]
            fits = "-"
        if mem > r["memory"]["hbm_budget_bytes"]:
            fits = "NO"
        rows.append(
            f"| {r['cell']} | ok | {r['n_params'] / 1e9:.2f}B "
            f"| {_fmt_bytes(mem)} | {fits} | {r['trace_s']:.0f} "
            f"| {r.get('note', '')} |")
    return "\n".join(rows)


def roofline_table(recs: List[Dict], pod: str = "pod1") -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | dominant "
            "| MODEL/HLO flops | roofline frac | bottleneck note |",
            "|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if not r["cell"].endswith(pod) or r["status"] != "ok":
            continue
        rl = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {rl['compute_s']:.4f} "
            f"| {_fmt(rl['memory_s'], '.4f')} "
            f"| {_fmt(rl['collective_s'], '.4f')} "
            f"| **{rl['dominant']}** | {r['useful_flops_ratio']:.2f} "
            f"| {r['roofline_fraction']:.3f} | {bottleneck_note(r)} |")
    return "\n".join(rows)


def bottleneck_note(r: Dict) -> str:
    """One sentence on what would move the dominant term down."""
    rl = r["roofline"]
    dom = rl["dominant"]
    shape = r["shape"]
    if dom == "collective":
        br = rl["collective_breakdown"] or {}
        top = max(br, key=br.get) if br else "?"
        return (f"dominated by {top}; fuse/reshard to cut per-layer syncs "
                f"(bf16 sync, 2D-sharded activations)")
    if dom == "memory":
        if "decode" in shape or "long" in shape:
            return "KV/state reads dominate; shrink cache dtype or shard KV wider"
        return "activation traffic; raise arithmetic intensity (fusion, remat policy)"
    if rl["memory_s"] is None:
        return "compute term only: memory and collective terms wait for 15c"
    return "compute-bound: already near the right wall; tune tensor-core use"


def perf_table(perf_dir: str) -> str:
    """Hill-climb log table from results/perf_torch/*.json."""
    if not os.path.isdir(perf_dir):
        return "(no hillclimb records yet)"
    rows = ["| variant | hypothesis | compute s | memory s | collective s "
            "| bound s | useful-MFU |",
            "|---|---|---|---|---|---|---|"]
    for name in sorted(os.listdir(perf_dir)):
        if not name.endswith(".json"):
            continue
        with open(os.path.join(perf_dir, name)) as f:
            r = json.load(f)
        rl = r["roofline"]
        rows.append(
            f"| {r['variant']} | {r['hypothesis'][:80]} "
            f"| {rl['compute_s']:.3f} | {_fmt(rl['memory_s'], '.3f')} "
            f"| {_fmt(rl['collective_s'], '.3f')} "
            f"| {r['step_time_bound_s']:.3f} "
            f"| {r['roofline_fraction']:.4f} |")
    return "\n".join(rows)


def main() -> None:
    results_dir = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "..", "..", "results",
        "dryrun_torch")
    recs = load(results_dir)
    print("## Dry run — single pod (16x16 = 256 devices)\n")
    print(dryrun_table(recs, "pod1"))
    print("\n## Dry run — multi-pod (2x16x16 = 512 devices)\n")
    print(dryrun_table(recs, "pod2"))
    print("\n## Roofline — per (arch x shape), single-pod baseline\n")
    print(roofline_table(recs, "pod1"))


if __name__ == "__main__":
    main()
