"""Assert each example's realized neighbor-sweep channel footprint, the
port's counterpart of examples/check_footprints.py.

The fused sweep streams only the union of the registered kernels' declared
channel reads. This script pins, per example, exactly which channels that
union holds, so a behavior that grows its footprint (and the per-step
memory traffic of every example using it) fails instead of landing
unnoticed. It also runs ``engine.check_kernel_footprints`` on each
example: every registered kernel runs alone on zeros holding ONLY its
declared channels, catching reads that ride along on another kernel's
declaration. Nothing here touches a device.

    PYTHONPATH=src python -m repro_torch.examples.check_footprints
"""

from __future__ import annotations

import importlib
import sys
from typing import Optional, Sequence

from ..core import engine as engine_mod
from ..core.forces import FORCE_READS
from ._common import parser

# module name -> expected realized footprint (the order of fused_reads: the
# force kernel first when forces are on, then behaviors in registration
# order). An empty tuple: the example runs no neighbor sweep at all.
EXPECTED = {
    # forces only: GrowDivide/NeuriteGrowth register no neighbor kernels
    "quickstart": FORCE_READS,
    "oncology": FORCE_READS,
    "neuroscience": FORCE_READS,
    # SIR: Infection's kernel, and no diameter — infection never streams
    # mechanical channels
    "epidemiology": ("position", "alive", "agent_type"),
    # diffusion-driven: Secretion/Chemotaxis read the substrate, not
    # neighbors — the step runs zero neighbor sweeps
    "cell_clustering": (),
}

# configs with the Verlet pair list: the list prunes candidates, never
# channels, so the footprint equals the streamed sweep's
PAIRLIST_VARIANTS = {
    "cell_clustering": (lambda mod: mod.make_config(pairlist=True),
                        FORCE_READS),
}


def _check(label: str, cfg, behaviors, expected, failed: list) -> None:
    got = engine_mod.realized_footprint(cfg, behaviors)
    status = "ok"
    if got != tuple(expected):
        status = f"MISMATCH (expected {tuple(expected)})"
        failed.append(label)
    print(f"{label:29s} footprint={got} {status}")
    try:
        engine_mod.check_kernel_footprints(cfg, behaviors)
    except KeyError as e:               # an undeclared read: report, fail
        print(f"{label:29s} footprint check FAILED: {e}")
        failed.append(label)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser(__doc__).parse_args(argv)
    failed: list = []
    for name, expected in EXPECTED.items():
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        behaviors = mod.behaviors()
        _check(name, mod.make_config(), behaviors, expected, failed)
        if name in PAIRLIST_VARIANTS:
            make_cfg, pl_expected = PAIRLIST_VARIANTS[name]
            pl_cfg = make_cfg(mod)
            assert pl_cfg.pairlist is not None, name
            _check(f"{name} [pairlist]", pl_cfg, behaviors, pl_expected,
                   failed)
    if failed:
        print(f"FAILED: {sorted(set(failed))}", file=sys.stderr)
        return 1
    print("OK: all example footprints match their pinned channel sets")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
