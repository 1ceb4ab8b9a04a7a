"""Numerical health guards folded into ``StepStats.health`` (port of
``repro.core.health``; the fault-injection hooks come with ROADMAP.md
Queue 1 item 10).

Bits: NONFINITE (NaN/Inf in a live position or force), ESCAPE (a live agent
outside the domain plus ``domain_tol``), DISPLACEMENT (per-axis step motion
above ``max_step_displacement``). Observability only: the engine never
raises on them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

NONFINITE = 1
ESCAPE = 2
DISPLACEMENT = 4


@dataclasses.dataclass(frozen=True)
class HealthConfig:
    check_finite: bool = True
    check_domain: bool = True
    domain_tol: float = 0.0
    max_step_displacement: Optional[float] = None

    @property
    def any_enabled(self) -> bool:
        return (self.check_finite or self.check_domain
                or self.max_step_displacement is not None)


def step_health(hcfg: HealthConfig, mask: torch.Tensor,
                position: torch.Tensor, domain_lo: torch.Tensor,
                domain_hi: torch.Tensor,
                force: Optional[torch.Tensor] = None,
                move_d: Optional[torch.Tensor] = None) -> torch.Tensor:
    """() int32 bitmask over the enabled predicates, rows restricted to
    ``mask``."""
    bits = torch.zeros((), dtype=torch.int32, device=position.device)
    if hcfg.check_finite:
        bad = ~torch.isfinite(position).all(-1)
        if force is not None:
            bad |= ~torch.isfinite(force).all(-1)
        bits = bits | (bad & mask).any().to(torch.int32) * NONFINITE
    if hcfg.check_domain:
        tol = hcfg.domain_tol
        out = ((position < domain_lo - tol)
               | (position > domain_hi + tol)).any(-1)
        bits = bits | (out & mask).any().to(torch.int32) * ESCAPE
    if hcfg.max_step_displacement is not None and move_d is not None:
        over = move_d.abs().amax(-1) > hcfg.max_step_displacement
        bits = bits | (over & mask).any().to(torch.int32) * DISPLACEMENT
    return bits
