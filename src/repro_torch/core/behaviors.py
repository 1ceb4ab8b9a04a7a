"""Behavior system (port of ``repro.core.behaviors``; this slice carries
``GrowDivide``, the other behaviors are ROADMAP.md Queue 1 item 10).

A behavior reads the step context and returns effects — channel updates,
staged births, death marks — that the engine merges and commits at the end
of the iteration. Its base mask is ``ctx.owned``, never ``pool.alive``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from . import rand
from .agents import AgentPool


def resolve(value, ctx):
    """A behavior knob: a plain number, or a callable ``ctx -> value``."""
    return value(ctx) if callable(value) else value


@dataclasses.dataclass
class BehaviorEffects:
    """What a behavior wants to change; all optional."""
    set_channels: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)
    birth_channels: Optional[Dict[str, torch.Tensor]] = None  # (Q, ...)
    birth_valid: Optional[torch.Tensor] = None                # (Q,) bool
    death_mask: Optional[torch.Tensor] = None                 # (C,) bool
    secretion: Optional[torch.Tensor] = None                  # (C,)


class Behavior:
    """Base class. Subclasses override ``extra_specs`` and ``__call__``;
    neighbor-using behaviors declare ``neighbor_kernels`` (later slice)."""

    name: str = "behavior"

    def extra_specs(self) -> Dict[str, tuple]:
        return {}

    def neighbor_kernels(self) -> Tuple:
        return ()

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        raise NotImplementedError


_HALF_VOLUME = 0.5 ** (1.0 / 3.0)     # d' = d / 2^(1/3) halves the volume


class GrowDivide(Behavior):
    """Grow diameter at ``rate``; split once at ``threshold_diameter``.

    The mother shrinks to half its volume; the daughter is staged at a
    random direction, one mother radius away.
    """

    name = "grow_divide"

    def __init__(self, rate: float = 1.0, threshold_diameter: float = 12.0,
                 applies_to: int | None = None):
        self.rate = rate
        self.threshold = threshold_diameter
        self.applies_to = applies_to

    def _mask(self, ctx, pool: AgentPool) -> torch.Tensor:
        m = ctx.owned
        if self.applies_to is not None:
            m = m & (pool.agent_type == self.applies_to)
        return m

    def __call__(self, ctx, pool: AgentPool, rng: torch.Tensor
                 ) -> BehaviorEffects:
        mask = self._mask(ctx, pool)
        rate = resolve(self.rate, ctx)
        threshold = resolve(self.threshold, ctx)
        # rate·dt in Python double, then one float32 add — the reference's
        # weak-typed scalar arithmetic
        new_dia = torch.where(mask, pool.diameter + rate * ctx.dt,
                              pool.diameter)
        divide = mask & (new_dia >= threshold)
        mother_dia = torch.where(divide, new_dia * _HALF_VOLUME, new_dia)
        direction = rand.normal_rows(rng, pool.capacity, 3)
        direction = direction / torch.sqrt(
            (direction * direction).sum(-1, keepdim=True) + 1e-12)
        d_pos = pool.position + direction * (mother_dia * 0.5)[:, None]
        return BehaviorEffects(
            set_channels={"diameter": mother_dia},
            birth_channels={"position": d_pos, "diameter": mother_dia,
                            "agent_type": pool.agent_type},
            birth_valid=divide)
