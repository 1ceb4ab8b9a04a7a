"""Numerical health guards folded into ``StepStats.health`` (port of
``repro.core.health``).

Bits: NONFINITE (NaN/Inf in a live position or force), ESCAPE (a live agent
outside the domain plus ``domain_tol``), DISPLACEMENT (per-axis step motion
above ``max_step_displacement``). Observability only: the engine never
raises on them.

The module also holds the test-only fault injection: deterministic
host-side corruption of an ``EngineState`` between steps (a value written,
bits flipped, an overflow flag forced on), so every reaction to a fault can
be exercised without waiting for one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .agents import pool_from_channels
from .lanes import Lanes

NONFINITE = 1
ESCAPE = 2
DISPLACEMENT = 4

_FLAG_NAMES = ((NONFINITE, "nonfinite"), (ESCAPE, "domain_escape"),
               (DISPLACEMENT, "displacement"))


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
                move_d: Optional[torch.Tensor] = None,
                lanes: Optional[Lanes] = None) -> torch.Tensor:
    """() int32 bitmask over the enabled predicates, rows restricted to
    ``mask``; (L,), one mask per lane, with ``lanes``."""
    lanes = lanes or Lanes()
    bits = torch.zeros((), dtype=torch.int32, device=position.device)
    if hcfg.check_finite:
        bad = ~torch.isfinite(position).all(-1)
        if force is not None:
            bad |= ~torch.isfinite(force).all(-1)
        bits = bits | lanes.any(bad & mask).to(torch.int32) * NONFINITE
    if hcfg.check_domain:
        tol = hcfg.domain_tol
        out = ((position < domain_lo - tol)
               | (position > domain_hi + tol)).any(-1)
        bits = bits | lanes.any(out & mask).to(torch.int32) * ESCAPE
    if hcfg.max_step_displacement is not None and move_d is not None:
        over = move_d.abs().amax(-1) > hcfg.max_step_displacement
        bits = bits | lanes.any(over & mask).to(torch.int32) * DISPLACEMENT
    return bits


def fault_bits(health) -> int:
    """Host-side OR over a step's health field (scalar or vector)."""
    h = health.detach().cpu().numpy() if isinstance(health, torch.Tensor) \
        else health
    return int(np.bitwise_or.reduce(np.asarray(h, np.int32).ravel(),
                                    initial=0))


def describe(bits: int) -> Tuple[str, ...]:
    """Names of the set health bits, e.g. ``('nonfinite',)``."""
    return tuple(name for bit, name in _FLAG_NAMES if bits & bit)


class HealthFault(RuntimeError):
    """A health flag fired and the supervisor ran out of remedies; carries
    the decoded flag names, the run report and the last healthy state."""

    def __init__(self, message: str, bits: int = 0, state=None, report=None):
        super().__init__(message)
        self.bits = bits
        self.flags = describe(bits)
        self.state = state
        self.report = report


def _channels(state):
    """(channels, rebuild(channels) -> state) of an ``EngineState`` or a
    ``DistState`` (whose channels are the global per-shard slabs)."""
    if hasattr(state, "pool"):
        def rebuild(ch):
            return dataclasses.replace(state, pool=pool_from_channels(ch))
        return state.pool.channels(), rebuild
    if hasattr(state, "channels"):
        def rebuild(ch):
            return dataclasses.replace(state, channels=ch)
        return dict(state.channels), rebuild
    raise TypeError(f"not a simulation state: {type(state)!r}")


def inject_value(state, channel: str, slot: int, value):
    """Overwrite one row (or one lane of a vector channel) with ``value``;
    ``inject_value(state, "position", 3, float("nan"))`` is the NaN
    injection the NONFINITE guard catches on the next step."""
    ch, rebuild = _channels(state)
    arr = ch[channel].clone()
    arr[slot] = value
    return rebuild({**ch, channel: arr})


def flip_bits(state, channel: str, slot: int, mask: int = 0x00400000):
    """XOR ``mask`` into one float32 row: simulated memory corruption. The
    default flips a high mantissa bit (large, finite); ``0x7FC00000``
    forges a quiet NaN."""
    ch, rebuild = _channels(state)
    t = ch[channel]
    if t.dtype != torch.float32:
        raise TypeError(f"flip_bits targets float32 channels, {channel} is "
                        f"{t.dtype}")
    arr = t.detach().cpu().numpy().copy()
    flat = arr.reshape(arr.shape[0], -1)
    flat[slot] = (flat[slot].view(np.uint32) ^ np.uint32(mask)).view(
        np.float32)
    return rebuild({**ch, channel: torch.from_numpy(arr).to(t.device)})


def storm_flags(state, field: str = "birth_overflow", count: int = 1):
    """Force a never-silent overflow flag on, as if ``count`` items had
    been dropped, so reactions to an overflow storm can be tested."""
    stats = dataclasses.replace(state.stats, **{
        field: torch.full_like(getattr(state.stats, field), count)})
    return dataclasses.replace(state, stats=stats)
