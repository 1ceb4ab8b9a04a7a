"""Per-iteration statistics (port of ``repro.core.stats``).

Every field is a 0-dim int32 tensor on the engine's device — (L,) in an
ensemble, one counter per lane; the host-side
helpers (:meth:`StepStats.flags`, :meth:`any_overflow`, :meth:`health_bits`)
are the only places that synchronise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass
class StepStats:
    """Counters of one iteration; field meanings as in the reference."""

    n_live: torch.Tensor
    n_active: torch.Tensor
    births: torch.Tensor
    deaths: torch.Tensor
    box_overflow: torch.Tensor
    birth_overflow: torch.Tensor
    halo_overflow: torch.Tensor
    migrate_overflow: torch.Tensor
    in_flight: torch.Tensor
    thin_slab: torch.Tensor
    box_demand: torch.Tensor
    capacity_demand: torch.Tensor
    pair_overflow: torch.Tensor
    pair_demand: torch.Tensor
    rebuilds: torch.Tensor
    rebuild_skips: torch.Tensor
    health: torch.Tensor

    FIELDS = ("n_live", "n_active", "births", "deaths", "box_overflow",
              "birth_overflow", "halo_overflow", "migrate_overflow",
              "in_flight", "thin_slab", "box_demand", "capacity_demand",
              "pair_overflow", "pair_demand",
              "rebuilds", "rebuild_skips", "health")

    # the never-silent-loss flags (demands and health are not overflow)
    OVERFLOW_FIELDS = ("box_overflow", "birth_overflow", "halo_overflow",
                       "migrate_overflow", "in_flight", "thin_slab",
                       "pair_overflow")

    @classmethod
    def zeros(cls, device: DeviceLike = None, shape: tuple = ()
              ) -> "StepStats":
        """All-zero counters of ``shape`` (``(L,)`` for an ensemble;
        ``device=None``: the CUDA card, raising without one)."""
        dev = resolve_device(device)
        return cls(**{f: torch.zeros(shape, dtype=torch.int32, device=dev)
                      for f in cls.FIELDS})

    def __getitem__(self, key: str) -> torch.Tensor:
        if key not in self.FIELDS:
            raise KeyError(key)
        return getattr(self, key)

    def keys(self):
        return iter(self.FIELDS)

    def items(self):
        return ((f, getattr(self, f)) for f in self.FIELDS)

    def overflowed(self) -> torch.Tensor:
        """Any never-silent-loss flag set (0-dim bool tensor, no sync)."""
        total = sum(getattr(self, f).sum() for f in self.OVERFLOW_FIELDS)
        return total > 0

    def flags(self) -> Dict[str, int]:
        """Host-side: the nonzero never-silent flags, ``{field: total}``.

        One device→host copy for all seven fields."""
        vals = torch.stack([getattr(self, f).sum()
                            for f in self.OVERFLOW_FIELDS]).tolist()
        return {f: int(v) for f, v in zip(self.OVERFLOW_FIELDS, vals) if v}

    def any_overflow(self) -> bool:
        return bool(self.overflowed())

    def health_bits(self) -> int:
        """Host-side OR of the health bitmask."""
        out = 0
        for v in self.health.reshape(-1).tolist():
            out |= int(v)
        return out
