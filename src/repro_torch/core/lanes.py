"""The lane layout of an ensemble: L independent simulations of C slots
each, stored as one lane-major pool of L·C slots, lane ``l`` in slots
``[l·C, (l+1)·C)`` laid out as its solo pool would be.

The engine's step runs over the whole pool at once. Where the solo step
reduces over the pool (a live count, a maximum, a compaction's prefix sum)
the lane step reduces over each lane's segment; :class:`Lanes` holds those
reductions. With one lane every helper is the solo step's own operation,
so a solo :class:`~.engine.Simulation` runs exactly the operations it ran
before lanes existed.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class Lanes:
    """``n`` lanes of ``capacity`` slots each."""
    n: int = 1
    capacity: int = 0

    @property
    def solo(self) -> bool:
        return self.n == 1

    def view(self, x: torch.Tensor) -> torch.Tensor:
        """(L·C, ...) → (L, C, ...)."""
        return x.reshape(self.n, self.capacity, *x.shape[1:])

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """int32 sum of each lane's rows: () solo, (L,) otherwise."""
        if self.solo:
            return x.sum(dtype=torch.int32)
        return self.view(x).sum(1, dtype=torch.int32)

    def sum_queue(self, valid: torch.Tensor) -> torch.Tensor:
        """int32 count of each lane's entries of a birth queue: ``k``
        blocks of L·C rows, as a behavior stages it over the pool."""
        if self.solo:
            return valid.sum(dtype=torch.int32)
        return valid.reshape(-1, self.n, self.capacity).sum(
            (0, 2), dtype=torch.int32)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """OR of each lane's rows: () solo, (L,) otherwise."""
        if self.solo:
            return x.any()
        return self.view(x).any(1)

    def rows(self, v: torch.Tensor) -> torch.Tensor:
        """A per-lane value (L, ...) repeated for each lane's C rows (an
        expand and one copy: no repeat count crosses from the host)."""
        return v[:, None].expand(self.n, self.capacity, *v.shape[1:]
                                 ).reshape(self.n * self.capacity,
                                           *v.shape[1:])

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """Largest element of each lane's rows: () solo, (L,) otherwise,
        for leaves of L·C or L·M rows (per slot or per box)."""
        if self.solo:
            return x.max()
        return x.reshape(self.n, -1).amax(1)

    def selector(self, lane_mask: torch.Tensor
                 ) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
        """``pick(new, old)``: ``new`` in the lanes ``lane_mask`` (L,)
        holds, ``old`` in the others, for leaves of L, L·C or L·M rows (per
        lane, per slot or per box), each lane's block of rows taking its
        lane's choice. Each row count's mask is expanded once."""
        masks = {self.n: lane_mask}

        def pick(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
            k = new.shape[0] // self.n
            if k * self.n not in masks:
                masks[k * self.n] = lane_mask[:, None].expand(
                    self.n, k).reshape(-1)
            m = masks[k * self.n]
            return torch.where(m.reshape(m.shape + (1,) * (new.dim() - 1)),
                               new, old)
        return pick

    def offsets(self, device) -> torch.Tensor:
        """(L,) int64 first slot of each lane."""
        return torch.arange(self.n, dtype=torch.int64,
                            device=device) * self.capacity


def row_cumsum(a: torch.Tensor) -> torch.Tensor:
    """Inclusive int32 cumulative sum along each row of ``a`` (R, K):
    one scan over the flattened rows less each row's base, the count of
    the rows before it. Equal to ``torch.cumsum(a, 1)``; on the card a
    scan along the inner dimension of a few long rows costs many times
    the one flat scan. Exact while the whole sum fits int32."""
    flat = torch.cumsum(a.reshape(-1), 0, dtype=torch.int32).reshape(
        a.shape)
    base = torch.nn.functional.pad(flat[:-1, -1], (1, 0))
    return flat - base[:, None]
