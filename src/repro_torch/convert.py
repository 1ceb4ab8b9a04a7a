"""Carry simulation state across: numpy leaves ↔ a port ``EngineState``.

The pool is the state (there are no weights), so a state from the reference
engine converts leaf by leaf: ``np.asarray`` on each of its arrays gives the
dict :func:`state_from_numpy` reads::

    {"pool": {channel: array, ...},         # AgentPool.channels() names
     "rng": (2,) uint32,                    # raw threefry key
     "iteration": () int32,
     "stats": {field: () int32, ...},       # StepStats.FIELDS
     "conc": (X, Y, Z) float32}             # optional

Dtypes are kept (uint32 keys become int64 holding the same values), so
:func:`state_to_numpy` returns arrays equal, bit for bit, to the input.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .core.agents import pool_from_channels
from .core.engine import EngineState
from .core.stats import StepStats
from .device import DeviceLike, resolve_device


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a, dtype=np.int64 if np.asarray(a).dtype == np.uint32
                 else None)                      # a writable copy
    return torch.from_numpy(a).to(device)


def state_from_numpy(leaves: Dict[str, Any], device: DeviceLike = None
                     ) -> EngineState:
    """Build an ``EngineState`` on ``device`` (None → the CUDA card)."""
    dev = resolve_device(device)
    pool = pool_from_channels({k: _to_torch(v, dev)
                               for k, v in leaves["pool"].items()})
    stats = StepStats(**{f: _to_torch(leaves["stats"][f], dev).to(torch.int32)
                         for f in StepStats.FIELDS})
    conc = leaves.get("conc")
    conc = (torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
            if conc is None else _to_torch(conc, dev))
    return EngineState(pool=pool, conc=conc,
                       rng=_to_torch(leaves["rng"], dev),
                       iteration=_to_torch(leaves["iteration"],
                                           dev).to(torch.int32),
                       stats=stats)


def state_to_numpy(state: EngineState) -> Dict[str, Any]:
    """Inverse of :func:`state_from_numpy` (keys back to uint32)."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()
    return {"pool": {k: arr(v) for k, v in state.pool.channels().items()},
            "rng": arr(state.rng).astype(np.uint32),
            "iteration": arr(state.iteration),
            "stats": {f: arr(state.stats[f]) for f in StepStats.FIELDS},
            "conc": arr(state.conc)}
