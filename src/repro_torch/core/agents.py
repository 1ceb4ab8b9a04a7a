"""Agent pool — fixed-capacity SoA storage (port of ``repro.core.agents``).

Live agents occupy slots ``[0, n_live)``; after every resident grid build they
sit there in row-major grid-key order (grid.py). Channels are plain tensors on
one device; the dataclass only groups them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

_TORCH_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16,
    "float16": torch.float16, "int16": torch.int16, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dt: Any) -> torch.dtype:
    """torch dtype from a torch dtype, numpy dtype or dtype name."""
    if isinstance(dt, torch.dtype):
        return dt
    return _TORCH_DTYPES[np.dtype(dt).name]


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """Per-channel storage dtypes: each capacity rung holds more agents per
    byte.

    Positions stay float32 always (forces and grid keys depend on them);
    the policy narrows the auxiliary channels only:

      aux_float:    ``diameter`` and every float32 behavior extra channel
                    ('float32' | 'bfloat16' | 'float16'). Narrowing trades
                    precision for bytes: the ladder's bit-parity contract
                    holds for the float32 policy.
      compact_ints: ``agent_type`` and ``force_nnz`` as int16 (type ids and
                    neighbor counts below 32768); ``born_iter`` stays int32.

    Arithmetic on a narrowed channel promotes as the reference's does: a
    Python scalar takes the channel's dtype (:func:`weak`), a float32
    tensor promotes the result to float32, and the engine casts each write
    back to the channel's dtype.
    """

    aux_float: str = "float32"
    compact_ints: bool = False

    def __post_init__(self):
        if self.aux_float not in AUX_FLOATS:
            raise ValueError(f"aux_float must be one of {AUX_FLOATS}, got "
                             f"{self.aux_float!r}")

    @property
    def aux_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.aux_float]

    @property
    def int_dtype(self) -> torch.dtype:
        return torch.int16 if self.compact_ints else torch.int32

    def extra_dtype(self, declared: Any) -> torch.dtype:
        """Storage dtype of a behavior extra channel declared ``declared``."""
        dt = torch_dtype(declared)
        return self.aux_dtype if dt == torch.float32 else dt


AUX_FLOATS = ("float32", "bfloat16", "float16")


def weak(value: float, like: torch.Tensor):
    """A Python scalar as the reference's weak-typed JAX scalar meets
    ``like``: rounded to ``like``'s dtype first when that is a narrowed
    float. Torch would otherwise carry a scalar factor at float32 precision
    into a bf16/f16 product (``bf16 * 0.79`` rounds once, from the exact
    float32 product), where JAX rounds the scalar to bf16 before
    multiplying. Float32 tensors take the scalar as they are."""
    if (isinstance(value, (int, float))
            and like.dtype in (torch.bfloat16, torch.float16)):
        return torch.tensor(value, dtype=like.dtype)
    return value


@dataclasses.dataclass
class AgentPool:
    """Structure-of-arrays agent storage; every tensor has leading dim C.

    position (C, 3) f32, diameter (C,) f32, agent_type (C,) i32, alive /
    static / moved / grew (C,) bool, born_iter (C,) i32, force_nnz (C,) i32,
    extra: per-behavior channels.
    """

    position: torch.Tensor
    diameter: torch.Tensor
    agent_type: torch.Tensor
    alive: torch.Tensor
    static: torch.Tensor
    moved: torch.Tensor
    grew: torch.Tensor
    born_iter: torch.Tensor
    force_nnz: torch.Tensor
    extra: Dict[str, torch.Tensor]

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def device(self) -> torch.device:
        return self.position.device

    @property
    def n_live(self) -> torch.Tensor:
        """Number of live agents (0-dim int32 tensor, no host sync)."""
        return self.alive.sum(dtype=torch.int32)

    def channels(self) -> Dict[str, torch.Tensor]:
        """Every per-agent channel, extras as ``extra.<name>``."""
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name != "extra"}
        for k, v in self.extra.items():
            out["extra." + k] = v
        return out

    def with_channels(self, ch: Dict[str, torch.Tensor]) -> "AgentPool":
        return pool_from_channels(ch)


def pool_from_channels(ch: Dict[str, torch.Tensor]) -> AgentPool:
    """Inverse of :meth:`AgentPool.channels`."""
    base = {k: v for k, v in ch.items() if not k.startswith("extra.")}
    extra = {k[len("extra."):]: v for k, v in ch.items()
             if k.startswith("extra.")}
    return AgentPool(extra=extra, **base)


def _as_tensor(x, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(x), device=device).to(dtype)


def make_pool(capacity: int, n_live: int = 0,
              position=None, diameter=None, agent_type=None,
              extra_specs: Optional[Dict[str, Any]] = None,
              policy: Optional[DtypePolicy] = None,
              device: DeviceLike = None) -> AgentPool:
    """Allocate ``capacity`` slots; fill the first ``n_live`` from the args.

    Same defaults as the reference: diameter 10 for live agents without one,
    type 0, every slot ``moved`` at t=0. ``extra_specs`` maps a channel name
    to ``(shape_suffix, dtype, fill)`` or to an (n_live, ...) initial array.
    ``device=None`` means the CUDA card and raises without one.
    """
    policy = policy or DtypePolicy()
    device = resolve_device(device)
    if position is not None:
        n_live = int(position.shape[0])

    def filled(arr, fill, suffix, dt):
        full = torch.full((capacity, *suffix), fill, dtype=dt, device=device)
        if arr is not None and n_live > 0:
            full[:n_live] = _as_tensor(arr, dt, device)
        return full

    pos = filled(position, 0.0, (3,), torch.float32)
    if diameter is not None:
        dia = filled(diameter, 0.0, (), policy.aux_dtype)
    else:
        dia = torch.full((capacity,), 10.0, dtype=policy.aux_dtype,
                         device=device)
    typ = filled(agent_type, 0, (), policy.int_dtype)
    alive = torch.arange(capacity, device=device) < n_live

    extra = {}
    for name, spec in (extra_specs or {}).items():
        if isinstance(spec, tuple):
            suffix, dt, fill = spec
            extra[name] = torch.full((capacity, *suffix), fill,
                                     dtype=policy.extra_dtype(dt),
                                     device=device)
        else:
            arr = np.asarray(spec)
            dt = policy.extra_dtype(arr.dtype)
            full = torch.zeros((capacity, *arr.shape[1:]), dtype=dt,
                               device=device)
            full[:n_live] = _as_tensor(arr, dt, device)
            extra[name] = full

    zeros_b = torch.zeros((capacity,), dtype=torch.bool, device=device)
    return AgentPool(
        position=pos, diameter=dia, agent_type=typ, alive=alive,
        static=zeros_b, moved=torch.ones_like(zeros_b), grew=zeros_b.clone(),
        born_iter=torch.zeros((capacity,), dtype=torch.int32, device=device),
        force_nnz=torch.zeros((capacity,), dtype=policy.int_dtype,
                              device=device),
        extra=extra)
