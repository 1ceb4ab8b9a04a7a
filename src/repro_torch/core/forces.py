"""Pairwise mechanical interaction force — Cortex3D form (port of
``repro.core.forces``).

  δ     = r_i + r_j − |x_j − x_i|
  F_rep = k_rep · √r_eff · max(δ, 0)^{3/2}
  F_adh = μ(type_i, type_j) · √(r_eff · max(δ + a, 0))      (δ + a > 0)

with r_eff = r_i·r_j/(r_i + r_j); a pair farther apart than its reach
contributes exactly +0.0. The engine's step computes these forces in the K1
kernel (kernels/collision_force.py) or, with ``force_impl="streamed"``,
through :func:`make_force_pair_fn` in the streamed sweep (grid.py);
:func:`pair_force` is the candidate-list form of the same function.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from .agents import weak


@dataclasses.dataclass(frozen=True)
class ForceParams:
    k_rep: float = 2.0               # repulsion stiffness
    adhesion_band: float = 0.4       # δ offset within which adhesion acts
    zeta: float = 1.0                # drag coefficient (overdamped)
    max_displacement: float = 3.0    # per-iteration displacement cap
    force_eps: float = 1e-7          # |F| below this counts as zero
    move_eps: float = 1e-9           # |dx| below this counts as not-moved


def pair_force(q_pos: torch.Tensor, q_dia: torch.Tensor, q_type: torch.Tensor,
               n_pos: torch.Tensor, n_dia: torch.Tensor, n_type: torch.Tensor,
               valid: torch.Tensor, params: ForceParams,
               adhesion: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Force on each query from each candidate: q_* (B, ...), n_* (B, M, ...),
    valid (B, M) → (B, M, 3), zero where invalid or out of reach."""
    d = n_pos - q_pos[:, None, :]
    dist2 = (d * d).sum(-1)
    dist = torch.sqrt(torch.clamp(dist2, min=1e-18))
    r_q = q_dia[:, None] * 0.5
    r_n = n_dia * 0.5
    delta = r_q + r_n - dist
    r_eff = torch.clamp(r_q * r_n / torch.clamp(r_q + r_n, min=1e-12),
                        min=1e-12)
    f_rep = weak(params.k_rep, r_eff) * torch.sqrt(r_eff) * torch.pow(
        torch.clamp(delta, min=0.0), 1.5)
    in_band = delta + params.adhesion_band > 0.0
    if adhesion is not None:
        mu = adhesion[q_type.long()[:, None], n_type.long()]
        band = torch.clamp(delta + params.adhesion_band, min=0.0)
        f_adh = torch.where(in_band, mu * torch.sqrt(r_eff * band),
                            torch.zeros_like(delta))
        f_mag = f_rep - f_adh
    else:
        f_mag = f_rep
    direction = d / dist[..., None]
    interacting = valid & in_band
    return torch.where(interacting[..., None], -f_mag[..., None] * direction,
                       torch.zeros_like(d))


# Channel footprint and outputs of the force pair kernel
FORCE_READS = ("position", "diameter", "agent_type", "alive")
FORCE_OUT_SPECS = {"force": ((3,), torch.float32),
                   "force_nnz": ((), torch.int32)}


def _per_query(params: ForceParams, q_slot: torch.Tensor) -> ForceParams:
    """``params`` with each per-row field (an ensemble's overrides, a (C,)
    tensor of each slot's lane's value) taken at the query rows as a (B, 1)
    column, which broadcasts against the (B, W) candidates."""
    rows = {f.name: v[q_slot.long()][:, None]
            for f in dataclasses.fields(params)
            if isinstance(v := getattr(params, f.name), torch.Tensor)
            and v.dim() == 1}
    return dataclasses.replace(params, **rows) if rows else params


def make_force_pair_fn(params: ForceParams,
                       adhesion: Optional[torch.Tensor] = None) -> Callable:
    """pair_fn of the streamed sweep computing (force, nnz count) per agent:
    the ``force_impl="streamed"`` counterpart of K1. A field of ``params``
    may be a (C,) tensor of per-row values (an ensemble's per-lane
    overrides): each query row then computes with its own."""

    def pair_fn(q: Dict[str, torch.Tensor], nbr: Dict[str, torch.Tensor],
                valid: torch.Tensor, q_slot: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        fp = _per_query(params, q_slot)
        f = pair_force(q["position"], q["diameter"], q["agent_type"],
                       nbr["position"], nbr["diameter"], nbr["agent_type"],
                       valid & nbr["alive"], fp, adhesion)
        nnz = ((f * f).sum(-1) > fp.force_eps ** 2).sum(-1)
        return {"force": f.sum(1), "force_nnz": nnz.to(torch.int32)}

    return pair_fn


def _col(v):
    """A per-row (C,) tensor as a (C, 1) column; anything else as it is."""
    return v[:, None] if isinstance(v, torch.Tensor) and v.dim() == 1 else v


def displacement(force: torch.Tensor, params: ForceParams, dt: float
                 ) -> torch.Tensor:
    """Overdamped integration with the per-step displacement cap. ``dt``
    and the fields of ``params`` may be tensors: 0-dim, or (C,) per row in
    an ensemble."""
    dx = force * _col(dt / params.zeta)
    norm = torch.sqrt(torch.clamp((dx * dx).sum(-1, keepdim=True),
                                  min=1e-30))
    scale = torch.clamp(_col(params.max_displacement) / norm, max=1.0)
    return dx * scale
