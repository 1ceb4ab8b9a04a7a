"""Extracellular diffusion grid (port of ``repro.core.diffusion``).

An explicit FTCS scheme (central-difference Laplacian, decay term) on a
regular voxel grid, with agent sources added per voxel and nearest-voxel
sampling of values and gradients. Stability: dt ≤ h²/(6·D) in 3-D
(:func:`stable_dt`).

The reference runs these inside its jitted step, where ``spec.voxel`` is a
constant and XLA rewrites each division by it into a multiplication by its
float32 reciprocal. The port multiplies by the same reciprocals, so voxel
indices (a floor) and gradients equal the engine's, not those of an eager
call of the reference. The FTCS update agrees to a few float32 ulps:
XLA:CPU also contracts its multiply-adds into FMAs. The port's diffusion
tests hold all of it at voxel 1.5.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import secretion
from .lanes import Lanes


@dataclasses.dataclass(frozen=True)
class DiffusionSpec:
    dims: Tuple[int, int, int]      # voxels per axis
    coefficient: float = 0.1        # D
    decay: float = 0.0              # μ
    voxel: float = 1.0              # h


def stable_dt(spec: DiffusionSpec) -> float:
    return spec.voxel ** 2 / (6.0 * max(spec.coefficient, 1e-12))


def _recip(x: float) -> float:
    """float32(1 / float32(x)): what XLA multiplies by for ``/ x``."""
    return float(np.float32(1.0) / np.float32(x))


def _edge_pad(a: torch.Tensor, x: int, yz: int) -> torch.Tensor:
    """Replicate-pad a 3-D grid, or an ensemble's (L, X, Y, Z) grids, by
    ``x`` voxels along x and ``yz`` along y and z (``jnp.pad(mode="edge")``;
    replicate padding needs a 5-D view)."""
    v = a[:, None] if a.dim() == 4 else a[None, None]
    p = F.pad(v, (yz, yz, yz, yz, x, x), mode="replicate")
    return p[:, 0] if a.dim() == 4 else p[0, 0]


def step_slab(spec: DiffusionSpec, conc: torch.Tensor, dt,
              x_lo: torch.Tensor, x_hi: torch.Tensor) -> torch.Tensor:
    """FTCS step on an x-slab whose face neighbors are given: ``x_lo`` /
    ``x_hi`` (ny, nz) are the planes just outside its low / high x face.
    Passing the slab's own edge planes gives the zero-flux (Neumann)
    boundary, which is how :func:`step` is defined; y and z stay Neumann.

    An ensemble's grids step together: ``conc`` (L, nx, ny, nz), the faces
    (L, ny, nz) and ``dt`` a number or (L,) per lane; each lane's voxels
    take exactly the operations of its solo step."""
    cx = torch.cat([x_lo.unsqueeze(-3), conc, x_hi.unsqueeze(-3)], -3)
    pad = _edge_pad(cx, 0, 1)
    lap = (pad[..., 2:, 1:-1, 1:-1] + pad[..., :-2, 1:-1, 1:-1]
           + pad[..., 1:-1, 2:, 1:-1] + pad[..., 1:-1, :-2, 1:-1]
           + pad[..., 1:-1, 1:-1, 2:] + pad[..., 1:-1, 1:-1, :-2]
           - 6.0 * conc) * _recip(spec.voxel ** 2)
    if isinstance(dt, torch.Tensor) and dt.dim() == 1:
        dt = dt[:, None, None, None]
    return conc + dt * (spec.coefficient * lap - spec.decay * conc)


def step(spec: DiffusionSpec, conc: torch.Tensor, dt) -> torch.Tensor:
    """One FTCS diffusion-decay step with zero-flux (Neumann) boundaries
    (an ensemble's (L, X, Y, Z) grids at once)."""
    return step_slab(spec, conc, dt, conc[..., 0, :, :], conc[..., -1, :, :])


def voxel_of(spec: DiffusionSpec, position: torch.Tensor,
             origin: torch.Tensor) -> torch.Tensor:
    """Voxel indices (N, 3) int32, clipped into the grid."""
    v = torch.floor((position - origin) * _recip(spec.voxel)).to(torch.int32)
    v = v.clamp(min=0)
    return torch.stack([v[:, i].clamp(max=d - 1)
                        for i, d in enumerate(spec.dims)], -1)


def _flat(spec: DiffusionSpec, v: torch.Tensor,
          lanes: Optional[Lanes] = None) -> torch.Tensor:
    """Flat voxel ids; an ensemble's rows index their own lane's grid of
    the (L, X, Y, Z) stack (+ lane·V)."""
    _, ny, nz = spec.dims
    v = v.to(torch.int64)
    flat = (v[:, 0] * ny + v[:, 1]) * nz + v[:, 2]
    if lanes is not None and not lanes.solo:
        vox = spec.dims[0] * ny * nz
        flat = flat + lanes.rows(torch.arange(
            lanes.n, dtype=torch.int64, device=flat.device) * vox)
    return flat


def add_sources(spec: DiffusionSpec, conc: torch.Tensor,
                position: torch.Tensor, amount: torch.Tensor,
                origin: torch.Tensor, lanes: Optional[Lanes] = None
                ) -> torch.Tensor:
    """Add per-agent secretion into the voxel grid, each voxel's amounts in
    slot order, as XLA:CPU's scatter does: ``index_add`` on the CPU, the
    secretion kernel on the card (``kernels/secretion.add``, which computes
    the voxels itself; the card's ``index_add`` adds by atomics, in no
    fixed order). An ensemble's rows add into their own lane's grid: the
    lanes' voxel ids are disjoint and its rows lane-major, so one call
    keeps every voxel's slot order."""
    if conc.device.type != "cpu":
        lane_rows = (position.shape[0] if lanes is None or lanes.solo
                     else lanes.capacity)
        return secretion.add(conc, position, amount, origin, spec.dims,
                             _recip(spec.voxel), lane_rows)
    idx = _flat(spec, voxel_of(spec, position, origin), lanes)
    return conc.reshape(-1).index_add(0, idx, amount.to(conc.dtype)
                                      ).reshape(conc.shape)


def sample(spec: DiffusionSpec, conc: torch.Tensor, position: torch.Tensor,
           origin: torch.Tensor, lanes: Optional[Lanes] = None
           ) -> torch.Tensor:
    idx = _flat(spec, voxel_of(spec, position, origin), lanes)
    return conc.reshape(-1)[idx]


def gradient(spec: DiffusionSpec, conc: torch.Tensor, position: torch.Tensor,
             origin: torch.Tensor, lanes: Optional[Lanes] = None
             ) -> torch.Tensor:
    """Central-difference gradient sampled at agent voxels, (N, 3)."""
    pad = _edge_pad(conc, 1, 1)
    r = _recip(2 * spec.voxel)
    gx = (pad[..., 2:, 1:-1, 1:-1] - pad[..., :-2, 1:-1, 1:-1]) * r
    gy = (pad[..., 1:-1, 2:, 1:-1] - pad[..., 1:-1, :-2, 1:-1]) * r
    gz = (pad[..., 1:-1, 1:-1, 2:] - pad[..., 1:-1, 1:-1, :-2]) * r
    idx = _flat(spec, voxel_of(spec, position, origin), lanes)
    return torch.stack([g.reshape(-1)[idx] for g in (gx, gy, gz)], -1)


class DiffusionOps:
    """Substance-grid operations as the iteration core consumes them, on
    the full in-memory grid (the distributed engine substitutes x-slab ops,
    ``distributed._ShardedDiffusionOps``). ``lanes``: an ensemble's (L, X,
    Y, Z) grids, each row reading and writing its own lane's."""

    def __init__(self, spec: DiffusionSpec, origin: torch.Tensor,
                 lanes: Optional[Lanes] = None):
        self.spec = spec
        self.origin = origin
        self.lanes = lanes

    def step(self, conc: torch.Tensor, dt) -> torch.Tensor:
        return step(self.spec, conc, dt)

    def sample(self, conc: torch.Tensor, position: torch.Tensor
               ) -> torch.Tensor:
        return sample(self.spec, conc, position, self.origin, self.lanes)

    def gradient(self, conc: torch.Tensor, position: torch.Tensor
                 ) -> torch.Tensor:
        return gradient(self.spec, conc, position, self.origin, self.lanes)

    def add_sources(self, conc: torch.Tensor, position: torch.Tensor,
                    amount: torch.Tensor) -> torch.Tensor:
        return add_sources(self.spec, conc, position, amount, self.origin,
                           self.lanes)
