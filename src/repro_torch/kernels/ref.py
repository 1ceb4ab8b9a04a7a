"""Dense oracles for the kernels (ports of ``repro.kernels.ref``): the
O(N²) collision force and softmax attention, the ground truth of the
tests."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def collision_force_ref(position: torch.Tensor, diameter: torch.Tensor,
                        agent_type: torch.Tensor, alive: torch.Tensor,
                        k_rep: float,
                        adhesion: Optional[Tuple[Tuple[float, ...], ...]],
                        adhesion_band: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (force (N, 3) f32, nnz (N,) int32) over every live pair,
    self-pairs excluded."""
    n = position.shape[0]
    d = position[None, :, :] - position[:, None, :]
    dist = torch.sqrt(torch.clamp((d * d).sum(-1), min=1e-18))
    r_q = diameter[:, None] * 0.5
    r_n = diameter[None, :] * 0.5
    delta = r_q + r_n - dist
    r_eff = torch.clamp(r_q * r_n / torch.clamp(r_q + r_n, min=1e-12),
                        min=1e-12)
    f_mag = k_rep * torch.sqrt(r_eff) * torch.pow(torch.clamp(delta, min=0.0),
                                                  1.5)
    in_band = delta + adhesion_band > 0.0
    if adhesion is not None:
        adh = torch.tensor(adhesion, dtype=torch.float32,
                           device=position.device)
        t = agent_type.long()
        mu = adh[t[:, None], t[None, :]]
        band = torch.clamp(delta + adhesion_band, min=0.0)
        f_mag = f_mag - torch.where(in_band, mu * torch.sqrt(r_eff * band),
                                    torch.zeros_like(delta))
    eye = torch.eye(n, dtype=torch.bool, device=position.device)
    valid = alive[:, None] & alive[None, :] & ~eye & in_band
    direction = d / dist[..., None]
    pair = torch.where(valid[..., None], -f_mag[..., None] * direction,
                       torch.zeros_like(d))
    force = pair.sum(1)
    nnz = ((pair * pair).sum(-1) > (1e-7) ** 2).sum(1).to(torch.int32)
    return force, nnz


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Reference softmax attention with GQA broadcast.

    q: (B, Hq, Sq, D); k, v: (B, Hkv, Sk, D) with Hq % Hkv == 0. Causal
    masks with −inf, queries aligned to the end of the keys, so a row with
    no visible key is NaN here (K2 writes 0 there).
    """
    b, hq, sq, dh = q.shape
    sk = k.shape[2]
    group = hq // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    scale = scale if scale is not None else 1.0 / (dh ** 0.5)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + (sk - sq)
        kpos = torch.arange(sk, device=q.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask, logits,
                             torch.full((), float("-inf"), device=q.device))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv.float()).to(q.dtype)
