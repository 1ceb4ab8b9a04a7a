"""AdamW with global-norm clipping (port of ``repro.train.optimizer``).

Hand-ported line for line, not ``torch.optim.AdamW``: the reference adds
the weight decay to the normalised step (``p − lr·(m̂/(√v̂ + eps) +
wd·p)``), clips by ``min(1, clip / max(norm, 1e-9))`` and keeps its
moments in ``moment_dtype`` (bf16 moments under f32 parameters for the
1T config), none of which torch's optimizer does.

Trees are the parameter tree's nested dicts; the state is ``{"mu", "nu",
"step"}`` with ``step`` an int32 scalar tensor, as the reference's, so
it crosses in checkpoints and ``convert``. The update runs in f32 and is
cast back to each leaf's dtype. The clip scale, the learning rate and the
step stay tensors on the parameters' device: a step reads nothing back.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"       # "bfloat16" for the 1T config
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def _leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves in the reference's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def _unflatten(like: Any, leaves: Iterator[torch.Tensor]) -> Any:
    """``like``'s structure with its leaves taken in :func:`_leaves`'
    order from ``leaves``."""
    if isinstance(like, dict):
        return {k: _unflatten(like[k], leaves) for k in sorted(like)}
    return next(leaves)


def _map(fn, *trees: Any) -> Any:
    first = trees[0]
    if isinstance(first, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in first}
    return fn(*trees)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay (standard LM schedule), in f32."""
    s = step.to(torch.float32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


def init_state(cfg: AdamWConfig, params: Any) -> Dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` and step 0, on each leaf's
    device."""
    dt = _MOMENT_DTYPES[cfg.moment_dtype]

    def zeros(p):
        return torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = _leaves(params)[0].device
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), each leaf's sum in f32."""
    sums = [torch.sum(torch.square(x.float())) for x in _leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: Dict[str, Any]
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns ``(params, state, {"grad_norm", "lr"})``;
    the inputs are not modified."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    s = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, s)
    bc2 = 1 - torch.pow(b2, s)

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu_n = b1 * mu.float() + (1 - b1) * g
        nu_n = b2 * nu.float() + (1 - b2) * g * g
        del g
        mhat = mu_n / bc1
        delta = torch.sqrt(nu_n / bc2)
        delta += cfg.eps
        torch.div(mhat, delta, out=delta)
        del mhat
        delta += cfg.weight_decay * p.float()
        p_n = p.float() - lr * delta
        return p_n.to(p.dtype), mu_n.to(mu.dtype), nu_n.to(nu.dtype)

    out = _map(upd, params, grads, state["mu"], state["nu"])

    def pick(i):
        return _map(lambda o: o[i], out)
    return (pick(0), {"mu": pick(1), "nu": pick(2), "step": step},
            {"grad_norm": gnorm, "lr": lr})
