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

On parameters sharded over a mesh (DTensor blocks, ``models/sharding.py``)
each rank updates its blocks, with moments placed like their parameters;
the gradients are the ranks' blocks (plain tensors or DTensors), and the
global norm sums every block's squares over the data axis and, on a
tensor-parallel mesh, the model axis (a leaf replicated along an axis
counted once), so the clip scale is the one-device scale. There the new
parameters and moments are written into the given ones, a slab of rows
at a time (the reference's donated buffers: no second generation of
moments at the update, which a model that needs its state sharded could
not hold).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models import sharding

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


def _like(p: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``local`` as a block placed like ``p`` (a DTensor), or itself."""
    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def init_state(cfg: AdamWConfig, params: Any) -> Dict[str, Any]:
    """Zero moments in ``cfg.moment_dtype`` and step 0, on each leaf's
    device, each placed like its parameter."""
    dt = _MOMENT_DTYPES[cfg.moment_dtype]

    def zeros(p):
        loc = sharding.local(p)
        return _like(p, torch.zeros(loc.shape, dtype=dt, device=loc.device))
    dev = sharding.local(_leaves(params)[0]).device
    return {"mu": _map(zeros, params), "nu": _map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Any, params: Any = None) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), each leaf's sum in f32. With sharded
    ``params`` (the layouts of ``tree``'s blocks) each leaf's sum is summed
    over the data axis's ranks in one all-reduce, a leaf replicated there
    counted once (data rank 0's); over a model axis of more than one rank
    (``sharding.tp_of``) in one more, a leaf replicated over it (the
    norms) counted once (model rank 0's)."""
    sums = torch.stack([torch.sum(torch.square(sharding.local(x).float()))
                        for x in _leaves(tree)])
    group, rank, _ = sharding.world_of(params)
    if group is None:
        return torch.sqrt(torch.sum(sums))
    tp = sharding.tp_of(params)
    lays = [sharding.layout(p) for p in _leaves(params)]
    drop = [(rank > 0 and lay.dim is None)
            or (tp is not None and tp.rank > 0 and lay.mdim is None)
            for lay in lays]
    if any(drop):
        sums = torch.where(torch.tensor(drop, device=sums.device),
                           torch.zeros_like(sums), sums)
    dist.all_reduce(sums, group=group)
    if tp is not None:
        dist.all_reduce(sums, group=tp.group)
    return torch.sqrt(torch.sum(sums))


# elements of one slab of an in-place update (its f32 temporaries)
_SLAB = 1 << 26


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Any, grads: Any,
                  state: Dict[str, Any]
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step. Returns ``(params, state, {"grad_norm", "lr"})``;
    the inputs are not modified, unless the parameters are sharded over a
    mesh: then the new parameters and moments are written into the given
    ones (returned as they are), each leaf in slabs of leading-axis rows,
    each slab computed as the whole leaf would be (elementwise, so
    bit-equal)."""
    step = state["step"] + 1
    gnorm = global_norm(grads, params)
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

    def in_place(p, g, mu, nu):
        loc = [sharding.local(t) for t in (p, g, mu, nu)]
        rows = loc[0].shape[0] if loc[0].dim() else 1
        per = max(1, _SLAB // max(1, loc[0].numel() // rows))
        for i in range(0, rows, per):
            part = [t[i:i + per] if t.dim() else t for t in loc]
            for dst, new in zip((part[0], part[2], part[3]), upd(*part)):
                dst.copy_(new)

    if sharding.is_sharded(params):
        _map(in_place, params, grads, state["mu"], state["nu"])
        return (params, {"mu": state["mu"], "nu": state["nu"], "step": step},
                {"grad_norm": gnorm, "lr": lr})

    def local_upd(p, g, mu, nu):
        out = upd(*(sharding.local(t) for t in (p, g, mu, nu)))
        return tuple(_like(like, o) for like, o in zip((p, mu, nu), out))
    out = _map(local_upd, params, grads, state["mu"], state["nu"])

    def pick(i):
        return _map(lambda o: o[i], out)
    return (pick(0), {"mu": pick(1), "nu": pick(2), "step": step},
            {"grad_norm": gnorm, "lr": lr})
