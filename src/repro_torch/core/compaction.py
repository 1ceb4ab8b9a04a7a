"""Agent removal and addition as prefix-sum stream compaction (port of
``repro.core.compaction``: the commit phase of the step, the capacity
ladder's restage, and the active index and block lists of static-region
skipping)."""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .agents import AgentPool
from .lanes import Lanes, row_cumsum


def compaction_permutation(alive: torch.Tensor,
                           lanes: Optional[Lanes] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Permutation placing live slots first (stable), dead after (stable);
    with ``lanes``, within each lane's segment.

    Returns ``(perm, n_live)`` with ``new[i] = old[perm[i]]`` (``n_live``
    (L,) per lane)."""
    c = alive.shape[0]
    if lanes is not None and not lanes.solo:
        a = lanes.view(alive).to(torch.int32)
        n_live = a.sum(1, dtype=torch.int32)
        live_before = row_cumsum(a)
        dst_live = live_before - 1
        # the dead slots up to j: (j + 1) less the live ones
        ar = torch.arange(1, a.shape[1] + 1, dtype=torch.int32,
                          device=alive.device)
        dst_dead = n_live[:, None] + (ar - live_before) - 1
        dst = torch.where(lanes.view(alive), dst_live, dst_dead).to(
            torch.int64) + lanes.offsets(alive.device)[:, None]
        perm = torch.empty(c, dtype=torch.int32, device=alive.device)
        perm[dst.reshape(-1)] = torch.arange(c, dtype=torch.int32,
                                             device=alive.device)
        return perm, n_live
    alive_i = alive.to(torch.int32)
    n_live = alive_i.sum(dtype=torch.int32)
    dst_live = torch.cumsum(alive_i, 0, dtype=torch.int32) - 1
    dst_dead = n_live + torch.cumsum(1 - alive_i, 0, dtype=torch.int32) - 1
    dst = torch.where(alive, dst_live, dst_dead).to(torch.int64)
    perm = torch.empty(c, dtype=torch.int32, device=alive.device)
    perm[dst] = torch.arange(c, dtype=torch.int32, device=alive.device)
    return perm, n_live


def apply_permutation(pool: AgentPool, perm: torch.Tensor) -> AgentPool:
    """Gather-reorder every SoA channel by ``perm``."""
    idx = perm.to(torch.int64)
    return pool.with_channels({k: v.index_select(0, idx)
                               for k, v in pool.channels().items()})


def compact(pool: AgentPool, lanes: Optional[Lanes] = None) -> AgentPool:
    """Remove dead agents: live agents move (stably) to slots [0, n_live)
    (of each lane's segment, with ``lanes``)."""
    perm, _ = compaction_permutation(pool.alive, lanes)
    return apply_permutation(pool, perm)


def _lane_queue(queue_valid: torch.Tensor, lanes: Lanes) -> torch.Tensor:
    """A birth queue's valid flags (k·L·C,) — ``k`` blocks of L·C rows, as
    a behavior stages them over the lane-major pool — as (L, k·C): each
    lane's entries in its solo queue order."""
    k = queue_valid.shape[0] // (lanes.n * lanes.capacity)
    return queue_valid.reshape(k, lanes.n, lanes.capacity).transpose(
        0, 1).reshape(lanes.n, k * lanes.capacity)


def commit_births(pool: AgentPool, queue: Dict[str, torch.Tensor],
                  queue_valid: torch.Tensor, iteration: torch.Tensor,
                  lanes: Optional[Lanes] = None) -> AgentPool:
    """Append staged newborns at the tail of the live region.

    Destinations are ``n_live + cumsum(valid) - 1``; a write whose
    destination is not below capacity is parked at index ``c`` and dropped
    (the engine counts it as ``birth_overflow``). Queue channels win over
    the defaults (alive, moved, grew set; static clear; born_iter =
    ``iteration``; force_nnz 0; everything else zero). With ``lanes`` each
    lane's newborns fill its own free slots in its solo queue order, and
    ``iteration`` is (L,).
    """
    c = pool.capacity
    dev = pool.device
    shape = queue_valid.shape
    if lanes is not None and not lanes.solo:
        n, per = lanes.n, lanes.capacity
        k = shape[0] // (n * per)
        qv = _lane_queue(queue_valid, lanes)
        n_live = lanes.sum(pool.alive)
        dst = n_live[:, None] + row_cumsum(qv.to(torch.int32)) - 1
        ok = qv & (dst < per)
        dst = torch.where(ok, dst.to(torch.int64)
                          + lanes.offsets(dev)[:, None],
                          torch.full((), c, dtype=torch.int64, device=dev))
        dst = dst.reshape(n, k, per).transpose(0, 1).reshape(-1)
        born = iteration.to(torch.int32)[None, :, None].expand(
            k, n, per).reshape(shape)
    else:
        qv = queue_valid.to(torch.int32)
        dst = pool.n_live + torch.cumsum(qv, 0, dtype=torch.int32) - 1
        ok = queue_valid & (dst < c)
        # parked writes land in an extra row c that is cut off afterwards
        dst = torch.where(ok, dst, torch.full_like(dst, c)).to(torch.int64)
        born = iteration.to(torch.int32).expand(shape)

    out = {}
    for k, v in pool.channels().items():
        if k in queue:
            src = queue[k]
        elif k in ("alive", "moved", "grew"):
            src = torch.ones(shape, dtype=torch.bool, device=dev)
        elif k == "born_iter":
            src = born
        else:                                   # static, force_nnz, extras
            src = torch.zeros(shape + v.shape[1:], dtype=v.dtype, device=dev)
        grown = torch.cat([v, v[:1]], 0)        # row c: the parking slot
        grown[dst] = src.to(v.dtype)
        out[k] = grown[:c]
    return pool.with_channels(out)


def birth_overflow(pool: AgentPool, queue_valid: torch.Tensor,
                   lanes: Optional[Lanes] = None) -> torch.Tensor:
    """Number of staged newborns that will not fit in capacity (int32; (L,)
    per lane with ``lanes``)."""
    if lanes is not None and not lanes.solo:
        n_new = _lane_queue(queue_valid, lanes).sum(1, dtype=torch.int32)
        free = lanes.capacity - lanes.sum(pool.alive)
        return torch.clamp(n_new - free, min=0)
    n_new = queue_valid.sum(dtype=torch.int32)
    free = pool.capacity - pool.n_live
    return torch.clamp(n_new - free, min=0)


# ---------------------------------------------------------------------------
# Capacity-ladder restage
# ---------------------------------------------------------------------------
#
# A rung cannot resize a tensor in place: the restage allocates the larger
# channels and copies the old pool into their prefix. Torch has no buffer
# donation, so the old channels live until the caller drops them; the restage
# holds no reference past its return, so a rung's peak is about old + new.

def grow_channels(ch: Dict[str, torch.Tensor], new_capacity: int
                  ) -> Dict[str, torch.Tensor]:
    """Re-stage a channel dict into ``new_capacity`` slots, dtypes kept.

    Slots ``[old_capacity, new_capacity)`` are zero-filled and dead
    (``alive`` False), as the tail of a freshly made pool, so a live
    trajectory equals a pre-sized pool's. Growing to the same capacity
    returns ``ch`` itself; growing to a smaller one raises.
    """
    cap = next(iter(ch.values())).shape[0]
    if new_capacity < cap:
        raise ValueError(f"cannot shrink pool {cap} -> {new_capacity}")
    if new_capacity == cap:
        return ch
    out = {}
    for k, v in ch.items():
        g = torch.zeros((new_capacity, *v.shape[1:]), dtype=v.dtype,
                        device=v.device)
        g[:cap] = v
        out[k] = g
    return out


def grow_pool(pool: AgentPool, new_capacity: int) -> AgentPool:
    """Re-stage a pool into a larger fixed-shape pool (a capacity rung)."""
    return pool.with_channels(grow_channels(pool.channels(), new_capacity))


def repack_slabs(channels: Dict[str, Any], n_shards: int, old_local: int,
                 new_local: int) -> Dict[str, Any]:
    """Re-pack sharded slab channels into a new local width.

    Channels are global ``(n_shards·old_local, ...)`` arrays with shard i's
    agents in ``[i·old_local, i·old_local + n_i)``. Each shard's slab is
    kept verbatim and padded with zero (dead) tail slots: the distributed
    counterpart of :func:`grow_channels`, used by the distributed ladder's
    restage and by a restore onto a larger rung. Tensors stay tensors on
    their device; numpy in, numpy out, as the reference.
    """
    if new_local < old_local:
        raise ValueError(f"cannot shrink slabs {old_local} -> {new_local}")
    out = {}
    for k, v in channels.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(
            np.array(v))
        g = torch.zeros((n_shards, new_local, *t.shape[1:]),
                        dtype=t.dtype, device=t.device)
        g[:, :old_local] = t.reshape(n_shards, old_local, *t.shape[1:])
        g = g.reshape(n_shards * new_local, *t.shape[1:])
        out[k] = g if isinstance(v, torch.Tensor) else g.numpy()
    return out


def active_index_list(active: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compact the indices of active slots to the front.

    Returns ``(idx, n_active)``: ``idx[:n_active]`` are the active slots in
    order, the tail repeats the last active index (0 if none is active).
    """
    c = active.shape[0]
    a = active.to(torch.int32)
    n_active = a.sum(dtype=torch.int32)
    ar = torch.arange(c, dtype=torch.int32, device=active.device)
    dst = torch.where(active, torch.cumsum(a, 0, dtype=torch.int32) - 1,
                      torch.full_like(ar, c)).to(torch.int64)
    # row c parks the inactive writes and is cut off
    idx = torch.zeros(c + 1, dtype=torch.int32, device=active.device)
    idx[dst] = ar
    idx = idx[:c]
    last = idx[torch.clamp(n_active - 1, min=0).to(torch.int64)]
    pad_val = torch.where(n_active > 0, last, torch.zeros_like(last))
    return torch.where(ar < n_active, idx, pad_val), n_active


def active_block_list(active: torch.Tensor, block: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ids of ``block``-sized slot ranges holding ≥ 1 active slot, as
    :func:`active_index_list` returns them; a trailing partial range counts
    as one block."""
    c = active.shape[0]
    n_blk = (c + block - 1) // block
    padded = torch.nn.functional.pad(active, (0, n_blk * block - c))
    return active_index_list(padded.reshape(n_blk, block).any(1))
