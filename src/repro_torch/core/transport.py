"""The distributed engine's moves between shards over a process group.

:class:`~.distributed.ShardAxis` moves data along the shard axis of
stacked tensors on one device: every shard is a lane of one pool.
:class:`GroupShardAxis` makes the same four moves over a
``torch.distributed`` process group of ``W`` ranks, rank ``r`` holding the
block of shards ``[r·S/W, (r+1)·S/W)`` of the ``S`` shards as the lanes of
its own pool: NCCL between cards, gloo between CPU processes. They are the
reference's ``jax.lax`` collectives over its mesh axis:

* ``shift_forward`` / ``shift_backward`` (``ppermute`` one hop, zeros into
  the first / last shard): the block shifts in place and its edge shard
  goes to the neighboring rank, one ``batch_isend_irecv`` a move;
* ``gather`` (a tiled ``all_gather``): one ``all_gather_into_tensor``,
  or one ``gather`` where only one rank needs the whole run (a
  checkpoint's writer);
* ``reduce_scatter`` (a tiled ``psum_scatter``): one
  ``all_to_all_single``, then every rank adds the S source shards of its
  rows in shard order, the order :class:`~.distributed.ShardAxis` adds
  them in. A library reduce-scatter fixes no summation order, so its sum
  could differ from the one-device run in the last bit.

A move takes one tensor or a dict of tensors (every channel of a halo
band) and is ONE collective either way: each tensor is viewed as bytes per
shard and the bytes are concatenated. That also keeps gloo's missing
dtypes (its all-gather refuses int16) off the wire.

Every rank must make the same moves in the same order: nothing here
branches on a value one rank holds and another does not.
"""

from __future__ import annotations

import math
import warnings
from typing import Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

Moved = Union[torch.Tensor, Dict[str, torch.Tensor]]


def _leaves(x: Moved):
    """(names or None, tensors)."""
    if isinstance(x, torch.Tensor):
        return None, [x]
    return list(x), list(x.values())


def _rebuild(names, tensors: List[torch.Tensor]) -> Moved:
    return tensors[0] if names is None else dict(zip(names, tensors))


def _row_bytes(t: torch.Tensor) -> int:
    return math.prod(t.shape[1:]) * t.element_size()


def pack_rows(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """(k, ...) tensors of any dtypes → (k, Σ bytes per row) uint8: row i
    holds every tensor's row i, in order."""
    k = tensors[0].shape[0]
    return torch.cat([t.contiguous().view(torch.uint8).reshape(k, -1)
                      for t in tensors], 1)


def unpack_rows(buf: torch.Tensor, like: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Inverse of :func:`pack_rows` for ``buf`` (k', bytes): each tensor
    with ``like``'s dtype and trailing shape and k' rows (copies, so that
    every one starts aligned for its dtype)."""
    k = buf.shape[0]
    out, at = [], 0
    for t in like:
        n = _row_bytes(t)
        o = torch.empty((k, *t.shape[1:]), dtype=t.dtype, device=buf.device)
        o.view(torch.uint8).reshape(k, n).copy_(buf[:, at:at + n])
        out.append(o)
        at += n
    return out


class GroupShardAxis:
    """The moves of :class:`~.distributed.ShardAxis` over a process group.

    ``n_shards`` must be a multiple of the group's size. Tensors carry the
    rank's block on their leading axis: ``n_local`` shards, global ids
    ``shard_ids`` (``first`` the first of them). With a group of one rank
    every shard is local and the moves are those of ``ShardAxis``, made
    through the group's collectives.
    """

    def __init__(self, n_shards: int, group: "dist.ProcessGroup | None",
                 device: torch.device):
        self.group = dist.group.WORLD if group is None else group
        self.world = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        if n_shards % self.world:
            raise ValueError(f"n_shards={n_shards} is not a multiple of the "
                             f"group's {self.world} ranks")
        self.n = n_shards
        self.n_local = n_shards // self.world
        self.first = self.rank * self.n_local
        self.device = torch.device(device)
        self.shard_ids = torch.arange(self.first, self.first + self.n_local,
                                      device=self.device)

    def _peer(self, group_rank: int) -> int:
        """A rank of the group as the point-to-point ops name it."""
        return dist.get_global_rank(self.group, group_rank)

    def _shift(self, x: Moved, forward: bool) -> Moved:
        names, ts = _leaves(x)
        # the block's own shift, then its edge shard from the neighbor
        if forward:
            out = [torch.cat([torch.zeros_like(t[:1]), t[:-1]]) for t in ts]
            send_to, recv_from, edge, fill = (self.rank + 1, self.rank - 1,
                                              -1, 0)
        else:
            out = [torch.cat([t[1:], torch.zeros_like(t[:1])]) for t in ts]
            send_to, recv_from, edge, fill = (self.rank - 1, self.rank + 1,
                                              0, -1)
        ops = []
        if 0 <= send_to < self.world:
            ops.append(dist.P2POp(dist.isend,
                                  pack_rows([t[edge:][:1] for t in ts]),
                                  self._peer(send_to), self.group))
        recv = None
        if 0 <= recv_from < self.world:
            recv = torch.empty((1, sum(_row_bytes(t) for t in ts)),
                               dtype=torch.uint8, device=self.device)
            ops.append(dist.P2POp(dist.irecv, recv, self._peer(recv_from),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        if recv is not None:
            for o, r in zip(out, unpack_rows(recv, ts)):
                o[fill] = r[0]
        return _rebuild(names, out)

    def shift_forward(self, x: Moved) -> Moved:
        """Shard i receives shard i-1's rows; shard 0 receives zeros."""
        return self._shift(x, True)

    def shift_backward(self, x: Moved) -> Moved:
        """Shard i receives shard i+1's rows; the last receives zeros."""
        return self._shift(x, False)

    def gather(self, x: Moved, dst: Optional[int] = None
               ) -> Optional[Moved]:
        """(n_local, k, ...) on every rank → (n_shards·k, ...): every
        shard's rows in shard order, on every rank; with ``dst`` (a rank
        of the group) on that rank only, None on the others."""
        names, ts = _leaves(x)
        local = pack_rows(ts).reshape(-1)           # (n_local · bytes,)
        if dst is None:
            out = torch.empty((self.world * local.numel(),),
                              dtype=torch.uint8, device=self.device)
            with warnings.catch_warnings():
                # torch 2.13 names all_gather_single instead; 2.11 lacks it
                warnings.filterwarnings("ignore", category=FutureWarning,
                                        message=".*all_gather_into_tensor")
                dist.all_gather_into_tensor(out, local, group=self.group)
        else:
            parts = ([torch.empty_like(local) for _ in range(self.world)]
                     if self.rank == dst else None)
            dist.gather(local, parts, dst=self._peer(dst), group=self.group)
            if parts is None:
                return None
            out = torch.cat(parts)
        parts = unpack_rows(out.reshape(self.n, -1), ts)
        return _rebuild(names, [p.reshape(self.n * t.shape[1], *t.shape[2:])
                                for p, t in zip(parts, ts)])

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """(n_local, n_shards·k, ...) → (n_local, k, ...): the sum over the
        n_shards shards of each, added in shard order, each shard keeping
        its own k rows."""
        nl, w = self.n_local, self.world
        rest = x.shape[2:]
        k = x.shape[1] // self.n
        # to rank j: every local source shard's rows of j's shards
        send = x.reshape(nl, w, nl * k, *rest).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        src = recv.reshape(self.n, nl * k, *rest)   # global shard order
        acc = src[0]
        for i in range(1, self.n):
            acc = acc + src[i]
        return acc.reshape(nl, k, *rest)

    def block(self, x: torch.Tensor) -> torch.Tensor:
        """A global tensor of n_shards·k leading rows → a copy of this
        rank's n_local·k (a copy, so the global tensor is freed with its
        last reference and a rank keeps only its block)."""
        k = x.shape[0] // self.n
        return x[self.first * k:(self.first + self.n_local) * k].clone()
