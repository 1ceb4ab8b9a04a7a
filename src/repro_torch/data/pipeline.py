"""Deterministic synthetic token pipeline, shardable across hosts (port of
``repro.data.pipeline``).

The batch for a step is drawn with numpy from a counter-based seed
``SeedSequence([seed, step, host_id])`` (stateless: any host can make any
batch index, so a restart repeats no data — the data state is the step
counter the checkpoint carries). The draws are the reference's, so tokens
and frontend embeds are bit-equal to its for every ``(step, host_id,
n_hosts)``; only the last step differs: the arrays go onto a torch device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    frontend_tokens: int = 0
    d_model: int = 0          # for frontend embeds


def _host_batch(cfg: DataConfig, step: int, host_id: int, n_hosts: int
                ) -> Dict[str, np.ndarray]:
    per_host = cfg.global_batch // n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    # zipf-ish marginal: realistic token frequency skew
    z = rng.zipf(1.3, size=(per_host, cfg.seq_len)).astype(np.int64)
    tokens = ((z % (cfg.vocab_size - 2)) + 2).astype(np.int32)
    out = {"tokens": tokens}
    if cfg.frontend_tokens:
        out["frontend_embeds"] = rng.standard_normal(
            (per_host, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


def _on(host: Dict[str, np.ndarray], dev: torch.device
        ) -> Dict[str, torch.Tensor]:
    tokens = torch.from_numpy(host["tokens"]).to(dev)
    out = {"tokens": tokens, "labels": tokens}
    if "frontend_embeds" in host:
        out["frontend_embeds"] = torch.from_numpy(
            host["frontend_embeds"]).to(dev)
    return out


def batch_at(cfg: DataConfig, step: int, host_id: int = 0, n_hosts: int = 1,
             device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Batch for ``step``, restricted to this host's shard
    (host-data-parallel): int32 ``tokens`` and ``labels`` (B, S) and, with
    ``frontend_tokens``, f32 ``frontend_embeds`` (B, F, d_model), on
    ``device`` (None → the CUDA card)."""
    dev = resolve_device(device)
    return _on(_host_batch(cfg, step, host_id, n_hosts), dev)


def rank_batch_at(cfg: DataConfig, step: int, rank: int, world: int,
                  device: DeviceLike = None, n_microbatches: int = 1
                  ) -> Dict[str, torch.Tensor]:
    """This rank's rows of the global ``batch_at(cfg, step)``: the
    data-parallel ranks of one step split one batch, whatever their count
    (``batch_at``'s ``host_id`` would seed each rank's rows apart, so the
    data would change with ``world``). The step splits the batch into
    ``n_microbatches`` contiguous global microbatches, as the reference
    does, and the rank takes block ``rank`` of ``world`` of each, in
    microbatch order: rows ``[i·B/n + rank·B/(n·world), i·B/n +
    (rank+1)·B/(n·world))`` for microbatch i (at n = 1, ``[rank·B/world,
    (rank+1)·B/world)``). So the step's own split of these rows into n
    gives the rank its block of each global microbatch, and MoE routing
    over the data ranks sees the reference's microbatches. Only those rows
    go to ``device``. On a ("data", "model") mesh ``rank`` is the data
    coordinate and ``world`` the data axis's size
    (``models/sharding.world_of``): the model ranks of one data coordinate
    take the same rows. Raises ValueError where ``n_microbatches · world``
    does not divide the global batch."""
    if cfg.global_batch % (world * n_microbatches):
        raise ValueError(f"a global batch of {cfg.global_batch} does not "
                         f"split over {world} ranks × {n_microbatches} "
                         f"microbatches")
    dev = resolve_device(device)
    micro = cfg.global_batch // n_microbatches
    per = micro // world
    rows = np.concatenate([np.arange(i * micro + rank * per,
                                     i * micro + (rank + 1) * per)
                           for i in range(n_microbatches)])
    return _on({k: np.ascontiguousarray(v[rows]) for k, v in
                _host_batch(cfg, step, 0, 1).items()}, dev)


def iterate(cfg: DataConfig, start_step: int = 0, host_id: int = 0,
            n_hosts: int = 1, device: DeviceLike = None
            ) -> Iterator[Dict[str, torch.Tensor]]:
    step = start_step
    while True:
        yield batch_at(cfg, step, host_id, n_hosts, device)
        step += 1
