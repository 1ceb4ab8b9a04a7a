"""Continuous batching — the paper's parallel add/remove (§3.2) for serving
(port of ``repro.serve.batching``).

A fixed-slot decode batch (= the paper's fixed-capacity agent pool):
finished sequences are retired and their pages released; queued requests
are admitted into free slots. The decode step always runs at the full
batch shape; inactive slots are masked.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from ..device import DeviceLike
from . import kv_cache as kvc


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int = 32


@dataclasses.dataclass
class Finished:
    uid: int
    tokens: List[int]


class ContinuousBatcher:
    """Host-side orchestrator around a masked decode step.

    prefill_fn(prompt, slot, batcher) → (kv, first token);
    decode_fn(params, tokens (S,) int32 CPU tensor, pool state, active (S,)
    bool CPU tensor) → (next_tokens (S,), pool state). The KV pool is the
    paged cache on ``device`` (None → the CUDA card); admission is blocked
    (queued) when the pool is out of pages.
    """

    def __init__(self, spec: kvc.PagedCacheSpec,
                 prefill_fn: Callable, decode_fn: Callable,
                 eos_token: int = 1, device: DeviceLike = None):
        self.spec = spec
        self.prefill_fn = prefill_fn
        self.decode_fn = decode_fn
        self.eos = eos_token
        self.state = kvc.init_cache(spec, device)
        self.queue: List[Request] = []
        self.slots: List[Optional[dict]] = [None] * spec.max_seqs
        self.finished: List[Finished] = []

    # -- admission (paper §3.2 additions) ------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _admit(self) -> None:
        for i in range(self.spec.max_seqs):
            if self.slots[i] is not None or not self.queue:
                continue
            req = self.queue[0]
            st, ok = kvc.admit_sequence(self.spec, self.state, i,
                                        len(req.prompt))
            if not bool(ok):
                break                      # pool exhausted: stay queued
            self.queue.pop(0)
            self.state = st
            _, last_tok = self.prefill_fn(req.prompt, i, self)
            self.slots[i] = {"req": req, "generated": [],
                             "last": int(last_tok), "left": req.max_new_tokens}

    # -- retirement (paper §3.2 removals) -------------------------------------
    def _retire(self, slot: int) -> None:
        info = self.slots[slot]
        self.finished.append(Finished(info["req"].uid, info["generated"]))
        self.state = kvc.release_sequence(self.spec, self.state, slot)
        self.slots[slot] = None

    # -- one engine iteration --------------------------------------------------
    def step(self, params) -> int:
        self._admit()
        active = np.array([s is not None for s in self.slots])
        if not active.any():
            return 0
        tokens = np.array([s["last"] if s else 0 for s in self.slots],
                          np.int32)
        next_tokens, self.state = self.decode_fn(
            params, torch.from_numpy(tokens), self.state,
            torch.from_numpy(active))
        next_np = np.asarray(next_tokens)
        n = 0
        for i, s in enumerate(self.slots):
            if s is None:
                continue
            tok = int(next_np[i])
            s["generated"].append(tok)
            s["last"] = tok
            s["left"] -= 1
            n += 1
            if tok == self.eos or s["left"] <= 0:
                self._retire(i)
        return n

    def run_until_drained(self, params, max_steps: int = 10_000) -> None:
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                return
            self.step(params)
