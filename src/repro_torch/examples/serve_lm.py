"""Batched serving with continuous batching and the paged KV pool (paper
§4.3), the port's counterpart of examples/serve_lm.py.

A small LM serves a queue of requests through fixed decode slots; finished
sequences release their pages back to the pool and queued requests are
admitted — the paper's parallel add/remove (§3.2) as admission control.
As in the reference, a prompt is written into the dense decode caches by
decode steps, so the served path runs the cached decode attention only.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..configs import ARCHS, ArchConfig
from ..models import build_model
from ..serve import ContinuousBatcher, Request
from ..serve import kv_cache as kvc
from ._common import parser

S_MAX = 128


def make_arch() -> ArchConfig:
    """A 2-layer f32 model of the qwen2 family at narrow widths."""
    return dataclasses.replace(
        ARCHS["qwen2-1.5b"], name="qwen2-serve", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=512, vocab_size=8192,
        param_dtype="float32", activation_dtype="float32", remat="none")


def make_cache_spec(arch: ArchConfig) -> kvc.PagedCacheSpec:
    return kvc.PagedCacheSpec(
        n_layers=arch.n_layers, n_kv_heads=arch.n_kv_heads,
        d_head=arch.d_head, page_size=16, n_pages=96, max_seqs=4,
        max_pages_per_seq=S_MAX // 16, dtype="float32")


def main(argv: Optional[Sequence[str]] = None) -> None:
    args = parser(__doc__).parse_args(argv)
    arch = make_arch()
    model = build_model(arch, device=args.device)
    dev = model.device
    params = model.init_params(torch.Generator(device=dev).manual_seed(0))
    spec = make_cache_spec(arch)

    # dense decode caches per slot (model side); the paged pool manages
    # admission/lengths (allocator side)
    caches = model.init_decode_caches(spec.max_seqs, S_MAX)
    lens = np.zeros(spec.max_seqs, np.int64)

    def prefill_fn(prompt, slot, batcher):
        # write the prompt into this slot's dense cache via decode steps
        nonlocal caches
        tok = None
        for p in prompt:
            one = torch.full((spec.max_seqs,), int(p), dtype=torch.int32,
                             device=dev)
            logits, caches = model.decode_step(params, one, caches,
                                               int(lens[slot]))
            lens[slot] += 1
            tok = int(torch.argmax(logits[slot]))
        return None, tok

    decode_calls = {"n": 0}

    def decode_fn(p, tokens, pool_state, active):
        nonlocal caches
        decode_calls["n"] += 1
        logits, caches = model.decode_step(p, tokens.to(dev), caches,
                                           int(lens.max()))
        lens[active.numpy()] += 1
        nxt = torch.argmax(logits, dim=-1).cpu()
        # keep the paged pool in lock-step (admission control ground truth)
        knew = torch.zeros((spec.n_layers, spec.max_seqs, spec.n_kv_heads,
                            spec.d_head), dtype=torch.float32, device=dev)
        pool_state2, _ = kvc.append_token(spec, batcher.state, knew, knew)
        batcher.state = pool_state2
        return nxt, pool_state2

    batcher = ContinuousBatcher(spec, prefill_fn, decode_fn, eos_token=0,
                                device=dev)
    rng = np.random.default_rng(0)
    for uid in range(10):
        prompt = rng.integers(2, 8192, size=rng.integers(4, 12)).astype(
            np.int32)
        batcher.submit(Request(uid=uid, prompt=prompt, max_new_tokens=12))

    batcher.run_until_drained(params, max_steps=500)
    done = sorted(f.uid for f in batcher.finished)
    print(f"finished {len(done)} requests: uids={done}")
    print(f"decode engine iterations: {decode_calls['n']} "
          f"(continuous batching packs multiple requests per iteration)")
    assert done == list(range(10))
    assert int(batcher.state.n_free) == spec.n_pages, "all pages returned"
    print("OK: continuous batching drained the queue; pool leaked nothing")


if __name__ == "__main__":
    main()
