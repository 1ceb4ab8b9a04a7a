"""Serve a language model with continuous batching over the paged KV pool,
on the CUDA card unless asked for the CPU, or tensor-parallel over the
cards of a (1, T) mesh.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch qwen2-1.5b \\
        --requests 8 --new-tokens 32 --slots 4 --s-max 4096 --pages 1024
    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch mamba2-370m
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch jamba-v0.1-52b --model-ranks 2
    PYTHONPATH=src python -m repro_torch.launch.serve_lm \\
        --arch seamless-m4t-large-v2

(jamba's 32 layers are 103 GB in bf16, more than one 80 GB card holds:
``--model-ranks 2`` serves them over two cards, 52 GB of weights each;
``--layers 16``, two of its 8-layer blocks, fits one card.)

``--model-ranks T`` spawns T ranks (``launch/distributed.spawn_ranks``:
one card each and NCCL, or gloo ranks with ``--device cpu``) over a
("data", "model") mesh of (1, T). Every rank draws the weights from
``--seed`` and keeps its TP block of each (``LM.init_params(generator,
mesh)``), makes its serve tree once (``models/sharding.for_serve``) and
runs the same batcher on the same requests: the prefills and decode
steps run on the rank's heads, columns and experts (K2 on the rank's
heads), its decode caches hold its kv heads and SSM channels, and the
next token is the argmax of the logits made whole over the model group,
the same bytes on every rank, so every host decision (the token, the
admission, ``lens``) is every rank's and the collectives stay in step.
The paged pool keeps the reference's spec with the global ``n_kv_heads``;
it only decides admission. Rank 0 prints and writes the report, with
K2's launches summed over the ranks.

The counterpart of ``examples/serve_lm.py``: a ``ContinuousBatcher`` over
the paged pool (admission control) with dense decode caches per slot
(model side) and greedy ``argmax``. Weights are random, drawn from
``--seed``. It differs from the example in one place: the example writes a
prompt by one ``decode_step`` per token, while here ``prefill_fn`` runs
``LM.prefill`` on the prompt — through K2 for GQA attention, the plain
``_sdpa`` for MLA — and writes the returned caches into the slot's rows of
the decode caches (zero past the prompt), as ``tests/test_arch_smoke.py``
pads prefill caches into decode caches.

Kept from the reference on purpose: ``decode_step`` takes one position for
the whole batch, and the loop passes the longest slot's length
(``lens.max()``), so a shorter slot writes its next K/V at that shared
position and attends the rows between (ROADMAP.md records this). The
paged pool is kept in step with the batch as in the example (its pages
hold zeros; it decides admission). Its spec is the reference's,
``n_kv_heads`` × ``d_head`` a token per layer, for an MLA model too (whose
decode caches hold ``c_kv`` and the rope key instead): at
deepseek-v2-lite-16b's shape the pool's 1,024 pages of 16 tokens take
27 × 1,024 × 16 × 16 × 128 × 2 (K and V) × 2 bytes ≈ 3.6 GB. For mamba2
(``n_kv_heads`` 0, ``d_head`` 0) the pages are zero-size and still decide
admission.

An SSM layer's decode cache is a state, not a sequence: the prompt's
conv window and final state are copied whole into the slot (the
attention leaves of a hybrid into the slot's first rows), so an idle
slot's state is overwritten when the slot is next admitted. Meanwhile
``decode_step`` steps every slot's state, idle slots included (their
outputs are not read), and the shared ``cur_len`` does not reach the SSM
layers: each slot's state advances one token per iteration whatever the
other slots' lengths.

An encoder-decoder model (seamless-m4t) is served with one block of
frame embeddings per request, ``(frontend_tokens, d_model)`` f32 drawn
standard-normal from ``--seed`` in submission order (the reference's
frontend stub, ``data/pipeline.py``; :func:`make_frames`). ``Request`` and
``ContinuousBatcher`` are the reference's and carry no frames: ``serve``
finds a prompt's frames by the identity of its prompt array. The prefill
encodes the frames and writes the cross-attention cache ``xk`` / ``xv``
whole into the slot, like an SSM state; decode reads it and never
re-encodes. The frames do not offset the decoder's positions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from ..configs import ARCHS
from ..kernels import flash_attention as k2
from ..models import EncDecLM, build_model
from ..models import sharding
from ..models.lm import LM
from ..serve import ContinuousBatcher, Finished, Request
from ..serve import kv_cache as kvc


@dataclasses.dataclass
class ServeReport:
    finished: List[Finished]          # in order of completion
    n_free: int                       # pool pages free at the end
    n_pages: int
    prompt_tokens: int                # decoder prompt tokens
    prefill_s: List[float]            # per prefill, prompt in → first token
    ttft_s: List[float]               # per prefill: serve start → first
                                      # token (admission is FIFO, so the
                                      # order of submission)
    decode_s: List[float]             # per decode iteration
    wall_s: float
    logits_finite: bool
    frame_tokens: int = 0             # encoder frames (encoder-decoder)

    @property
    def generated_tokens(self) -> int:
        return sum(len(f.tokens) for f in self.finished)

    def summary(self) -> Dict[str, Any]:
        """The serve's figures. ``prefill_tokens_per_s`` counts decoder
        prompt tokens only: an encoder-decoder's frames (``frame_tokens``)
        are encoded in the same prefills but not counted in it."""
        ttft = sorted(self.ttft_s)
        return {
            "requests": len(self.finished),
            "prefills": len(self.prefill_s),
            "decode_iterations": len(self.decode_s),
            "prompt_tokens": self.prompt_tokens,
            "frame_tokens": self.frame_tokens,
            "generated_tokens": self.generated_tokens,
            "prefill_tokens_per_s": self.prompt_tokens / sum(self.prefill_s),
            "prefill_ms_mean": 1e3 * float(np.mean(self.prefill_s)),
            "ttft_ms_median": 1e3 * float(np.median(ttft)),
            "ttft_ms_max": 1e3 * ttft[-1],
            "decode_ms_per_iter_median": 1e3 * float(
                np.median(self.decode_s)),
            "decode_ms_per_iter_mean": 1e3 * float(np.mean(self.decode_s)),
            "generated_tokens_per_s": self.generated_tokens / self.wall_s,
            "wall_s": self.wall_s,
            "n_free": self.n_free, "n_pages": self.n_pages,
            "logits_finite": self.logits_finite}


def make_requests(n: int, vocab: int, *, prompt_min: int, prompt_max: int,
                  new_tokens: int, seed: int) -> List[Request]:
    """``n`` requests with prompt lengths uniform in [prompt_min,
    prompt_max] and tokens uniform in [2, vocab), from ``seed``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for uid in range(n):
        length = int(rng.integers(prompt_min, prompt_max + 1))
        prompt = rng.integers(2, vocab, size=length).astype(np.int32)
        reqs.append(Request(uid=uid, prompt=prompt,
                            max_new_tokens=new_tokens))
    return reqs


def make_frames(cfg, requests: Sequence[Request], seed: int
                ) -> List[np.ndarray] | None:
    """``serve``'s ``frames`` for ``requests`` under ``cfg``: for an
    encoder-decoder, one block of frame embeddings ``(frontend_tokens,
    d_model)`` f32 per request, standard normal, in submission order, from
    a stream of their own (entropy ``[seed, 1]``, so they do not repeat
    the requests' draws); None for a decoder-only model."""
    if not cfg.encoder_layers:
        return None
    rng = np.random.default_rng([seed, 1])
    return [rng.standard_normal((cfg.frontend_tokens, cfg.d_model)
                                ).astype(np.float32) for _ in requests]


# decode-cache leaves by key: an attention cache has a sequence axis
# second from the end (GQA's k / v (B, Hkv, S, Dh), MLA's c_kv / k_pe
# (B, S, ·)); an SSM cache has none (conv (B, K−1, C), state (B, H, P,
# N)), and an encoder-decoder's cross cache (xk / xv (B, Hkv, S_enc, Dh))
# is the prompt's own: these are copied whole
_SEQ_LEAVES = ("k", "v", "c_kv", "k_pe")
_WHOLE_LEAVES = ("conv", "state", "xk", "xv")


def _keyed_leaves(tree: Any, key: str | None = None
                  ) -> List[tuple[str | None, torch.Tensor]]:
    """(dict key, tensor) of every leaf of a cache tree, dict entries in
    key order."""
    if isinstance(tree, dict):
        return [kl for k in sorted(tree) for kl in _keyed_leaves(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [kl for v in tree for kl in _keyed_leaves(v, key)]
    return [(key, tree)]


def _leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a cache tree, dict entries in key order."""
    return [t for _, t in _keyed_leaves(tree)]


def _put(key: str | None, rows: torch.Tensor, src: torch.Tensor,
         n: int) -> None:
    """Write one leaf of a prefill of length ``n`` into decode rows of the
    same batch: a self-attention leaf into its first ``n`` positions, zero
    past them; an SSM or cross-attention leaf whole."""
    if key in _WHOLE_LEAVES:
        rows.copy_(src)
    elif key in _SEQ_LEAVES:
        rows.zero_()
        rows[..., :n, :] = src
    else:
        raise KeyError(f"decode cache leaf {key!r}")


def write_caches(dense: Any, pre: Any, n: int) -> None:
    """Copy prefill caches (length n) into decode caches of the same batch
    (length s_max): self-attention leaves into their first n positions,
    zero past them; SSM and cross-attention leaves whole."""
    for (key, d), (_, p) in zip(_keyed_leaves(dense), _keyed_leaves(pre),
                                strict=True):
        _put(key, d, p, n)


def _write_prompt(dense: Any, pre: Any, slot: int, n: int) -> None:
    """Copy one prompt's prefill caches (batch 1, length n) into ``slot`` of
    the dense decode caches (batch = slots), as :func:`write_caches`. Both
    are ``(prefix_caches, block_caches)``: the slot axis is axis 0 of a
    prefix leaf and axis 1 of a stacked block leaf. The leaf's key, not its
    shape, says whether it has a sequence axis."""
    for axis, d_part, p_part in zip((0, 1), dense, pre):
        for (key, d), (_, p) in zip(_keyed_leaves(d_part),
                                    _keyed_leaves(p_part), strict=True):
            _put(key, d.select(axis, slot), p.select(axis, 0), n)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _frames_by_prompt(requests: Sequence[Request],
                      frames: Sequence[np.ndarray]) -> Dict[int, np.ndarray]:
    """{id of a request's prompt array: its frames}: the batcher hands
    ``prefill_fn`` the request's own prompt array."""
    if len(frames) != len(requests):
        raise ValueError(f"{len(frames)} frame blocks for {len(requests)} "
                         f"requests")
    shapes = {f.shape for f in frames}
    if len(shapes) != 1:
        raise ValueError(f"frame blocks of unequal shapes {sorted(shapes)}: "
                         f"the slots share one cross-attention cache shape")
    by_prompt = {id(r.prompt): f for r, f in zip(requests, frames)}
    if len(by_prompt) != len(requests):
        raise ValueError("two requests share one prompt array: their "
                         "frames cannot be told apart")
    return by_prompt


def serve(model: LM | EncDecLM, params: Dict, requests: Sequence[Request],
          *, frames: Sequence[np.ndarray] | None = None, slots: int = 4,
          s_max: int = 4096, page_size: int = 16, n_pages: int = 1024,
          eos_token: int = -1, max_steps: int = 100_000,
          tp: sharding.ModelAxis | None = None) -> ServeReport:
    """Serve ``requests`` to completion on the model's device.

    ``eos_token`` −1 (no token ends a request: random weights have no end
    token) makes every request produce its ``max_new_tokens``. Each
    request needs ``len(prompt) + max_new_tokens < s_max``. An
    encoder-decoder model needs ``frames``, one ``(S_enc, d_model)`` block
    per request in the order of ``requests`` (:func:`make_frames`); a
    decoder-only model takes none. With ``tp``, ``params`` is the serve
    tree it came with (``sharding.for_serve``): every rank of the model
    group calls ``serve`` with the same requests, and the decode caches
    are the rank's.
    """
    cfg, dev = model.cfg, model.device
    t = 1 if tp is None else tp.size
    for r in requests:
        if len(r.prompt) + r.max_new_tokens >= s_max:
            raise ValueError(f"request {r.uid}: prompt {len(r.prompt)} + "
                             f"{r.max_new_tokens} new tokens does not fit "
                             f"s_max={s_max}")
    encdec = cfg.encoder_layers > 0
    if encdec != (frames is not None):
        raise ValueError(f"{cfg.name}: frames are "
                         f"{'required' if encdec else 'not taken'}")
    spec = kvc.PagedCacheSpec(
        n_layers=cfg.n_layers, n_kv_heads=cfg.n_kv_heads, d_head=cfg.d_head,
        page_size=page_size, n_pages=n_pages, max_seqs=slots,
        max_pages_per_seq=s_max // page_size, dtype=cfg.activation_dtype)
    if encdec:
        frames_of = _frames_by_prompt(requests, frames)
        caches = model.init_decode_caches(slots, s_max, frames[0].shape[0],
                                          model_ranks=t)
    else:
        caches = model.init_decode_caches(slots, s_max, model_ranks=t)
    lens = np.zeros(slots, np.int64)
    zero_kv = torch.zeros((spec.n_layers, slots, spec.n_kv_heads,
                           spec.d_head), dtype=spec._dt, device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    prefill_s: List[float] = []
    decode_s: List[float] = []
    ttft: List[float] = []

    def prefill_fn(prompt, slot, batcher):
        nonlocal finite
        t = time.perf_counter()
        with record_function("serve/prefill"):
            toks = torch.as_tensor(prompt, dtype=torch.int64,
                                   device=dev)[None]
            fe = (torch.from_numpy(frames_of[id(prompt)]).to(dev)[None]
                  if encdec else None)
            logits, pre = model.prefill(params, toks, fe, tp=tp)
            _write_prompt(caches, pre, slot, toks.shape[1])
            lens[slot] = toks.shape[1]
            finite = finite & torch.isfinite(logits).all()
            first = int(torch.argmax(logits[0]))        # synchronises
        done = time.perf_counter()
        prefill_s.append(done - t)
        ttft.append(done - t0)
        return None, first

    def decode_fn(p, tokens, pool_state, active):
        nonlocal finite
        t = time.perf_counter()
        with record_function("serve/decode"):
            logits, _ = model.decode_step(p, tokens.to(dev, torch.int64),
                                          caches, int(lens.max()), tp=tp)
            lens[active.numpy()] += 1
            finite = finite & torch.isfinite(logits).all()
            nxt = torch.argmax(logits, dim=-1)
            # keep the paged pool in lock-step (admission control)
            st, _ = kvc.append_token(spec, pool_state, zero_kv, zero_kv)
            nxt = nxt.cpu()                              # synchronises
        decode_s.append(time.perf_counter() - t)
        return nxt, st

    batcher = ContinuousBatcher(spec, prefill_fn, decode_fn,
                                eos_token=eos_token, device=dev)
    for r in requests:
        batcher.submit(r)
    _sync(dev)
    t0 = time.perf_counter()
    batcher.run_until_drained(params, max_steps=max_steps)
    _sync(dev)
    wall = time.perf_counter() - t0
    return ServeReport(
        finished=batcher.finished, n_free=int(batcher.state.n_free),
        n_pages=n_pages,
        prompt_tokens=sum(len(r.prompt) for r in requests),
        prefill_s=prefill_s, ttft_s=ttft, decode_s=decode_s, wall_s=wall,
        logits_finite=bool(finite),
        frame_tokens=sum(len(f) for f in frames) if encdec else 0)


def traffic_parser(description: str, **defaults) -> argparse.ArgumentParser:
    """The model, traffic and pool options of a serve (and ``--out``);
    ``defaults`` overrides their defaults."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--arch", default="qwen2-1.5b", choices=sorted(ARCHS))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth (default: the config's)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--prompt-min", type=int, default=256)
    ap.add_argument("--prompt-max", type=int, default=2048)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--s-max", type=int, default=4096)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="write the report as JSON")
    ap.set_defaults(**defaults)
    return ap


def setup(args: argparse.Namespace, device: str | None = None, mesh=None
          ) -> tuple[LM | EncDecLM, Dict, List[Request], Dict[str, Any]]:
    """Model, random weights from ``--seed``, requests and ``serve``'s
    keywords (the pool's, and an encoder-decoder's frames), from
    :func:`traffic_parser`'s options. With a (1, T) ``DeviceMesh`` the
    weights are this rank's serve tree (``sharding.for_serve``, its TP
    blocks of the same draws) and the keywords carry its ``tp``;
    ``launch/mesh.check_divides`` refuses a config that does not split
    over the mesh or whose head dim K2 does not take."""
    cfg = ARCHS[args.arch]
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    pool: Dict[str, Any] = {}
    if mesh is None:
        params = model.init_params(gen)
    else:
        from .mesh import check_divides
        check_divides(cfg, mesh, attn_impl=model.attn_impl)
        params, pool["tp"] = sharding.for_serve(model.init_params(gen, mesh))
    reqs = make_requests(args.requests, cfg.vocab_size,
                         prompt_min=args.prompt_min,
                         prompt_max=args.prompt_max,
                         new_tokens=args.new_tokens, seed=args.seed)
    pool.update(slots=args.slots, s_max=args.s_max,
                page_size=args.page_size, n_pages=args.pages,
                frames=make_frames(cfg, reqs, args.seed))
    return model, params, reqs, pool


def _serve_and_report(args: argparse.Namespace, device: str | None,
                      mesh=None) -> tuple[ServeReport, Dict[str, Any]]:
    """:func:`setup` and :func:`serve`, K2's launches counted over the
    serve; the report's summary with the config, the device and the
    ranks."""
    model, params, reqs, pool = setup(args, device, mesh)
    cfg = model.cfg
    k2.flash_attention.launches = 0
    report = serve(model, params, reqs, **pool)
    summary = {"arch": cfg.name, "n_layers": cfg.n_layers,
               "device": str(model.device),
               "model_ranks": 1 if mesh is None else mesh.size(),
               "k2_launches": k2.flash_attention.launches,
               **report.summary()}
    return report, summary


def _emit(args: argparse.Namespace, summary: Dict[str, Any]) -> None:
    print(json.dumps(summary))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(summary, indent=1))


def _serve_rank(group, device, args: argparse.Namespace) -> None:
    """One rank of ``--model-ranks``: its serve over the (1, T) mesh of
    ``group``; rank 0 prints and writes the summary, K2's launches summed
    over the ranks."""
    import torch.distributed as dist
    from .mesh import Mesh, make_device_mesh
    t = dist.get_world_size(group)
    mesh = make_device_mesh(Mesh((1, t), ("data", "model")), device)
    _, summary = _serve_and_report(args, device, mesh)
    launches = [None] * t
    dist.all_gather_object(launches, summary["k2_launches"], group=group)
    if dist.get_rank(group) == 0:
        _emit(args, dict(summary, k2_launches=sum(launches),
                         k2_launches_by_rank=launches))


def main(argv: Sequence[str] | None = None) -> ServeReport | None:
    ap = traffic_parser(__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card (raises without one)")
    ap.add_argument("--model-ranks", type=int, default=1,
                    help="serve tensor-parallel over a (1, T) mesh of T "
                         "spawned ranks (one card each; gloo ranks with "
                         "--device cpu)")
    args = ap.parse_args(argv)
    if args.model_ranks > 1:
        from .distributed import spawn_ranks
        spawn_ranks(_serve_rank, (args,), args.model_ranks,
                    args.device or "cuda")
        return None
    report, summary = _serve_and_report(args, args.device)
    _emit(args, summary)
    return report


if __name__ == "__main__":
    main()
