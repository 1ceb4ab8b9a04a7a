"""Where the serving path's time goes on the card: ``torch.profiler`` over
``serve_lm.serve`` at full width.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --requests 4 --new-tokens 8 --out chiprun_out/profile_serve.json
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch deepseek-v2-lite-16b --requests 4 --new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch mamba2-370m --requests 4 --new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch jamba-v0.1-52b --layers 16 --requests 4 --new-tokens 8
    PYTHONPATH=src python -m repro_torch.launch.profile_serve \\
        --arch seamless-m4t-large-v2 --requests 4 --new-tokens 8

Serves the requests twice after a short warm-up: once unprofiled (wall
times) and once under the profiler. Reports the device's busy time and idle
share over the profiled serve (both from that one run; the profiler slows
the host, so the unprofiled serve idles less), and the device time and
launches of each named range (a device operation belongs to the innermost
range open on the host when it was launched): ``attn/k2`` (K2; none for an
MLA model, whose attention runs the plain path), ``full/attn`` (prefill
projections, rope, MLA's attention), ``full/ssm`` (an SSM layer's
projections, conv and chunked SSD), ``full/mlp`` and ``full/moe`` (the
dense MLP; the router, dispatch, expert FFN and combine), ``encode``
(an encoder-decoder's encoder stack, outside its layers' ranges: the
frames' cast and the final norm), ``full/xattn`` (cross-attention: the
plain ``_sdpa`` over the encoder output), ``full/logits``,
``serve/prefill`` (embedding, cache write, argmax), ``decode/attn``,
``decode/xattn`` (over the cached ``xk`` / ``xv``), ``decode/ssm`` (the
one-token recurrence), ``decode/mlp``, ``decode/moe``, ``decode/logits``
and ``serve/decode`` (embedding, argmax, paged-pool
update). Takes ``serve_lm``'s options, with
fewer requests and new tokens by default so the trace stays short. Runs on
the CUDA card only.
"""

from __future__ import annotations

import json
import tempfile
import time
from pathlib import Path

from torch.profiler import ProfilerActivity, profile

from ..device import card_description, resolve_device
from . import serve_lm
from .profile_step import analyze_trace


def main() -> None:
    args = serve_lm.traffic_parser(
        "Where the serving path's time goes on the card.", requests=4,
        new_tokens=8).parse_args()
    resolve_device(None)                      # the card, or raise
    model, params, reqs, pool = serve_lm.setup(args)
    cfg = model.cfg
    warm = serve_lm.make_requests(2, cfg.vocab_size,
                                  prompt_min=args.prompt_min,
                                  prompt_max=args.prompt_max, new_tokens=2,
                                  seed=args.seed + 1)
    serve_lm.serve(model, params, warm, **dict(
        pool, frames=serve_lm.make_frames(cfg, warm, args.seed + 1)))
    plain = serve_lm.serve(model, params, reqs, **pool)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        profiled = serve_lm.serve(model, params, reqs, **pool)
        window_ms = (time.perf_counter() - t0) * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "trace.json")
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    stats = analyze_trace(events, 1)
    wall_ms = plain.wall_s * 1e3
    report = {"card": card_description(), "arch": cfg.name,
              "n_layers": cfg.n_layers, "args": vars(args),
              "serve": plain.summary(),
              "wall_ms": wall_ms, "wall_ms_profiled": profiled.wall_s * 1e3,
              "profiled_window_ms": window_ms,
              "prefill_ms": 1e3 * sum(plain.prefill_s),
              "decode_ms": 1e3 * sum(plain.decode_s),
              "prefill_ms_profiled": 1e3 * sum(profiled.prefill_s),
              "decode_ms_profiled": 1e3 * sum(profiled.decode_s),
              "device_idle_share": 1.0 - stats["device_busy_ms"] / window_ms,
              **stats}
    print(f"card: {report['card']}")
    print(f"{cfg.name} ({cfg.n_layers} layers), {args.requests} requests x "
          f"{args.new_tokens} new tokens: {wall_ms:.2f} ms "
          f"({report['wall_ms_profiled']:.2f} profiled; prefill "
          f"{report['prefill_ms']:.2f}, decode {report['decode_ms']:.2f}); "
          f"device busy {stats['device_busy_ms']:.2f} ms, idle share "
          f"{report['device_idle_share']:.3f} over the profiled "
          f"{window_ms:.2f} ms; {stats['launches']:.0f} device ops")
    for name, r in stats["ranges"].items():
        print(f"  {name:20s} {r['device_ms']:10.3f} ms  "
              f"{r['launches']:8.0f} launches")
    for k in stats["top_device_ops"]:
        print(f"  {k['device_ms']:10.3f} ms  x{k['calls']:7.0f}  "
              f"{k['name'][:90]}")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
