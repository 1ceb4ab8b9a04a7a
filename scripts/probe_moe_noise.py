#!/usr/bin/env python3
"""How far chip_smoke phase 40 (a)'s one-device deepseek-v2-lite-16b job
parts from itself when nothing but bf16 rounding changes, printed and
written to chiprun_out/probe_moe_noise.json.

The job is phase 33 (b)'s (``chip_smoke.TRAIN_MOE``: full width, 4 of 27
layers, 2 × 4,096 tokens in 2 microbatches, 5 steps at lr 3e-4) under
deterministic algorithms, from the seed-0 weights, at a warm-up of 2
steps and at ``AdamWConfig``'s 100 (``WARMUPS``); then the same job from
those weights with one bf16 unit in the last place added to a random
2^-10 share of every leaf's elements (two draws): a change below the
rounding of any bf16 implementation of the step, such as the
tensor-parallel one's partial sums. For each run: every step's loss and
grad_norm and their relative gaps to the unperturbed run's, step 1's
routing (``chip_smoke._routing_of``) against the unperturbed run's, and
the dropped share.

    python3 scripts/probe_moe_noise.py          # one card
    python3 scripts/probe_moe_noise.py --cpu    # reduced config, CPU
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402

SPEC = dict(chip_smoke.TRAIN_MOE)
MICRO = chip_smoke.TPM_MICRO
WARMUPS = (2, 100)
SHARE = 2.0 ** -10                 # of each leaf's elements, one ulp each
DRAWS = (1, 2)


def _bump(leaf, gen) -> None:
    """One unit in the last place more magnitude on a random ``SHARE`` of
    ``leaf``'s elements, in place (the integer view of a float adds 1)."""
    import torch
    ints = {torch.bfloat16: torch.int16, torch.float32: torch.int32}
    mask = torch.rand(leaf.shape, generator=gen, device=leaf.device) < SHARE
    bits = leaf.view(ints[leaf.dtype])
    bits += mask.to(bits.dtype)


def _run(cfg, device, warmup: int, draw) -> dict:
    """The job at ``warmup`` from the seed-0 weights, perturbed by
    ``draw`` unless it is None."""
    import torch
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import build_model
    from repro_torch.models import moe as moe_mod
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    from repro_torch.train.optimizer import _leaves
    model = build_model(cfg, attn_impl="sdpa", device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(SPEC["seed"]))
    if draw is not None:
        gen = torch.Generator(device=device).manual_seed(draw)
        for leaf in _leaves(params):
            _bump(leaf, gen)
    ocfg = AdamWConfig(lr=SPEC["lr"], warmup_steps=warmup,
                       total_steps=SPEC["steps"],
                       moment_dtype=cfg.opt_moment_dtype)
    state = init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg, n_microbatches=MICRO)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=SPEC["seq_len"],
                      global_batch=SPEC["batch"], seed=SPEC["seed"])
    rows, routing = [], None
    for i in range(SPEC["steps"]):
        with (chip_smoke._recording(moe_mod, "positions",
                                    lambda out: (out[0], out[2]))
              if i == 0 else contextlib.nullcontext()) as seen:
            params, state, met = step_fn(params, state,
                                         batch_at(dcfg, i, device=device))
        rows.append({k: float(v) for k, v in met.items()})
        if seen is not None:
            routing = chip_smoke._routing_of(seen)
    del params, state
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return {"steps": rows, "routing": routing}


def main() -> int:
    import torch
    cpu = "--cpu" in sys.argv[1:]
    if not cpu and not torch.cuda.is_available():
        print("probe_moe_noise: no CUDA device (--cpu for the rehearsal)",
              file=sys.stderr)
        return 2
    device = torch.device("cpu" if cpu else "cuda")
    cfg = chip_smoke._fsdp_cfg(SPEC)
    if cpu:
        from repro_torch.models import reduced_config
        cfg = dataclasses.replace(reduced_config(cfg), remat="full",
                                  param_dtype="bfloat16",
                                  activation_dtype="bfloat16")
        SPEC["seq_len"] = 64
    torch.use_deterministic_algorithms(True)
    runs = {}
    for warmup in WARMUPS:
        runs[f"warmup{warmup}_base"] = _run(cfg, device, warmup, None)
        for draw in DRAWS:
            runs[f"warmup{warmup}_draw{draw}"] = _run(cfg, device, warmup,
                                                      draw)
    for name, r in runs.items():
        base = runs[name.split("_")[0] + "_base"]
        r["rel_gaps"] = [
            {k: abs(s[k] - b[k]) / abs(b[k]) for k in ("loss", "grad_norm")}
            for s, b in zip(r["steps"], base["steps"])]
        r["routing_equal_to_base"] = (r["routing"]["hashes"]
                                      == base["routing"]["hashes"])
        r["dropped_share"] = (r["routing"]["dropped"]
                              / r["routing"]["assignments"])
        print(f"[noise] {cfg.name} ({cfg.n_layers} layers, "
              f"{'reduced, CPU' if cpu else 'full width'}), {name}: loss "
              + " ".join(f"{s['loss']:.6g}" for s in r["steps"])
              + ", grad_norm " + " ".join(f"{s['grad_norm']:.6g}"
                                          for s in r["steps"])
              + "; rel gaps to base (loss, grad_norm) by step "
              + " ".join(f"({g['loss']:.3g}, {g['grad_norm']:.3g})"
                         for g in r["rel_gaps"])
              + f"; step 1's routing equal to base's: "
              f"{r['routing_equal_to_base']}; dropped share "
              f"{r['dropped_share']:.5f}", flush=True)
    from repro_torch.device import card_description
    out = {"device": ("cpu" if cpu else torch.cuda.get_device_name(0)),
           "card": None if cpu else card_description(),
           "share": SHARE, "spec": SPEC,
           "runs": {k: {kk: vv for kk, vv in v.items() if kk != "routing"}
                    for k, v in runs.items()}}
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "probe_moe_noise.json").write_text(json.dumps(out, indent=1))
    if not cpu:
        print(out["card"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
