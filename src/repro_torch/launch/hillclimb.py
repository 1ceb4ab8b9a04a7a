"""Hill-climb (port of ``repro.launch.hillclimb``): dry-run the
optimisation variants of three cells and record their roofline terms
under ``results/perf_torch/``.

Cells:
  kimi-k2-1t-a32b  × train_4k   — worst useful-MFU fraction
  deepseek-v2-lite × train_4k   — most collective-bound
  qwen3-14b        × decode_32k — most paper-representative (KV pool serving)

Each variant goes through the port's dry run (``dryrun.measure``) on the
production mesh. That records the compute term and the argument bytes;
temp bytes and the memory and collective terms are null until a device's
shard of the step is traced under a fake process group (ROADMAP 15c: the
sharded runtime counts the collectives of a real mesh only), so the
hypotheses about collectives cannot be checked yet.

Usage: PYTHONPATH=src python -m repro_torch.launch.hillclimb [variant ...]
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import time
import traceback
from typing import Optional

from ..configs import ARCHS, SHAPES
from ..models.layers import MeshAxes
from . import dryrun
from .mesh import make_production_mesh, mesh_axes

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "perf_torch")


def _variants():
    ds = ARCHS["deepseek-v2-lite-16b"]
    km = ARCHS["kimi-k2-1t-a32b"]
    q3 = ARCHS["qwen3-14b"]
    return {
        # --- deepseek train: attack the collective term ---
        "ds_train_v1_gather": dict(
            cfg=dataclasses.replace(ds, moe_dispatch="gather"),
            shape="train_4k",
            hyp="dispatch as int32 slot-map + activation gather: the f32 "
                "(E,cap,D) scatter-psum becomes one bf16 all-gather "
                "(predict collective −40%)"),
        "ds_train_v2_unshard_ffn": dict(
            cfg=dataclasses.replace(ds, moe_dispatch="gather",
                                    moe_ffn_unsharded=True),
            shape="train_4k",
            hyp="expert FFN dim replicated (weights fit: 1.8 GB/dev): the "
                "down-proj partial-sum all-reduce disappears "
                "(predict collective −50% more)"),
        "ds_train_v3_bf16_sync": dict(
            cfg=dataclasses.replace(ds, moe_dispatch="gather",
                                    moe_ffn_unsharded=True),
            shape="train_4k", grad_sync_dtype="bfloat16",
            hyp="bf16 gradient sync: DP reduce wire halves "
                "(predict collective −20% more)"),
        "ds_train_v4_cf1": dict(
            cfg=dataclasses.replace(ds, moe_dispatch="gather",
                                    moe_ffn_unsharded=True,
                                    capacity_factor=1.0),
            shape="train_4k", grad_sync_dtype="bfloat16",
            hyp="capacity factor 1.25→1.0: dispatched volume −20% "
                "(compute & remaining dispatch wire −20%)"),
        "ds_train_v5_remat_dots": dict(
            cfg=dataclasses.replace(ds, moe_dispatch="gather",
                                    moe_ffn_unsharded=True,
                                    capacity_factor=1.0, remat="dots"),
            shape="train_4k", grad_sync_dtype="bfloat16",
            hyp="remat policy full→dots_saveable: the backward pass stops "
                "replaying the forward's gathers/psums (predict collective "
                "−~25%, memory term up)"),
        # --- kimi train: same levers minus ffn-unshard (weights too big) ---
        "kimi_train_v1_gather": dict(
            cfg=dataclasses.replace(km, moe_dispatch="gather"),
            shape="train_4k",
            hyp="gather dispatch (see ds_v1) at 1T scale"),
        "kimi_train_v2_bf16_sync": dict(
            cfg=dataclasses.replace(km, moe_dispatch="gather"),
            shape="train_4k", grad_sync_dtype="bfloat16",
            hyp="bf16 gradient sync on 1T params"),
        "kimi_train_v3_cf1": dict(
            cfg=dataclasses.replace(km, moe_dispatch="gather",
                                    capacity_factor=1.0),
            shape="train_4k", grad_sync_dtype="bfloat16",
            hyp="capacity factor 1.0"),
        # --- qwen3 decode: attack the memory term ---
        "q3_decode_v1_kv_tp": dict(
            cfg=q3, shape="decode_32k", cache_seq_axis="model",
            hyp="shard the KV seq dim over the idle model axis too: cache "
                "reads spread over 16× more chips (predict memory −~10×, "
                "small softmax psum added)"),
        "q3_decode_v2_tp_only_weights": dict(
            cfg=q3, shape="decode_32k", cache_seq_axis="model",
            axes_override="tp_only",
            hyp="inference weights TP-only (replicated over data — no "
                "optimizer state to co-shard): removes the per-step FSDP "
                "weight all-gather (2.2 GB/dev; predict collective −~45×)"),
    }


def run_variant(key: str, spec: dict, multi_pod: bool = False,
                results_dir: Optional[str] = None) -> dict:
    """Dry-run one variant on the production mesh of ``multi_pod`` and
    write its record to ``results_dir/<key>.json``."""
    cfg = spec["cfg"]
    shape = SHAPES[spec["shape"]]
    mesh = make_production_mesh(multi_pod=multi_pod)
    axes = mesh_axes(multi_pod)
    if spec.get("axes_override") == "tp_only":
        axes = MeshAxes(fsdp=(), tp="model",
                        batch_axes=("pod", "data") if multi_pod else ("data",))
    t0 = time.time()
    m = dryrun.measure(cfg, shape, mesh, axes,
                       grad_sync_dtype=spec.get("grad_sync_dtype"),
                       cache_seq_axis=spec.get("cache_seq_axis"))
    rec = {
        "variant": key, "hypothesis": spec["hyp"],
        "arch": cfg.name, "shape": shape.name, "n_devices": mesh.size,
        "roofline": m["roofline"],
        "model_flops": m["model_flops"],
        "roofline_fraction": m["roofline_fraction"],
        "step_time_bound_s": m["step_time_bound_s"],
        "temp_bytes_per_device": m["memory"]["temp_bytes_per_device"],
        "argument_bytes_per_device":
            m["memory"]["argument_bytes_per_device"],
        "wall_s": round(time.time() - t0, 1),
        **({"pending": m["pending"]} if "pending" in m else {}),
    }
    d = results_dir or RESULTS_DIR
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, key + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    print(json.dumps({k: rec[k] for k in ("variant", "step_time_bound_s",
                                          "roofline_fraction")}))
    return rec


def main() -> None:
    vs = _variants()
    keys = sys.argv[1:] or list(vs)
    for key in keys:
        try:
            run_variant(key, vs[key])
        except Exception:  # noqa: BLE001 — report the variant, go on
            traceback.print_exc()
            print(f"VARIANT FAILED: {key}")


if __name__ == "__main__":
    main()
