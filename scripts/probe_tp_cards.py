#!/usr/bin/env python3
"""Two measurements of the sharded training runtime on 4 CUDA cards,
printed and written to chiprun_out/probe_tp_cards.json:

1. ``save``: each card's peak device memory while a checkpoint of the
   full-size qwen3-14b (bf16 params, f32 moments) is gathered onto rank 0
   leaf by leaf and copied to the host, as ``train/checkpoint.save`` does,
   on a (4, 1) and on a (2, 2) ("data", "model") mesh;
2. ``parity``: chip_smoke's phase 37 (a) again (qwen2-1.5b at full width
   and depth, 3 steps of 4 × 4,096 tokens on a (1, 2) mesh against one
   unsharded card in 2 microbatches, deterministic algorithms; phase 36
   shows the unsharded step ≡ the (1, 1) mesh's bit for bit), with the
   element that sets the largest params gap, both runs' Adam moments
   there, and each leaf's first-moment gap between the runs.

    python3 scripts/probe_tp_cards.py          # 4 cards
    python3 scripts/probe_tp_cards.py --cpu    # gloo ranks, reduced configs
"""

from __future__ import annotations

import gc
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402

SAVE_MESHES = ((4, 1), (2, 2))
SAVE_SPEC = dict(chip_smoke.FSDP_CELL)
PARITY = dict(chip_smoke.FSDP_PARITY)
PARITY_MESH = chip_smoke.TP_PARITY_MESH
# the rehearsal's sizes: reduced configs, short sequences
CPU_SIZES = dict(seq_len=64)


def _cfg(spec: dict, cpu: bool):
    from repro_torch.models import reduced_config
    cfg = chip_smoke._fsdp_cfg(spec)
    return reduced_config(cfg) if cpu else cfg


def _memory(device) -> tuple:
    """(allocated, peak) bytes on a card; zeros on the CPU."""
    import torch
    if device.type != "cuda":
        return 0, 0
    torch.cuda.synchronize(device)
    return (torch.cuda.memory_allocated(device),
            torch.cuda.max_memory_allocated(device))


def _save_peak(cfg, mesh, device) -> dict:
    """Rank 0's gather of every leaf of a fresh (params, moments) tree and
    its copy to the host, each card's peak above its state."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch.models import build_model, sharding
    from repro_torch.train import AdamWConfig, checkpoint, init_state
    model = build_model(cfg, attn_impl="sdpa", device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), mesh)
    state = init_state(AdamWConfig(moment_dtype=cfg.opt_moment_dtype),
                       params)
    flat = checkpoint._flatten_with_paths({"params": params, "opt": state})
    held, _ = _memory(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    largest, t0 = ("", 0), time.perf_counter()
    for k, v in flat.items():
        if not isinstance(v, DTensor):
            continue
        whole = sharding.gather_to_rank0(v)
        if whole is not None:
            size = whole.numel() * whole.element_size()
            largest = max(largest, (k, size), key=lambda x: x[1])
            whole.detach().cpu()
        del whole
    _, peak = _memory(device)
    return {"state_bytes": held, "peak_bytes": peak,
            "above_state_bytes": peak - held, "largest_leaf": largest[0],
            "largest_leaf_bytes": largest[1],
            "seconds": time.perf_counter() - t0}


def _steps(spec: dict, cfg, mesh, device, micro: int, save: str) -> dict:
    """``spec``'s steps (on ``mesh``, or unsharded with None), the params
    and moments saved after them."""
    import torch
    from repro_torch.data import DataConfig, rank_batch_at
    from repro_torch.models import build_model, sharding
    from repro_torch.train import (AdamWConfig, checkpoint, init_state,
                                   make_train_step)
    model = build_model(cfg, attn_impl="sdpa", device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(spec["seed"]), mesh)
    ocfg = AdamWConfig(lr=spec["lr"], warmup_steps=spec["warmup"],
                       total_steps=spec["steps"],
                       moment_dtype=cfg.opt_moment_dtype)
    state = init_state(ocfg, params)
    step_fn = make_train_step(model, ocfg, n_microbatches=micro)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=spec["seq_len"],
                      global_batch=spec["batch"], seed=spec["seed"])
    _, rank, world = sharding.world_of(params)
    rows = []
    for i in range(spec["steps"]):
        params, state, met = step_fn(
            params, state, rank_batch_at(
                dcfg, i, rank, world, device=device,
                n_microbatches=step_fn.n_microbatches))
        rows.append({k: float(v) for k, v in met.items()})
    checkpoint.save(save, spec["steps"], {"params": params, "opt": state})
    return {"steps": rows}


def _rank(group, device, jobs: list, out: str) -> None:
    """``jobs`` on this rank; rank 0 writes ``out/<tag>.json`` with every
    rank's record."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as lmesh
    torch.use_deterministic_algorithms(True)
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    for job in jobs:
        cfg = _cfg(job["spec"], job["cpu"])
        mesh = lmesh.make_device_mesh(
            lmesh.Mesh(tuple(job["mesh"]), ("data", "model")), device,
            cfg=cfg)
        if job["kind"] == "save":
            rec = _save_peak(cfg, mesh, device)
        else:
            rec = _steps(job["spec"], cfg, mesh, device, 1, job["save"])
        every = [None] * world
        dist.all_gather_object(every, rec, group=group)
        if rank == 0:
            (Path(out) / f"{job['tag']}.json").write_text(json.dumps(every))
        del mesh
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()


def _spawn(jobs: list, ranks: int, out: Path, device: str) -> dict:
    from repro_torch.launch import distributed as launcher
    out.mkdir(parents=True, exist_ok=True)
    launcher.spawn_ranks(_rank, (jobs, str(out)), ranks, device,
                         timeout_s=900)
    return {j["tag"]: json.loads((out / f"{j['tag']}.json").read_text())
            for j in jobs}


def _moments(d: str, step: int, leaf: str) -> tuple:
    """(mu, nu) of a params leaf ("params/...") in a saved run."""
    import numpy as np
    name = leaf[len("params/"):]
    with np.load(Path(d) / f"step_{step:09d}" / "arrays.npz") as z:
        return z[f"opt/mu/{name}"], z[f"opt/nu/{name}"]


def _leaf_mu_gaps(one: str, tp: str, step: int) -> dict:
    """‖mu_tp − mu_one‖ / ‖mu_one‖ of every leaf: each leaf's gradient
    history on the (1, 2) mesh against one card's."""
    import numpy as np
    out = {}
    with np.load(Path(one) / f"step_{step:09d}" / "arrays.npz") as a, \
            np.load(Path(tp) / f"step_{step:09d}" / "arrays.npz") as b:
        for k in a.files:
            if k.startswith("opt/mu/"):
                x, y = a[k].astype(np.float64), b[k].astype(np.float64)
                out[k[len("opt/mu/"):]] = float(
                    np.linalg.norm(y - x) / max(np.linalg.norm(x), 1e-30))
    return out


def _explain(one: str, tp: str, gap: dict, lr: float, eps: float) -> dict:
    """The worst element's moments in both runs, against its leaf's."""
    import numpy as np
    w = gap["worst"]
    at = tuple(w["index"])
    (mu1, nu1), (mu2, nu2) = (_moments(one, PARITY["steps"], w["leaf"]),
                              _moments(tp, PARITY["steps"], w["leaf"]))
    a = np.abs(mu1)
    return {
        "mu_one": float(mu1[at]), "mu_tp": float(mu2[at]),
        "nu_one": float(nu1[at]), "nu_tp": float(nu2[at]),
        "adam_dir_one": float(mu1[at] / (np.sqrt(nu1[at]) + eps)),
        "adam_dir_tp": float(mu2[at] / (np.sqrt(nu2[at]) + eps)),
        "mu_sign_flipped": bool(np.sign(mu1[at]) != np.sign(mu2[at])),
        "abs_mu_quantile": float((a < abs(mu1[at])).mean()),
        "leaf_median_abs_mu": float(np.median(a)),
        "leaf_mu_rel_gap": float(np.linalg.norm(mu2 - mu1)
                                 / np.linalg.norm(mu1)),
        "gap_over_lr": abs(w["got"] - w["want"]) / lr}


def main() -> int:
    import torch
    cpu = "--cpu" in sys.argv[1:]
    if not cpu and torch.cuda.device_count() < 4:
        print("probe_tp_cards: needs 4 CUDA cards (or --cpu)",
              file=sys.stderr)
        return 1
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    if cpu:
        PARITY.update(CPU_SIZES)
    from repro_torch.train import AdamWConfig
    dev = "cpu" if cpu else "cuda"
    rec: dict = {}
    with tempfile.TemporaryDirectory(prefix="probe_tp_") as tmp:
        tmpd = Path(tmp)
        # 1. the save's peak on (4, 1) and (2, 2)
        got = _spawn([dict(tag=f"save{d}{t}", kind="save", spec=SAVE_SPEC,
                           mesh=(d, t), cpu=cpu) for d, t in SAVE_MESHES],
                     4, tmpd / "save", dev)
        rec["save"] = {}
        for d, t in SAVE_MESHES:
            ranks = got[f"save{d}{t}"]
            rec["save"][f"({d}, {t})"] = ranks
            print(f"[save] {SAVE_SPEC['arch']}{' (reduced)' if cpu else ''}"
                  f" on ({d}, {t}): the checkpoint's gather onto rank 0 and "
                  f"copy to the host in {ranks[0]['seconds']:.1f} s; peak GB "
                  f"by card {[round(r['peak_bytes'] / 1e9, 3) for r in ranks]}"
                  f", state GB "
                  f"{[round(r['state_bytes'] / 1e9, 3) for r in ranks]}"
                  f", rank 0 above its state "
                  f"{ranks[0]['above_state_bytes'] / 1e9:.3f} GB; largest "
                  f"leaf {ranks[0]['largest_leaf']} "
                  f"{ranks[0]['largest_leaf_bytes'] / 1e9:.3f} GB",
                  flush=True)
        # 2. 37 (a) with the worst element explained
        one, tp = str(tmpd / "one"), str(tmpd / "tp")
        torch.use_deterministic_algorithms(True)
        device = torch.device(dev, 0) if dev == "cuda" else torch.device(dev)
        ref = _steps(PARITY, _cfg(PARITY, cpu), None, device, 2, one)
        gc.collect()
        if not cpu:
            torch.cuda.empty_cache()
        torch.use_deterministic_algorithms(False)
        par = _spawn([dict(tag="tp", kind="steps", spec=PARITY,
                           mesh=PARITY_MESH, save=tp, cpu=cpu)],
                     PARITY_MESH[0] * PARITY_MESH[1], tmpd / "par", dev)
        gap = chip_smoke._param_gap(one, tp, PARITY["steps"], PARITY["lr"])
        why = _explain(one, tp, gap, PARITY["lr"], AdamWConfig().eps)
        leaves = _leaf_mu_gaps(one, tp, PARITY["steps"])
        rec["parity"] = {"one": ref, "tp": par["tp"][0], **gap,
                         "explain": why, "leaf_mu_rel_gap": leaves}
        top = sorted(leaves.items(), key=lambda x: -x[1])[:5]
        print(f"[parity] {PARITY['arch']}{' (reduced)' if cpu else ''} on "
              f"{PARITY_MESH} against one card, {PARITY['steps']} steps: "
              f"params {gap['max_gap_over_bound']:.4g} of 3·lr + "
              f"2^-8·|p|, set by {gap['worst']}; there {why}; the leaves' "
              f"largest first-moment gaps {top}", flush=True)
    if not cpu:
        from repro_torch.device import card_description
        rec["card"] = card_description()
        print(rec["card"], flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "probe_tp_cards.json").write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
