"""End-to-end training driver (port of ``repro.launch.train``): config →
mesh → data → train loop → checkpoints.

Fault-tolerance contract, as the reference's:
  * resumes from the latest checkpoint automatically (crash/preemption
    safe),
  * checkpoints asynchronously every ``ckpt_every`` steps and at the end,
  * the data pipeline is stateless-by-step, so a restart repeats no batch,
  * restore reshards onto whatever mesh the restart runs with (elastic).

Without a mesh the run is one device. With a ``DeviceMesh``
(``launch/mesh.make_device_mesh``) over the ranks of a process group (the
launcher's ``spawn_ranks``, or torchrun) every rank runs ``run`` and the
step is FSDP over the data axis × tensor parallelism over the model axis:
each rank holds its block of every parameter and moment, gathers its TP
block of the weights over the data axis where a layer uses them, runs
every family's layers tensor-parallel over the model axis (GQA, MLA, the
MLPs, the SSM, the expert FFN, the encoder-decoder's cross-attention),
and takes its data coordinate's block of each global microbatch
(``models/sharding.py``, ``data.rank_batch_at``); MoE routing and a
``loss_mask`` over the data ranks keep their one-device meaning. The
checkpoints are the reference's format (``{"params", "opt"}`` through
``train/checkpoint.py``, in the global layout), so a run resumes across
the two packages and across rank counts. The model runs
``attn_impl="sdpa"``: K2 has no backward. The loss is read back to the
host on the log steps only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..data import DataConfig, batch_at, rank_batch_at
from ..device import DeviceLike, resolve_device
from ..models import build_model, sharding
from ..models.layers import MeshAxes, set_hint_axes
from ..train import AdamWConfig, checkpoint, make_train_step
from ..train.optimizer import init_state as opt_init


@dataclasses.dataclass
class TrainJob:
    arch: ArchConfig
    steps: int = 100
    seq_len: int = 512
    global_batch: int = 8
    lr: float = 3e-4
    warmup: int = 20
    n_microbatches: int = 1
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    seed: int = 0


def run(job: TrainJob, mesh=None, axes: Optional[MeshAxes] = None,
        device: DeviceLike = None, log=print) -> Dict[str, float]:
    """Train ``job`` on ``device`` (None → the CUDA card; with a ``mesh``,
    the mesh's device type, this rank's card). ``axes`` names the mesh's
    axes (default ``MeshAxes(fsdp=("data",), tp="model")``). Returns the
    first and the last logged loss, and every logged loss (``losses``):
    with a mesh the same on every rank (all-reduced), logged by global
    rank 0 only. An
    encoder-decoder config gets frames of ``seq_len`` on its encoder, as
    the reference feeds it."""
    if mesh is None:
        return _run(job, None, None, resolve_device(device), log)
    if device is None and mesh.device_type == "cuda":
        device = torch.device("cuda", torch.cuda.current_device())
    dev = resolve_device(device if device is not None else mesh.device_type)
    axes = axes or MeshAxes(fsdp=("data",), tp="model")
    set_hint_axes(axes)
    try:
        return _run(job, mesh, axes, dev, log if torch.distributed.get_rank()
                    == 0 else (lambda *a, **k: None))
    finally:
        set_hint_axes(None)


def _run(job: TrainJob, mesh, axes: Optional[MeshAxes], dev: torch.device,
         log) -> Dict[str, float]:
    cfg = job.arch
    model = build_model(cfg, attn_impl="sdpa", device=dev)
    opt_cfg = AdamWConfig(lr=job.lr, warmup_steps=job.warmup,
                          total_steps=job.steps,
                          moment_dtype=cfg.opt_moment_dtype)
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=job.seq_len,
                      global_batch=job.global_batch,
                      frontend_tokens=(job.seq_len if cfg.encoder_layers
                                       else cfg.frontend_tokens),
                      d_model=cfg.d_model, seed=job.seed)

    params = model.init_params(torch.Generator(device=dev).manual_seed(
        job.seed), mesh, axes)
    opt_state = opt_init(opt_cfg, params)
    start_step = 0
    group, rank, world = sharding.world_of(params)


    ck = checkpoint.AsyncCheckpointer(job.ckpt_dir) if job.ckpt_dir else None
    if job.ckpt_dir:
        latest = checkpoint.latest_step(job.ckpt_dir)
        if latest is not None:
            log(f"[train] resuming from checkpoint step {latest}")
            state = checkpoint.restore(job.ckpt_dir, latest,
                                       {"params": params, "opt": opt_state})
            params, opt_state = state["params"], state["opt"]
            start_step = latest

    step_fn = make_train_step(model, opt_cfg,
                              n_microbatches=job.n_microbatches)

    def batch(step: int):
        if mesh is None:
            return batch_at(dcfg, step, device=dev)
        return rank_batch_at(dcfg, step, rank, world, device=dev,
                             n_microbatches=step_fn.n_microbatches)
    losses = []
    t0 = time.time()
    for step in range(start_step, job.steps):
        params, opt_state, metrics = step_fn(params, opt_state, batch(step))
        if (step + 1) % job.log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            losses.append(loss)
            tok_s = (job.global_batch * job.seq_len * (step + 1 - start_step)
                     / max(time.time() - t0, 1e-9))
            log(f"[train] step {step + 1}/{job.steps} loss={loss:.4f} "
                f"lr={float(metrics['lr']):.2e} "
                f"gnorm={float(metrics['grad_norm']):.3f} tok/s={tok_s:.0f}")
        if ck and (step + 1) % job.ckpt_every == 0:
            ck.save_async(step + 1, {"params": params, "opt": opt_state})
    if ck:
        ck.save_async(job.steps, {"params": params, "opt": opt_state})
        ck.wait()
        if group is not None:       # the others wait for rank 0's write
            one = torch.ones(1, device=dev)
            torch.distributed.all_reduce(one, group=group)
            one.item()
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "losses": losses}
