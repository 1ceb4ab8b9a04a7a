"""End-to-end training driver (port of ``repro.launch.train``): config →
data → train loop → checkpoints.

Fault-tolerance contract, as the reference's:
  * resumes from the latest checkpoint automatically (crash/preemption
    safe),
  * checkpoints asynchronously every ``ckpt_every`` steps and at the end,
  * the data pipeline is stateless-by-step, so a restart repeats no batch.

The port runs one device: there is no mesh and no ``MeshAxes`` argument
(the reference's FSDP and tensor-parallel sharding wait for ROADMAP.md
Queue 1 items 15b and 18). The checkpoints are the reference's format
(``{"params", "opt"}`` through ``train/checkpoint.py``), so a run resumes
across the two packages. The model runs ``attn_impl="sdpa"``: K2 has no
backward. The loss is read back to the host on the log steps only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..data import DataConfig, batch_at
from ..device import DeviceLike, resolve_device
from ..models import build_model
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


def run(job: TrainJob, device: DeviceLike = None, log=print
        ) -> Dict[str, float]:
    """Train ``job`` on ``device`` (None → the CUDA card). Returns the
    first and the last logged loss, and every logged loss (``losses``).
    An encoder-decoder config gets frames of ``seq_len`` on its encoder,
    as the reference feeds it."""
    dev = resolve_device(device)
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
        job.seed))
    opt_state = opt_init(opt_cfg, params)
    start_step = 0

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
    losses = []
    t0 = time.time()
    for step in range(start_step, job.steps):
        batch = batch_at(dcfg, step, device=dev)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
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
    return {"final_loss": losses[-1] if losses else float("nan"),
            "first_loss": losses[0] if losses else float("nan"),
            "losses": losses}
