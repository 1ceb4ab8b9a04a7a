"""End-to-end LM training: data pipeline → train loop → async
checkpoints → resume (the port's counterpart of examples/train_lm.py).

Presets:
  smoke (default) ~7M params, 60 steps.
  100m            ~100M params, 300 steps — the end-to-end size.
  encdec-smoke    the encoder-decoder (reduced seamless-m4t-large-v2,
                  0.26M params), 60 steps, frames of the sequence length
                  on the encoder; the port's own preset (the reference's
                  example trains the qwen2 presets only).

Demonstrates fault tolerance: run it, kill it mid-way, run again — it
resumes from the latest checkpoint and repeats no data.

    PYTHONPATH=src python -m repro_torch.examples.train_lm \\
        [smoke|100m|encdec-smoke] \\
        [--ckpt DIR] [--steps N] [--device D]

``--ckpt`` defaults to ``repro_torch_ckpt`` under the temporary
directory; a second run with the same directory resumes.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Optional, Sequence

from ..configs import ARCHS, ArchConfig
from ..launch.train import TrainJob, run
from ..models import build_model, reduced_config
from ._common import parser


def make_arch(preset: str) -> ArchConfig:
    """The reference's presets, field for field, and ``encdec-smoke``."""
    if preset == "encdec-smoke":
        return reduced_config(ARCHS["seamless-m4t-large-v2"])
    base = ARCHS["qwen2-1.5b"]
    if preset == "smoke":
        return dataclasses.replace(
            base, name="qwen2-smoke", n_layers=2, d_model=128, n_heads=4,
            n_kv_heads=2, d_head=32, d_ff=512, vocab_size=8192,
            param_dtype="float32", activation_dtype="float32", remat="none")
    # ~100M: tied embeddings 50k x 640 = 32M + 10 blocks x ~6.5M
    return dataclasses.replace(
        base, name="qwen2-100m", n_layers=10, d_model=640, n_heads=10,
        n_kv_heads=2, d_head=64, d_ff=2560, vocab_size=50304,
        param_dtype="float32", activation_dtype="float32", remat="none")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = parser(__doc__)
    ap.add_argument("preset", nargs="?", default="smoke",
                    choices=["smoke", "100m", "encdec-smoke"])
    ap.add_argument("--ckpt", default=None,
                    help="checkpoint directory (default: repro_torch_ckpt "
                         "under the temporary directory)")
    ap.add_argument("--steps", type=int, default=None)
    args = ap.parse_args(argv)

    arch = make_arch(args.preset)
    n = build_model(arch, device=args.device).n_params()
    print(f"[train_lm] arch={arch.name} params={n:,}")
    small = args.preset != "100m"
    steps = args.steps or (60 if small else 300)
    ckpt = args.ckpt or os.path.join(tempfile.gettempdir(),
                                     "repro_torch_ckpt")
    job = TrainJob(arch=arch, steps=steps,
                   seq_len=256 if small else 512,
                   global_batch=8, lr=1e-3, warmup=10,
                   ckpt_dir=ckpt, ckpt_every=20, log_every=5)
    out = run(job, device=args.device)
    print(f"[train_lm] loss {out['first_loss']:.3f} -> "
          f"{out['final_loss']:.3f}")
    if not out["final_loss"] < out["first_loss"]:
        raise AssertionError("training must reduce loss")
    print("OK")


if __name__ == "__main__":
    main()
