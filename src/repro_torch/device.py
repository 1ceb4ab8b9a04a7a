"""Device resolution: the port runs on the CUDA card unless asked for the CPU.

There is no fallback. ``resolve_device(None)`` means the card; on a host
without one it raises instead of quietly running the CPU path, so a result
never names the wrong device. Tests and CPU tools pass ``"cpu"`` explicitly.
"""

from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; an explicit device is taken as given.

    Raises ``RuntimeError`` when a CUDA device is requested (explicitly or by
    default) and ``torch.cuda.is_available()`` is false.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run the plain CPU path")
    return dev


def card_description() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them
    (``name, power.limit``): every device number is kept beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]
