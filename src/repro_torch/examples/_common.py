"""What the examples share: the ``--device`` flag and the size knobs."""

from __future__ import annotations

import argparse
import os
from typing import Optional


def env_int(name: str, default: int) -> int:
    """A size knob from the environment (the reference's smoke caps)."""
    return int(os.environ.get(name, default))


def parser(doc: Optional[str]) -> argparse.ArgumentParser:
    """An example's argument parser with ``--device``."""
    ap = argparse.ArgumentParser(
        description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    return ap

