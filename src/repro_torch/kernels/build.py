"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its first use into
``<repo>/build/kernels/<name>-<hash>.so``, where the hash covers the source
and the flags, so an edited source rebuilds and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source at once and waits for all.
Nothing here runs at import time: this module imports on hosts without a
CUDA toolkit, and only a kernel launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
# sm_90a: Hopper with its arch-specific features; IEEE sqrt/div (no
# --use_fast_math). nvcc contracts a*b+c into FMA by default, so sums can
# differ from the CPU's in the last bits — the reason for the force
# tolerance in the tests.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOADED: Dict[str, ctypes.CDLL] = {}
BUILD_LOGS: Dict[str, str] = {}


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under ``$CUDA_HOME`` or
    ``/usr/local/cuda``. Raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (nvcc on PATH or under /usr/local/cuda)")


def sources() -> List[str]:
    """Names of every kernel source under ``csrc/``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def constants(name: str) -> Dict[str, int]:
    """The integer ``constexpr`` constants of ``csrc/<name>.cu`` (those of
    type int or long long, in source order), each evaluated from the ones
    before it: what a test needs to know of a kernel's tiling."""
    out: Dict[str, int] = {}
    text = (CSRC / f"{name}.cu").read_text()
    for m in re.finditer(r"constexpr (?:int|long long) (\w+) = ([^;]+);",
                         text):
        expr = re.sub(r"(\d+)LL\b", r"\1", m.group(2)).replace("/", "//")
        out[m.group(1)] = int(eval(expr, {"__builtins__": {}}, dict(out)))
    return out


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = (csrc / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Sequence[str] | None = None,
              csrc: Path = CSRC) -> Dict[str, Path]:
    """Compile every named source of ``csrc`` (by default the kernels'
    ``csrc/``) that is not built yet, all in parallel.

    Returns ``{name: library path}``. Raises with the compiler's output if
    any build fails; ``BUILD_LOGS[name]`` keeps each compiler's output
    (register and spill use from ``-Xptxas=-v``), also for a library built
    earlier (its log is kept beside it).
    """
    names = list(sources() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: library_path(n, csrc) for n in names}
    todo = [n for n in names if not paths[n].is_file()]
    for n in names:
        log = paths[n].with_suffix(".log")
        if n not in todo and log.is_file():
            BUILD_LOGS[n] = log.read_text()
    if not todo:
        return paths
    nvcc = nvcc_path()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{n}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        BUILD_LOGS[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        paths[n].with_suffix(".log").write_text(out)
        os.replace(tmp, paths[n])            # atomic: no half-written .so
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return paths


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library of ``<csrc>/<name>.cu``, built on first use."""
    key = str(csrc / name)
    lib = _LOADED.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([name], csrc)[name]))
        _LOADED[key] = lib
    return lib
