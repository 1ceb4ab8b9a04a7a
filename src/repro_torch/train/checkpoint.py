"""Checkpoint / restore with atomic writes (port of
``repro.train.checkpoint``).

* **Atomic**: a save writes to ``step_N.tmp``, fsyncs, renames, and updates
  ``LATEST`` last — a write killed midway never corrupts a checkpoint.
* **Async**: :class:`AsyncCheckpointer` copies the tensors to the host on
  the caller's thread and writes on a background thread.
* **Self-describing**: a manifest (step, each leaf's shape and dtype, and
  optional ``extras``) travels with the data; restore checks the structure.

The format is the reference's: one ``arrays.npz`` of the flattened leaves
and a ``manifest.json``, in a ``step_{step:09d}`` directory. bfloat16
leaves are stored as their uint16 bit patterns with ``"bfloat16"`` in the
manifest. Leaf keys are the strings the reference renders from JAX key
paths: a dataclass field as ``.name``, a dict key as itself (dict keys in
sorted order), a sequence index as its number, joined by ``/``; ``None``
holds no leaf. So a checkpoint written by either package restores in the
other.

Leaves may be tensors (any device), numpy arrays or Python scalars; a
Python float is stored as float32 and an int as int32, the reference's
default types. :func:`restore` rebuilds ``like``'s structure: where
``like`` holds a tensor the leaf comes back as a tensor on that tensor's
device, where it holds a Python float or int, as one of those (a float
keeps ``like``'s double value when that rounds to the stored float32).

Sharded trees (DTensor blocks over a mesh, ``models/sharding.py``) are
saved in the same global layout: the ranks gather each leaf onto rank 0
over the model axis and then the data axis
(``sharding.gather_to_rank0``), on the caller's thread (a writer
thread's collectives would race the step's), and rank 0 alone writes.
Restore reads the global arrays on every rank and keeps each rank's
block of them as ``like``'s DTensor holds it, on any mesh: (2, 2), (4, 1)
and (1, 1) read each other's checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from ..models import sharding

_MANIFEST = "manifest.json"
_DATA = "arrays.npz"


def _items(node: Any):
    """(key string, child) pairs of an inner node, or None for a leaf."""
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return [("." + f.name, getattr(node, f.name))
                for f in dataclasses.fields(node)]
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(node)]
    return None


def _flatten_with_paths(tree: Any) -> Dict[str, Any]:
    """Leaves by the reference's key strings, in its flattening order."""
    flat: Dict[str, Any] = {}

    def walk(node: Any, path: tuple) -> None:
        if node is None:
            return
        kids = _items(node)
        if kids is None:
            flat["/".join(path)] = node
            return
        for key, child in kids:
            walk(child, path + (key,))
    walk(tree, ())
    return flat


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host array; bfloat16 tensors as uint16 bit patterns
    (their manifest dtype says bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy()
        return t.numpy().copy()
    if isinstance(leaf, bool):
        return np.asarray(leaf)
    if isinstance(leaf, float):
        return np.asarray(leaf, np.float32)
    if isinstance(leaf, int):
        return np.asarray(leaf, np.int32)
    return np.asarray(leaf)


def _dtype_name(leaf: Any, host: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return "bfloat16"
    return str(host.dtype)


def _snapshot(tree: Any) -> Optional[Dict[str, tuple]]:
    """``{key: (host array as stored, manifest dtype)}`` of every leaf; for
    a sharded tree, on rank 0 only (None on the others)."""
    flat = _flatten_with_paths(tree)
    sharded = any(isinstance(v, DTensor) for v in flat.values())
    if sharded and dist.get_rank() != 0:
        for v in flat.values():
            if isinstance(v, DTensor):
                sharding.gather_to_rank0(v)
        return None
    out = {}
    for k, v in flat.items():
        if isinstance(v, DTensor):
            v = sharding.gather_to_rank0(v)
        h = _host(v)
        name = _dtype_name(v, h)
        if h.dtype.name == "bfloat16":          # an ml_dtypes array
            h = h.view(np.uint16)
        out[k] = (h, name)
    return out


def _write(ckpt_dir: str, step: int, snap: Dict[str, tuple],
           extras: Optional[Dict]) -> str:
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    tmp = path + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, _DATA), **{k: h for k, (h, _) in snap.items()})
    manifest = {"step": step,
                "leaves": {k: {"shape": list(h.shape), "dtype": name}
                           for k, (h, name) in snap.items()}}
    if extras is not None:
        manifest["extras"] = extras
    with open(os.path.join(tmp, _MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    _update_latest(ckpt_dir, step)
    return path


def save(ckpt_dir: str, step: int, tree: Any,
         extras: Optional[Dict] = None) -> str:
    """Synchronous atomic save. Returns the checkpoint's path (None on a
    rank other than 0 of a sharded tree, which writes nothing).

    ``extras``: an optional JSON-serialisable dict stored in the manifest
    (the simulation checkpoints record their rung and degradation knobs).
    """
    snap = _snapshot(tree)
    return None if snap is None else _write(ckpt_dir, step, snap, extras)


def _update_latest(ckpt_dir: str, step: int) -> None:
    tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(tmp, "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, os.path.join(ckpt_dir, "LATEST"))


class AsyncCheckpointer:
    """Copy to the host on the caller's thread, write on a daemon thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    def save_async(self, step: int, tree: Any,
                   extras: Optional[Dict] = None) -> None:
        self.wait()
        snap = _snapshot(tree)          # device → host, on this thread
        if snap is None:                # a sharded tree: rank 0 writes
            return

        def _write_and_gc():
            _write(self.ckpt_dir, step, snap, extras)
            self._gc()

        self._thread = threading.Thread(target=_write_and_gc, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = list_steps(self.ckpt_dir)
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:09d}"),
                          ignore_errors=True)
        # a stale .tmp dir is debris of an interrupted save, never a live
        # write: saves on one checkpointer are serialised by wait()
        for name in os.listdir(self.ckpt_dir):
            if name.startswith("step_") and name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.ckpt_dir, name),
                              ignore_errors=True)


def list_steps(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            out.append(int(name[len("step_"):]))
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    """The newest complete checkpoint. The directory listing decides, not
    ``LATEST``: a crash between the rename and the ``LATEST`` update
    leaves ``LATEST`` one save behind."""
    steps = list_steps(ckpt_dir)
    return steps[-1] if steps else None


def load_manifest(ckpt_dir: str, step: int) -> Dict:
    """The manifest of one checkpoint (step, leaves, optional extras)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}", _MANIFEST)
    with open(path) as f:
        return json.load(f)


def _leaf_like(arr: np.ndarray, dtype_name: str, like: Any) -> Any:
    """A stored array as ``like``'s kind of leaf (a DTensor: this rank's
    block of it)."""
    if isinstance(like, DTensor):
        from ..launch.mesh import shard
        full = _leaf_like(arr, dtype_name, torch.empty(0))
        return shard(full.to(like.device), like.device_mesh, like.placements)
    if isinstance(like, torch.Tensor):
        if dtype_name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16).copy()).view(
                torch.bfloat16)
        elif arr.dtype == np.uint32:
            # the port holds uint32 values (keys) in int64
            t = torch.from_numpy(arr.astype(np.int64))
        else:
            t = torch.from_numpy(arr.copy())
        return t.to(like.device)
    if isinstance(like, bool):
        return bool(arr)
    if isinstance(like, float):
        # a float leaf is a configuration value (the grid's box edge), held
        # in double but stored as float32: the template's own value stands
        # when it is the one that was stored
        return like if np.float32(like) == arr else float(arr)
    if isinstance(like, int):
        return int(arr)
    return arr


def restore(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes checked per leaf)."""
    path = os.path.join(ckpt_dir, f"step_{step:09d}")
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    flat_like = _flatten_with_paths(like)
    missing = set(flat_like) - set(manifest["leaves"])
    extra = set(manifest["leaves"]) - set(flat_like)
    if missing or extra:
        raise ValueError(f"checkpoint structure mismatch: missing={missing} "
                         f"extra={extra}")
    with np.load(os.path.join(path, _DATA)) as raw:
        data = {k: raw[k] for k in raw.files}
    leaves = {}
    for key, leaf in flat_like.items():
        arr = data[key]
        want = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: shape {arr.shape} != expected {want}")
        leaves[key] = _leaf_like(arr, manifest["leaves"][key]["dtype"], leaf)
    return _unflatten(like, leaves)


def _unflatten(like: Any, leaves: Dict[str, Any]) -> Any:
    """``like`` with each leaf replaced by ``leaves[its key]``."""
    def walk(node: Any, path: tuple) -> Any:
        if node is None:
            return None
        kids = _items(node)
        if kids is None:
            return leaves["/".join(path)]
        if dataclasses.is_dataclass(node):
            return dataclasses.replace(node, **{
                k[1:]: walk(v, path + (k,)) for k, v in kids})
        if isinstance(node, dict):
            return {k: walk(node[k], path + (str(k),)) for k in node}
        return type(node)(walk(v, path + (str(i),))
                          for i, v in enumerate(node))
    return walk(like, ())
