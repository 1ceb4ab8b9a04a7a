"""Carry state across from the reference: numpy leaves ↔ the port's tensors.

LM weights and decode caches (:func:`params_from_numpy`,
:func:`params_to_numpy`): ``jax.tree.map(np.asarray, tree)`` of the
reference's parameter tree or its ``(prefix_caches, block_caches)`` gives
nested dicts, lists and tuples of numpy arrays; the port's tree has the
same structure with tensors. bfloat16 leaves arrive as numpy arrays whose
``dtype.name == "bfloat16"`` (the ml_dtypes type) and are carried bit for
bit through their 16-bit patterns, without importing ml_dtypes. The AdamW
state ``{"mu", "nu", "step"}`` crosses the same way
(:func:`opt_state_from_numpy`, :func:`opt_state_to_numpy`), so a
reference run's optimizer steps on in the port.

Simulation state (:func:`state_from_numpy`, :func:`state_to_numpy`): the
pool is the state, so a state from the reference engine converts leaf by
leaf: ``np.asarray`` on each of its arrays gives the
dict :func:`state_from_numpy` reads::

    {"pool": {channel: array, ...},         # AgentPool.channels() names,
                                            # behaviors' extra.* included
     "rng": (2,) uint32,                    # raw threefry key
     "iteration": () int32,
     "stats": {field: () int32, ...},       # StepStats.FIELDS
     "conc": (X, Y, Z) float32,             # the diffusion grid; optional
     "env": {...} or None}                  # every_k's cache; optional

The behaviors' extra channels (``extra.infect_timer``,
``extra.direction``, ``extra.path_len``) travel as pool channels, the
diffusion grid as ``conc``. The cache of ``RebuildPolicy("every_k")``
(``EngineState.env``, a ``RebuildState``) travels as ``{"grid": {origin,
box_size, keys, order, rank, starts, counts, max_count, max_run_count},
"steps_since", "disp_accum", "dirty", "pairs": {idx, run_off, count,
demand} or None, "pair_disp": array or None}``, so a state with a warm
cache steps on in the port as it would have in the reference.

An ensemble (:func:`ensemble_state_from_numpy`,
:func:`ensemble_state_to_numpy`) crosses in the reference's stacked
layout, whatever the port's lane-major pool holds in memory::

    {"pool": {channel: (L, C, ...)},
     "conc": (L, ...), "rng": (L, 2) uint32, "iteration": (L,) int32,
     "stats": {field: (L,) int32, ...}, "active": (L,) bool,
     "params": {"dt": () per lane or None, "force": {...},
                "rates": {...}} or None,     # leaves (L, ...)
     "tick": () int32,
     "env": {...} or None}                  # every_k's caches, (L, ...)

An ensemble's ``env`` is the solo layout with a leading lane axis on every
leaf (``box_size`` (L,) float32 too) and each lane's slot ids its own, as
the reference's vmapped cache holds them; the port keeps it lane-major in
memory (``grid.stack_rebuild_state`` / ``flatten_rebuild_state``).

Dtypes are kept (uint32 keys become int64 holding the same values), so
:func:`state_to_numpy` returns arrays equal, bit for bit, to the input.
The channels a narrowed ``DtypePolicy`` stores in bfloat16, float16 or
int16 cross bit for bit too: bfloat16 through its 16-bit patterns, as the
LM weights do, coming back as uint16 bits or viewed as the ``bfloat16``
numpy dtype a caller passes.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .core.agents import pool_from_channels
from .core.engine import EngineState, ScenarioParams
from .core.ensemble import EnsembleState
from .core.grid import (GridState, PairList, RebuildState,
                        flatten_rebuild_state, stack_rebuild_state)
from .core.lanes import Lanes
from .core.stats import StepStats
from .device import DeviceLike, resolve_device


def _to_torch(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return _leaf_from_numpy(a, device)
    a = np.array(a, dtype=np.int64 if a.dtype == np.uint32
                 else None)                      # a writable copy
    return torch.from_numpy(a).to(device)


def _to_numpy(t: torch.Tensor, bfloat16: Optional[np.dtype] = None
              ) -> np.ndarray:
    """A tensor on the host; bfloat16 as uint16 bits, or viewed as
    ``bfloat16`` when the caller passes that numpy dtype."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16)
        return bits if bfloat16 is None else bits.view(bfloat16)
    return t.numpy()


def state_from_numpy(leaves: Dict[str, Any], device: DeviceLike = None
                     ) -> EngineState:
    """Build an ``EngineState`` on ``device`` (None → the CUDA card)."""
    dev = resolve_device(device)
    pool = pool_from_channels({k: _to_torch(v, dev)
                               for k, v in leaves["pool"].items()})
    stats = StepStats(**{f: _to_torch(leaves["stats"][f], dev).to(torch.int32)
                         for f in StepStats.FIELDS})
    conc = leaves.get("conc")
    conc = (torch.zeros((1, 1, 1), dtype=torch.float32, device=dev)
            if conc is None else _to_torch(conc, dev))
    return EngineState(pool=pool, conc=conc,
                       rng=_to_torch(leaves["rng"], dev),
                       iteration=_to_torch(leaves["iteration"],
                                           dev).to(torch.int32),
                       stats=stats, env=_env_from_numpy(leaves.get("env"),
                                                        dev))


_GRID_FIELDS = ("origin", "keys", "order", "rank", "starts", "counts",
                "max_count", "max_run_count")
_PAIR_FIELDS = ("idx", "run_off", "count", "demand")


def _env_from_numpy(env: Optional[Dict[str, Any]], dev: torch.device,
                    stacked: bool = False) -> Optional[RebuildState]:
    """The cache from its leaves; ``stacked``: an ensemble's (L, ...)
    leaves, returned lane-major."""
    if env is None:
        return None
    g = env["grid"]
    box = (_to_torch(g["box_size"], dev) if stacked
           else float(np.asarray(g["box_size"])))
    grid = GridState(box_size=box,
                     **{f: _to_torch(g[f], dev) for f in _GRID_FIELDS})
    pairs = env.get("pairs")
    if pairs is not None:
        pairs = PairList(**{f: _to_torch(pairs[f], dev)
                            for f in _PAIR_FIELDS})
    pair_disp = env.get("pair_disp")
    out = RebuildState(
        grid=grid, pairs=pairs,
        pair_disp=None if pair_disp is None else _to_torch(pair_disp, dev),
        **{f: _to_torch(env[f], dev)
           for f in ("steps_since", "disp_accum", "dirty")})
    return flatten_rebuild_state(out) if stacked else out


def _env_to_numpy(env: Optional[RebuildState], arr: Callable
                  ) -> Optional[Dict[str, Any]]:
    if env is None:
        return None
    grid = {f: arr(getattr(env.grid, f)) for f in _GRID_FIELDS}
    grid["keys"] = grid["keys"].astype(np.uint32)
    box = env.grid.box_size
    grid["box_size"] = (arr(box).astype(np.float32)
                        if isinstance(box, torch.Tensor) else np.float32(box))
    return {
        "grid": grid,
        **{f: arr(getattr(env, f))
           for f in ("steps_since", "disp_accum", "dirty")},
        "pairs": None if env.pairs is None else {
            f: arr(getattr(env.pairs, f)) for f in _PAIR_FIELDS},
        "pair_disp": None if env.pair_disp is None else arr(env.pair_disp)}


def state_to_numpy(state: EngineState,
                   bfloat16: Optional[np.dtype] = None) -> Dict[str, Any]:
    """Inverse of :func:`state_from_numpy` (keys back to uint32). bfloat16
    channels come back as their uint16 bit patterns, or viewed as
    ``bfloat16`` when the caller passes that numpy dtype."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return _to_numpy(t, bfloat16)
    out = {"pool": {k: arr(v) for k, v in state.pool.channels().items()},
           "rng": arr(state.rng).astype(np.uint32),
           "iteration": arr(state.iteration),
           "stats": {f: arr(state.stats[f]) for f in StepStats.FIELDS},
           "conc": arr(state.conc), "env": _env_to_numpy(state.env, arr)}
    return out


def ensemble_state_from_numpy(leaves: Dict[str, Any],
                              device: DeviceLike = None) -> EnsembleState:
    """Build an ``EnsembleState`` on ``device`` (None → the CUDA card) from
    the reference's stacked leaves; the pool becomes lane-major."""
    dev = resolve_device(device)
    pool = pool_from_channels({
        k: _to_torch(v, dev).reshape(-1, *np.shape(v)[2:])
        for k, v in leaves["pool"].items()})
    p = leaves.get("params")
    params = None
    if p is not None:
        params = ScenarioParams(
            dt=None if p.get("dt") is None else _to_torch(p["dt"], dev),
            force={k: _to_torch(v, dev)
                   for k, v in (p.get("force") or {}).items()},
            rates={k: _to_torch(v, dev)
                   for k, v in (p.get("rates") or {}).items()})
    return EnsembleState(
        pool=pool, conc=_to_torch(leaves["conc"], dev),
        rng=_to_torch(leaves["rng"], dev),
        iteration=_to_torch(leaves["iteration"], dev).to(torch.int32),
        stats=StepStats(**{f: _to_torch(leaves["stats"][f], dev).to(
            torch.int32) for f in StepStats.FIELDS}),
        active=_to_torch(leaves["active"], dev).to(torch.bool),
        params=params,
        tick=_to_torch(leaves["tick"], dev).to(torch.int32),
        env=_env_from_numpy(leaves.get("env"), dev, stacked=True))


def ensemble_state_to_numpy(state: EnsembleState,
                            bfloat16: Optional[np.dtype] = None
                            ) -> Dict[str, Any]:
    """Inverse of :func:`ensemble_state_from_numpy`: the stacked (L, C,
    ...) leaves, keys back to uint32."""
    def arr(t: torch.Tensor) -> np.ndarray:
        return _to_numpy(t, bfloat16)
    n = state.n_lanes
    p = state.params
    env = state.env
    if env is not None:
        env = stack_rebuild_state(env, Lanes(n, state.pool.capacity // n))
    return {
        "pool": {k: arr(v).reshape(n, -1, *v.shape[1:])
                 for k, v in state.pool.channels().items()},
        "conc": arr(state.conc),
        "rng": arr(state.rng).astype(np.uint32),
        "iteration": arr(state.iteration),
        "stats": {f: arr(state.stats[f]) for f in StepStats.FIELDS},
        "active": arr(state.active),
        "params": None if p is None else {
            "dt": None if p.dt is None else arr(p.dt),
            "force": {k: arr(v) for k, v in p.force.items()},
            "rates": {k: arr(v) for k, v in p.rates.items()}},
        "tick": arr(state.tick), "env": _env_to_numpy(env, arr)}


def _leaf_from_numpy(a: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """A nested dict/list/tuple of numpy arrays (LM parameters or decode
    caches) → the same tree of tensors on ``device`` (None → the CUDA
    card). bfloat16 leaves keep their bits."""
    dev = resolve_device(device)

    def walk(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return _leaf_from_numpy(t, dev)
    return walk(tree)


def params_to_numpy(tree: Any, bfloat16: Optional[np.dtype] = None) -> Any:
    """Inverse of :func:`params_from_numpy`. bfloat16 leaves come back as
    their uint16 bit patterns, or viewed as ``bfloat16`` when the caller
    passes that numpy dtype (``ml_dtypes.bfloat16``, ``jnp.bfloat16``)."""
    def walk(t: Any) -> Any:
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v) for v in t)
        return _to_numpy(t, bfloat16)
    return walk(tree)


def opt_state_from_numpy(leaves: Dict[str, Any], device: DeviceLike = None
                         ) -> Dict[str, Any]:
    """The reference's AdamW state as numpy leaves (``{"mu": tree, "nu":
    tree, "step": () int32}``) → the port's on ``device`` (None → the
    CUDA card); moments keep their dtype (bf16 bit for bit)."""
    if set(leaves) != {"mu", "nu", "step"}:
        raise ValueError(f"an AdamW state has mu, nu and step, not "
                         f"{sorted(leaves)}")
    dev = resolve_device(device)
    return {"mu": params_from_numpy(leaves["mu"], dev),
            "nu": params_from_numpy(leaves["nu"], dev),
            "step": _leaf_from_numpy(
                np.asarray(leaves["step"], np.int32), dev)}


def opt_state_to_numpy(state: Dict[str, Any],
                       bfloat16: Optional[np.dtype] = None
                       ) -> Dict[str, Any]:
    """Inverse of :func:`opt_state_from_numpy` (bfloat16 moments as in
    :func:`params_to_numpy`)."""
    return {"mu": params_to_numpy(state["mu"], bfloat16),
            "nu": params_to_numpy(state["nu"], bfloat16),
            "step": _to_numpy(state["step"].to(torch.int32))}
