"""Model-layer primitives and the parameter registry (port of
``repro.models.layers``).

Parameters are nested dicts of tensors. A ``ParamSet`` records, for every
parameter: shape, dtype, init kind and std, and the placeholder sharding
axes of the reference ("fsdp" / "tp"), kept as data so the two registries
stay comparable. ``MeshAxes`` and ``resolve_spec`` turn those
placeholders into per-dim mesh axes, for the dry run
(``launch/cells.build_cell``) and for a sharded run, whose
``ParamSet.init_params(generator, mesh, axes)`` keeps each rank's block of
every leaf as a DTensor. ``hint`` (with ``set_hint_axes``) is the
reference's sharding constraint on an activation: it redistributes a
DTensor to its spec's placements and leaves anything else as it is. The
sharded runtime (``models/sharding.py``) keeps activations as plain local
tensors, so its hints are identities: they mark where its tensor-parallel
collectives go (``swiglu``'s hidden stays on "tp"; the logits are
vocab-parallel, and ``cross_entropy`` reduces over the model axis).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import sharding

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name."""
    return _DTYPES[name]


class ShapeDtype(NamedTuple):
    """Shape and dtype of a tensor not yet made (``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


# ---------------------------------------------------------------------------
# Parameter registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ParamInfo:
    shape: Tuple[int, ...]
    dtype: torch.dtype
    spec: Tuple[Optional[str], ...]       # axis names: "fsdp" | "tp" | None
    init: str = "normal"                  # normal | zeros | ones
    std: float = 0.02


class ParamSet:
    """Collects ParamInfo under nested string paths ('a/b/c')."""

    def __init__(self, dtype: torch.dtype = torch.float32):
        self.infos: Dict[str, ParamInfo] = {}
        self.default_dtype = dtype

    def add(self, path: str, shape: Sequence[int],
            spec: Sequence[Optional[str]], init: str = "normal",
            std: float = 0.02, dtype: Optional[torch.dtype] = None) -> None:
        assert path not in self.infos, f"duplicate param {path}"
        assert len(spec) == len(shape), (path, shape, spec)
        self.infos[path] = ParamInfo(tuple(shape), dtype or self.default_dtype,
                                     tuple(spec), init, std)

    def init_params(self, generator: torch.Generator, mesh=None,
                    axes: Optional["MeshAxes"] = None) -> Dict[str, Any]:
        """Materialise every parameter on ``generator``'s device: in sorted
        path order, ``normal`` draws f32 N(0, 1)·std from ``generator`` and
        casts; ``zeros`` / ``ones`` are constant. The draws differ from
        ``jax.random`` — carry the reference's weights with
        ``convert.params_from_numpy`` where the numbers must agree. The
        scale is applied in place: one f32 copy of a leaf at a time (an
        expert leaf of deepseek-v2-lite is 19.2 GB in f32).

        With a ``DeviceMesh`` every leaf is a DTensor laid out by its spec
        resolved on ``axes`` (default ``MeshAxes(fsdp=("data",))``): every
        rank draws each whole leaf in the same order from the same seed,
        keeps its block (``launch/mesh.shard``) and frees the rest, so a
        rank's block is bit-equal to the same slice of the one-device
        init."""
        dev = generator.device
        if mesh is not None:
            from ..launch.mesh import placements, shard
            axes = axes or MeshAxes(fsdp=("data",))
        out: Dict[str, Any] = {}
        for path, info in sorted(self.infos.items()):
            if info.init == "zeros":
                val = torch.zeros(info.shape, dtype=info.dtype, device=dev)
            elif info.init == "ones":
                val = torch.ones(info.shape, dtype=info.dtype, device=dev)
            else:
                val = torch.randn(info.shape, generator=generator,
                                  dtype=torch.float32, device=dev)
                val = val.mul_(info.std).to(info.dtype)
            if mesh is not None:
                val = shard(val, mesh, placements(
                    resolve_spec(info.spec, axes), mesh))
            _set(out, path, val)
        return out

    def shape_tree(self) -> Dict[str, Any]:
        """Nested dict of every parameter's ``ShapeDtype``, its keys in
        the order ``init_params`` makes them (sorted paths): an eager loop
        over the leaves, as AdamW's, visits them in that order, which sets
        where its transient peak falls."""
        out: Dict[str, Any] = {}
        for path, info in sorted(self.infos.items()):
            _set(out, path, ShapeDtype(info.shape, info.dtype))
        return out

    def spec_tree(self, axes: "MeshAxes") -> Dict[str, Any]:
        """Nested dict of every parameter's spec resolved on ``axes``, in
        ``shape_tree``'s order."""
        out: Dict[str, Any] = {}
        for path, info in sorted(self.infos.items()):
            _set(out, path, resolve_spec(info.spec, axes))
        return out

    def n_params(self) -> int:
        return sum(math.prod(i.shape) for i in self.infos.values())


def _set(tree: Dict[str, Any], path: str, val: Any) -> None:
    parts = path.split("/")
    for p in parts[:-1]:
        tree = tree.setdefault(p, {})
    tree[parts[-1]] = val


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    """How placeholder axis names map onto the physical mesh.

    fsdp=() replicates parameters across the data axes (inference mode: no
    optimizer state, weights TP-only).
    """
    fsdp: Tuple[str, ...]        # e.g. ("data",) or ("pod", "data") or ()
    tp: str = "model"
    batch_axes: Optional[Tuple[str, ...]] = None

    @property
    def batch(self) -> Tuple[str, ...]:
        return self.batch_axes if self.batch_axes is not None else self.fsdp


# A resolved spec (the counterpart of a ``PartitionSpec``): one entry per
# dim, each None (replicated), a mesh axis name, or a tuple of names.
Spec = Tuple[Any, ...]


def resolve_spec(spec: Tuple[Optional[str], ...], axes: MeshAxes) -> Spec:
    """Resolve the placeholders "fsdp", "tp" and "batch" of ``spec`` on
    ``axes``; raises ValueError on any other name."""
    def _axes_or_none(t):
        if not t:
            return None
        return t if len(t) > 1 else t[0]

    resolved = []
    for s in spec:
        if s is None:
            resolved.append(None)
        elif s == "fsdp":
            resolved.append(_axes_or_none(axes.fsdp))
        elif s == "tp":
            resolved.append(axes.tp)
        elif s == "batch":
            resolved.append(_axes_or_none(axes.batch))
        else:
            raise ValueError(f"unknown axis placeholder {s}")
    return tuple(resolved)


# ---------------------------------------------------------------------------
# Intermediate-activation sharding hints
# ---------------------------------------------------------------------------
# The reference's models insert ``hint()`` constraints at layer boundaries;
# they resolve against the MeshAxes the launcher installs and are no-ops
# when none is installed.

_HINT_AXES: Optional[MeshAxes] = None


def set_hint_axes(axes: Optional[MeshAxes]) -> None:
    global _HINT_AXES
    _HINT_AXES = axes


def hint(x: torch.Tensor, *spec: Optional[str]) -> torch.Tensor:
    """``x`` itself without installed axes or when it is not a DTensor;
    else ``x`` redistributed to the placements of ``spec`` resolved on the
    installed axes (``launch/mesh.placements``)."""
    if _HINT_AXES is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    from ..launch.mesh import placements
    return x.redistribute(x.device_mesh, placements(
        resolve_spec(tuple(spec), _HINT_AXES), x.device_mesh))


# ---------------------------------------------------------------------------
# Numerics (casts as in the reference)
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    """Normalise in f32, cast to x's dtype, then scale by ``weight``."""
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(dt) * weight


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4
         ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, D_even); positions: (..., S) or (S,).
    Frequencies ``1 / theta ** (arange(half) / half)`` in f32."""
    d = x.shape[-1]
    half = d // 2
    exps = torch.arange(half, dtype=torch.float32, device=x.device) / half
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., :, None].float() * freqs        # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor,
           tp: Optional[sharding.ModelAxis] = None) -> torch.Tensor:
    """SwiGLU. With ``tp`` the weights are the rank's blocks: ``w_gate`` /
    ``w_up`` column-parallel (the hidden stays on "tp"), ``w_down``
    row-parallel, its partial output summed over the model ranks."""
    x = sharding.to_model(x, tp)
    hspec = ("batch",) + (None,) * (x.dim() - 2) + ("tp",)
    g = hint(torch.matmul(x, w_gate), *hspec)
    u = hint(torch.matmul(x, w_up), *hspec)
    return sharding.from_model(torch.matmul(F.silu(g) * u, w_down), tp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  tp: Optional[sharding.ModelAxis] = None,
                  dp: Optional[sharding.DataAxis] = None) -> torch.Tensor:
    """Mean token cross-entropy in f32. logits (..., V); labels (...).
    With ``mask``: ``sum(nll · mask) / max(sum(mask), 1)``, the two sums
    over the data ranks' rows with ``dp`` (``sharding.sum_over_data``), so
    every data rank holds the global masked mean (``dp`` is not used
    without a mask: each rank's mean is its share of the global one).

    With ``tp`` the logits are vocab-parallel: this rank's columns
    ``[rank·V, (rank+1)·V)`` of the whole vocab. The row maximum, the sum
    of exponentials (in f32) and the gold logit are each reduced over the
    model ranks, so every rank holds the same loss."""
    logits = logits.float()
    if tp is None:
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    else:
        v = logits.shape[-1]
        top = sharding.max_over_model(torch.amax(logits, dim=-1), tp)
        z = torch.sum(torch.exp(logits - top[..., None]), dim=-1)
        logz = torch.log(sharding.from_model(z, tp)) + top
        col = labels.long() - tp.rank * v
        mine = (col >= 0) & (col < v)
        gold = torch.gather(logits, -1,
                            torch.where(mine, col, 0)[..., None])[..., 0]
        gold = sharding.from_model(
            torch.where(mine, gold, torch.zeros((), device=gold.device)), tp)
    nll = logz - gold
    if mask is not None:
        mask = mask.float()
        num, den = sharding.sum_over_data(
            torch.stack([torch.sum(nll * mask), torch.sum(mask)]), dp)
        return num / torch.clamp(den, min=1.0)
    return torch.mean(nll)
