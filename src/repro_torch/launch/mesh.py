"""Production meshes (port of ``repro.launch.mesh``), and the device
mesh of a sharded run.

A ``Mesh`` is shape and axis names only: the dry run reckons per-device
shapes and bytes on it and runs on no device. :func:`make_device_mesh`
lays the same shape and names over the ranks of the current process group
as a ``torch.distributed`` ``DeviceMesh`` (NCCL on the cards, gloo on the
CPU), and :func:`placements` turns a resolved spec
(``models/layers.resolve_spec``) into the DTensor placements a leaf takes
on it; :func:`shard` keeps one rank's block of a whole tensor, sharded
along the data and the model axis alike (FSDP × TP, ``models/sharding.py``).
:func:`check_divides` refuses a config whose sharded dims do not split
into whole heads, rows and columns over the mesh.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch

from ..device import DeviceLike, resolve_device
from ..models.layers import MeshAxes
from ..models.moe import expert_axes


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named device axes: ``shape[i]`` devices along ``axis_names[i]``."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def axis_size(self, entry: Any) -> int:
        """Devices along one spec entry: None, an axis name, or a tuple of
        names. Raises ValueError on a name the mesh does not have."""
        if entry is None:
            return 1
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for name in names:
            if name not in self.axis_names:
                raise ValueError(f"axis {name!r} is not on the mesh "
                                 f"{self.axis_names}")
            n *= self.shape[self.axis_names.index(name)]
        return n

    def shard_shape(self, global_shape: Sequence[int], spec: Tuple
                    ) -> Tuple[int, ...]:
        """One device's block of a ``global_shape`` array laid out by
        ``spec`` (``NamedSharding(mesh, spec).shard_shape``). A dim that
        does not divide takes the ceiling, as GSPMD pads it."""
        if len(spec) > len(global_shape):
            raise ValueError(f"spec {spec} has more entries than the shape "
                             f"{tuple(global_shape)} has dims")
        entries = tuple(spec) + (None,) * (len(global_shape) - len(spec))
        return tuple(-(-d // self.axis_size(e))
                     for d, e in zip(global_shape, entries))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """Single pod: 16×16 = 256 devices (data, model). Multi-pod: 2×16×16 =
    512 devices (pod, data, model); the pod axis carries cross-pod data
    parallelism."""
    if multi_pod:
        return Mesh((2, 16, 16), ("pod", "data", "model"))
    return Mesh((16, 16), ("data", "model"))


def mesh_axes(multi_pod: bool = False) -> MeshAxes:
    """Placeholder-axis resolution for this mesh
    (``models/layers.resolve_spec``)."""
    return MeshAxes(fsdp=("pod", "data") if multi_pod else ("data",),
                    tp="model")


def make_host_mesh() -> Mesh:
    """Degenerate 1×1 mesh: one device, the same axis names as the single
    pod's."""
    return Mesh((1, 1), ("data", "model"))


# ---------------------------------------------------------------------------
# A mesh over the ranks of a process group
# ---------------------------------------------------------------------------

def _axis_sizes(mesh) -> dict:
    """{axis name: ranks} of a ``Mesh`` or a ``DeviceMesh``."""
    names = tuple(getattr(mesh, "axis_names", None)
                  or mesh.mesh_dim_names)
    return dict(zip(names, tuple(mesh.shape)))


def check_divides(cfg, mesh, attn_impl: Optional[str] = None) -> None:
    """Raise ValueError unless ``cfg``'s sharded dims split evenly over
    ``mesh`` (a ``Mesh`` or a ``DeviceMesh`` with "data" and "model"
    axes): the heads, the kv heads, ``d_ff`` and the vocab padded to 128
    over "model" (a rank takes whole heads: query head h reads kv head
    h // group on the same rank; MLA's heads are ``n_heads``); with SSM
    layers also their heads (``ssm_expand · d_model / ssm_head_dim``),
    ``w_in``'s columns and the conv's channels, the blocks the model group
    gathers; with experts the shared experts' ``moe_d_ff ·
    n_shared_experts`` over "model", and the expert dims where
    ``models/moe.expert_axes`` puts them (``n_experts`` or ``moe_d_ff``
    over "model" for "tp", over "data" for "fsdp"); ``d_model`` over
    "data". The reference's GSPMD would reshard an uneven split; this
    runtime refuses it. A serve through K2 (``attn_impl="k2"``, the check
    of a (1, T) serving mesh) also needs a GQA config's head dim among
    K2's (``kernels/flash_attention.SUPPORTED_D``), which every rank's
    prefill runs on its heads."""
    sizes = _axis_sizes(mesh)
    t, d = sizes.get("model", 1), sizes.get("data", 1)
    v_pad = ((cfg.vocab_size + 127) // 128) * 128
    dims = [("n_heads", cfg.n_heads), ("n_kv_heads", cfg.n_kv_heads),
            ("d_ff", cfg.d_ff), ("the padded vocab", v_pad)]
    over_data = [("d_model", cfg.d_model)]
    if any(ld.kind == "ssm" for ld in cfg.layer_pattern()):
        di = cfg.ssm_expand * cfg.d_model
        h, n = di // cfg.ssm_head_dim, cfg.ssm_state
        dims += [("the SSM heads", h), ("w_in's columns", 2 * di + 2 * n + h),
                 ("the conv channels", di + 2 * n)]
    if cfg.n_experts:
        dims.append(("the shared experts' d_ff",
                     cfg.moe_d_ff * cfg.n_shared_experts))
        e_ax, f_ax = expert_axes(cfg)
        for ax, dim in ((e_ax, ("n_experts", cfg.n_experts)),
                        (f_ax, ("moe_d_ff", cfg.moe_d_ff))):
            if ax == "tp":
                dims.append(dim)
            elif ax == "fsdp":
                over_data.append(dim)
    bad = [f"{name} {n} over 'model' {t}" for name, n in dims if n % t]
    bad += [f"{name} {n} over 'data' {d}" for name, n in over_data if n % d]
    if bad:
        raise ValueError(f"{cfg.name} on a mesh {sizes}: "
                         + ", ".join(bad) + " do not divide")
    if attn_impl == "k2" and cfg.n_heads and not cfg.mla:
        from ..kernels.flash_attention import SUPPORTED_D
        if cfg.d_head not in SUPPORTED_D:
            raise ValueError(f"{cfg.name} served through K2: head dim "
                             f"{cfg.d_head} is not one of {SUPPORTED_D}")


def make_device_mesh(mesh: Mesh, device: DeviceLike = None, cfg=None):
    """A ``DeviceMesh`` with ``mesh``'s shape and axis names over the ranks
    of the current process group, rank r at row-major position r, on
    ``device``'s type (None → the CUDA card, raising without one; NCCL
    there, gloo on ``"cpu"``). On a ("data", "model") mesh of (D, T) the
    ranks of one data coordinate form a model group of T and those of one
    model coordinate a data group of D. With ``cfg``, raises ValueError
    when its dims do not divide (:func:`check_divides`); RuntimeError
    without a process group, ValueError when the group's size is not the
    mesh's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    dev = resolve_device(device)
    if cfg is not None:
        check_divides(cfg, mesh)
    if not dist.is_initialized():
        raise RuntimeError("make_device_mesh needs a process group "
                           "(torch.distributed.init_process_group)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"a {mesh.shape} mesh needs {mesh.size} ranks, the "
                         f"group has {dist.get_world_size()}")
    return DeviceMesh(dev.type, torch.arange(mesh.size).reshape(mesh.shape),
                      mesh_dim_names=tuple(mesh.axis_names))


def placements(spec: Tuple, device_mesh) -> Tuple:
    """DTensor placements of a leaf laid out by the resolved ``spec`` (one
    entry per dim: None, an axis name or a tuple of names): each mesh axis
    named in dim d's entry is ``Shard(d)``, every other mesh axis
    ``Replicate()``. Raises ValueError on a name the mesh does not have or
    an axis named twice."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    seen = set()
    for d, entry in enumerate(spec):
        for name in (entry if isinstance(entry, tuple)
                     else () if entry is None else (entry,)):
            if name not in names:
                raise ValueError(f"axis {name!r} is not on the mesh {names}")
            if name in seen:
                raise ValueError(f"axis {name!r} shards two dims of {spec}")
            seen.add(name)
            out[names.index(name)] = Shard(d)
    return tuple(out)


def shard(full: torch.Tensor, device_mesh, places: Tuple):
    """This rank's block of ``full`` as a DTensor with ``places`` (a copy,
    so ``full`` can be freed). A sharded dim must divide by its mesh axes'
    size (ValueError otherwise): every rank's block has one shape, as
    ``Mesh.shard_shape`` reckons it."""
    from torch.distributed.tensor import DTensor, Shard
    local = full
    for i, pl in enumerate(places):
        if isinstance(pl, Shard):
            n = device_mesh.size(i)
            if local.shape[pl.dim] % n:
                raise ValueError(f"dim {pl.dim} of {tuple(full.shape)} does "
                                 f"not divide over {n} ranks")
            local = local.chunk(n, dim=pl.dim)[device_mesh.get_local_rank(i)]
    return DTensor.from_local(
        local.clone(memory_format=torch.contiguous_format), device_mesh,
        places, run_check=False, shape=full.shape, stride=full.stride())
