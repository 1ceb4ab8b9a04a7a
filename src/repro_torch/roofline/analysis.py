"""Roofline of one step on an NVIDIA H100 (port of
``repro.roofline.analysis``).

Per (arch × shape × mesh) cell:
  compute term    = FLOPs per device / PEAK_FLOPS
  memory term     = bytes moved per device / HBM_BW
  collective term = wire bytes per device / NVLINK_BW

``trace_step`` stands in for the reference's "lower, compile,
``memory_analysis``, ``cost_analysis``": it runs the step once under
``FakeTensorMode`` (no device memory, no kernels) and counts its FLOPs,
the bytes its ops move, its argument bytes and its peak live bytes. The
same tracer runs over real tensors too, so a step on the card can be held
against its trace.

The reference parses the collectives of XLA's optimised HLO
(``_shape_bytes`` … ``parse_collectives``); torch gives no HLO, so the
port counts them where they run: :func:`collectives_of` runs one step of
the sharded runtime on a real mesh under ``CommDebugMode`` (the count by
op) and a dispatch mode that reads each collective's operand bytes and
group size, and applies the reference's ring model
(``src/repro/roofline/analysis.py:16-21``). Its wire bytes per device by
op, each weighed over its own group (the data or the model axis), are
what ``analyze(cost, collectives)`` takes. The production mesh's
collective term stays None: that needs a trace of one device's shard of
the step under a fake process group (ROADMAP 15c).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import Any, Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..models.layers import ShapeDtype

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, NVIDIA's data
# sheet: dense bf16 tensor-core peak, HBM bandwidth, NVLink bandwidth per
# direction
PEAK_FLOPS = 989e12          # bf16 FLOP/s
HBM_BW = 3.35e12             # bytes/s
NVLINK_BW = 450e9            # bytes/s per direction
# its memory as torch.cuda.get_device_properties(0).total_memory reported
# it on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 34)
HBM_BYTES = 85_017_493_504

# ops that move no data: aliases of their input that the schema does not
# mark as views, and what detach / lift return
_VIEW_LIKE = frozenset(("aten._unsafe_view", "aten.alias", "aten.detach",
                        "aten.lift_fresh"))


@dataclasses.dataclass
class StepCost:
    flops: int                # FlopCounterMode's count (matmuls, convs, SDPA)
    bytes_moved: int          # each op's tensor inputs and outputs, once
    argument_bytes: int       # distinct storages of the arguments
    peak_bytes: int           # most live bytes at once, arguments included
    n_ops: int                # ops counted in bytes_moved


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor addresses: a stride-0 dim
    (a broadcast) counts once."""
    if t.numel() == 0:
        return 0
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class _Traffic(TorchDispatchMode):
    """Counts the bytes each op moves and the live bytes of storages.

    Bytes moved: for every op, the bytes of its tensor inputs and outputs
    (``tensor_bytes``), so an in-place op counts its operand read and
    written. Skipped: ``prim.*`` ops (metadata queries such as
    ``prim.device``), every op whose schema makes it a view (``is_view``),
    and the view-likes of ``_VIEW_LIKE``. This is the traffic of eager
    execution with each op reading its inputs and writing its outputs once
    (no cache reuse between ops, none of a kernel's own re-reads): a lower
    bound on what the card moves when no ops are fused.

    Live bytes: every storage an op's output lies on counts its ``nbytes``
    from the op that made it until the last tensor on it dies (a weak
    reference to the storage).
    """

    def __init__(self):
        super().__init__()
        self.bytes_moved = 0
        self.n_ops = 0
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, Any] = {}
        self._lock = threading.Lock()     # backward may run on another thread

    def watch(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        with self._lock:
            if key in self._refs:
                return
            nbytes = st.nbytes()

            def gone(_, key=key, nbytes=nbytes):
                with self._lock:
                    self.live -= nbytes
                    self._refs.pop(key, None)
            self._refs[key] = weakref.ref(st, gone)
            self.live += nbytes
            self.peak = max(self.peak, self.live)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        for t in outs:
            self.watch(t)
        if (func.namespace == "prim" or func.is_view
                or str(func.overloadpacket) in _VIEW_LIKE):
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        self.bytes_moved += sum(tensor_bytes(t) for t in ins + outs)
        self.n_ops += 1
        return out


def _inputs(tree: Any, device: str, fake_mode) -> Any:
    """``tree`` with each ``ShapeDtype`` leaf made as zeros on ``device``
    and, under ``fake_mode``, each tensor leaf made a fake of itself."""
    if isinstance(tree, dict):
        return {k: _inputs(v, device, fake_mode) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, ShapeDtype):
        return type(tree)(_inputs(v, device, fake_mode) for v in tree)
    if isinstance(tree, ShapeDtype):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if fake_mode is not None and isinstance(tree, torch.Tensor):
        return fake_mode.from_tensor(tree)
    return tree


def trace_step(fn: Callable, *args, device: str = "cpu",
               fake: bool = True) -> StepCost:
    """Run ``fn(*args)`` once and count what it does (``StepCost``).

    ``args`` are trees of ``ShapeDtype`` leaves (made as zeros on
    ``device``) or tensors. With ``fake`` the step runs under
    ``FakeTensorMode``: no memory is taken and no kernel runs, and tensors
    among ``args`` become fakes of themselves. Without it the step runs
    for real on its arguments' devices. FLOPs come from
    ``torch.utils.flop_counter.FlopCounterMode``; bytes moved and live
    bytes from ``_Traffic``. The arguments stay alive through the step, as
    a caller's do."""
    from torch.utils.flop_counter import FlopCounterMode

    mode = None
    if fake:
        from torch._subclasses.fake_tensor import FakeTensorMode
        mode = FakeTensorMode(allow_non_fake_inputs=False)
    with mode if mode is not None else contextlib.nullcontext():
        args = tuple(_inputs(a, device, mode) for a in args)
        traffic = _Traffic()
        for t in tree_flatten(args)[0]:
            if isinstance(t, torch.Tensor):
                traffic.watch(t)
        argument_bytes = traffic.live
        flops = FlopCounterMode(display=False)
        with flops, traffic:
            out = fn(*args)
            del out
    return StepCost(flops=int(flops.get_total_flops()),
                    bytes_moved=int(traffic.bytes_moved),
                    argument_bytes=int(argument_bytes),
                    peak_bytes=int(traffic.peak), n_ops=int(traffic.n_ops))


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: Optional[float]
    wire_bytes_per_device: Optional[float]
    compute_s: float
    memory_s: Optional[float]
    collective_s: Optional[float]
    dominant: str
    collective_breakdown: Optional[Dict[str, float]]

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)

    @property
    def step_time_bound_s(self) -> float:
        """The largest term reckoned: a lower bound on the step's time."""
        return max(t for t in (self.compute_s, self.memory_s,
                               self.collective_s) if t is not None)


def analyze(cost: Dict, collectives: Optional[Dict[str, float]] = None
            ) -> Roofline:
    """The three terms of one device's step. ``cost``: ``"flops"`` and
    ``"bytes accessed"`` per device (bytes None where not reckoned);
    ``collectives``: wire bytes per device by collective op, None where not
    recorded (then ``collective_s`` is None). The dominant term is the
    largest of those reckoned."""
    flops = float(cost.get("flops", 0.0))
    byts = cost.get("bytes accessed")
    terms = {"compute": flops / PEAK_FLOPS,
             "memory": None if byts is None else float(byts) / HBM_BW,
             "collective": None}
    wire = None
    if collectives is not None:
        wire = float(sum(collectives.values()))
        terms["collective"] = wire / NVLINK_BW
    known = {k: v for k, v in terms.items() if v is not None}
    return Roofline(flops_per_device=flops,
                    bytes_per_device=None if byts is None else float(byts),
                    wire_bytes_per_device=wire,
                    compute_s=terms["compute"], memory_s=terms["memory"],
                    collective_s=terms["collective"],
                    dominant=max(known, key=known.get),
                    collective_breakdown=(None if collectives is None
                                          else dict(collectives)))


# ---------------------------------------------------------------------------
# Collectives of a sharded step on a real mesh
# ---------------------------------------------------------------------------

# the reference's ring model (src/repro/roofline/analysis.py:16-21): wire
# bytes per device of one collective of ``b`` payload bytes over n ranks
_RING = {"all-gather": lambda b, n: (n - 1) / n * b,
         "reduce-scatter": lambda b, n: (n - 1) / n * b,
         "all-reduce": lambda b, n: 2 * (n - 1) / n * b}
# a c10d op: (the reference's name, the argument holding the payload: the
# all-gather's output, the reduce-scatter's input, the all-reduce's list)
_C10D = {"c10d._allgather_base_": ("all-gather", 0),
         "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
         "c10d.allreduce_": ("all-reduce", 0)}


def _group_of(args) -> Any:
    """The process group among a c10d op's arguments (a boxed
    ``ProcessGroup``), or None."""
    import torch.distributed as dist
    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a)
            except RuntimeError:      # another boxed argument (a ReduceOp)
                continue
    return None


def _ranks(group) -> tuple:
    """The global ranks of a process group."""
    import torch.distributed as dist
    return tuple(dist.get_process_group_ranks(group))


class _CollectiveBytes(TorchDispatchMode):
    """Payload bytes and counts of the c10d collectives dispatched while
    active, by the reference's op name and by the group each ran over
    (named by ``names``: a group's global ranks → an axis name, so two
    group objects over the same ranks, as two meshes of one layout give,
    take one name; else "<n> ranks"); raises on a collective the ring
    model does not cover."""

    def __init__(self, names: Dict[tuple, str]):
        super().__init__()
        self.names = names
        self.by_group: Dict[str, Dict] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            op = str(func.overloadpacket)
            if op not in _C10D:
                raise ValueError(f"{op}: no wire model for this collective")
            name, arg = _C10D[op]
            pg = _group_of(args)
            n = pg.size()
            key = self.names.get(_ranks(pg), f"{n} ranks")
            rec = self.by_group.setdefault(key, {
                "ranks": n, "counts": {}, "payload_bytes": {},
                "wire_bytes": {}})
            b = sum(tensor_bytes(t) for t in tree_flatten(args[arg])[0]
                    if isinstance(t, torch.Tensor))
            for k, v in (("counts", 1), ("payload_bytes", b),
                         ("wire_bytes", _RING[name](b, n))):
                rec[k][name] = rec[k].get(name, 0) + v
        return func(*args, **(kwargs or {}))

    def total(self, what: str) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for rec in self.by_group.values():
            for k, v in rec[what].items():
                out[k] = out.get(k, 0) + v
        return out


@dataclasses.dataclass
class Collectives:
    counts: Dict[str, int]            # CommDebugMode's count by op
    payload_bytes: Dict[str, int]     # by the reference's op name
    wire_bytes: Dict[str, float]      # per device, the ring model
    ranks: int                        # of the whole mesh
    # {group: {"ranks", "counts", "payload_bytes", "wire_bytes"}}, each
    # by the reference's op name
    by_group: Dict[str, Dict] = dataclasses.field(default_factory=dict)

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def collectives_of(fn: Callable, ranks: int, *args,
                   groups: Optional[Dict[str, Any]] = None) -> tuple:
    """``(fn(*args), Collectives)``: one call of a step on a real mesh of
    ``ranks`` ranks, its collectives counted by ``CommDebugMode`` and each
    weighed by the reference's ring model over the size of its own group
    (the data axis's or the model axis's), so the wire bytes a device
    sum both axes. ``groups`` names the groups in ``by_group``
    (``models/sharding.groups_of``: ``{"data": ..., "model": ...}``).
    ``analyze(cost, c.wire_bytes)`` takes the result."""
    from torch.distributed.tensor.debug import CommDebugMode
    names: Dict[tuple, str] = {}
    for k, g in (groups or {}).items():     # on one rank the first: "data"
        names.setdefault(_ranks(g), k)
    rec = _CollectiveBytes(names)
    with CommDebugMode() as comm, rec:
        out = fn(*args)
    counts = {str(k): int(v) for k, v in comm.get_comm_counts().items()}
    return out, Collectives(counts, rec.total("payload_bytes"),
                            rec.total("wire_bytes"), ranks, rec.by_group)


def _layer_collectives(model, ld, tokens: int, gathers: bool = True,
                       routed: Optional[int] = None) -> tuple:
    """The model-axis collectives of one layer of an ``LM`` over a model
    axis of more than one rank, one pass of ``tokens`` tokens (an MoE
    layer's capacity that of ``routed`` tokens, default ``tokens``: the
    global microbatch's over data ranks): ``(forward, backward)``, each a
    list of (op, payload bytes) in the order issued (the backward's order
    is not kept). The forward's row-parallel sums
    and the SSM's gathers (not on a serve tree: ``gathers`` False); the
    backward's sums into the normed input of each column-parallel region
    and into the weights every model rank uses on its own heads only, and
    the gathers' reduce-scatters."""
    from ..models.moe import capacity, expert_axes
    cfg = model.cfg
    act = model.adt.itemsize * tokens * cfg.d_model
    w = model.pdt.itemsize
    fwd, bwd = [], []
    if ld.kind == "ssm":
        di = cfg.ssm_expand * cfg.d_model
        h, nst = di // cfg.ssm_head_dim, cfg.ssm_state
        ssq = 4 * tokens                        # the gated norm's sums
        gathered = [(2 * di + 2 * nst + h) * cfg.d_model * w,   # w_in
                    (di + 2 * nst) * cfg.ssm_conv * w,          # conv_w
                    (di + 2 * nst) * w]                         # conv_b
        if gathers:
            fwd += [("all-gather", b) for b in gathered]
        fwd += [("all-reduce", ssq), ("all-reduce", act)]       # w_out
        bwd += [("all-reduce", ssq), ("all-reduce", act)]       # normed in
        bwd += [("all-reduce", n * w) for n in (h, h, h, di)]   # a_log,
        bwd += [("reduce-scatter", b) for b in gathered]  # dt_bias, d_skip,
    elif cfg.mla:                                               # out_norm
        r, dr = cfg.kv_lora_rank, cfg.qk_rope_dim
        fwd.append(("all-reduce", act))                         # wo
        bwd.append(("all-reduce", act))                         # normed in
        bwd += [("all-reduce", n * w) for n in (        # w_dkv, w_kpe,
            cfg.d_model * r, cfg.d_model * dr, r)]      # kv_norm
    else:
        fwd.append(("all-reduce", act))                         # wo
        bwd.append(("all-reduce", act))                         # normed in
        if cfg.qk_norm:
            bwd += [("all-reduce", cfg.d_head * w)] * 2   # q_norm, k_norm
    if ld.mlp == "dense":
        fwd.append(("all-reduce", act))                         # w_down
        bwd.append(("all-reduce", act))                         # normed in
    elif ld.mlp == "moe":
        e_ax, f_ax = expert_axes(cfg)
        buf = (cfg.n_experts * capacity(routed or tokens, cfg)
               * cfg.d_model * model.adt.itemsize)
        if e_ax == "tp":            # the experts' outputs made whole
            fwd.append(("all-gather", buf))
        elif f_ax == "tp":          # their partial outputs summed
            fwd.append(("all-reduce", buf))
        if "tp" in (e_ax, f_ax):
            bwd.append(("all-reduce", buf))     # into the expert buffer
        if cfg.n_shared_experts:
            fwd.append(("all-reduce", act))                     # ws_down
            bwd.append(("all-reduce", act))                     # xt
    return fwd, bwd


def _ends_in_a_sum(cfg, ld) -> bool:
    """Whether a layer's last forward collective is a row-parallel sum
    that only joins the residual: under remat the recompute stops before
    it (torch's checkpoint early stop), since no saved tensor follows."""
    if ld.mlp == "moe":
        return bool(cfg.n_shared_experts)
    return True


def reckon_collectives(model, data: int, model_ranks: int,
                       microbatches: int, rows: int, seq_len: int,
                       enc_len: int = 0) -> Dict[str, Dict]:
    """The collectives the spec tree implies for one train step of an
    ``LM`` of any family or an ``EncDecLM`` (remat "none" or "full";
    frames of ``enc_len`` on its encoder) on a (``data``, ``model_ranks``)
    ("data", "model") mesh, ``microbatches`` passes of ``rows`` sequences
    of ``seq_len`` tokens on each data rank, as :func:`collectives_of`
    records them in ``by_group``: ``{group: {"ranks", "counts",
    "payload_bytes", "wire_bytes"}}``.

    Data axis, each pass: every leaf sharded on "data" all-gathered (its
    TP block) in the forward and, stacked under remat "full", again in the
    recompute, then reduce-scattered; a data-replicated leaf's gradient
    all-reduced. Over more than one data rank each MoE layer's routing
    (``models/moe.global_slots``): its (2E,) int64 counts all-gathered and
    its (E,) f32 sum of router probabilities all-reduced in the forward
    and, stacked under remat "full", again in the recompute, and that
    sum's gradient all-reduced in the backward; the MoE capacity is the
    global microbatch's. Then the loss and the global norm's per-leaf
    sums (a step without a ``loss_mask``, whose sums would add one
    all-reduce each way). Model
    axis (more than one rank), each pass: the lookup's rows; the
    cross-entropy's maximum, sum of exponentials and gold logit; in the
    backward the gradient into the head's normed input; and each layer's
    own (:func:`_layer_collectives`): in the forward the row-parallel
    partial outputs (GQA's and MLA's ``wo``, ``w_down``, the SSM's
    ``w_out``, the shared experts' ``ws_down``), the expert FFN's partial
    outputs summed or its experts' outputs all-gathered, the SSM's
    ``w_in``, ``conv_w`` and ``conv_b`` all-gathered and its gated norm's
    f32 sum of squares; in the backward the gradient into every
    column-parallel region's input (the normed inputs, the expert buffer,
    the shared experts' tokens), of ``q_norm`` / ``k_norm``, of MLA's
    ``w_dkv``, ``w_kpe`` and ``kv_norm``, of the SSM's ``a_log``,
    ``dt_bias``, ``d_skip`` and ``out_norm`` and its sum of squares, and
    the gathers' reduce-scatters. A stacked block under remat "full"
    issues its forward's again in the recompute, but for a last
    row-parallel sum that only joins the residual
    (:func:`_ends_in_a_sum`); the prefix layers run once. The
    encoder-decoder's layers (dense, GQA, the cross-attention's ``wo``
    and the encoder output's gradient into each cross-attention) are
    reckoned apart. Then the global norm's sums."""
    from ..models.layers import MeshAxes, resolve_spec
    cfg = model.cfg
    if cfg.remat not in ("none", "full"):
        raise ValueError(f"reckoned for remat none and full, not "
                         f"{cfg.remat!r}")
    if cfg.encoder_layers and (cfg.n_experts or cfg.mla or {
            (ld.kind, ld.mlp) for ld in cfg.layer_pattern()} != {
                ("attn", "dense")}):
        raise ValueError(f"{cfg.name}: the encoder-decoder is reckoned "
                         f"with GQA and dense layers")
    again = 2 if cfg.remat == "full" else 1
    axes = MeshAxes(fsdp=("data",))
    stacks = ({"enc_blocks/": cfg.encoder_layers,
               "dec_blocks/": cfg.n_layers} if cfg.encoder_layers
              else {"blocks/": model.n_blocks})
    out: Dict[str, Dict] = {}

    def add(group: str, n: int, op: str, calls: int, b: int) -> None:
        rec = out.setdefault(group, {"ranks": n, "counts": {},
                                     "payload_bytes": {}, "wire_bytes": {}})
        for k, v in (("counts", calls), ("payload_bytes", calls * b),
                     ("wire_bytes", calls * _RING[op](b, n))):
            rec[k][op] = rec[k].get(op, 0) + v
    for path, info in sorted(model.ps.infos.items()):
        stack = next((k for k in stacks if path.startswith(k)), None)
        n = 1 if stack is None else stacks[stack]
        b = (math.prod(info.shape[1:] if stack else info.shape)
             * info.dtype.itemsize)
        spec = resolve_spec(info.spec, axes)
        if "model" in spec:
            b //= model_ranks
        if "data" in spec:
            add("data", data, "all-gather",
                microbatches * n * (again if stack else 1), b)
            add("data", data, "reduce-scatter", microbatches * n, b)
        else:
            add("data", data, "all-reduce", microbatches * n, b)
    s_all = seq_len + (0 if cfg.encoder_layers else cfg.frontend_tokens)
    if data > 1 and cfg.n_experts:
        e = cfg.n_experts
        for pattern, n, stacked in ((model.prefix_pattern, model.n_prefix,
                                     False),
                                    (model.pattern, model.n_blocks, True)):
            moe = n * sum(ld.mlp == "moe" for ld in pattern)
            fwd = microbatches * moe * (again if stacked else 1)
            add("data", data, "all-gather", fwd, data * 2 * e * 8)
            add("data", data, "all-reduce", fwd + microbatches * moe, 4 * e)
    leaves = 4 * len(model.ps.infos)
    add("data", data, "all-reduce", 1, 4)
    add("data", data, "all-reduce", 1, leaves)
    if model_ranks <= 1:
        return out
    t, m = model_ranks, microbatches
    act = model.adt.itemsize * rows * cfg.d_model

    def ar(calls: int, b: int) -> None:
        add("model", t, "all-reduce", m * calls, b)
    ar(1, act * seq_len)                        # the lookup's rows
    ar(3, 4 * rows * (seq_len - 1))             # the cross-entropy's sums
    ar(1, act * s_all)                          # the head's normed input
    if cfg.encoder_layers:
        ne, nd, s_enc = cfg.encoder_layers, cfg.n_layers, enc_len
        # encoder: wo, w_down, wo again; the attention's and the MLP's
        # normed inputs
        ar(ne * (again + 1), act * s_enc)
        ar(2 * ne, act * s_enc)
        # decoder: wo, the cross wo, w_down, both wo again; the normed
        # inputs of the attention, the cross-attention and the MLP; the
        # encoder output into the cross-attention
        ar(nd * (3 + 2 * (again - 1)), act * seq_len)
        ar(3 * nd, act * seq_len)
        ar(nd, act * s_enc)
        if cfg.qk_norm:
            ar(2 * (ne + nd), cfg.d_head * model.pdt.itemsize)
    else:
        for pattern, n, stacked in ((model.prefix_pattern, model.n_prefix,
                                     False),
                                    (model.pattern, model.n_blocks, True)):
            if not n:
                continue
            fwd, bwd = [], []
            for ld in pattern:
                f, b = _layer_collectives(model, ld, rows * s_all,
                                          routed=data * rows * s_all)
                fwd += f
                bwd += b
            issued = fwd + bwd
            if stacked and again == 2:
                issued += (fwd[:-1] if _ends_in_a_sum(cfg, pattern[-1])
                           else fwd)
            for op, b in issued:
                add("model", t, op, m * n, b)
    add("model", t, "all-reduce", 1, leaves)
    return out


def reckon_serve_collectives(model, model_ranks: int, kind: str, rows: int,
                             seq_len: int = 1, enc_len: int = 0,
                             frontend_len: int = 0) -> Dict[str, Dict]:
    """The collectives of one serving step on a serve tree
    (``models/sharding.for_serve``) over a (1, ``model_ranks``) mesh, as
    :func:`collectives_of` records them in ``by_group``: ``kind``
    ``"prefill"`` (``rows`` prompts of ``seq_len`` tokens, an
    encoder-decoder's frames ``enc_len`` long, ``frontend_len`` frontend
    embeddings ahead of a vlm's tokens) or ``"decode"`` (``rows``
    tokens).
    Model axis only, and the forward's only: the lookup's rows; each
    layer's (:func:`_layer_collectives` without the SSM's gathers: the
    serve tree holds the rank's columns), and an encoder-decoder's
    encoder (``wo``, ``w_down``) and decoder (``wo``, the cross
    attention's ``wo``, ``w_down``) layers; the logits made whole. No
    collective on the data axis, and none at ``model_ranks`` 1."""
    if kind not in ("prefill", "decode"):
        raise ValueError(f"kind {kind!r}: prefill or decode")
    out: Dict[str, Dict] = {}
    if model_ranks <= 1:
        return out
    cfg = model.cfg
    t = model_ranks
    rec = out.setdefault("model", {"ranks": t, "counts": {},
                                   "payload_bytes": {}, "wire_bytes": {}})

    def add(op: str, calls: int, b: int) -> None:
        for k, v in (("counts", calls), ("payload_bytes", calls * b),
                     ("wire_bytes", calls * _RING[op](b, t))):
            rec[k][op] = rec[k].get(op, 0) + v
    seq = seq_len if kind == "prefill" else 1
    act = model.adt.itemsize * rows * cfg.d_model
    add("all-reduce", 1, act * seq)                     # the lookup's rows
    if cfg.encoder_layers:
        if kind == "prefill":
            add("all-reduce", 2 * cfg.encoder_layers, act * enc_len)
        add("all-reduce", 3 * cfg.n_layers, act * seq)
    else:
        s_all = seq + (frontend_len if kind == "prefill" else 0)
        for pattern, n in ((model.prefix_pattern, model.n_prefix),
                           (model.pattern, model.n_blocks)):
            for ld in pattern:
                fwd, _ = _layer_collectives(model, ld, rows * s_all,
                                            gathers=False)
                for op, b in fwd:
                    add(op, n, b)
    v_pad = ((cfg.vocab_size + 127) // 128) * 128
    add("all-gather", 1, rows * v_pad * model.adt.itemsize)    # the logits
    return out
