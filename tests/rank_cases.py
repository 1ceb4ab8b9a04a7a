"""The cases of the rank tests (``test_torch_ranks.py``,
``test_torch_distributed.py``, ``test_torch_sharded_train.py``) that the
launcher's jobs do not cover. For the distributed engine:
the capacity ladder, a run pre-sized at given rungs, a supervised run with
a NaN drill, a resume from and a save to a checkpoint. A case is a
launcher job (``launch/distributed.py``) with any of these keys:

* ``ladder``: run a ``DistributedCapacityLadder``;
* ``rungs``: start from these capacities (what :func:`rungs_of` reads);
* ``supervised`` (``ckpt_dir``, ``checkpoint_every``): run the steps under
  ``SupervisedRunner`` over the ladder, with an optional ``nan_drill``
  (``iteration``, ``row``);
* ``resume`` / ``save``: checkpoint directories to start from / write at
  the end.

:func:`run_case` runs one on every rank of a group or, with no group, as
lanes of one device; :func:`launch` runs a list of them on gloo ranks in
one subprocess (the launcher's ``spawn_ranks``), with a timeout.

For the LM's sharded training, :func:`run_train_case` runs one case on
every rank of a ("data", "model") mesh of W ranks ((W, 1) unless the case
names another shape: (1, 2) and (2, 2) are tensor-parallel), and
:func:`launch_train` a list of them on W gloo ranks in one subprocess; see
:func:`run_train_case` for the keys of a case. For the LM's serving over
a (1, T) mesh, :func:`run_serve_case` and :func:`launch_serve` do the
same (``test_torch_tp_serve.py``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

from repro_torch.core import (DistConfig, DistributedCapacityLadder,
                              DistributedSimulation, SupervisedRunner, health,
                              restore_dist_state, save_dist_state)
from repro_torch.launch import distributed as launcher

ROOT = Path(__file__).resolve().parents[1]
TIMEOUT_S = 600


def _with_rungs(dcfg: DistConfig, rungs: Dict) -> DistConfig:
    eng = dcfg.engine
    eng = dataclasses.replace(eng, **{k: rungs[k] for k in (
        "max_per_box", "max_per_run") if k in rungs})
    if "max_pairs" in rungs:
        eng = dataclasses.replace(eng, pairlist=dataclasses.replace(
            eng.pairlist, max_pairs=rungs["max_pairs"]))
    return dataclasses.replace(dcfg, engine=eng, **{k: rungs[k] for k in (
        "local_capacity", "halo_capacity", "migrate_capacity")
        if k in rungs})


def rungs_of(dcfg: DistConfig) -> Dict:
    """The capacities a ladder grows (what ``rungs`` starts a case from)."""
    eng = dcfg.engine
    out = {k: getattr(dcfg, k) for k in ("local_capacity", "halo_capacity",
                                         "migrate_capacity")}
    out.update(max_per_box=eng.max_per_box, max_per_run=eng.max_per_run)
    if eng.pairlist is not None:
        out["max_pairs"] = eng.pairlist.max_pairs
    return out


def _nan_drill(drill: Optional[Dict], ladder) -> Optional[Callable]:
    """A NaN into the position of one agent (``row`` of the whole run's
    slots) before iteration ``iteration``, once, on the rank that holds
    it."""
    if not drill:
        return None
    fired: List[int] = []

    def hook(it, state):
        if it != drill["iteration"] or fired:
            return None
        fired.append(it)
        shards, c = ladder.sim.shards, ladder.dcfg.local_capacity
        row = drill["row"] - shards.first * c
        if 0 <= row < shards.n_local * c:
            return health.inject_value(state, "position", row, float("nan"))
        return None
    return hook


CASE_KEYS = ("ladder", "rungs", "supervised", "resume", "save")


def run_case(job: Dict, group=None, device="cpu") -> Dict:
    """One case, as ``launcher.run_job`` runs a job (a job with none of
    the case keys runs through ``run_job`` itself); ``own`` also holds the
    supervisor's ``report``, the ladder's ``rungs`` and the
    ``final_rungs``. A supervised case's arrays are those of its final
    state (no steps recorded)."""
    if not any(k in job for k in CASE_KEYS):
        return launcher.run_job(job, group, device)
    sc = launcher.scenario(job)
    dcfg = _with_rungs(sc.dcfg, job.get("rungs", {}))
    beh = sc.behaviors()
    if "resume" in job:
        st, dcfg = restore_dist_state(job["resume"], dcfg, beh,
                                      device=device, group=group)
    sup = job.get("supervised")
    ladder = bool(job.get("ladder") or sup)
    cls = DistributedCapacityLadder if ladder else DistributedSimulation
    sim = cls(dcfg, beh, device=device, group=group)
    if "resume" not in job:
        st = sim.init_state(sc.position, **sc.init)
    report = None
    if sup:
        runner = SupervisedRunner(
            sim, sup["ckpt_dir"], checkpoint_every=sup["checkpoint_every"],
            fault_hook=_nan_drill(job.get("nan_drill"), sim))
        st, rep = runner.run(st, job["steps"])
        report = rep.to_dict()
    res = launcher.run_steps(sim, st, 0 if sup else job["steps"])
    final = sim.sim if ladder else sim
    if "save" in job:
        save_dist_state(job["save"], res["state"], final.dcfg, group=group)
    res["own"].update(report=report, rungs=list(getattr(sim, "rungs", [])),
                      final_rungs=rungs_of(final.dcfg))
    return res


def main(argv: List[str]) -> None:
    """``PLAN OUT RANKS``: the plan's cases on that many gloo ranks."""
    plan, out, ranks = argv
    jobs = json.loads(Path(plan).read_text())
    launcher.spawn_ranks(launcher.run_jobs, (jobs, out, run_case),
                         int(ranks), "cpu")


def launch(jobs: List[Dict], world: int, out: Path) -> None:
    """``jobs`` on ``world`` gloo ranks in one subprocess (with a timeout);
    each writes ``out/<name>.npz`` and ``out/<name>.json``."""
    out.mkdir(parents=True, exist_ok=True)
    plan = out / "plan.json"
    plan.write_text(json.dumps(jobs))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, rank_cases; rank_cases.main(sys.argv[1:])",
         str(plan), str(out), str(world)], env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]


# ---------------------------------------------------------------------------
# The LM's sharded training (test_torch_sharded_train.py)
# ---------------------------------------------------------------------------

def _flat(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


def _np(t):
    import torch
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def run_train_case(case: Dict, group, device) -> Optional[Dict]:
    """One sharded-training case on this rank; rank 0 returns its record
    (others None). Keys: ``name``, ``arch`` (reduced), ``remat``;
    ``batch`` (global rows), ``seq``, ``steps`` (the step to end at),
    ``opt`` (AdamWConfig fields), ``micro``, ``sync`` (grad_sync_dtype);
    ``init``: a checkpoint directory holding ``{"params", "opt"}`` at step
    0 (else the seed-0 init); ``restore`` / ``save``: checkpoint
    directories to start from (its latest step) / write at the end;
    ``count``: the first step under ``collectives_of``; ``init_shards``:
    each rank writes its blocks of the seed-0 init to
    ``out/<name>_r<rank>.npz``; ``shapes``: record each leaf's local shape
    and a hint's placements; ``run``: ``launch/train.run`` with these
    TrainJob fields instead; ``mesh``: another (data, model) shape;
    ``cfg``: ArchConfig fields to override on the reduced config;
    ``mask``: batches with a ragged ``loss_mask`` (:func:`ragged_mask`);
    ``aux``: every ``train_loss`` call's aux loss on every rank
    (``aux_by_rank``); ``routing``: over every MoE ``positions`` call on
    every rank, the assignments, the dropped ones and those dropped only
    by the lower data ranks' offsets (``routing_by_rank``);
    ``deterministic``: under
    ``torch.use_deterministic_algorithms``; ``raises``: the case must
    raise NotImplementedError or ValueError, its type and message
    recorded; ``grads``: rank 0 writes the gradient of the loss of step
    0's batch (every leaf made whole; the mean over ``micro``
    microbatches) to ``out/<name>_grads.npz``; ``ce``:
    the vocab-parallel cross-entropy of random logits with padded columns
    against the one-device ``cross_entropy`` of the whole logits (values
    and gradients, with and without a mask)."""
    try:
        rec = _train_case(case, group, device)
    except (NotImplementedError, ValueError) as e:
        if not case.get("raises"):
            raise
        rec = {"name": case["name"], "raised": [type(e).__name__, str(e)]}
    else:
        if case.get("raises"):
            raise AssertionError(f"{case['name']} did not raise")
    import torch.distributed as dist
    return rec if dist.get_rank(group) == 0 else None


def _train_case(case: Dict, group, device) -> Dict:
    import dataclasses as dc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, rank_batch_at
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train as ltrain
    from repro_torch.models import build_model, layers, reduced_config
    from repro_torch.roofline import analysis
    from repro_torch.train import (AdamWConfig, checkpoint, init_state,
                                   make_train_step)

    from repro_torch.models import sharding
    rank, world = dist.get_rank(group), dist.get_world_size(group)
    rec: Dict = {"name": case["name"], "world": world}
    if case.get("deterministic"):
        torch.use_deterministic_algorithms(True)
    mesh = lmesh.make_device_mesh(lmesh.Mesh(
        tuple(case.get("mesh", (world, 1))), ("data", "model")), device)
    if case.get("ce"):
        rec["ce"] = _vocab_parallel_ce(mesh, device)
        return rec
    cfg = dc.replace(reduced_config(ARCHS[case["arch"]]),
                     remat=case.get("remat", "none"), **case.get("cfg", {}))
    if "run" in case:
        logs: List[str] = []
        out = ltrain.run(ltrain.TrainJob(arch=cfg, **case["run"]),
                         mesh=mesh, device=device, log=logs.append)
        rec.update(losses=out["losses"])
        every = [None] * world
        dist.all_gather_object(every, len(logs), group=group)
        rec["log_lines"] = every
        return rec
    model = build_model(cfg, attn_impl="sdpa", device=device)
    params = model.init_params(
        torch.Generator(device=device).manual_seed(0), mesh)
    _, drank, dworld = sharding.world_of(params)
    if case.get("init_shards"):
        np.savez(Path(case["out"]) / f"{case['name']}_r{rank}.npz", **{
            k: _np(v.to_local()) for k, v in _flat(params).items()})
    if case.get("shapes"):
        from torch.distributed.tensor import DTensor
        rec["local_shapes"] = {k: list(v.to_local().shape)
                               for k, v in _flat(params).items()}
        x = DTensor.from_local(torch.ones(2, 3, 8, device=device), mesh,
                               lmesh.placements(("data", None, None), mesh))
        layers.set_hint_axes(layers.MeshAxes(fsdp=("data",)))
        try:
            y = layers.hint(x, None, None, "fsdp")
        finally:
            layers.set_hint_axes(None)
        rec["hint"] = [str(p) for p in y.placements]
        rec["hint_local"] = list(y.to_local().shape)
        try:
            lmesh.shard(torch.ones(9, 8, device=device), mesh,
                        lmesh.placements(("data", None), mesh))
            rec["uneven"] = None
        except ValueError as e:
            rec["uneven"] = [type(e).__name__, str(e)]
    ocfg = AdamWConfig(**case.get("opt", {}))
    state = init_state(ocfg, params)
    start = 0
    src = case.get("restore") or case.get("init")
    if src:
        start = checkpoint.latest_step(src) if case.get("restore") else 0
        got = checkpoint.restore(src, start,
                                 {"params": params, "opt": state})
        params, state = got["params"], got["opt"]
    step_fn = make_train_step(model, ocfg,
                              n_microbatches=case.get("micro", 1),
                              grad_sync_dtype=case.get("sync"))
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=case.get("seq", 16),
                      global_batch=case.get("batch", 4), seed=1234,
                      frontend_tokens=cfg.frontend_tokens,
                      d_model=cfg.d_model)
    micro = step_fn.n_microbatches

    def batch_of(i):
        b = rank_batch_at(dcfg, i, drank, dworld, device=device,
                          n_microbatches=micro)
        if case.get("mask"):
            b["loss_mask"] = ragged_mask(b["tokens"])
        return b
    spies, seen = contextlib.ExitStack(), {}
    if case.get("aux"):
        seen["aux"] = spies.enter_context(_spy(
            model, "train_loss",
            lambda a, out: float(out[1]["aux"].detach())))
    if case.get("routing"):
        from repro_torch.models import moe
        seen["routing"] = spies.enter_context(_spy(moe, "positions",
                                                   _routed))
    if case.get("grads"):
        _save_grads(model, params, batch_of(0), micro,
                    Path(case["out"]) / f"{case['name']}_grads.npz")
    rec["metrics"] = []
    for i in range(start, case["steps"]):
        batch = batch_of(i)
        if case.get("count") and i == start:
            (params, state, m), col = analysis.collectives_of(
                step_fn, world, params, state, batch,
                groups=sharding.groups_of(params))
            rec["collectives"] = col.as_dict()
        else:
            params, state, m = step_fn(params, state, batch)
        rec["metrics"].append({k: float(m[k])
                               for k in ("loss", "grad_norm", "lr")})
    spies.close()
    for key, calls in seen.items():
        every = [None] * world
        dist.all_gather_object(every, calls, group=group)
        rec[f"{key}_by_rank"] = every
    if case.get("save"):
        tree = {"params": params, "opt": state}
        rec["save_gathers"] = _count_gathers(
            lambda: checkpoint.save(case["save"], case["steps"], tree))
        rec["save_gathers_expected"] = _sharded_axes(tree)
        one = torch.ones(1)
        dist.all_reduce(one, group=group)      # rank 0's write is done
    return rec


def ragged_mask(tokens):
    """A ``loss_mask`` over the label positions ``[:, 1:]`` of a batch's
    tokens, a function of the tokens alone (so a rank's rows of the
    global mask are the mask of its rows): 0 where the next token is a
    multiple of 3, so each row keeps a different count."""
    return (tokens[:, 1:] % 3 != 0).int()


@contextlib.contextmanager
def _spy(owner, name: str, pick):
    """While the block runs, ``owner.name`` appends ``pick(args,
    output)`` of every call to the yielded list."""
    own = name in vars(owner)      # else an instance's method, shadowed
    real = getattr(owner, name)
    seen: List = []

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append(pick(args, out))
        return out
    setattr(owner, name, spy)
    try:
        yield seen
    finally:
        if own:
            setattr(owner, name, real)
        else:
            delattr(owner, name)


def _routed(args, out) -> List[int]:
    """[assignments, dropped, dropped only by the offsets (the position in
    the rank's buffer below the capacity)] of one ``moe.positions(
    expert_idx, n_experts, cap, offset)`` call."""
    _, pos, keep = out
    return [keep.numel(), int((~keep).sum()),
            int(((pos < args[2]) & ~keep).sum())]


def _count_gathers(fn) -> int:
    """The ``torch.distributed.gather`` calls this rank makes in ``fn()``."""
    import torch.distributed as dist
    real, calls = dist.gather, []

    def counting(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    dist.gather = counting
    try:
        fn()
    finally:
        dist.gather = real
    return len(calls)


def _sharded_axes(tree) -> int:
    """Over a tree's DTensor leaves, the mesh axes of more than one rank
    each leaf is sharded over: the gathers a save makes on rank 0 (a leaf
    is gathered once over each such axis, and never over an axis of one
    rank or one it is replicated over)."""
    from torch.distributed.tensor import DTensor, Shard
    return sum(isinstance(pl, Shard) and v.device_mesh.size(i) > 1
               for v in _flat(tree).values() if isinstance(v, DTensor)
               for i, pl in enumerate(v.placements))


def _save_grads(model, params, batch, micro: int, path: Path) -> None:
    """The gradient of ``model.train_loss`` for every leaf, the mean over
    ``micro`` microbatches of ``batch`` (its rows split as the train step
    splits them), made whole on rank 0, which writes them to ``path``:
    the data ranks' gradients summed (by the gathers' backward) and
    divided by their count, as the train step divides them."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.models import sharding
    from repro_torch.train import microbatch
    from repro_torch.train.optimizer import _leaves, _unflatten
    leaves = [p.detach().requires_grad_(True) for p in _leaves(params)]
    tree = _unflatten(params, iter(leaves))
    loss = sum(model.train_loss(tree, microbatch(batch, micro, i))[0]
               for i in range(micro)) / micro
    grads = torch.autograd.grad(loss, leaves)
    data = sharding.world_of(params)[2]
    whole = {k: sharding.gather_to_rank0(g) for k, g in
             zip(_flat(params), grads)}
    whole = {k: None if v is None else v / data for k, v in whole.items()}
    if dist.get_rank() == 0:
        np.savez(path, **{k: _np(v) for k, v in whole.items()})


def _vocab_parallel_ce(mesh, device) -> Dict:
    """Random logits over a vocab of 200 padded to 256 (the padded columns
    at -1e30, as ``LM._logits`` masks them), 2 × 6 labels: each rank's
    column block through ``cross_entropy(..., tp)`` against the whole
    logits through the one-device ``cross_entropy``; the gaps of the loss
    and the largest of the gradient of this rank's columns, unmasked and
    masked, gathered from every rank."""
    import torch
    import torch.distributed as dist
    from repro_torch.models import layers, sharding
    group = mesh.get_group(sharding.mesh_dims(mesh)[1])
    tp = sharding.ModelAxis(group, dist.get_rank(group),
                            dist.get_world_size(group))
    gen = torch.Generator(device=device).manual_seed(5)
    vocab, v_pad = 200, 256
    logits = torch.randn(2, 6, v_pad, generator=gen, device=device) * 3
    logits[..., vocab:] = -1e30
    labels = torch.randint(0, vocab, (2, 6), generator=gen, device=device)
    mask = (torch.rand(2, 6, generator=gen, device=device) > 0.3).float()
    v = v_pad // tp.size
    cols = slice(tp.rank * v, (tp.rank + 1) * v)
    out = {}
    for name, m in (("plain", None), ("masked", mask)):
        whole = logits.clone().requires_grad_(True)
        want = layers.cross_entropy(whole, labels, m)
        (g_want,) = torch.autograd.grad(want, [whole])
        part = logits[..., cols].clone().requires_grad_(True)
        got = layers.cross_entropy(part, labels, m, tp)
        (g_got,) = torch.autograd.grad(got, [part])
        mine = {"loss": float(got), "loss_gap": abs(float(got - want)),
                "grad_gap": float((g_got - g_want[..., cols]).abs().max()),
                "padded_cols": int((logits[0, 0, cols] < -1e29).sum())}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, mine)
        out[name] = every
    return out


def run_train_cases(group, device, cases: List[Dict], out: str) -> None:
    """Every case in order on this rank; rank 0 writes ``out/cases.json``
    (a record a case)."""
    recs = []
    for case in cases:
        rec = run_train_case(dict(case, out=out), group, device)
        recs.append(rec)
    if recs and recs[0] is not None:
        (Path(out) / "cases.json").write_text(json.dumps(recs))


def train_main(argv: List[str]) -> None:
    """``PLAN OUT RANKS``: the plan's training cases on that many gloo
    ranks."""
    plan, out, ranks = argv
    cases = json.loads(Path(plan).read_text())
    launcher.spawn_ranks(run_train_cases, (cases, out), int(ranks), "cpu")


def launch_train(cases: List[Dict], world: int, out: Path) -> List[Dict]:
    """``cases`` on ``world`` gloo ranks in one subprocess (with a
    timeout); rank 0's records."""
    out.mkdir(parents=True, exist_ok=True)
    plan = out / "plan.json"
    plan.write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, rank_cases; rank_cases.train_main(sys.argv[1:])",
         str(plan), str(out), str(world)], env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((out / "cases.json").read_text())


# ---------------------------------------------------------------------------
# The LM's serving over a model axis (test_torch_tp_serve.py)
# ---------------------------------------------------------------------------

def unflatten(flat: Dict) -> Dict:
    """``{"a/b/c": leaf}`` → the nested dict."""
    out: Dict = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out


def _shard_whole(model, whole, mesh):
    """A whole parameter tree laid out on ``mesh`` by the model's spec
    tree (each rank's block as a DTensor)."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.models import layers
    axes = layers.MeshAxes(fsdp=("data",))
    flat = _flat(whole)
    out = {}
    for path, info in model.ps.infos.items():
        out[path] = lmesh.shard(flat[path], mesh, lmesh.placements(
            layers.resolve_spec(info.spec, axes), mesh))
    return unflatten(out)


# the ops that copy what they read (a read of a weight by one of them is a
# copy of that weight); ``embedding`` is a lookup of rows, not listed
_COPY_OPS = ("_to_copy", "clone", "copy_", "cat", "stack", "index",
             "index_select", "gather", "repeat", "contiguous",
             "expand_copy", "_unsafe_index")


def _weight_copies(fn, tree, *args):
    """``fn(*args)`` with every aten op recorded that copies an input
    sharing storage with a leaf of ``tree`` (:data:`_COPY_OPS`): (its
    result, [[op, input shape], ...])."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves
    ptrs = {x.untyped_storage().data_ptr() for x in tree_leaves(tree)
            if isinstance(x, torch.Tensor)}
    seen: List = []

    class Copies(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func.overloadpacket.__name__ in _COPY_OPS:
                for a in tree_leaves((args, kwargs or {})):
                    if (isinstance(a, torch.Tensor)
                            and a.untyped_storage().data_ptr() in ptrs):
                        seen.append([str(func), list(a.shape)])
            return func(*args, **(kwargs or {}))
    with Copies():
        out = fn(*args)
    return out, seen


def _serve_case(case: Dict, group, device) -> Dict:
    """One serving case on this rank (keys in :func:`run_serve_case`)."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch import convert
    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops as kops
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import serve_lm
    from repro_torch.models import build_model, reduced_config, sharding
    from repro_torch.roofline import analysis
    from repro_torch.train import make_decode_step, make_prefill_step
    world = dist.get_world_size(group)
    rec: Dict = {"name": case["name"]}
    cfg = dataclasses.replace(reduced_config(ARCHS[case["arch"]]),
                              **case.get("cfg", {}))
    model = build_model(cfg, device=device)
    shape = tuple(case.get("mesh", (1, world)))
    mesh = lmesh.make_device_mesh(lmesh.Mesh(shape, ("data", "model")),
                                  device)
    with np.load(case["weights"]) as z:
        whole = convert.params_from_numpy(unflatten(
            {k: z[k] for k in z.files}), device)
    params = _shard_whole(model, whole, mesh)
    tree, tp = sharding.for_serve(params)
    locals_ = _flat(params)
    rec["views"] = {k: v.data_ptr() == locals_[k].to_local().data_ptr()
                    for k, v in _flat(tree).items()}
    rec["local_shapes"] = {k: list(v.shape) for k, v in _flat(tree).items()}
    del params, whole
    groups = {"data": mesh.get_group(0), "model": mesh.get_group(1)}
    with np.load(case["inputs"]) as z:
        inp = {k: torch.from_numpy(z[k]).to(device) for k in z.files}
    b, s = inp["tokens"].shape
    batch = {"tokens": inp["tokens"]}
    fe = inp.get("frontend_embeds")
    if fe is not None:
        batch["frontend_embeds"] = fe
    shapes: List = []
    real = kops.flash_attention

    def spy(q, k, v, **kw):
        shapes.append([list(q.shape), list(k.shape)])
        return real(q, k, v, **kw)
    kops.flash_attention = spy
    try:
        (logits, pre), col = analysis.collectives_of(
            make_prefill_step(model, tp), world, tree, batch, groups=groups)
    finally:
        kops.flash_attention = real
    rec["k2_shapes"] = shapes
    rec["prefill_collectives"] = col.by_group
    n = s + (fe.shape[1] if fe is not None and not cfg.encoder_layers
             else 0)
    t = 1 if tp is None else tp.size
    s_max = case["s_max"]
    if cfg.encoder_layers:
        caches = model.init_decode_caches(b, s_max, fe.shape[1],
                                          model_ranks=t)
    else:
        caches = model.init_decode_caches(b, s_max, model_ranks=t)
    rec["cache_shapes"] = [list(c.shape) for c in serve_lm._leaves(caches)]
    serve_lm.write_caches(caches, pre, n)
    decode = make_decode_step(model, tp)
    out = [logits]
    for i, tok in enumerate(inp["decode_tokens"]):
        if i == 0:
            (lg, caches), col = analysis.collectives_of(
                decode, world, tree, tok, caches, n, groups=groups)
            rec["decode_collectives"] = col.by_group
        elif i == 1:
            (lg, caches), rec["decode_weight_copies"] = _weight_copies(
                decode, tree, tree, tok, caches, n + i)
        else:
            lg, caches = decode(tree, tok, caches, n + i)
        out.append(lg)
    logits = torch.stack(out).cpu().numpy()
    every: List = [None] * world
    dist.all_gather_object(every, logits.tobytes(), group=group)
    rec["logits_equal_on_ranks"] = all(x == every[0] for x in every)
    if dist.get_rank(group) == 0:
        np.save(Path(case["out"]) / f"{case['name']}_logits.npy", logits)
    if case.get("serve"):
        kw = dict(case["serve"])
        reqs = serve_lm.make_requests(kw.pop("requests"), cfg.vocab_size,
                                      prompt_min=kw.pop("prompt_min"),
                                      prompt_max=kw.pop("prompt_max"),
                                      new_tokens=kw.pop("new_tokens"),
                                      seed=kw.pop("seed"))
        frames = serve_lm.make_frames(cfg, reqs, case["serve"]["seed"])
        rep = serve_lm.serve(model, tree, reqs, frames=frames, tp=tp, **kw)
        streams = [[f.uid, list(map(int, f.tokens))] for f in rep.finished]
        dist.all_gather_object(every, streams, group=group)
        rec["streams"] = streams
        rec["streams_equal_on_ranks"] = all(x == streams for x in every)
        rec["n_free"] = rep.n_free
    return rec


def run_serve_case(case: Dict, group, device) -> Optional[Dict]:
    """One serving case on this rank; rank 0 returns its record (others
    None). Keys: ``name``, ``arch`` (reduced; ``cfg``: ArchConfig fields
    to override on it), ``weights`` (an npz of the
    whole weights, flat paths), ``inputs`` (an npz of ``tokens`` (B, S),
    ``decode_tokens`` (steps, B) and optionally ``frontend_embeds``),
    ``s_max``; ``mesh``: another (data, model) shape; ``serve``:
    ``serve_lm.serve``'s traffic and pool; ``raises``: the case must
    raise NotImplementedError or ValueError, its type and message
    recorded. The record: each serve-tree leaf's local shape and whether
    it is a view of the DTensor's block, the q and k shapes K2 got, the
    prefill's and the first decode step's collectives by group, the ops
    of the second decode step that copy a weight (:func:`_weight_copies`),
    the decode
    caches' shapes, whether the logits are equal on every rank (rank 0
    writes the prefill's and 4 decode steps' to ``<name>_logits.npy``),
    and the serve's token streams."""
    import torch.distributed as dist
    try:
        rec = _serve_case(case, group, device)
    except (NotImplementedError, ValueError) as e:
        if not case.get("raises"):
            raise
        rec = {"name": case["name"], "raised": [type(e).__name__, str(e)]}
    else:
        if case.get("raises"):
            raise AssertionError(f"{case['name']} did not raise")
    return rec if dist.get_rank(group) == 0 else None


def run_serve_cases(group, device, cases: List[Dict], out: str) -> None:
    """Every case in order on this rank; rank 0 writes ``out/cases.json``."""
    recs = [run_serve_case(dict(case, out=out), group, device)
            for case in cases]
    if recs and recs[0] is not None:
        (Path(out) / "cases.json").write_text(json.dumps(recs))


def serve_main(argv: List[str]) -> None:
    """``PLAN OUT RANKS``: the plan's serving cases on that many gloo
    ranks."""
    plan, out, ranks = argv
    cases = json.loads(Path(plan).read_text())
    launcher.spawn_ranks(run_serve_cases, (cases, out), int(ranks), "cpu")


def launch_serve(cases: List[Dict], world: int, out: Path) -> List[Dict]:
    """``cases`` on ``world`` gloo ranks in one subprocess (with a
    timeout); rank 0's records."""
    out.mkdir(parents=True, exist_ok=True)
    plan = out / "plan.json"
    plan.write_text(json.dumps(cases))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]))
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, rank_cases; rank_cases.serve_main(sys.argv[1:])",
         str(plan), str(out), str(world)], env=env, capture_output=True,
        text=True, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads((out / "cases.json").read_text())
