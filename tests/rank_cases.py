"""The cases of the rank tests (``test_torch_ranks.py``,
``test_torch_distributed.py``) that the launcher's jobs do not cover:
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
"""

from __future__ import annotations

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
