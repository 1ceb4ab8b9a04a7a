"""MoE routing over the data axis on gloo ranks on the CPU: the reduced MoE
configs trained over (2, 1), (4, 1) and (2, 2) ("data", "model")
``DeviceMesh``es ≡ the JAX reference, whose routing is global over the
microbatch's tokens on all data ranks (the capacity, the slot positions
and the aux loss: ``models/moe.global_slots``).

The ranks run in one subprocess per world size (2, then 4), each with a
timeout (``rank_cases.launch_train``); the reference is computed once a
config in this process meanwhile, and both packages start from its
weights (its step-0 checkpoint, restored onto each mesh). The reference's
one-device ``jax.grad`` and its ``make_train_step(n_microbatches=2)`` are
the judges. The configs:

* the reduced deepseek-v2-lite-16b at 32 experts (experts over "fsdp",
  the FFN dim over "tp", as at full width): MLA, the dense first layer,
  the shared experts;
* the reduced jamba (experts over "tp", their FFN dim over "fsdp"; SSM
  and GQA layers) and kimi-k2 (GQA, a shared expert);
* the deepseek one at capacity factor 1.0 on 64-token sequences, where
  some assignments are dropped only because of the lower data ranks'
  assignments to their expert (drops across a rank boundary).

It shows, with 2 microbatches: the gradient of every leaf made whole ≡
``jax.grad`` of the reference; 3 steps ≡ the reference's (loss,
grad_norm, lr), params within 1e-3; the aux loss of every microbatch ≡
the reference's and the same on every rank; a ragged ``loss_mask`` on
(2, 1) and (2, 2) ≡ ``jax.grad``; the collectives of a step ≡
``roofline/analysis.reckon_collectives`` under remat none and full; the
port's ``launch/train.run`` on 2 ranks ≡ the reference's own over 2 host
devices; and ``data.rank_batch_at``'s rows of each global microbatch.
"""

import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.data import DataConfig as TDataConfig  # noqa: E402
from repro_torch.data import batch_at as tbatch_at  # noqa: E402
from repro_torch.data import rank_batch_at  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402
from repro_torch.train import microbatch  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-5, 1e-4
# lr 1e-3, as test_torch_tp_moe.py's (the reduced jamba amplifies
# rounding about tenfold a step at 1e-2)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS, BATCH, SEQ, MICRO = 3, 8, 16, 2
DS = "deepseek-v2-lite-16b"
# name: (arch, ArchConfig fields over the reduced config, sequence length)
CONFIGS = {"deepseek": (DS, dict(n_experts=32), SEQ),
           "jamba": ("jamba-v0.1-52b", {}, SEQ),
           "kimi": ("kimi-k2-1t-a32b", {}, SEQ),
           "drops": (DS, dict(n_experts=32, capacity_factor=1.0), 64)}
# (run, world, mesh, config): 3 steps and step 0's gradients
STEP_RUNS = {**{f"dp21_{n}": (2, (2, 1), n) for n in CONFIGS},
             "dp41_deepseek": (4, (4, 1), "deepseek"),
             "dp22_deepseek": (4, (2, 2), "deepseek")}
# the gradients of a ragged loss_mask (the deepseek config)
MASK_RUNS = {"dp21_mask": (2, (2, 1)), "dp22_mask": (4, (2, 2))}
# one counted step each, by (config, mesh, remat); the step runs count
# their first step under remat full
COUNTED = [(n, mesh, remat) for n in ("deepseek", "jamba", "kimi")
           for mesh in ((2, 1), (2, 2)) for remat in ("none", "full")]
RUN_JOB = dict(steps=STEPS, seq_len=SEQ, global_batch=BATCH,
               lr=OPT["lr"], warmup=OPT["warmup_steps"],
               n_microbatches=MICRO, log_every=1)


@pytest.fixture(scope="module", autouse=True)
def _single_thread():
    """One torch thread for the module (as every rank runs)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _data(cfg, seq):
    return dict(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=BATCH,
                seed=1234, frontend_tokens=cfg.frontend_tokens,
                d_model=cfg.d_model)


def _flat_np(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np(tree[k], path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _counted_name(n, mesh, remat):
    return f"count_{n}_{mesh[0]}{mesh[1]}_{remat}"


def _plans(dirs, d):
    """The gloo cases by world size."""
    def case(name, cfg_name, **kw):
        arch, over, seq = CONFIGS[cfg_name]
        return dict(dict(name=name, arch=arch, cfg=over, batch=BATCH,
                         seq=seq, opt=OPT, micro=MICRO,
                         init=dirs[cfg_name]), **kw)
    plans = {2: [], 4: []}
    for run, (world, mesh, n) in STEP_RUNS.items():
        plans[world].append(case(run, n, mesh=mesh, steps=STEPS,
                                 remat="full", aux=True,
                                 count=n != "drops", save=str(d / run)))
        plans[world].append(case(f"{run}_grads", n, mesh=mesh, steps=0,
                                 grads=True, routing=n == "drops"))
    for run, (world, mesh) in MASK_RUNS.items():
        plans[world].append(case(f"{run}_grads", "deepseek", mesh=mesh,
                                 steps=0, grads=True, mask=True))
    for n, mesh, remat in COUNTED:
        if f"dp{mesh[0]}{mesh[1]}_{n}" in STEP_RUNS and remat == "full":
            continue
        plans[math.prod(mesh)].append(case(
            _counted_name(n, mesh, remat), n, mesh=mesh, steps=1,
            remat=remat, count=True))
    arch, over, _ = CONFIGS["deepseek"]
    plans[2].append(dict(name="run", arch=arch, cfg=over, run=dict(
        RUN_JOB, ckpt_dir=str(d / "run_port"))))
    return plans


_RUN_SCRIPT = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import dataclasses
import jax
from repro.configs import ARCHS
from repro.launch import train
from repro.models import reduced_config
arch, over, job = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
cfg = dataclasses.replace(reduced_config(ARCHS[arch]), **over)
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
out = train.run(train.TrainJob(arch=cfg, **job), mesh=mesh,
                log=lambda *a: None)
print(json.dumps({"devices": mesh.devices.size, **out}))
"""


def _reference_run(ckpt_dir):
    """The reference's own ``launch/train.run`` of the deepseek config
    over a (2, 1) mesh of 2 host devices, from the step-0 checkpoint in
    ``ckpt_dir``, in a subprocess."""
    arch, over, _ = CONFIGS["deepseek"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _RUN_SCRIPT, arch, json.dumps(over),
         json.dumps(dict(RUN_JOB, ckpt_dir=str(ckpt_dir)))], env=env,
        capture_output=True, text=True, timeout=rank_cases.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(ref, runs). ``ref``, per config: ``jax.grad`` of the mean of its
    loss over step 0's 2 microbatches (with the ragged mask too for
    deepseek), and the metrics, each microbatch's aux loss and the params
    of 3 jitted steps of ``make_train_step(n_microbatches=2)``; under
    ``"run"`` the reference's ``launch/train.run`` over 2 host devices.
    ``runs``: ({world: {case name: rank 0's record}}, the scratch
    directory). The reference's step-0 checkpoints are written first; the
    gloo subprocesses (2 ranks, and 4) and the host-device run start from
    them and run while this process computes the rest of the
    reference."""
    from concurrent.futures import ThreadPoolExecutor
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.data import DataConfig, batch_at
    from repro.models import build_model, reduced_config
    from repro.train import AdamWConfig, checkpoint, make_train_step
    from repro.train import optimizer
    d = tmp_path_factory.mktemp("dp_moe")
    jc = AdamWConfig(**OPT)
    models, dirs = {}, {}
    for name, (arch, over, _) in CONFIGS.items():
        jm = build_model(dataclasses.replace(reduced_config(ARCHS[arch]),
                                             **over))
        jp = jm.init_params(jax.random.PRNGKey(0))
        dirs[name] = str(d / "ref" / name)
        checkpoint.save(dirs[name], 0, {"params": jp,
                                        "opt": optimizer.init_state(jc, jp)})
        models[name] = (jm, jp)
    for run in ("run_port", "run_ref"):
        shutil.copytree(dirs["deepseek"], d / run)
    plans = _plans(dirs, d)

    def micro(b, i):
        return jax.tree.map(
            lambda x: x.reshape((MICRO, x.shape[0] // MICRO)
                                + x.shape[1:])[i], b)

    def grads(name):
        """The mean of ``jax.grad`` over step 0's 2 microbatches (one
        trace, called on each)."""
        jm, jp = models[name]
        grad = jax.jit(jax.grad(lambda p, b: jm.train_loss(p, b)[0]))
        batch = batch_at(DataConfig(**_data(jm.cfg, CONFIGS[name][2])), 0)
        rec = {}
        for key, b in (("grads", batch), ("mask_grads", dict(
                batch, loss_mask=jnp.asarray(
                    np.asarray(batch["tokens"])[:, 1:] % 3 != 0,
                    jnp.int32)))):
            if key == "mask_grads" and name != "deepseek":
                continue
            g = [_flat_np(jax.tree.map(np.asarray, grad(jp, micro(b, i))))
                 for i in range(MICRO)]
            rec[key] = {k: sum(x[k] for x in g) / MICRO for k in g[0]}
        return rec

    def steps(name):
        """3 jitted steps of ``make_train_step(n_microbatches=2)``, and the
        aux loss of each microbatch before each step."""
        jm, jp = models[name]
        dcfg = DataConfig(**_data(jm.cfg, CONFIGS[name][2]))
        step = jax.jit(make_train_step(jm, jc, n_microbatches=MICRO))
        aux = jax.jit(lambda p, b: jm.train_loss(p, b)[1]["aux"])
        p, st, mets, auxes = jp, optimizer.init_state(jc, jp), [], []
        for i in range(STEPS):
            b = batch_at(dcfg, i)
            auxes += [float(aux(p, micro(b, j))) for j in range(MICRO)]
            p, st, m = step(p, st, b)
            mets.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        return dict(metrics=mets, aux=auxes,
                    final=_flat_np(jax.tree.map(np.asarray, p)))

    # XLA compiles outside the GIL: the reference's parts run in threads
    # beside the gloo subprocesses and the host-device run
    with ThreadPoolExecutor(len(plans) + 1 + 2 * len(models)) as pool:
        futures = {w: pool.submit(rank_cases.launch_train, cases, w,
                                  d / f"w{w}") for w, cases in plans.items()}
        run_ref = pool.submit(_reference_run, d / "run_ref")
        parts = {(name, fn.__name__): pool.submit(fn, name)
                 for name in models for fn in (grads, steps)}
        ref = {name: {} for name in models}
        for (name, _), f in parts.items():
            ref[name].update(f.result())
        ref["run"] = run_ref.result()
        out = {w: {r["name"]: r for r in f.result()}
               for w, f in futures.items()}
    return ref, (out, d)


@pytest.fixture(scope="module")
def ref(both):
    return both[0]


@pytest.fixture(scope="module")
def runs(both):
    return both[1]


def _grads_of(d, world, case):
    with np.load(d / f"w{world}" / f"{case}_grads_grads.npz") as z:
        return {k: z[k] for k in z.files}


def _assert_grads(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_dp_moe_gradients_match_reference(runs, ref, run):
    """The gradient of every leaf over 2 microbatches on the data ranks
    (the router's through the aux loss's summed probabilities, the expert
    FFN's from each rank's own kept rows), made whole and divided by the
    data ranks as the step divides it, ≡ ``jax.grad`` of the reference's
    mean loss over the same 2 global microbatches."""
    world, _, name = STEP_RUNS[run]
    _assert_grads(_grads_of(runs[1], world, run), ref[name]["grads"])


@pytest.mark.parametrize("run", list(MASK_RUNS))
def test_dp_ragged_loss_mask_gradients_match_reference(runs, ref, run):
    """A ragged ``loss_mask`` (a different count of kept positions on each
    row and rank): its masked sum and count are summed over the data
    ranks, so every gradient leaf ≡ ``jax.grad`` of the reference's
    global masked mean."""
    world, _ = MASK_RUNS[run]
    _assert_grads(_grads_of(runs[1], world, run),
                  ref["deepseek"]["mask_grads"])


@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_dp_moe_steps_match_reference(runs, ref, run):
    """Loss, grad_norm and lr of 3 steps of 2 microbatches on the data
    ranks (remat full) ≡ the reference's single-device
    ``make_train_step(n_microbatches=2)`` from the same weights and
    batches."""
    world, _, name = STEP_RUNS[run]
    got = runs[0][world][run]["metrics"]
    assert len(got) == STEPS
    for i, (g, w) in enumerate(zip(got, ref[name]["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{run} step {i + 1} {k}")


@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_dp_moe_params_match_reference(runs, ref, run):
    """The params after 3 steps (saved in the reference's global layout)
    within lr of the reference's."""
    d = runs[1]
    name = STEP_RUNS[run][2]
    with np.load(d / run / f"step_{STEPS:09d}" / "arrays.npz") as z:
        got = {k[len("params/"):]: z[k] for k in z.files
               if k.startswith("params/")}
    want = ref[name]["final"]
    assert set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max())
               for k in want) < OPT["lr"]


@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_dp_moe_aux_is_the_references_on_every_rank(runs, ref, run):
    """Each microbatch's aux loss (E · Σ f_e · p_e over the global
    microbatch's tokens) is the same on every rank, bit for bit, and ≡
    the reference's on that microbatch."""
    world, _, name = STEP_RUNS[run]
    by_rank = runs[0][world][run]["aux_by_rank"]
    assert len(by_rank) == world and len(by_rank[0]) == STEPS * MICRO
    assert all(a == by_rank[0] for a in by_rank), by_rank
    np.testing.assert_allclose(by_rank[0], ref[name]["aux"], atol=ATOL,
                               rtol=RTOL)


def test_drops_cross_a_rank_boundary(runs):
    """At capacity factor 1.0 some assignments are dropped, and on data
    rank 1 some of them only because rank 0's assignments to their expert
    came first (their local position is below the capacity): the case
    the offsets decide. Rank 0 has no offset."""
    by_rank = runs[0][2]["dp21_drops_grads"]["routing_by_rank"]
    assert len(by_rank[0]) == MICRO          # one MoE layer a microbatch
    for r, calls in enumerate(by_rank):
        assert all(0 < dropped < n for n, dropped, _ in calls), (r, calls)
    assert all(crossed == 0 for _, _, crossed in by_rank[0])
    assert sum(crossed for _, _, crossed in by_rank[1]) > 0, by_rank


@pytest.mark.parametrize("n,mesh,remat", COUNTED)
def test_dp_moe_collectives_are_what_the_spec_tree_implies(runs, n, mesh,
                                                           remat):
    """One step of 2 microbatches, by group, ≡
    ``roofline/analysis.reckon_collectives``: on the data axis, besides
    FSDP's gathers and reduce-scatters, each MoE layer's counts
    all-gathered and its summed router probabilities all-reduced in the
    forward (and, under remat full, again in the recompute) and their
    gradient all-reduced in the backward; on (2, 2) the model axis's
    collectives at the global microbatch's capacity."""
    from repro_torch.roofline import analysis
    world = math.prod(mesh)
    name = f"dp{mesh[0]}{mesh[1]}_{n}"
    if not (name in STEP_RUNS and remat == "full"):
        name = _counted_name(n, mesh, remat)
    rec = runs[0][world][name]["collectives"]
    arch, over, seq = CONFIGS[n]
    cfg = dataclasses.replace(treduced(TARCHS[arch]), remat=remat, **over)
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    want = analysis.reckon_collectives(model, mesh[0], mesh[1], MICRO,
                                       BATCH // mesh[0] // MICRO, seq)
    assert rec["by_group"] == want
    moe = sum(ld.mlp == "moe" for ld in model.pattern) * model.n_blocks
    again = 2 if remat == "full" else 1
    data = want["data"]["counts"]
    # the routing's own: the blocks' all-gathers besides FSDP's
    fsdp = analysis.reckon_collectives(model, 1, mesh[1], MICRO,
                                       BATCH // mesh[0] // MICRO, seq)
    assert data["all-gather"] - fsdp["data"]["counts"]["all-gather"] \
        == MICRO * moe * again


def test_train_run_matches_the_references_over_two_host_devices(runs, ref):
    """The port's ``launch/train.run`` on 2 gloo ranks ((2, 1), 2
    microbatches) ≡ the reference's own ``launch/train.run`` jitted over a
    (2, 1) mesh of 2 host devices (``--xla_force_host_platform_device_
    count``), both resumed from the same step-0 checkpoint: the first and
    last logged loss, and the params of the step-3 checkpoints each
    wrote."""
    want = ref["run"]
    assert want["devices"] == 2
    got = runs[0][2]["run"]["losses"]
    assert len(got) == STEPS
    np.testing.assert_allclose([got[0], got[-1]],
                               [want["first_loss"], want["final_loss"]],
                               atol=ATOL, rtol=RTOL)
    d = runs[1]
    arrays = {}
    for run in ("run_port", "run_ref"):
        assert tckpt.latest_step(str(d / run)) == STEPS
        with np.load(d / run / f"step_{STEPS:09d}" / "arrays.npz") as z:
            arrays[run] = {k: z[k].astype(np.float32) for k in z.files
                           if k.startswith("params/")}
    assert set(arrays["run_port"]) == set(arrays["run_ref"])
    assert max(float(np.abs(arrays["run_port"][k]
                            - arrays["run_ref"][k]).max())
               for k in arrays["run_ref"]) < OPT["lr"]


@pytest.mark.parametrize("world,n", [(1, 1), (2, 1), (2, 2), (4, 2),
                                     (2, 4)])
def test_rank_batch_rows_are_blocks_of_each_global_microbatch(world, n):
    """``rank_batch_at(..., n_microbatches=n)``: split as the step splits
    it (``train_step.microbatch``), rank r's microbatch i is block r of the global microbatch i
    (rows ``[i·B/n + r·B/(n·W), i·B/n + (r+1)·B/(n·W))``); n·W that does
    not divide the batch raises."""
    cfg = TDataConfig(vocab_size=512, seq_len=8, global_batch=8, seed=3,
                      frontend_tokens=2, d_model=4)
    whole = tbatch_at(cfg, 5, device="cpu")
    per = 8 // n // world
    for r in range(world):
        part = rank_batch_at(cfg, 5, r, world, device="cpu",
                             n_microbatches=n)
        for k, v in whole.items():
            assert part[k].shape[0] == 8 // world
            for i in range(n):
                rows = slice(i * (8 // n) + r * per,
                             i * (8 // n) + (r + 1) * per)
                assert torch.equal(microbatch(part, n, i)[k], v[rows])
    with pytest.raises(ValueError, match="microbatches"):
        rank_batch_at(cfg, 5, 0, world, device="cpu",
                      n_microbatches=3 * n)
