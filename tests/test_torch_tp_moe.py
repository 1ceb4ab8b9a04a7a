"""Tensor parallelism of MLA and the expert FFN on gloo ranks on the CPU:
the reduced MoE configs trained over a (1, 2) and a (1, 4) ("data",
"model") ``DeviceMesh`` ≡ the JAX reference.

The ranks run in one subprocess per world size (2, then 4), each with a
timeout (``rank_cases.launch_train``); the reference is computed once a
config in this process, and both packages start from its weights (its
step-0 checkpoint, restored onto each mesh). The configs:

* the reduced deepseek-v2-lite-16b at 32 experts (``reduced_config``
  gives every MoE config 8, and 8 experts go over "tp"; at 32 they go
  over "fsdp" with the FFN dim over "tp", as at full width): MLA, the
  dense first layer, the shared experts;
* the reduced jamba (experts over "tp"; SSM and GQA layers);
* the reduced kimi-k2 (GQA, experts over "tp", a shared expert);
* the deepseek one at capacity factor 1.0 on 64-token sequences (some
  assignments dropped into the parked slot), with ``moe_dispatch=
  "gather"``, and with ``moe_ffn_unsharded`` (the expert FFN whole on
  every model rank).

It shows: the gradient of every leaf on (1, 2), and of the deepseek one on
(1, 4), made whole ≡ ``jax.grad`` of the reference; 3 steps ≡ the
reference's (loss, grad_norm, lr), params within 1e-3; each rank's init
block ≡ the slice of the one-device init, bit for bit; the expert weights
split as ``models/moe.expert_axes`` lays them out; the collectives of a
step ≡ ``roofline/analysis.reckon_collectives``; and
``launch/mesh.check_divides`` refusing expert dims that do not split.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.data import DataConfig as TDataConfig  # noqa: E402
from repro_torch.data import batch_at as tbatch_at  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
# lr 1e-3, not test_torch_sharded_train.py's 1e-2: at 1e-2 the reduced
# jamba's steps amplify rounding about tenfold a step (a 1e-7 relative
# perturbation of the weights moves step 3's grad_norm by 2e-5), and the
# port's one-device step already parts from the reference's by 1.9e-4 in
# step 3's grad_norm there; at 1e-3 the same perturbation moves it by 8e-7
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEPS, BATCH, SEQ = 3, 4, 16
DS = "deepseek-v2-lite-16b"
# name: (arch, ArchConfig fields over the reduced config, sequence length)
CONFIGS = {"deepseek": (DS, dict(n_experts=32), SEQ),
           "jamba": ("jamba-v0.1-52b", {}, SEQ),
           "kimi": ("kimi-k2-1t-a32b", {}, SEQ)}
# gradients only
VARIANTS = {"deepseek_drops": (DS, dict(n_experts=32, capacity_factor=1.0),
                               64),
            "deepseek_gather": (DS, dict(n_experts=32,
                                         moe_dispatch="gather"), SEQ),
            "deepseek_unsharded": (DS, dict(n_experts=32,
                                            moe_ffn_unsharded=True), SEQ)}
ALL = {**CONFIGS, **VARIANTS}
# (run, world, mesh, config)
STEP_RUNS = {**{f"tp12_{n}": (2, (1, 2), n) for n in CONFIGS},
             "tp14_deepseek": (4, (1, 4), "deepseek")}
GRAD_RUNS = {**{f"tp12_{n}": (2, (1, 2), n) for n in ALL},
             "tp14_deepseek": (4, (1, 4), "deepseek")}


@pytest.fixture(scope="module", autouse=True)
def _single_thread():
    """One torch thread for the module (as every rank runs)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(name):
    arch, over, _ = ALL[name]
    return dataclasses.replace(treduced(TARCHS[arch]), **over)


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


def _plans(dirs, d):
    """The gloo cases by world size: 3 steps (remat full; on (1, 2) the
    first under ``collectives_of``), step 0's gradients, the init
    blocks."""
    def case(name, cfg_name, **kw):
        arch, over, seq = ALL[cfg_name]
        return dict(dict(name=name, arch=arch, cfg=over, batch=BATCH,
                         seq=seq, opt=OPT, init=dirs[cfg_name]), **kw)
    plans = {2: [], 4: []}
    for run, (world, mesh, n) in STEP_RUNS.items():
        plans[world].append(case(run, n, mesh=mesh, steps=STEPS,
                                 remat="full", count=world == 2,
                                 save=str(d / run)))
    for run, (world, mesh, n) in GRAD_RUNS.items():
        plans[world].append(case(f"{run}_grads", n, mesh=mesh, steps=0,
                                 grads=True))
    for run, (world, mesh, n) in STEP_RUNS.items():
        plans[world].append(dict(name=f"shards_{run}", arch=ALL[n][0],
                                 cfg=ALL[n][1], steps=0, mesh=mesh,
                                 init_shards=True, shapes=world == 2))
    return plans


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(ref, runs). ``ref``, per config: the reference's weights (numpy),
    ``jax.grad`` of its loss on step 0's batch, and (``CONFIGS``) the
    metrics and params of 3 jitted steps. ``runs``: ({world: {case name:
    rank 0's record}}, the scratch directory). The reference's step-0
    checkpoints ``{"params", "opt"}`` are written first; the gloo
    subprocesses (2 ranks, and 4) start from them and run while this
    process computes the rest of the reference."""
    from concurrent.futures import ThreadPoolExecutor
    pytest.importorskip("jax")
    import jax
    from repro.configs import ARCHS
    from repro.data import DataConfig, batch_at
    from repro.models import build_model, reduced_config
    from repro.train import AdamWConfig, checkpoint, make_train_step
    from repro.train import optimizer
    d = tmp_path_factory.mktemp("tp_moe")
    jc = AdamWConfig(**OPT)
    models, dirs = {}, {}
    for name, (arch, over, _) in ALL.items():
        jm = build_model(dataclasses.replace(reduced_config(ARCHS[arch]),
                                             **over))
        jp = jm.init_params(jax.random.PRNGKey(0))
        dirs[name] = str(d / "ref" / name)
        checkpoint.save(dirs[name], 0, {"params": jp,
                                        "opt": optimizer.init_state(jc, jp)})
        models[name] = (jm, jp)
    plans = _plans(dirs, d)
    with ThreadPoolExecutor(len(plans)) as pool:
        futures = {w: pool.submit(rank_cases.launch_train, cases, w,
                                  d / f"w{w}") for w, cases in plans.items()}
        ref = {}
        for name, (jm, jp) in models.items():
            dcfg = DataConfig(**_data(jm.cfg, ALL[name][2]))
            batch = batch_at(dcfg, 0)
            grads = jax.jit(jax.grad(
                lambda p: jm.train_loss(p, batch)[0]))(jp)
            rec = dict(params=jax.tree.map(np.asarray, jp),
                       grads=_flat_np(jax.tree.map(np.asarray, grads)))
            if name in CONFIGS:
                step = jax.jit(make_train_step(jm, jc))
                p, st, mets = jp, optimizer.init_state(jc, jp), []
                for i in range(STEPS):
                    p, st, m = step(p, st, batch_at(dcfg, i))
                    mets.append({k: float(m[k])
                                 for k in ("loss", "grad_norm", "lr")})
                rec.update(metrics=mets,
                           final=_flat_np(jax.tree.map(np.asarray, p)))
            ref[name] = rec
        out = {w: {r["name"]: r for r in f.result()}
               for w, f in futures.items()}
    return ref, (out, d)


@pytest.fixture(scope="module")
def ref(both):
    return both[0]


@pytest.fixture(scope="module")
def runs(both):
    return both[1]


@pytest.mark.parametrize("run", list(GRAD_RUNS))
def test_tp_moe_gradients_match_reference(runs, ref, run):
    """The gradient of every leaf on the model axis, made whole (MLA's
    column and row blocks and its replicated ``w_dkv``, ``w_kpe``,
    ``kv_norm`` whose gradients are summed over the model ranks; the
    router, every model rank's own; the expert FFN's FFN-dim or expert
    blocks; the shared experts'), ≡ ``jax.grad`` of the reference."""
    _, d = runs
    world, _, name = GRAD_RUNS[run]
    with np.load(d / f"w{world}" / f"{run}_grads_grads.npz") as z:
        got = {k: z[k] for k in z.files}
    want = ref[name]["grads"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_tp_moe_steps_match_reference(runs, ref, run):
    """Loss, grad_norm and lr of 3 steps on the model axis (remat full) ≡
    the reference's single-device ``make_train_step`` from the same
    weights and batches."""
    world, _, name = STEP_RUNS[run]
    got = runs[0][world][run]["metrics"]
    assert len(got) == STEPS
    for i, (g, w) in enumerate(zip(got, ref[name]["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{run} step {i + 1} {k}")


@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_tp_moe_params_match_reference(runs, ref, run):
    """The params after 3 steps (saved in the reference's global layout)
    within lr of the reference's: AdamW may move an element whose |g| is
    near eps by up to lr on rounding alone."""
    _, d = runs
    name = STEP_RUNS[run][2]
    man = tckpt.load_manifest(str(d / run), STEPS)["leaves"]
    with np.load(d / run / f"step_{STEPS:09d}" / "arrays.npz") as z:
        got = {k[len("params/"):]: z[k] for k in z.files
               if k.startswith("params/")}
    assert all(man[f"params/{k}"]["dtype"] == "float32" for k in got)
    want = ref[name]["final"]
    assert set(got) == set(want)
    assert max(float(np.abs(got[k] - want[k]).max())
               for k in want) < OPT["lr"]


@pytest.mark.parametrize("run", list(STEP_RUNS))
def test_tp_moe_init_blocks_are_slices_of_the_one_device_init(runs, run):
    """Rank r of a (1, T) mesh holds model block r of every leaf: its
    block ≡ the slice of the one-device seed-0 init along the leaf's
    "tp" dim (the experts' or their FFN dim's, as ``expert_axes`` says),
    bit for bit."""
    _, d = runs
    world, shape, name = STEP_RUNS[run]
    model = tbuild(_cfg(name), attn_impl="sdpa", device="cpu")
    whole = _flat_np_t(model.init_params(
        torch.Generator(device="cpu").manual_seed(0)))
    axes = tlayers.MeshAxes(fsdp=("data",))
    specs = {k: tlayers.resolve_spec(info.spec, axes)
             for k, info in model.ps.infos.items()}
    t = shape[1]
    for r in range(world):
        with np.load(d / f"w{world}" / f"shards_{run}_r{r}.npz") as z:
            for k, full in whole.items():
                idx = tuple(slice(r * (n // t), (r + 1) * (n // t))
                            if e == "model" else slice(None)
                            for n, e in zip(full.shape, specs[k]))
                assert z[k].tobytes() == full[idx].numpy().tobytes(), (r, k)


def _flat_np_t(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np_t(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


@pytest.mark.parametrize("name,leaf,local", [
    ("deepseek", "blocks/l0/moe/w_gate", [1, 32, 64, 16]),
    ("deepseek", "blocks/l0/moe/w_down", [1, 32, 16, 64]),
    ("deepseek", "blocks/l0/attn/w_uk", [1, 32, 32]),
    ("jamba", "blocks/l1/moe/w_gate", [1, 4, 64, 32]),
    ("kimi", "blocks/l0/moe/w_down", [1, 4, 32, 64])])
def test_expert_weights_split_as_expert_axes_lays_them_out(runs, name, leaf,
                                                           local):
    """On (1, 2) the reduced deepseek at 32 experts keeps every expert and
    half its FFN dim on a rank (experts over "fsdp", the FFN dim over
    "tp"), jamba and kimi-k2 (8 experts) half the experts whole; MLA's
    ``w_uk`` holds the rank's 2 heads of 16."""
    got = runs[0][2][f"shards_tp12_{name}"]["local_shapes"][leaf]
    assert got == local, (name, leaf, got)


def test_capacity_factor_one_drops_assignments(ref):
    """The drops case's routing parks some assignments in slot ``cap``
    (so the TP path's dropped rows are exercised)."""
    cfg = _cfg("deepseek_drops")
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    params = convert.params_from_numpy(ref["deepseek_drops"]["params"],
                                       "cpu")
    batch = tbatch_at(TDataConfig(**_data(cfg, 64)), 0, device="cpu")
    real, kept = tmoe.positions, []

    def spy(*a):
        out = real(*a)
        kept.append(out[2])
        return out
    tmoe.positions = spy
    try:
        with torch.no_grad():
            model.train_loss(params, batch)
    finally:
        tmoe.positions = real
    assert len(kept) == 1                       # one MoE layer
    dropped, n = int((~kept[0]).sum()), kept[0].numel()
    assert 0 < dropped < n, (dropped, n)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_tp_moe_collectives_are_what_the_spec_tree_implies(runs, name):
    """One (1, 2) step under remat "full", by group, ≡
    ``roofline/analysis.reckon_collectives``: besides the dense layers'
    sums, MLA's ``w_dkv``, ``w_kpe`` and ``kv_norm`` gradients, the
    expert FFN's partial outputs all-reduced (deepseek) or its experts'
    outputs all-gathered (jamba, kimi-k2) in the forward and the
    recompute, and the expert buffer's gradient all-reduced."""
    from repro_torch.roofline import analysis
    rec = runs[0][2][f"tp12_{name}"]["collectives"]
    cfg = dataclasses.replace(_cfg(name), remat="full")
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    want = analysis.reckon_collectives(model, 1, 2, 1, BATCH, SEQ)
    assert rec["by_group"] == want
    ops = {"all-gather": "c10d._allgather_base_",
           "reduce-scatter": "c10d._reduce_scatter_base_",
           "all-reduce": "c10d.allreduce_"}
    total = {}
    for g in want.values():
        for op, n in g["counts"].items():
            total[ops[op]] = total.get(ops[op], 0) + n
    assert rec["counts"] == total
    model_ops = want["model"]["counts"]
    assert ("all-gather" in model_ops) == (name != "deepseek"), model_ops


@pytest.mark.parametrize("arch,over,shape,bad", [
    (DS, {}, (4, 1), None),
    (DS, dict(moe_d_ff=1410), (1, 4), "moe_d_ff 1410 over 'model' 4"),
    (DS, dict(n_experts=96), (64, 1), "n_experts 96 over 'data' 64"),
    ("jamba-v0.1-52b", {}, (1, 8), None),
    ("jamba-v0.1-52b", dict(n_experts=12), (1, 8),
     "n_experts 12 over 'model' 8"),
    ("jamba-v0.1-52b", dict(moe_d_ff=1000), (16, 1),
     "moe_d_ff 1000 over 'data' 16"),
    ("jamba-v0.1-52b", dict(n_shared_experts=1, moe_d_ff=1004), (1, 8),
     "the shared experts' d_ff 1004 over 'model' 8"),
    ("kimi-k2-1t-a32b", dict(), (256, 1), "n_experts 384 over 'data' 256")])
def test_check_divides_expert_dims(arch, over, shape, bad):
    """``launch/mesh.check_divides`` on the expert dims where
    ``expert_axes`` puts them: deepseek-v2-lite-16b's 64 experts over
    "fsdp", its ``moe_d_ff`` 1,408 (352 a rank of 4), shared 2,816 (704),
    16 heads and ``d_ff`` 10,944 (2,736) over "model"; jamba's 16 experts
    over "tp" and its ``moe_d_ff`` over "fsdp"; kimi-k2's 384 experts over
    "fsdp"."""
    cfg = dataclasses.replace(TARCHS[arch], **over)
    mesh = tmesh.Mesh(shape, ("data", "model"))
    if bad is None:
        tmesh.check_divides(cfg, mesh)
    else:
        with pytest.raises(ValueError, match=bad.replace("'", ".")):
            tmesh.check_divides(cfg, mesh)


def test_deepseek_dims_split_over_four_model_ranks():
    """The reckoning of the four-card run, from the config's own numbers:
    every dim deepseek-v2-lite-16b splits over "model" divides by 4."""
    cfg = TARCHS[DS]
    assert (cfg.moe_d_ff, cfg.moe_d_ff * cfg.n_shared_experts, cfg.n_heads,
            cfg.d_ff, cfg.n_experts) == (1408, 2816, 16, 10944, 64)
    assert tmoe.expert_axes(cfg) == ("fsdp", "tp")
    assert all(n % 4 == 0 for n in (1408, 2816, 16, 10944))
    tmesh.check_divides(cfg, tmesh.Mesh((1, 4), ("data", "model")))
