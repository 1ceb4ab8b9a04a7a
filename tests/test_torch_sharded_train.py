"""The LM's sharded runtime on gloo ranks on the CPU: FSDP training over a
(W, 1) ("data", "model") ``DeviceMesh`` ≡ the JAX reference's
``make_train_step``, and ≡ the port's one-device step bit for bit at
W = 1.

The ranks run in one subprocess per world size (4, then 2, then 1: the
later ones restore the W = 4 checkpoint), each with a timeout, through the
launcher's ``spawn_ranks`` and ``rank_cases.run_train_case``; the
reference is computed in this process, from weights both packages start
from (the reference's checkpoint at step 0, restored onto each mesh). It
shows:

* W = 2 and W = 4 on the reduced qwen3-14b and yi-6b: loss, grad_norm and
  lr of 3 steps ≡ the reference's at ``test_torch_train.py``'s tolerances,
  params within 1e-3; a microbatched and a bf16-gradient-sync case;
* W = 1 ≡ the port's unsharded step bit for bit, and ``launch/train.run``
  on a mesh ≡ the unsharded run (bit for bit at W = 1), logging on rank 0
  only;
* each rank's init block ≡ the slice of the one-device init, bit for bit;
  ``Mesh.shard_shape`` ≡ the DTensor local shapes;
* the reduced encoder-decoder and mamba2 on W = 2 ≡ the reference;
* checkpoints: saved on W = 4, continued on W = 4 bit for bit, on W = 2
  and W = 1 within the tolerances; readable by the reference's
  ``checkpoint.restore``;
* an MoE config over 2 ranks and a "model" axis of 2 raise naming 15c;
* ``hint`` is ``x`` itself without axes or on a plain tensor, and gives
  ``resolve_spec``'s placements on a DTensor; the port calls it in the
  functions where the reference does;
* the collectives of one W = 2 step under remat (``CommDebugMode``) ≡
  what the spec tree implies, count and wire bytes.
"""

import ast
import dataclasses
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.data import DataConfig as TDataConfig  # noqa: E402
from repro_torch.data import batch_at as tbatch_at  # noqa: E402
from repro_torch.data import rank_batch_at  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.train import AdamWConfig, init_state  # noqa: E402
from repro_torch.train import make_train_step as tmake_train_step  # noqa
from repro_torch.train import checkpoint as tckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL, RTOL = 1e-5, 1e-4
OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)
STEPS, BATCH, SEQ = 3, 4, 16
REF_ARCHS = ("qwen3-14b", "yi-6b", "seamless-m4t-large-v2", "mamba2-370m")
RUN_JOB = dict(steps=3, seq_len=16, global_batch=4, lr=1e-2, warmup=2,
               log_every=1)


@pytest.fixture(scope="module", autouse=True)
def _single_thread():
    """One torch thread for the module (as every rank runs)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import types

    import jax
    from repro.configs import ARCHS
    from repro.data import DataConfig, batch_at
    from repro.models import build_model, reduced_config
    from repro.train import AdamWConfig as JAdamW
    from repro.train import checkpoint, make_train_step, optimizer
    return types.SimpleNamespace(
        jax=jax, ARCHS=ARCHS, DataConfig=DataConfig, batch_at=batch_at,
        build_model=build_model, reduced_config=reduced_config,
        AdamWConfig=JAdamW, make_train_step=make_train_step,
        optimizer=optimizer, checkpoint=checkpoint)


def _data(cfg):
    return dict(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH,
                seed=1234, frontend_tokens=cfg.frontend_tokens,
                d_model=cfg.d_model)


@pytest.fixture(scope="module")
def ref(jx, tmp_path_factory):
    """Per config: the reference's reduced model, its weights, the
    directory of its step-0 checkpoint ``{"params", "opt"}``, and its
    3-step runs ({variant: (metrics, final params)})."""
    d = tmp_path_factory.mktemp("ref")
    out = {}
    jc = jx.AdamWConfig(**OPT)
    for name in REF_ARCHS:
        jm = jx.build_model(jx.reduced_config(jx.ARCHS[name]))
        jp = jm.init_params(jx.jax.random.PRNGKey(0))
        ck = d / name
        jx.checkpoint.save(str(ck), 0, {
            "params": jp, "opt": jx.optimizer.init_state(jc, jp)})
        variants = {"plain": {}}
        if name == "qwen3-14b":
            variants["micro"] = {"n_microbatches": 2}
        runs = {v: _run3(jx, jm, jp, jc,
                         jx.jax.jit(jx.make_train_step(jm, jc, **kw)))
                for v, kw in variants.items()}
        if name == "qwen3-14b":
            runs["bf16_dp2"] = _run3(jx, jm, jp, jc, jx.jax.jit(
                _dp_bf16_step(jx, jm, jc, 2)))
        out[name] = dict(model=jm, params=jp, dir=str(ck), runs=runs)
    return out


def _run3(jx, jm, jp, jc, step):
    """(metrics of 3 steps, final params) of a jitted reference step."""
    p, st, mets = jp, jx.optimizer.init_state(jc, jp), []
    for i in range(STEPS):
        p, st, m = step(p, st, jx.batch_at(jx.DataConfig(**_data(jm.cfg)),
                                           i))
        mets.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    return mets, jx.jax.tree.map(np.asarray, p)


def _dp_bf16_step(jx, jm, jc, world):
    """The reference's bf16 gradient sync as it acts over ``world``
    data-parallel ranks: each rank's gradient of its rows cast to bf16,
    the casts summed in bf16 and divided by ``world``, the loss the mean
    of the ranks' (the reference's ``make_train_step`` casts the whole
    batch's gradient on one device: a different rounding, by up to a bf16
    ulp of each partial sum)."""
    import jax.numpy as jnp
    grad_fn = jx.jax.value_and_grad(jm.train_loss, has_aux=True)

    def step(params, state, batch):
        rows = BATCH // world
        loss, grads = 0.0, None
        for r in range(world):
            part = jx.jax.tree.map(lambda x: x[r * rows:(r + 1) * rows],
                                   batch)
            (l_r, _), g = grad_fn(params, part)
            g = jx.jax.tree.map(lambda x: x.astype(jnp.bfloat16), g)
            grads = g if grads is None else jx.jax.tree.map(jnp.add, grads,
                                                            g)
            loss = loss + l_r
        grads = jx.jax.tree.map(lambda x: x / world, grads)
        params, state, om = jx.optimizer.apply_updates(jc, params, grads,
                                                       state)
        return params, state, {"loss": loss / world, **om}
    return step


def _case(name, arch, ref, **kw):
    return dict(dict(name=name, arch=arch, steps=STEPS, batch=BATCH,
                     seq=SEQ, opt=OPT, init=ref[arch]["dir"]), **kw)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """{world: {case name: rank 0's record}} for W = 4, 2, 1 (in that
    order), and the checkpoint directories."""
    d = tmp_path_factory.mktemp("sharded")
    dirs = {k: str(d / k) for k in ("w4_qwen3", "ck4", "ck4_same",
                                    "ck2_from4", "ck1_from4", "w1_qwen3")}
    q = "qwen3-14b"
    shards = dict(arch=q, steps=0, init_shards=True, shapes=True)
    plans = {
        4: [_case("qwen3", q, ref, save=dirs["w4_qwen3"], count=True),
            _case("yi", "yi-6b", ref),
            _case("qwen3_ck", q, ref, steps=2, save=dirs["ck4"]),
            dict(name="qwen3_ck_same", arch=q, steps=STEPS, opt=OPT,
                 restore=dirs["ck4"], save=dirs["ck4_same"]),
            dict(shards, name="shards"),
            dict(name="run", arch=q, run=RUN_JOB)],
        2: [_case("qwen3", q, ref),
            _case("yi", "yi-6b", ref),
            _case("qwen3_micro", q, ref, micro=2),
            _case("qwen3_bf16", q, ref, sync="bfloat16"),
            _case("seamless", "seamless-m4t-large-v2", ref),
            _case("mamba2", "mamba2-370m", ref),
            _case("qwen3_remat", q, ref, remat="full", count=True),
            dict(name="qwen3_from4", arch=q, steps=STEPS, opt=OPT,
                 restore=dirs["ck4"], save=dirs["ck2_from4"]),
            dict(name="moe", arch="deepseek-v2-lite-16b", steps=0,
                 raises=True),
            dict(name="tp", arch=q, steps=0, mesh=(1, 2), raises=True),
            dict(name="mask", arch=q, steps=1, mask=True, raises=True),
            dict(shards, name="shards"),
            dict(name="run", arch=q, run=RUN_JOB)],
        1: [_case("qwen3", q, ref, save=dirs["w1_qwen3"], count=True),
            dict(name="qwen3_from4", arch=q, steps=STEPS, opt=OPT,
                 restore=dirs["ck4"], save=dirs["ck1_from4"]),
            dict(name="run", arch=q, run=RUN_JOB)],
    }
    out = {}
    for world, cases in plans.items():
        recs = rank_cases.launch_train(cases, world, d / f"w{world}")
        out[world] = {r["name"]: r for r in recs}
    return out, dirs, d


def _close(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{what} step {i + 1} {k}")


def _arrays(ckpt_dir, step):
    with np.load(Path(ckpt_dir) / f"step_{step:09d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def _params_of(ckpt_dir, step):
    man = tckpt.load_manifest(ckpt_dir, step)["leaves"]
    out = {}
    for k, v in _arrays(ckpt_dir, step).items():
        if k.startswith("params/"):
            if man[k]["dtype"] == "bfloat16":
                v = (v.astype(np.uint32) << 16).view(np.float32)
            out[k[len("params/"):]] = v
    return out


def _flat_np(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np(tree[k], path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


def _max_diff(got, want):
    assert set(got) == set(want)
    return max(float(np.abs(got[k] - want[k]).max()) for k in want)


@pytest.mark.parametrize("world", [4, 2])
@pytest.mark.parametrize("case,arch,variant", [
    ("qwen3", "qwen3-14b", "plain"), ("yi", "yi-6b", "plain")])
def test_sharded_steps_match_reference(runs, ref, world, case, arch,
                                       variant):
    recs, _, _ = runs
    mets, _ = ref[arch]["runs"][variant]
    _close(recs[world][case]["metrics"], mets, f"W={world} {case}")


def test_sharded_params_after_three_steps_match_reference(runs, ref):
    """The W = 4 run's saved params (the reference's global layout) against
    the reference's after 3 steps: AdamW may move an element whose |g| is
    near eps by up to lr on rounding alone, so 1e-3 at lr 1e-2, as
    ``test_torch_train.py`` holds the one-device step."""
    _, dirs, _ = runs
    got = _params_of(dirs["w4_qwen3"], STEPS)
    want = _flat_np(ref["qwen3-14b"]["runs"]["plain"][1])
    assert _max_diff(got, want) < 1e-3


@pytest.mark.parametrize("case,variant", [("qwen3_micro", "micro"),
                                          ("qwen3_bf16", "bf16_dp2"),
                                          ("qwen3_remat", "plain")])
def test_sharded_variants_match_reference(runs, ref, case, variant):
    """W = 2: two microbatches of each rank's rows against the reference's
    two microbatches of the global batch; bf16 gradients cast before the
    reduce-scatter against the reference's bf16 cast of each rank's
    gradient, summed in bf16 (``_dp_bf16_step``); remat "full" (gathers
    inside the checkpointed block) against the reference."""
    recs, _, _ = runs
    _close(recs[2][case]["metrics"], ref["qwen3-14b"]["runs"][variant][0],
           f"W=2 {case}")


@pytest.mark.parametrize("case,arch", [
    ("seamless", "seamless-m4t-large-v2"), ("mamba2", "mamba2-370m")])
def test_encdec_and_ssm_sharded_match_reference(runs, ref, case, arch):
    recs, _, _ = runs
    _close(recs[2][case]["metrics"], ref[arch]["runs"]["plain"][0],
           f"W=2 {case}")


def _port_unsharded(ref, arch="qwen3-14b"):
    """The port's one-device run of the same weights and batches."""
    cfg = treduced(TARCHS[arch])
    m = tbuild(cfg, attn_impl="sdpa", device="cpu")
    p = convert.params_from_numpy(_flat_tree(ref[arch]["params"]), "cpu")
    oc = AdamWConfig(**OPT)
    st, step, mets = init_state(oc, p), tmake_train_step(m, oc), []
    for i in range(STEPS):
        p, st, met = step(p, st, tbatch_at(TDataConfig(**_data(cfg)), i,
                                           device="cpu"))
        mets.append({k: float(met[k]) for k in ("loss", "grad_norm", "lr")})
    return mets, p


def _flat_tree(jp):
    import jax
    return jax.tree.map(np.asarray, jp)


def test_one_rank_equals_the_unsharded_step_bit_for_bit(runs, ref):
    recs, dirs, _ = runs
    mets, p = _port_unsharded(ref)
    assert recs[1]["qwen3"]["metrics"] == mets
    got = _params_of(dirs["w1_qwen3"], STEPS)
    want = {k: v.detach().numpy() for k, v in
            _flat_np_t(p).items()}
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


def _flat_np_t(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np_t(tree[k], path + (k,)))
        return out
    return {"/".join(path): tree}


@pytest.mark.parametrize("world", [4, 2, 1])
def test_train_run_on_a_mesh_matches_the_unsharded_run(runs, world):
    """``launch/train.run(job, mesh)`` ≡ ``run(job)`` (bit for bit at
    W = 1, at the tolerances otherwise); only rank 0 logs."""
    recs, _, _ = runs
    cfg = treduced(TARCHS["qwen3-14b"])
    want = ttrain.run(ttrain.TrainJob(arch=cfg, **RUN_JOB), device="cpu",
                      log=lambda *a: None)["losses"]
    rec = recs[world]["run"]
    assert rec["log_lines"] == [STEPS] + [0] * (world - 1)
    if world == 1:
        assert rec["losses"] == want
    else:
        np.testing.assert_allclose(rec["losses"], want, atol=ATOL,
                                   rtol=RTOL)


@pytest.mark.parametrize("world", [4, 2])
def test_init_blocks_are_slices_of_the_one_device_init(runs, world):
    """Each rank's block of every leaf ≡ the slice of the one-device
    seed-0 init, bit for bit, and ``Mesh.shard_shape`` ≡ its shape."""
    recs, _, d = runs
    cfg = treduced(TARCHS["qwen3-14b"])
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    whole = _flat_np_t(model.init_params(
        torch.Generator(device="cpu").manual_seed(0)))
    axes = tlayers.MeshAxes(fsdp=("data",))
    mesh = tmesh.Mesh((world, 1), ("data", "model"))
    specs = {k: tlayers.resolve_spec(info.spec, axes)
             for k, info in model.ps.infos.items()}
    shapes = recs[world]["shards"]["local_shapes"]
    for r in range(world):
        with np.load(d / f"w{world}" / f"shards_r{r}.npz") as z:
            for k, full in whole.items():
                spec = specs[k]
                idx = tuple(slice(r * (n // world), (r + 1) * (n // world))
                            if e == "data" else slice(None)
                            for n, e in zip(full.shape, spec))
                assert z[k].tobytes() == full[idx].numpy().tobytes(), (r, k)
    for k, full in whole.items():
        assert tuple(shapes[k]) == mesh.shard_shape(full.shape, specs[k]), k


@pytest.mark.parametrize("world", [4, 2])
def test_uneven_dim_ceiling_and_refusal(runs, world):
    """An uneven dim: ``shard_shape`` takes the ceiling (GSPMD's padding),
    where DTensor would split like ``torch.chunk``; ``launch/mesh.shard``
    refuses to make such blocks (9 rows over W ranks)."""
    mesh = tmesh.Mesh((world, 1), ("data", "model"))
    assert mesh.shard_shape((9, 8), ("data", None)) == (-(-9 // world), 8)
    assert runs[0][world]["shards"]["uneven"][0] == "ValueError"


def test_checkpoint_on_four_ranks_continues_bit_for_bit_on_four(runs):
    recs, dirs, _ = runs
    full, resumed = recs[4]["qwen3"], recs[4]["qwen3_ck_same"]
    assert resumed["metrics"] == full["metrics"][2:]
    want, got = _arrays(dirs["w4_qwen3"], STEPS), _arrays(dirs["ck4_same"],
                                                           STEPS)
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("world", [2, 1])
def test_checkpoint_of_four_ranks_continues_on_fewer(runs, world):
    recs, dirs, _ = runs
    want = recs[4]["qwen3"]["metrics"][2:]
    _close(recs[world]["qwen3_from4"]["metrics"], want,
           f"W=4 → W={world}")
    got = _params_of(dirs[f"ck{world}_from4"], STEPS)
    assert _max_diff(got, _params_of(dirs["w4_qwen3"], STEPS)) < 1e-3


def test_reference_restores_the_sharded_checkpoint(runs, ref, jx):
    """The W = 4 checkpoint is the reference's format: its restore reads
    it, and its params after 2 steps are the reference's within 1e-3."""
    _, dirs, _ = runs
    jm, jp = ref["qwen3-14b"]["model"], ref["qwen3-14b"]["params"]
    jc = jx.AdamWConfig(**OPT)
    like = {"params": jp, "opt": jx.optimizer.init_state(jc, jp)}
    got = jx.checkpoint.restore(dirs["ck4"], 2, like)
    assert int(got["opt"]["step"]) == 2
    step = jx.jax.jit(jx.make_train_step(jm, jc))
    p, st = jp, like["opt"]
    for i in range(2):
        p, st, _ = step(p, st, jx.batch_at(jx.DataConfig(**_data(jm.cfg)),
                                           i))
    assert _max_diff(_flat_np(jx.jax.tree.map(np.asarray, got["params"])),
                     _flat_np(jx.jax.tree.map(np.asarray, p))) < 1e-3


@pytest.mark.parametrize("case,pattern", [("moe", "MoE.*15c"),
                                          ("tp", "model.*15c")])
def test_moe_and_model_axis_raise_naming_15c(runs, case, pattern):
    import re
    rec = runs[0][2][case]
    assert rec["raised"][0] == "NotImplementedError"
    assert re.search(pattern, rec["raised"][1]), rec["raised"]


def test_model_axis_raises_before_any_group():
    with pytest.raises(NotImplementedError, match="15c"):
        tmesh.make_device_mesh(tmesh.Mesh((1, 2), ("data", "model")), "cpu")


def test_sharded_step_refuses_a_loss_mask(runs):
    """Trap 2: the mean of the ranks' masked means is not the global
    masked mean, so a masked batch over 2 ranks raises."""
    rec = runs[0][2]["mask"]
    assert rec["raised"][0] == "NotImplementedError"
    assert "loss_mask" in rec["raised"][1]


def test_hint_is_an_identity_without_axes_and_on_plain_tensors():
    x = torch.ones(2, 3, 4)
    assert tlayers.hint(x, "batch", None, "tp") is x
    tlayers.set_hint_axes(tlayers.MeshAxes(fsdp=("data",)))
    try:
        assert tlayers.hint(x, "batch", None, "tp") is x
    finally:
        tlayers.set_hint_axes(None)


@pytest.mark.parametrize("world", [4, 2])
def test_hint_gives_resolve_spec_placements_on_a_dtensor(runs, world):
    """On a (W, 1) mesh a DTensor sharded along dim 0 and hinted (None,
    None, "fsdp") comes back ``Shard(2)`` on "data" (the ones of a (2, 3,
    8) tensor: 8 / W along dim 2)."""
    rec = runs[0][world]["shards"]
    assert rec["hint"][0] == "S(2)" and rec["hint"][1] == "R", rec["hint"]
    assert rec["hint_local"] == [2 * world, 3, 8 // world]


def _hint_sites(path):
    tree = ast.parse(Path(path).read_text())
    out = set()

    def visit(node, scope):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                visit(child, scope + (child.name,))
            else:
                if isinstance(child, ast.Call) and getattr(
                        child.func, "id", None) == "hint":
                    out.add(".".join(scope))
                visit(child, scope)
    visit(tree, ())
    return out


@pytest.mark.parametrize("module", ["layers", "attention", "moe", "ssm",
                                    "lm", "encdec"])
def test_port_calls_hint_where_the_reference_does(module):
    ref = _hint_sites(ROOT / "src" / "repro" / "models" / f"{module}.py")
    port = _hint_sites(ROOT / "src" / "repro_torch" / "models" /
                       f"{module}.py")
    assert port == ref, (module, port, ref)


def test_collectives_of_a_step_are_what_the_spec_tree_implies(runs):
    """One W = 2 step of the reduced qwen3 under remat "full": every
    stacked leaf sharded on "data" is gathered in the forward and again in
    the recompute and reduce-scattered once a block, a top-level one
    gathered and reduce-scattered once; a replicated leaf's gradient is
    all-reduced once a block (or once), and the loss and the global
    norm's per-leaf sums once each. Wire bytes by the ring model at
    n = 2 (f32 throughout)."""
    rec = runs[0][2]["qwen3_remat"]["collectives"]
    cfg = dataclasses.replace(treduced(TARCHS["qwen3-14b"]), remat="full")
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    axes = tlayers.MeshAxes(fsdp=("data",))
    nb = model.n_blocks
    gathers = scatters = reduces = 0
    gather_b = scatter_b = reduce_b = 0
    for path, info in model.ps.infos.items():
        stacked = path.startswith("blocks/")
        n = nb if stacked else 1
        one = math.prod(info.shape[1:] if stacked else info.shape) * 4
        if "data" in tlayers.resolve_spec(info.spec, axes):
            fwd = 2 if stacked else 1            # the recompute gathers
            gathers += fwd * n
            gather_b += fwd * n * one
            scatters += n
            scatter_b += n * one
        else:
            reduces += n
            reduce_b += n * one
    reduces += 2                                  # loss, global norm sums
    reduce_b += 4 + 4 * len(model.ps.infos)
    assert rec["counts"] == {"c10d._allgather_base_": gathers,
                             "c10d._reduce_scatter_base_": scatters,
                             "c10d.allreduce_": reduces}
    assert rec["payload_bytes"] == {"all-gather": gather_b,
                                    "reduce-scatter": scatter_b,
                                    "all-reduce": reduce_b}
    assert rec["wire_bytes"] == {"all-gather": gather_b / 2,
                                 "reduce-scatter": scatter_b / 2,
                                 "all-reduce": float(reduce_b)}


def test_one_rank_step_has_the_same_collectives_and_no_wire(runs):
    recs = runs[0]
    w1, w4 = recs[1]["qwen3"]["collectives"], recs[4]["qwen3"]["collectives"]
    assert w1["counts"] == w4["counts"]
    assert set(w1["wire_bytes"].values()) == {0.0}
    assert all(v > 0 for v in w4["wire_bytes"].values())


def test_rank_batches_split_the_global_batch():
    cfg = TDataConfig(vocab_size=512, seq_len=8, global_batch=4, seed=3,
                      frontend_tokens=2, d_model=4)
    whole = tbatch_at(cfg, 5, device="cpu")
    for w in (1, 2, 4):
        parts = [rank_batch_at(cfg, 5, r, w, device="cpu") for r in range(w)]
        for k in whole:
            assert torch.equal(torch.cat([p[k] for p in parts]), whole[k])
    with pytest.raises(ValueError):
        rank_batch_at(cfg, 5, 0, 3, device="cpu")


@pytest.mark.cuda
def test_embedding_gradient_sums_a_tokens_rows_in_f32_on_the_card():
    """The LM's token lookup (``lm.embed_rows``) on a bf16 table: the
    gradient of 4,096 lookups of a few tokens is the f32 sum of the rows,
    rounded once (advanced indexing's backward rounds after every row and
    loses the small addends, so the sum would depend on how many rows a
    rank holds)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.models import lm
    g = torch.Generator(device="cuda").manual_seed(0)
    table = (torch.randn(64, 32, device="cuda", generator=g) * 0.02).to(
        torch.bfloat16).requires_grad_(True)
    tokens = torch.zeros(4096, dtype=torch.int32, device="cuda")
    tokens[::7] = 3
    up = (torch.randn(4096, 32, device="cuda", generator=g) * 1e-3).to(
        torch.bfloat16)
    (got,) = torch.autograd.grad(lm.embed_rows(table, tokens), [table], up)
    want = torch.zeros(64, 32, device="cuda").index_add_(
        0, tokens.long(), up.float())
    # one rounding of the f32 sum: within a bf16 ulp of it
    assert bool(((got.float() - want).abs() <= 2 ** -8 * want.abs()).all())
