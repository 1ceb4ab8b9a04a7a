"""The LM's sharded runtime on gloo ranks on the CPU: FSDP training over a
(W, 1) ("data", "model") ``DeviceMesh`` and FSDP × tensor parallelism over
(1, 2) and (2, 2) meshes ≡ the JAX reference's ``make_train_step``, and ≡
the port's one-device step bit for bit at W = 1.

The ranks run in one subprocess per world size (4, then 2, then 1: the
later ones restore the W = 4 checkpoint), each with a timeout, through the
launcher's ``spawn_ranks`` and ``rank_cases.run_train_case``; the
reference is computed in this process, from weights both packages start
from (the reference's checkpoint at step 0, restored onto each mesh). It
shows:

* W = 2 and W = 4 on the reduced qwen3-14b and yi-6b: loss, grad_norm and
  lr of 3 steps ≡ the reference's at ``test_torch_train.py``'s tolerances,
  params within 1e-3; a microbatched and a bf16-gradient-sync case (the
  sync also against the reference's own step jitted over 2 host devices,
  in a subprocess);
* tensor parallelism on (1, 2) (in the W = 2 subprocess) and (2, 2) (in
  the W = 4 one) for the reduced qwen3-14b (qk-norm), qwen2-1.5b (tied
  embeddings, qkv bias), yi-6b, phi-3-vision (frontend tokens),
  seamless-m4t-large-v2 (both stacks, the cross-attention) and mamba2
  (8 SSM heads over a fused ``w_in`` of 296 columns, tied embeddings):
  the same bounds; the gradient of every leaf on (1, 2), the qk-norm's
  and the SSM's among them, ≡ ``jax.grad`` of the reference; the
  vocab-parallel cross-entropy with padded columns; the (1, 2) and (2, 2)
  init blocks; the collectives of a (2, 2) step by group; checkpoints
  between (2, 2), (4, 1) and (1, 1), and the reference's restore of them;
  an uneven kv-head split and SSM heads that do not divide raise (the
  MoE and MLA configs on a model axis: ``test_torch_tp_moe.py``);
* W = 1 ≡ the port's unsharded step bit for bit, and ``launch/train.run``
  on a mesh ≡ the unsharded run (bit for bit at W = 1), logging on rank 0
  only;
* each rank's init block ≡ the slice of the one-device init, bit for bit;
  ``Mesh.shard_shape`` ≡ the DTensor local shapes;
* the reduced encoder-decoder and mamba2 on W = 2 ≡ the reference;
* checkpoints: saved on W = 4, continued on W = 4 bit for bit, on W = 2
  and W = 1 within the tolerances; readable by the reference's
  ``checkpoint.restore``;
* (the MoE configs and a ``loss_mask`` over data ranks:
  ``test_torch_dp_moe.py``);
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
REF_ARCHS = ("qwen3-14b", "yi-6b", "seamless-m4t-large-v2", "mamba2-370m",
             "qwen2-1.5b", "phi-3-vision-4.2b")
# the tensor-parallel configs: qk-norm, tied embeddings with qkv bias, GQA,
# MHA with frontend tokens, the encoder-decoder, the SSM
TP_ARCHS = ("qwen3-14b", "qwen2-1.5b", "yi-6b", "phi-3-vision-4.2b",
            "seamless-m4t-large-v2", "mamba2-370m")
# the families added after the dense ones: each also has its gradients,
# init blocks, (2, 2) checkpoint and collectives held
TP_FAMILIES = ("seamless-m4t-large-v2", "mamba2-370m")
TP_MESHES = {"tp12": (1, 2), "tp22": (2, 2)}
# a reduced mamba2 of 6 SSM heads (d_inner 192, head dim 32)
SSM_6_HEADS = dict(ssm_expand=3, ssm_head_dim=32)
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
            # the reference's bf16 sync: its compiled program sums the
            # gradient over data-parallel devices in f32 and casts after,
            # so over 2 devices it is its one-device run (held apart by
            # test_bf16_sync_matches_the_reference_over_two_host_devices)
            variants["bf16_dp2"] = {"grad_sync_dtype": "bfloat16"}
        runs = {v: _run3(jx, jm, jp, jc,
                         jx.jax.jit(jx.make_train_step(jm, jc, **kw)))
                for v, kw in variants.items()}
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


def _case(name, arch, ref, **kw):
    return dict(dict(name=name, arch=arch, steps=STEPS, batch=BATCH,
                     seq=SEQ, opt=OPT, init=ref[arch]["dir"]), **kw)


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """{world: {case name: rank 0's record}} for W = 4, 2, 1 (in that
    order), and the checkpoint directories."""
    d = tmp_path_factory.mktemp("sharded")
    dirs = {k: str(d / k) for k in (
        "w4_qwen3", "ck4", "ck4_same", "ck2_from4", "ck1_from4", "w1_qwen3",
        "tp22_ck", "tp22_ck_same", "ck41_from22", "ck11_from22",
        "tp22_from41")}
    dirs.update({f"{m}_{a}": str(d / f"{m}_{a}") for m in TP_MESHES
                 for a in TP_ARCHS})
    dirs.update({f"{k}_{a}": str(d / f"{k}_{a}") for a in TP_FAMILIES
                 for k in ("tp22_ck", "tp22_ck_same", "ck41_from22")})
    q = "qwen3-14b"
    shards = dict(arch=q, steps=0, init_shards=True, shapes=True)
    tp = {m: [_case(f"{m}_{a}", a, ref, mesh=shape, save=dirs[f"{m}_{a}"])
              for a in TP_ARCHS] for m, shape in TP_MESHES.items()}
    # the (2, 2) steps of qwen3 and the families under remat "full", their
    # collectives counted
    for c in tp["tp22"]:
        if c["arch"] in (q,) + TP_FAMILIES:
            c.update(remat="full", count=True)
    ck22 = dict(arch=q, opt=OPT, remat="full", steps=STEPS)
    # each family's (2, 2) checkpoint at step 2, resumed on (2, 2) and
    # (4, 1)
    fam_ck = []
    for a in TP_FAMILIES:
        fck = dict(arch=a, opt=OPT, remat="full", steps=STEPS,
                   restore=dirs[f"tp22_ck_{a}"])
        fam_ck += [
            _case(f"tp22_ck_{a}", a, ref, mesh=(2, 2), remat="full",
                  steps=2, save=dirs[f"tp22_ck_{a}"]),
            dict(fck, name=f"tp22_ck_same_{a}", mesh=(2, 2),
                 save=dirs[f"tp22_ck_same_{a}"]),
            dict(fck, name=f"ck41_from22_{a}",
                 save=dirs[f"ck41_from22_{a}"])]
    plans = {
        4: [_case("qwen3", q, ref, save=dirs["w4_qwen3"], count=True),
            _case("yi", "yi-6b", ref),
            _case("qwen3_ck", q, ref, steps=2, save=dirs["ck4"]),
            dict(name="qwen3_ck_same", arch=q, steps=STEPS, opt=OPT,
                 restore=dirs["ck4"], save=dirs["ck4_same"]),
            dict(shards, name="shards"),
            dict(name="run", arch=q, run=RUN_JOB),
            *tp["tp22"],
            _case("tp22_ck", q, ref, mesh=(2, 2), remat="full", steps=2,
                  save=dirs["tp22_ck"]),
            dict(ck22, name="tp22_ck_same", mesh=(2, 2),
                 restore=dirs["tp22_ck"], save=dirs["tp22_ck_same"]),
            dict(ck22, name="ck41_from22", restore=dirs["tp22_ck"],
                 save=dirs["ck41_from22"]),
            dict(ck22, name="tp22_from41", mesh=(2, 2), restore=dirs["ck4"],
                 save=dirs["tp22_from41"]),
            dict(name="shards_tp22", arch=q, steps=0, init_shards=True,
                 mesh=(2, 2)),
            dict(name="kv_uneven", arch=q, steps=0, mesh=(1, 4),
                 raises=True),
            *fam_ck,
            *[dict(name=f"shards_tp22_{a}", arch=a, steps=0,
                   init_shards=True, mesh=(2, 2)) for a in TP_FAMILIES],
            dict(name="ssm_uneven", arch="mamba2-370m", steps=0,
                 mesh=(1, 4), cfg=SSM_6_HEADS, raises=True),
            dict(name="run_tp22", arch=q, run=RUN_JOB, mesh=(2, 2))],
        2: [_case("qwen3", q, ref),
            _case("yi", "yi-6b", ref),
            _case("qwen3_micro", q, ref, micro=2),
            _case("qwen3_bf16", q, ref, sync="bfloat16"),
            _case("seamless", "seamless-m4t-large-v2", ref),
            _case("mamba2", "mamba2-370m", ref),
            _case("qwen3_remat", q, ref, remat="full", count=True),
            dict(name="qwen3_from4", arch=q, steps=STEPS, opt=OPT,
                 restore=dirs["ck4"], save=dirs["ck2_from4"]),
            dict(shards, name="shards"),
            dict(name="run", arch=q, run=RUN_JOB),
            *tp["tp12"],
            _case("tp12_grads", q, ref, mesh=(1, 2), steps=0, grads=True),
            dict(name="tp12_ce", arch=q, steps=0, mesh=(1, 2), ce=True),
            dict(name="shards_tp12", arch=q, steps=0, init_shards=True,
                 mesh=(1, 2)),
            *[_case(f"tp12_grads_{a}", a, ref, mesh=(1, 2), steps=0,
                    grads=True) for a in TP_FAMILIES],
            *[dict(name=f"shards_tp12_{a}", arch=a, steps=0,
                   init_shards=True, mesh=(1, 2)) for a in TP_FAMILIES],
            dict(name="run_tp12", arch=q, run=RUN_JOB, mesh=(1, 2))],
        1: [_case("qwen3", q, ref, save=dirs["w1_qwen3"], count=True),
            dict(name="qwen3_from4", arch=q, steps=STEPS, opt=OPT,
                 restore=dirs["ck4"], save=dirs["ck1_from4"]),
            dict(name="run", arch=q, run=RUN_JOB),
            dict(ck22, name="ck11_from22", restore=dirs["tp22_ck"],
                 save=dirs["ck11_from22"])],
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
    two microbatches of the global batch; the bf16 gradient sync (the
    gradients summed over the ranks, then cast) against the reference's
    ``make_train_step(grad_sync_dtype="bfloat16")``; remat "full" (gathers
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


@pytest.mark.parametrize("world,case", [
    (4, "qwen3"), (4, "tp22_qwen3-14b"), (4, "tp22_ck"), (2, "qwen3_from4"),
    (2, "tp12_qwen2-1.5b"), (1, "qwen3")])
def test_checkpoint_save_gathers_only_over_axes_of_more_than_one_rank(
        runs, world, case):
    """Rank 0 gathers a leaf once over each mesh axis of more than one rank
    that it is sharded over: on (W, 1) never over the model axis, on
    (1, 1) never at all."""
    rec = runs[0][world][case]
    assert rec["save_gathers"] == rec["save_gathers_expected"]
    if world == 1:
        assert rec["save_gathers"] == 0


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


def test_model_axis_raises_before_any_group():
    """A (1, 2) mesh is made (the "model" axis is no longer refused), but
    not without a process group."""
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_device_mesh(tmesh.Mesh((1, 2), ("data", "model")), "cpu")


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


# ---------------------------------------------------------------------------
# Tensor parallelism over the "model" axis: (1, 2) in the W = 2 subprocess,
# (2, 2) in the W = 4 one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mesh", list(TP_MESHES))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_steps_match_reference(runs, ref, mesh, arch):
    """Loss, grad_norm and lr of 3 steps on a (1, 2) and a (2, 2) mesh ≡
    the reference's single-device ``make_train_step`` from the same
    weights (its step-0 checkpoint) and batches."""
    world = math.prod(TP_MESHES[mesh])
    _close(runs[0][world][f"{mesh}_{arch}"]["metrics"],
           ref[arch]["runs"]["plain"][0], f"{mesh} {arch}")


@pytest.mark.parametrize("mesh", list(TP_MESHES))
@pytest.mark.parametrize("arch", TP_ARCHS)
def test_tensor_parallel_params_match_reference(runs, ref, mesh, arch):
    """The params after 3 tensor-parallel steps (saved in the reference's
    global layout) within 1e-3 of the reference's, as the FSDP run's."""
    _, dirs, _ = runs
    got = _params_of(dirs[f"{mesh}_{arch}"], STEPS)
    assert _max_diff(got, _flat_np(ref[arch]["runs"]["plain"][1])) < 1e-3


def _ref_grads(jx, ref, arch):
    jm, jp = ref[arch]["model"], ref[arch]["params"]
    batch = jx.batch_at(jx.DataConfig(**_data(jm.cfg)), 0)
    grads = jx.jax.grad(lambda p: jm.train_loss(p, batch)[0])(jp)
    return _flat_np(jx.jax.tree.map(np.asarray, grads))


def _tp12_grads(runs, name="tp12_grads"):
    _, _, d = runs
    with np.load(d / "w2" / f"{name}_grads.npz") as z:
        return {k: z[k] for k in z.files}


def test_qk_norm_gradient_matches_reference_on_a_model_axis(runs, ref,
                                                            jx):
    """qwen3's ``q_norm`` / ``k_norm`` act on different heads on each model
    rank, so each rank's gradient is a part: summed over the model ranks
    it ≡ ``jax.grad`` of the reference (1e-5 + 1e-4·|ref|) on a (1, 2)
    mesh."""
    got, want = _tp12_grads(runs), _ref_grads(jx, ref, "qwen3-14b")
    keys = [k for k in want if k.endswith(("q_norm", "k_norm"))]
    assert len(keys) == 2, keys
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


def test_tensor_parallel_gradients_match_reference(runs, ref, jx):
    """The gradient of every leaf of the reduced qwen3 on a (1, 2) mesh,
    made whole (vocab-parallel embedding and head, column- and
    row-parallel projections, norms) ≡ ``jax.grad`` of the reference."""
    got, want = _tp12_grads(runs), _ref_grads(jx, ref, "qwen3-14b")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("masked", ["plain", "masked"])
def test_vocab_parallel_cross_entropy_with_padded_columns(runs, masked):
    """Logits over a vocab of 200 padded to 256, split over 2 model ranks
    (the second holds all 56 padded columns): the vocab-parallel
    cross-entropy ≡ the one-device one on the whole logits, loss and the
    gradient of each rank's columns, with and without a mask."""
    recs = runs[0][2]["tp12_ce"]["ce"][masked]
    assert [r["padded_cols"] for r in recs] == [0, 56]
    assert recs[0]["loss"] == recs[1]["loss"]
    for r in recs:
        assert r["loss_gap"] <= ATOL + RTOL * abs(r["loss"]), r
        assert r["grad_gap"] <= ATOL, r


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_tensor_parallel_init_blocks_are_slices_of_the_one_device_init(
        runs, mesh):
    """Rank r of a (D, T) mesh sits at data coordinate r // T and model
    coordinate r % T; its block of every leaf ≡ the slice of the
    one-device seed-0 init along both axes, bit for bit."""
    _init_blocks_are_slices(runs, mesh, "qwen3-14b", f"shards_{mesh}")


def _init_blocks_are_slices(runs, mesh, arch, name):
    _, _, d = runs
    shape = TP_MESHES[mesh]
    world = math.prod(shape)
    cfg = treduced(TARCHS[arch])
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    whole = _flat_np_t(model.init_params(
        torch.Generator(device="cpu").manual_seed(0)))
    specs = {k: tlayers.resolve_spec(info.spec, tlayers.MeshAxes(
        fsdp=("data",))) for k, info in model.ps.infos.items()}
    for r in range(world):
        at = {"data": r // shape[1], "model": r % shape[1]}
        size = {"data": shape[0], "model": shape[1]}
        with np.load(d / f"w{world}" / f"{name}_r{r}.npz") as z:
            for k, full in whole.items():
                idx = tuple(
                    slice(None) if e is None else
                    slice(at[e] * (n // size[e]), (at[e] + 1) * (n // size[e]))
                    for n, e in zip(full.shape, specs[k]))
                assert z[k].tobytes() == full[idx].numpy().tobytes(), (r, k)


def test_tensor_parallel_collectives_are_what_the_spec_tree_implies(runs):
    """One (2, 2) step of the reduced qwen3 under remat "full", by group,
    ≡ ``roofline/analysis.reckon_collectives``. Data axis (2 ranks): each
    leaf sharded on "data" gathered (its TP block: 1/T of the leaf) in the
    forward and again in the recompute and reduce-scattered, a
    data-replicated one's gradient all-reduced, the loss and the global
    norm's sums all-reduced. Model axis (2 ranks), all all-reduces:
    forward, the embedding's partial rows, the attention's and the MLP's
    row-parallel outputs and the attention's again in the recompute (which
    stops before the MLP's sum, not needed by the backward), the
    cross-entropy's maximum, sum of exponentials and gold logit; backward,
    the gradient into the normed inputs of the attention, the MLP and the
    head, and of ``q_norm`` / ``k_norm``; then the global norm's sums.
    Wire bytes by the ring model over each group's 2 ranks (f32
    throughout). The counts by op are CommDebugMode's."""
    from repro_torch.roofline import analysis
    rec = runs[0][4]["tp22_qwen3-14b"]["collectives"]
    cfg = dataclasses.replace(treduced(TARCHS["qwen3-14b"]), remat="full")
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    want = analysis.reckon_collectives(model, 2, 2, 1, BATCH // 2, SEQ)
    assert rec["by_group"] == want
    # the reckoning spelled out for this config (one block, d 64, S 16,
    # 2 rows, head dim 16, f32): 3 model all-reduces of (2, 16, 64) in
    # the forward and recompute, 3 of (2, 15) in the CE, 3 normed inputs
    # and 2 norm weights in the backward, the lookup's rows, the norm sums
    act, ce = 2 * SEQ * 64 * 4, 2 * (SEQ - 1) * 4
    assert want["model"]["counts"] == {"all-reduce": 1 + 3 + 3 + 3 + 2 + 1}
    assert want["model"]["payload_bytes"] == {"all-reduce": 7 * act + 3 * ce
                                              + 2 * 16 * 4
                                              + 4 * len(model.ps.infos)}
    assert rec["counts"] == {
        "c10d._allgather_base_": want["data"]["counts"]["all-gather"],
        "c10d._reduce_scatter_base_":
            want["data"]["counts"]["reduce-scatter"],
        "c10d.allreduce_": want["data"]["counts"]["all-reduce"]
        + want["model"]["counts"]["all-reduce"]}
    assert rec["wire_bytes"]["all-reduce"] == float(
        want["data"]["payload_bytes"]["all-reduce"]
        + want["model"]["payload_bytes"]["all-reduce"])


def test_tensor_parallel_checkpoint_continues_bit_for_bit_on_its_mesh(
        runs):
    """A (2, 2) checkpoint at step 2, step 3 resumed on (2, 2) ≡ the
    uninterrupted (2, 2) run: its metrics and every array of the step-3
    checkpoint."""
    _resumed_bit_for_bit(runs, "tp22_qwen3-14b", "tp22_ck_same")


def _resumed_bit_for_bit(runs, full_case, resumed_case):
    recs, dirs, _ = runs
    full, resumed = recs[4][full_case], recs[4][resumed_case]
    assert resumed["metrics"] == full["metrics"][2:]
    want = _arrays(dirs[full_case], STEPS)
    got = _arrays(dirs[resumed_case], STEPS)
    assert set(got) == set(want)
    for k in want:
        assert got[k].tobytes() == want[k].tobytes(), k


@pytest.mark.parametrize("case,world,src", [
    ("ck41_from22", 4, "tp22_qwen3-14b"), ("ck11_from22", 1, "tp22_qwen3-14b"),
    ("tp22_from41", 4, "w4_qwen3")])
def test_tensor_parallel_checkpoint_moves_between_meshes(runs, case, world,
                                                         src):
    """A (2, 2) checkpoint at step 2 resumed on (4, 1) and on (1, 1), and
    a (4, 1) one resumed on (2, 2): step 3 within the tolerances of the
    uninterrupted run, params within 1e-3."""
    recs, dirs, _ = runs
    want = (recs[4]["tp22_qwen3-14b"] if src.startswith("tp22")
            else recs[4]["qwen3"])["metrics"][2:]
    _close(recs[world][case]["metrics"], want, case)
    assert _max_diff(_params_of(dirs[case], STEPS),
                     _params_of(dirs[src], STEPS)) < 1e-3


def test_reference_restores_the_tensor_parallel_checkpoint(runs, ref, jx):
    """The (2, 2) checkpoint is the reference's format: its restore reads
    it, and its params after 2 steps are the reference's within 1e-3."""
    _reference_restores(runs, ref, jx, "qwen3-14b", "tp22_ck")


def _reference_restores(runs, ref, jx, arch, ckpt):
    _, dirs, _ = runs
    jm, jp = ref[arch]["model"], ref[arch]["params"]
    jc = jx.AdamWConfig(**OPT)
    like = {"params": jp, "opt": jx.optimizer.init_state(jc, jp)}
    got = jx.checkpoint.restore(dirs[ckpt], 2, like)
    assert int(got["opt"]["step"]) == 2
    step = jx.jax.jit(jx.make_train_step(jm, jc))
    p, st = jp, like["opt"]
    for i in range(2):
        p, st, _ = step(p, st, jx.batch_at(jx.DataConfig(**_data(jm.cfg)),
                                           i))
    assert _max_diff(_flat_np(jx.jax.tree.map(np.asarray, got["params"])),
                     _flat_np(jx.jax.tree.map(np.asarray, p))) < 1e-3


def test_uneven_kv_heads_raise(runs):
    """The reduced qwen3's 2 kv heads over a "model" axis of 4: ValueError
    (a rank takes whole heads; the reference's GSPMD would reshard)."""
    rec = runs[0][4]["kv_uneven"]
    assert rec["raised"][0] == "ValueError", rec
    assert "n_kv_heads 2 over 'model' 4" in rec["raised"][1], rec


@pytest.mark.parametrize("shape,bad", [
    ((2, 8), None), ((16, 16), "n_heads 40 over 'model' 16"),
    ((1, 5), "n_kv_heads 8 over 'model' 5"),
    ((3, 8), "d_model 5120 over 'data' 3")])
def test_check_divides(shape, bad):
    """``launch/mesh.check_divides`` on qwen3-14b (40 heads, 8 kv heads,
    d_ff 17,408, vocab 151,936 padded to 152,064, d_model 5,120)."""
    cfg = TARCHS["qwen3-14b"]
    mesh = tmesh.Mesh(shape, ("data", "model"))
    if bad is None:
        tmesh.check_divides(cfg, mesh)
    else:
        with pytest.raises(ValueError, match=bad.replace("'", ".")):
            tmesh.check_divides(cfg, mesh)


class _NamedMesh:
    """What ``sharding.mesh_dims`` reads of a ``DeviceMesh``."""

    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("shape,names,want", [
    ((2, 2), ("data", "model"), (0, 1)),
    ((4, 1), ("data", "model"), (0, 1)),
    ((1, 4, 2), ("pod", "data", "model"), (1, 2)),
    ((2, 1, 2), ("pod", "data", "model"), (0, 2)),
    ((4,), ("data",), (0, None)),
    ((2, 2, 1), ("pod", "data", "model"), NotImplementedError),
    ((2,), ("model",), ValueError)])
def test_mesh_axes_come_from_the_mesh_names(shape, names, want):
    """The data and model axes are read from the mesh's own names, whatever
    hint axes another caller left installed."""
    from repro_torch.models import sharding
    mesh = _NamedMesh(shape, names)
    tlayers.set_hint_axes(tlayers.MeshAxes(fsdp=("model",), tp="data"))
    try:
        if isinstance(want, tuple):
            assert sharding.mesh_dims(mesh) == want
        else:
            with pytest.raises(want):
                sharding.mesh_dims(mesh)
    finally:
        tlayers.set_hint_axes(None)


@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_train_run_on_a_tensor_parallel_mesh(runs, mesh):
    """``launch/train.run(job, mesh)`` on (1, 2) and (2, 2) ≡ the
    unsharded run within the tolerances; only global rank 0 logs."""
    world = math.prod(TP_MESHES[mesh])
    cfg = treduced(TARCHS["qwen3-14b"])
    want = ttrain.run(ttrain.TrainJob(arch=cfg, **RUN_JOB), device="cpu",
                      log=lambda *a: None)["losses"]
    rec = runs[0][world][f"run_{mesh}"]
    assert rec["log_lines"] == [STEPS] + [0] * (world - 1)
    np.testing.assert_allclose(rec["losses"], want, atol=ATOL, rtol=RTOL)


# ---------------------------------------------------------------------------
# Tensor parallelism of the encoder-decoder and the SSM family
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", TP_FAMILIES)
def test_tp_family_gradients_match_reference(runs, ref, jx, arch):
    """The gradient of every leaf on a (1, 2) mesh, made whole, ≡
    ``jax.grad`` of the reference: of seamless's two stacks, its
    cross-attention (the encoder output's gradient summed over the model
    ranks) and its vocab-parallel lookup and head; of mamba2's ``w_in``
    (each rank's heads' z, x and dt columns, B and C's summed over the
    ranks), conv, ``a_log``, ``dt_bias``, ``d_skip``, ``out_norm`` (each
    rank's part, summed) and ``w_out``."""
    got = _tp12_grads(runs, f"tp12_grads_{arch}")
    want = _ref_grads(jx, ref, arch)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", TP_FAMILIES)
@pytest.mark.parametrize("mesh", list(TP_MESHES))
def test_tp_family_init_blocks_are_slices_of_the_one_device_init(
        runs, mesh, arch):
    """Each rank's block of every leaf of the reduced seamless and mamba2
    on (1, 2) and (2, 2) ≡ the slice of the one-device seed-0 init, bit for
    bit: the SSM's fused ``w_in`` stays in the reference's layout."""
    _init_blocks_are_slices(runs, mesh, arch, f"shards_{mesh}_{arch}")


@pytest.mark.parametrize("arch", TP_FAMILIES)
def test_tp_family_checkpoint_continues_bit_for_bit_on_its_mesh(runs,
                                                               arch):
    """A (2, 2) checkpoint at step 2, step 3 resumed on (2, 2) ≡ the
    uninterrupted (2, 2) run: its metrics and every array of the step-3
    checkpoint."""
    _resumed_bit_for_bit(runs, f"tp22_{arch}", f"tp22_ck_same_{arch}")


@pytest.mark.parametrize("arch", TP_FAMILIES)
def test_tp_family_checkpoint_resumes_on_four_data_ranks(runs, arch):
    """The (2, 2) checkpoint at step 2 resumed on (4, 1): step 3 within the
    tolerances of the uninterrupted (2, 2) run, params within 1e-3."""
    recs, dirs, _ = runs
    _close(recs[4][f"ck41_from22_{arch}"]["metrics"],
           recs[4][f"tp22_{arch}"]["metrics"][2:], f"(2, 2) → (4, 1) {arch}")
    assert _max_diff(_params_of(dirs[f"ck41_from22_{arch}"], STEPS),
                     _params_of(dirs[f"tp22_{arch}"], STEPS)) < 1e-3


@pytest.mark.parametrize("arch", TP_FAMILIES)
def test_reference_restores_the_tp_family_checkpoint(runs, ref, jx, arch):
    """Each family's (2, 2) checkpoint is the reference's format: its
    restore reads it, and its params after 2 steps are the reference's
    within 1e-3."""
    _reference_restores(runs, ref, jx, arch, f"tp22_ck_{arch}")


@pytest.mark.parametrize("arch", TP_FAMILIES)
def test_tp_family_collectives_are_what_the_spec_tree_implies(runs, arch):
    """One (2, 2) step under remat "full", by group, ≡
    ``roofline/analysis.reckon_collectives``; CommDebugMode's counts by op
    are the groups' sums. For the reduced mamba2 (one layer) the model
    axis spelled out: all-reduces of the lookup's rows, the
    cross-entropy's 3 sums, the head's and the layer's normed inputs,
    ``w_out``'s partial output, the gated norm's sums of squares in the
    forward, the recompute and the backward, the gradients of ``a_log``,
    ``dt_bias``, ``d_skip`` and ``out_norm``, the global norm's sums; the
    gathers of ``w_in``, ``conv_w`` and ``conv_b`` in the forward and the
    recompute, and their reduce-scatters."""
    from repro_torch.roofline import analysis
    rec = runs[0][4][f"tp22_{arch}"]["collectives"]
    cfg = dataclasses.replace(treduced(TARCHS[arch]), remat="full")
    model = tbuild(cfg, attn_impl="sdpa", device="cpu")
    want = analysis.reckon_collectives(model, 2, 2, 1, BATCH // 2, SEQ,
                                       enc_len=cfg.frontend_tokens)
    assert rec["by_group"] == want
    ops = {"all-gather": "c10d._allgather_base_",
           "reduce-scatter": "c10d._reduce_scatter_base_",
           "all-reduce": "c10d.allreduce_"}
    total = {}
    for g in want.values():
        for op, n in g["counts"].items():
            total[ops[op]] = total.get(ops[op], 0) + n
    assert rec["counts"] == total
    if arch == "mamba2-370m":
        assert want["model"]["counts"] == {
            "all-reduce": 1 + 3 + 1 + 1 + 1 + 3 + 4 + 1,
            "all-gather": 3 * 2, "reduce-scatter": 3}


def test_ssm_heads_that_do_not_divide_raise(runs):
    """A reduced mamba2 of 6 SSM heads on a "model" axis of 4: ValueError
    (``launch/mesh.check_divides``: a rank takes whole SSM heads)."""
    rec = runs[0][4]["ssm_uneven"]
    assert rec["raised"][0] == "ValueError", rec
    assert "the SSM heads 6 over 'model' 4" in rec["raised"][1], rec


@pytest.mark.parametrize("arch,shape,bad", [
    ("mamba2-370m", (2, 2), None), ("mamba2-370m", (1, 8), None),
    ("mamba2-370m", (1, 3), "the SSM heads 32 over 'model' 3"),
    ("mamba2-370m", (1, 64), "the SSM heads 32 over 'model' 64"),
    ("seamless-m4t-large-v2", (2, 2), None),
    ("seamless-m4t-large-v2", (1, 32), "n_heads 16 over 'model' 32")])
def test_check_divides_ssm_and_encdec(arch, shape, bad):
    """``launch/mesh.check_divides`` on mamba2-370m (32 SSM heads, ``w_in``
    of 4,384 columns, 2,304 conv channels) and seamless-m4t-large-v2 (16
    heads and kv heads, d_ff 8,192, vocab padded to 256,256)."""
    mesh = tmesh.Mesh(shape, ("data", "model"))
    if bad is None:
        tmesh.check_divides(TARCHS[arch], mesh)
    else:
        with pytest.raises(ValueError, match=bad.replace("'", ".")):
            tmesh.check_divides(TARCHS[arch], mesh)


_DP2_SCRIPT = """
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import ARCHS
from repro.data import DataConfig, batch_at
from repro.models import build_model, reduced_config
from repro.models.layers import MeshAxes, set_hint_axes
from repro.train import AdamWConfig, make_train_step, optimizer
data, opt = json.loads(sys.argv[1]), json.loads(sys.argv[2])
m = build_model(reduced_config(ARCHS["qwen3-14b"]))
mesh = jax.make_mesh((2, 1), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
axes = MeshAxes(fsdp=("data",))
specs = m.ps.spec_tree(axes)
put = lambda tree, specs: jax.tree.map(
    lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), tree, specs,
    is_leaf=lambda x: isinstance(x, P))
jc = AdamWConfig(**opt)
set_hint_axes(axes)
step = jax.jit(make_train_step(m, jc, grad_sync_dtype="bfloat16"))
with mesh:
    p = put(m.init_params(jax.random.PRNGKey(0)), specs)
    st = optimizer.init_state(jc, p)
    out = []
    for i in range(int(sys.argv[3])):
        b = jax.tree.map(lambda x: jax.device_put(
            x, NamedSharding(mesh, P("data"))),
            batch_at(DataConfig(**data), i))
        p, st, met = step(p, st, b)
        out.append({k: float(met[k]) for k in ("loss", "grad_norm", "lr")})
    hlo = step.lower(p, st, b).compile().as_text()
reductions = [l.split(op)[0] for l in hlo.splitlines()
              for op in (" all-reduce(", " reduce-scatter(") if op in l]
print(json.dumps({"devices": len(p["final_norm"].sharding.device_set),
                  "metrics": out, "reductions": len(reductions),
                  "bf16_reductions": sum("bf16" in r for r in reductions)}))
"""


@pytest.fixture(scope="module")
def ref_dp2(jx):
    """The reference's ``make_train_step(grad_sync_dtype="bfloat16")``
    jitted over a (2, 1) host mesh of 2 devices (params and batch placed by
    the spec tree) in a subprocess, 3 steps."""
    import json
    import os
    import subprocess
    import sys
    cfg = treduced(TARCHS["qwen3-14b"])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _DP2_SCRIPT, json.dumps(_data(cfg)),
         json.dumps(OPT), str(STEPS)], env=env, capture_output=True,
        text=True, timeout=rank_cases.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_bf16_sync_matches_the_reference_over_two_host_devices(runs,
                                                               ref_dp2):
    """The port's bf16 gradient sync on 2 gloo ranks ≡ the reference's
    own ``make_train_step(grad_sync_dtype="bfloat16")`` jitted over 2 host
    devices, loss, grad_norm and lr of 3 steps at the file's tolerances.
    Its compiled program sums the f32 gradients over the devices (no bf16
    all-reduce) and casts after, which the port now does too: a cast on
    each rank before the sum made grad_norm differ by 1.0e-3 at step 1."""
    assert ref_dp2["devices"] == 2
    assert ref_dp2["reductions"] > 0 and ref_dp2["bf16_reductions"] == 0
    _close(runs[0][2]["qwen3_bf16"]["metrics"], ref_dp2["metrics"],
           "W=2 bf16 sync against the reference on 2 host devices")
