"""The port's training path ≡ the JAX package's, on the CPU.

``cross_entropy``; ``LM.train_loss`` (loss, ce, the router aux) and every
gradient leaf against ``jax.value_and_grad`` of the reference's, on the
reference's weights carried across by ``convert.params_from_numpy`` and
the same batch, for nine reduced configs (dense: qwen2 with QKV bias,
qwen3 with qk_norm, yi; vlm: phi-3-vision with its frontend stub; the
encoder-decoder seamless, frames on the encoder; MoE: deepseek-v2-lite
with MLA, kimi-k2 with GQA; SSM: mamba2; hybrid: jamba) at atol 1e-5 +
rtol 1e-4; the three remat policies bit for bit (the encoder-decoder's two
stacks, and the MoE, SSM and hybrid configs without JAX); the AdamW
schedule and update; three train steps (seamless's, deepseek-v2-lite's in
2 microbatches and mamba2's too); the reference's own optimizer and
train-step tests mirrored on the port; and K2 refusing autograd. One
reference model per config and remat policy serves the module. Inputs
come from numpy seeds.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.data import DataConfig as TDataConfig  # noqa: E402
from repro_torch.data import batch_at as tbatch_at  # noqa: E402
from repro_torch.kernels import flash_attention as k2  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.train import optimizer as topt  # noqa: E402
from repro_torch.train import make_train_step as tmake_train_step  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
TRAIN_ARCHS = ("qwen2-1.5b", "qwen3-14b", "yi-6b", "phi-3-vision-4.2b",
               "seamless-m4t-large-v2", "deepseek-v2-lite-16b",
               "kimi-k2-1t-a32b", "mamba2-370m", "jamba-v0.1-52b")
# the MoE (MLA and GQA), SSM and hybrid families
FAMILY_ARCHS = TRAIN_ARCHS[5:]


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.data import DataConfig, batch_at
    from repro.models import build_model, layers, reduced_config
    from repro.train import AdamWConfig, make_train_step, optimizer
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, ARCHS=ARCHS, DataConfig=DataConfig,
        batch_at=batch_at, build_model=build_model, layers=layers,
        reduced_config=reduced_config, AdamWConfig=AdamWConfig,
        make_train_step=make_train_step, optimizer=optimizer)


@pytest.fixture(autouse=True)
def _single_thread():
    """One torch CPU thread keeps the parity tests deterministic (see
    tests/test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _flat(tree, path=()):
    """{path tuple: leaf} of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + (k,)))
        return out
    return {path: tree}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _data_cfg(cfg, seq_len=16, global_batch=2, seed=1234):
    return dict(vocab_size=cfg.vocab_size, seq_len=seq_len,
                global_batch=global_batch, seed=seed,
                frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)


_REF = {}


def _ref(jx, name, remat):
    """The reference's reduced model and its weights, one per (config,
    remat) for the module."""
    key = (name, remat)
    if key not in _REF:
        jcfg = dataclasses.replace(jx.reduced_config(jx.ARCHS[name]),
                                   remat=remat)
        jm = jx.build_model(jcfg)
        _REF[key] = jm, jm.init_params(jx.jax.random.PRNGKey(0))
    return _REF[key]


def _both(jx, name, remat="none", **data):
    """(reference model, its params, its batch, port model, the same params
    and batch as tensors) for ``reduced_config(name)``."""
    jm, jp = _ref(jx, name, remat)
    dcfg = _data_cfg(jm.cfg, **data)
    jb = jx.batch_at(jx.DataConfig(**dcfg), 0)
    tcfg = dataclasses.replace(treduced(TARCHS[name]), remat=remat)
    tm = tbuild(tcfg, attn_impl="sdpa", device="cpu")
    tp = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jp), "cpu")
    tb = tbatch_at(TDataConfig(**dcfg), 0, device="cpu")
    return jm, jp, jb, tm, tp, tb


def _loss_and_grads(model, params, batch):
    """The port's loss, its metrics and {path: gradient}."""
    flat = _flat(params)
    leaves = {k: v.detach().requires_grad_(True) for k, v in flat.items()}
    tree = {}
    for path, v in leaves.items():
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = v
    loss, metrics = model.train_loss(tree, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


# ---------------------------------------------------------------------------
# the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True], ids=["mean", "masked"])
def test_cross_entropy_matches_reference(jx, masked):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 7)).astype(np.int32)
    mask = (rng.random((2, 7)) < 0.6).astype(np.float32) if masked else None
    want = jx.layers.cross_entropy(
        jx.jnp.asarray(logits), jx.jnp.asarray(labels),
        None if mask is None else jx.jnp.asarray(mask))
    got = tlayers.cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32
    _close(got, want, "cross_entropy", atol=1e-6, rtol=1e-6)


def test_cross_entropy_of_an_empty_mask_is_zero():
    logits = torch.zeros((1, 3, 5))
    got = tlayers.cross_entropy(logits, torch.zeros((1, 3), dtype=torch.int32),
                                torch.zeros((1, 3)))
    assert float(got) == 0.0


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_train_loss_and_grads_match_jax(jx, name):
    jm, jp, jb, tm, tp, tb = _both(jx, name)
    (jloss, jmet), jgrads = jx.jax.value_and_grad(
        jm.train_loss, has_aux=True)(jp, jb)
    loss, met, grads = _loss_and_grads(tm, tp, tb)
    _close(loss, jloss, f"{name} loss")
    _close(met["ce"], jmet["ce"], f"{name} ce")
    _close(met["aux"], jmet["aux"], f"{name} aux")
    # the router aux loss is in the loss exactly where there are experts
    assert (float(jmet["aux"]) > 0) == bool(tm.cfg.n_experts), name
    want = {tuple(p.key for p in path): leaf for path, leaf in
            jx.jax.tree_util.tree_flatten_with_path(jgrads)[0]}
    assert set(want) == set(grads)
    for path, g in grads.items():
        assert g.shape == tuple(want[path].shape), path
        _close(g, want[path], f"{name} grad {'/'.join(path)}")


def test_train_loss_slices_off_the_frontend_positions(jx):
    """phi-3-vision: the frontend embeds sit ahead of the tokens, and the
    loss reads only the token positions (the reference's ``nfe``)."""
    _, _, _, tm, tp, tb = _both(jx, "phi-3-vision-4.2b")
    assert tb["frontend_embeds"].shape[1] == tm.cfg.frontend_tokens == 8
    loss, _ = tm.train_loss(tp, tb)
    x = tm._embed(tp, tb["tokens"], tb["frontend_embeds"])
    logits = tm._logits(tp, tm._run_blocks_train(tp, x)[0])[:, 8:]
    want = tlayers.cross_entropy(logits[:, :-1], tb["labels"][:, 1:])
    assert torch.equal(loss, want)


def _count_ops(fn):
    """Calls of aten.mm and aten.bmm while ``fn`` runs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"mm": 0, "bmm": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in counts:
                counts[name] += 1
            return func(*args, **(kwargs or {}))
    with Count():
        out = fn()
    return out, counts


def test_remat_policies_are_bit_equal_and_recompute_what_they_say(jx):
    """none / dots / full give the same loss and gradients bit for bit.
    "full" recomputes every matmul of a block in the backward; "dots"
    keeps the plain matmuls' outputs (aten.mm: no more calls than "none")
    and recomputes the batched attention einsums (aten.bmm)."""
    runs = {}
    for remat in ("none", "dots", "full"):
        _, _, _, tm, tp, tb = _both(jx, "qwen2-1.5b", remat=remat)
        runs[remat] = _count_ops(lambda: _loss_and_grads(tm, tp, tb))
    (loss0, _, g0), c0 = runs["none"]
    for remat in ("dots", "full"):
        (loss, _, g), _ = runs[remat]
        assert torch.equal(loss, loss0), remat
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)
    cd, cf = runs["dots"][1], runs["full"][1]
    assert cd["mm"] == c0["mm"] < cf["mm"], (c0, cd, cf)
    assert c0["bmm"] < cd["bmm"] == cf["bmm"], (c0, cd, cf)


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_family_remat_policies_are_bit_equal(name):
    """The MoE, MLA, SSM and hybrid configs: remat none / dots / full give
    the same loss, aux and gradients bit for bit (the aux leaves each
    checkpointed block as its second output)."""
    runs = {}
    for remat in ("none", "dots", "full"):
        cfg = dataclasses.replace(treduced(TARCHS[name]), remat=remat)
        tm = tbuild(cfg, attn_impl="sdpa", device="cpu")
        tp = tm.init_params(torch.Generator().manual_seed(0))
        tb = tbatch_at(TDataConfig(**_data_cfg(cfg)), 0, device="cpu")
        runs[remat] = _loss_and_grads(tm, tp, tb)
    loss0, met0, g0 = runs["none"]
    assert (float(met0["aux"].detach()) > 0) == bool(cfg.n_experts)
    for remat in ("dots", "full"):
        loss, met, g = runs[remat]
        assert torch.equal(loss, loss0), remat
        assert torch.equal(met["aux"], met0["aux"]), remat
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)


def test_train_loss_unbinds_each_stacked_leaf_once(jx):
    """The blocks' stacked leaves are split by one unbind each, never by a
    select per block (whose backward would scatter into a zero tensor the
    size of the whole leaf, once per block)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    _, _, _, tm, tp, tb = _both(jx, "qwen2-1.5b")
    tm.n_blocks = 3
    tp = dict(tp, blocks=_stack3(tp["blocks"]))
    seen = {"select": 0, "unbind": 0}

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            if name in seen and args[0].dim() >= 2 and args[0].shape[0] == 3:
                seen[name] += 1
            return func(*args, **(kwargs or {}))
    with Count():
        _loss_and_grads(tm, tp, tb)
    n_leaves = len(_flat(tp["blocks"]))
    assert seen == {"select": 0, "unbind": n_leaves}, seen


def _stack3(tree):
    if isinstance(tree, dict):
        return {k: _stack3(v) for k, v in tree.items()}
    return torch.cat([tree] * 3)


def test_encdec_remat_is_bit_equal_and_recomputes_both_stacks(jx):
    """seamless: remat none / dots / full give the same loss and gradients
    bit for bit. As the reference's ``jax.checkpoint`` (no policy) around
    the encoder's and the decoder's layers, "dots" is "full" here: both
    recompute every matmul of every layer of both stacks in the backward
    (the head's matmul is outside any layer)."""
    runs = {}
    for remat in ("none", "dots", "full"):
        _, _, _, tm, tp, tb = _both(jx, "seamless-m4t-large-v2", remat=remat)
        runs[remat] = _count_ops(lambda: _loss_and_grads(tm, tp, tb))
    (loss0, _, g0), c0 = runs["none"]
    for remat in ("dots", "full"):
        (loss, _, g), c = runs[remat]
        assert torch.equal(loss, loss0), remat
        for path in g0:
            assert torch.equal(g[path], g0[path]), (remat, path)
        assert c == runs["full"][1], remat
    # every layer of both stacks runs its 7 self-attention and MLP
    # matmuls (q, k, v, o, gate, up, down) again in the backward
    cfg = tm.cfg
    again = runs["full"][1]["mm"] - c0["mm"]
    assert again >= 7 * (cfg.encoder_layers + cfg.n_layers), \
        (c0, runs["full"][1])


def test_encdec_three_train_steps_match_reference(jx):
    """seamless through the train step, with frames of the sequence length
    as ``launch/train.run`` feeds them: loss, grad_norm and lr of three
    steps ≡ the reference's jitted step."""
    from repro_torch.train import init_state
    jm, jp, _, tm, tp, _ = _both(jx, "seamless-m4t-large-v2")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jc, tc = jx.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jstep = jx.jax.jit(jx.make_train_step(jm, jc))
    tstep = tmake_train_step(tm, tc)
    dcfg = dict(_data_cfg(tm.cfg, seq_len=16, global_batch=2),
                frontend_tokens=16)
    jst, tst = jx.optimizer.init_state(jc, jp), init_state(tc, tp)
    for i in range(3):
        tb = tbatch_at(TDataConfig(**dcfg), i, device="cpu")
        assert tb["frontend_embeds"].shape == (2, 16, tm.cfg.d_model)
        jp, jst, jmet = jstep(jp, jst, jx.batch_at(jx.DataConfig(**dcfg), i))
        tp, tst, tmet = tstep(tp, tst, tb)
        for key in ("loss", "grad_norm", "lr"):
            _close(tmet[key], jmet[key], f"step {i + 1} {key}")
    assert _tree_max_diff(tp, jp) < 1e-3


def test_encdec_trains_through_launch_train_run(tmp_path):
    """``launch/train.run`` builds seamless with ``attn_impl="sdpa"`` and
    feeds it frames of ``seq_len``: a reduced run logs finite losses that
    fall, and checkpoints."""
    from repro_torch.launch import train as ttrain
    from repro_torch.train import checkpoint as tckpt
    job = ttrain.TrainJob(arch=treduced(TARCHS["seamless-m4t-large-v2"]),
                          steps=6, seq_len=16, global_batch=2, lr=1e-2,
                          warmup=2, ckpt_dir=str(tmp_path), ckpt_every=3,
                          log_every=1)
    logs = []
    out = ttrain.run(job, device="cpu", log=logs.append)
    assert len(logs) == 6 and np.isfinite(out["first_loss"])
    assert out["final_loss"] < out["first_loss"]
    assert tckpt.list_steps(str(tmp_path)) == [3, 6]


def test_train_loss_with_k2_raises(jx):
    _, _, _, tm, tp, tb = _both(jx, "qwen2-1.5b")
    m = tbuild(tm.cfg, attn_impl="k2", device="cpu")
    with pytest.raises(ValueError, match="K2 has no backward"):
        m.train_loss(tp, tb)


def test_k2_raises_under_autograd():
    """K2 refuses q, k or v that require grad while grad is enabled, on
    the CPU path as on the card; under no_grad it runs."""
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((1, 2, 8, 16)).astype(
        np.float32))
    kv = torch.from_numpy(rng.standard_normal((1, 1, 8, 16)).astype(
        np.float32))
    for which in range(3):
        args = [q.clone(), kv.clone(), kv.clone()]
        args[which].requires_grad_(True)
        with pytest.raises(RuntimeError, match="no backward"):
            k2.flash_attention(*args)
        with torch.no_grad():
            out = k2.flash_attention(*args)
        assert torch.equal(out, k2.flash_attention_plain(q, kv, kv))
    assert torch.equal(k2.flash_attention(q, kv, kv),
                       k2.flash_attention_plain(q, kv, kv))


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------

def test_schedule_matches_reference(jx):
    cfg = dict(lr=3e-4, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    jc, tc = jx.AdamWConfig(**cfg), topt.AdamWConfig(**cfg)
    for step in (0, 1, 5, 10, 55, 100, 130):
        want = jx.optimizer.schedule(jc, jx.jnp.int32(step))
        got = topt.schedule(tc, torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        _close(got, want, f"schedule at {step}", atol=0, rtol=1e-6)


def _opt_inputs(seed):
    """Params, grads (norm above clip, so the clip is exercised) and a
    warm state, as numpy."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 5), "b": {"c": (7,), "d": (2, 4, 3)}}

    def draw(shape, scale):
        if isinstance(shape, dict):
            return {k: draw(v, scale) for k, v in shape.items()}
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    p, g = draw(shapes, 1.0), draw(shapes, 0.5)
    mu, nu = draw(shapes, 0.1), draw(shapes, 0.1)
    nu = _tmap(np.abs, nu)
    return p, g, mu, nu


def _tmap(fn, tree):
    if isinstance(tree, dict):
        return {k: _tmap(fn, v) for k, v in tree.items()}
    return fn(tree)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_apply_updates_matches_reference(jx, moment_dtype):
    jnp = jx.jnp
    p, g, mu, nu = _opt_inputs(1)
    kw = dict(lr=1e-2, warmup_steps=3, total_steps=20,
              moment_dtype=moment_dtype)
    jc, tc = jx.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    mdt = jnp.float32 if moment_dtype == "float32" else jnp.bfloat16
    jstate = {"mu": _tmap(lambda a: jnp.asarray(a, mdt), mu),
              "nu": _tmap(lambda a: jnp.asarray(a, mdt), nu),
              "step": jnp.int32(4)}
    jp, jg = _tmap(jnp.asarray, p), _tmap(jnp.asarray, g)
    tstate = convert.opt_state_from_numpy(
        jx.jax.tree.map(np.asarray, jstate), "cpu")
    tp = convert.params_from_numpy(p, "cpu")
    tg = convert.params_from_numpy(g, "cpu")
    before = {k: v.clone() for k, v in _flat(tp).items()}
    jnew, jst, jm = jx.optimizer.apply_updates(jc, jp, jg, jstate)
    tnew, tst, tm = topt.apply_updates(tc, tp, tg, tstate)
    assert all(torch.equal(v, before[k]) for k, v in _flat(tp).items())
    assert float(jm["grad_norm"]) > 1.0          # the clip is active
    _close(tm["grad_norm"], jm["grad_norm"], "grad_norm", atol=0, rtol=1e-6)
    _close(tm["lr"], jm["lr"], "lr", atol=0, rtol=1e-6)
    assert int(tst["step"]) == int(jst["step"]) == 5
    assert tst["step"].dtype == torch.int32
    for name, got, want in (("params", tnew, jnew), ("mu", tst["mu"],
                                                     jst["mu"]),
                            ("nu", tst["nu"], jst["nu"])):
        want_f = _flat(want)
        for path, t in _flat(got).items():
            w = np.asarray(want_f[path]).astype(np.float32)
            assert t.dtype == (torch.bfloat16 if name != "params" and
                               moment_dtype == "bfloat16" else torch.float32)
            _close(t, w, f"{name} {path}", atol=0, rtol=1e-6)


def test_opt_state_crosses_both_ways(jx):
    jnp = jx.jnp
    st = {"mu": {"w": jnp.asarray([1.5, -2.25], jnp.bfloat16)},
          "nu": {"w": jnp.asarray([0.5, 3.0], jnp.bfloat16)},
          "step": jnp.int32(7)}
    leaves = jx.jax.tree.map(np.asarray, st)
    t = convert.opt_state_from_numpy(leaves, "cpu")
    assert t["mu"]["w"].dtype == torch.bfloat16
    assert t["step"].dtype == torch.int32 and int(t["step"]) == 7
    back = convert.opt_state_to_numpy(t, bfloat16=jnp.bfloat16)
    for a, b in zip(jx.jax.tree.leaves(leaves), jx.jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="mu, nu and step"):
        convert.opt_state_from_numpy({"mu": {}}, "cpu")


def test_adamw_converges_quadratic():
    """The port's mirror of tests/test_train_serve.py's."""
    cfg = topt.AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                           total_steps=300, min_lr_ratio=1.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = topt.init_state(cfg, params)
    for _ in range(200):
        g = {"w": 2 * params["w"]}
        params, state, _ = topt.apply_updates(cfg, params, g, state)
    assert float(params["w"].abs().max()) < 1e-2


def test_schedule_shape():
    cfg = topt.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    step = lambda s: torch.tensor(s, dtype=torch.int32)   # noqa: E731
    assert float(topt.schedule(cfg, step(0))) == 0.0
    assert abs(float(topt.schedule(cfg, step(10))) - 1.0) < 1e-6
    assert float(topt.schedule(cfg, step(100))) <= 0.11


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

def _tree_max_diff(a, b):
    fa, fb = _flat(a), _flat(b)
    return max(float((_np(fa[k]) - _np(fb[k])).__abs__().max()) for k in fa)


def test_three_train_steps_match_reference(jx):
    """Loss, grad_norm and lr of three steps on three batches, from the
    same weights and a fresh state, as the reference's jitted step."""
    from repro_torch.train import init_state
    jm, jp, _, tm, tp, _ = _both(jx, "qwen3-14b")
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jc, tc = jx.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jstep = jx.jax.jit(jx.make_train_step(jm, jc))
    tstep = tmake_train_step(tm, tc)
    dcfg = _data_cfg(tm.cfg, seq_len=16, global_batch=2)
    jst, tst = jx.optimizer.init_state(jc, jp), init_state(tc, tp)
    for i in range(3):
        jp, jst, jmet = jstep(jp, jst, jx.batch_at(jx.DataConfig(**dcfg), i))
        tp, tst, tmet = tstep(tp, tst, tbatch_at(TDataConfig(**dcfg), i,
                                                 device="cpu"))
        for key in ("loss", "grad_norm", "lr"):
            _close(tmet[key], jmet[key], f"step {i + 1} {key}")
    assert int(tst["step"]) == 3
    # f32 params after three steps at lr <= 1e-2: AdamW divides by √v̂ +
    # eps, so an element whose |g| is near eps could move by up to lr on
    # rounding alone; none does here (2e-5 measured), and 1e-3 says so
    assert _tree_max_diff(tp, jp) < 1e-3


@pytest.mark.parametrize("name,n_micro", [("deepseek-v2-lite-16b", 2),
                                          ("mamba2-370m", 1)])
def test_family_three_train_steps_match_reference(jx, name, n_micro):
    """deepseek-v2-lite (MLA + MoE) with 2 microbatches, each carrying its
    aux loss, and mamba2: loss, grad_norm and lr of three steps ≡ the
    reference's jitted step."""
    from repro_torch.train import init_state
    jm, jp, _, tm, tp, _ = _both(jx, name)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10)
    jc, tc = jx.AdamWConfig(**kw), topt.AdamWConfig(**kw)
    jstep = jx.jax.jit(jx.make_train_step(jm, jc, n_microbatches=n_micro))
    tstep = tmake_train_step(tm, tc, n_microbatches=n_micro)
    dcfg = _data_cfg(tm.cfg, seq_len=16, global_batch=4)
    jst, tst = jx.optimizer.init_state(jc, jp), init_state(tc, tp)
    for i in range(3):
        jp, jst, jmet = jstep(jp, jst, jx.batch_at(jx.DataConfig(**dcfg), i))
        tp, tst, tmet = tstep(tp, tst, tbatch_at(TDataConfig(**dcfg), i,
                                                 device="cpu"))
        for key in ("loss", "grad_norm", "lr"):
            _close(tmet[key], jmet[key], f"{name} step {i + 1} {key}")
    assert _tree_max_diff(tp, jp) < 1e-3


def test_train_loss_decreases_small_lm():
    cfg = treduced(TARCHS["qwen2-1.5b"])
    m = tbuild(cfg, attn_impl="sdpa", device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    ocfg = topt.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=60)
    opt = topt.init_state(ocfg, params)
    step = tmake_train_step(m, ocfg)
    batch = tbatch_at(TDataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                  global_batch=4), 0, device="cpu")
    losses = []
    for _ in range(30):
        params, opt, metrics = step(params, opt, batch)  # overfit one batch
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] * 0.7, losses[::10]
    assert np.isfinite(losses).all()


def _yi_step(n_micro=1, grad_sync_dtype=None, params=None):
    cfg = treduced(TARCHS["yi-6b"])
    m = tbuild(cfg, attn_impl="sdpa", device="cpu")
    if params is None:
        params = m.init_params(torch.Generator().manual_seed(0))
    ocfg = topt.AdamWConfig(lr=1e-3)
    batch = tbatch_at(TDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=8), 0, device="cpu")
    return tmake_train_step(m, ocfg, n_microbatches=n_micro,
                            grad_sync_dtype=grad_sync_dtype)(
        params, topt.init_state(ocfg, params), batch)


def test_microbatch_equivalence():
    """grad accumulation (n micro) == single batch step, same params out."""
    p1, _, m1 = _yi_step(1)
    p4, _, m4 = _yi_step(4)
    assert _tree_max_diff(p1, p4) < 5e-5
    _close(m4["loss"], m1["loss"], "loss", atol=1e-5, rtol=1e-5)


def test_bf16_grad_sync_close_to_f32():
    p32, _, _ = _yi_step(1)
    p16, _, _ = _yi_step(1, grad_sync_dtype="bfloat16")
    f32, f16 = _flat(p32), _flat(p16)
    rel = max(float((f32[k] - f16[k]).abs().max()
                    / (f32[k].abs().max() + 1e-9)) for k in f32)
    assert rel < 0.05, rel


@pytest.mark.parametrize("grad_sync_dtype", [None, "bfloat16"])
def test_microbatches_match_reference(jx, grad_sync_dtype):
    """n_microbatches 4 (f32 accumulation, optionally bf16-synced
    gradients) against the reference's scan, same weights and batch."""
    jcfg = jx.reduced_config(jx.ARCHS["yi-6b"])
    jm = jx.build_model(jcfg)
    jp = jm.init_params(jx.jax.random.PRNGKey(0))
    ocfg = jx.AdamWConfig(lr=1e-3)
    jb = jx.batch_at(jx.DataConfig(vocab_size=jcfg.vocab_size, seq_len=16,
                                   global_batch=8), 0)
    jnew, _, jmet = jx.jax.jit(jx.make_train_step(
        jm, ocfg, n_microbatches=4, grad_sync_dtype=grad_sync_dtype))(
        jp, jx.optimizer.init_state(ocfg, jp), jb)
    tnew, _, tmet = _yi_step(4, grad_sync_dtype, convert.params_from_numpy(
        jx.jax.tree.map(np.asarray, jp), "cpu"))
    for key in ("loss", "grad_norm", "lr"):
        _close(tmet[key], jmet[key], key)
    # one step at lr 1e-3 (warm-up step 1: lr 1e-5): rounding alone may
    # move an element with |g| near eps by up to lr
    assert _tree_max_diff(tnew, jnew) < 1e-5 + 1e-6


def test_prefill_and_decode_steps_match_reference(jx):
    """``make_prefill_step`` with phi-3-vision's frontend embeds, and
    ``make_decode_step`` from empty caches, against the reference's."""
    from repro.train import make_decode_step as jdecode
    from repro.train import make_prefill_step as jprefill
    from repro_torch.train import make_decode_step, make_prefill_step
    jm, jp, jb, tm, tp, tb = _both(jx, "phi-3-vision-4.2b")
    jlogits, _ = jprefill(jm)(jp, jb)
    with torch.no_grad():
        tlogits, _ = make_prefill_step(tm)(tp, tb)
    _close(tlogits, jlogits, "prefill logits", atol=1e-4, rtol=1e-4)
    tok = np.asarray([3, 7], np.int32)
    jl, _ = jdecode(jm)(jp, jx.jnp.asarray(tok), jm.init_decode_caches(2, 8),
                        jx.jnp.int32(0))
    tl, _ = make_decode_step(tm)(tp, torch.from_numpy(tok),
                                 tm.init_decode_caches(2, 8), 0)
    _close(tl, jl, "decode logits", atol=1e-4, rtol=1e-4)
