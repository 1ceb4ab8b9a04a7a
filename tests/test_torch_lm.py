"""The port's LM substrate ≡ the JAX package's, dense family.

Layers, GQA attention (both of the port's paths against both of the
reference's), and the whole LM at ``reduced_config(qwen2-1.5b)`` with 2
layers and a vocab of 500 (f32): prefill logits and caches, and
teacher-forced ``decode_step`` logits, to atol 1e-4, with the reference's
weights carried over by ``convert.params_from_numpy``. Inputs come from
numpy seeds.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402

ATOL = 1e-4


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.models import attention, build_model, layers, reduced_config
    return types.SimpleNamespace(jax=jax, jnp=jnp, ARCHS=ARCHS,
                                 attention=attention, layers=layers,
                                 build_model=build_model,
                                 reduced_config=reduced_config)


@pytest.fixture(autouse=True)
def _single_thread():
    """One torch CPU thread keeps the parity tests deterministic (see
    tests/test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _small(arch_cfg, n_layers=2, vocab=500):
    return dataclasses.replace(arch_cfg, n_layers=n_layers, vocab_size=vocab)


def _np(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def test_archs_equal_the_reference_field_for_field(jx):
    assert sorted(TARCHS) == sorted(jx.ARCHS)
    for name, cfg in jx.ARCHS.items():
        assert dataclasses.asdict(TARCHS[name]) == dataclasses.asdict(cfg), \
            name
        assert dataclasses.asdict(treduced(TARCHS[name])) == \
            dataclasses.asdict(jx.reduced_config(cfg)), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_rope_swiglu_match_jax(jx, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 9, 32)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (32,)).astype(np.float32)
    pos = np.arange(9)
    jdt, tdt = getattr(jx.jnp, dtype), getattr(torch, dtype)
    tol = ATOL if dtype == "float32" else 2e-2
    jxv, twx = jx.jnp.asarray(x, jdt), torch.from_numpy(x).to(tdt)
    got = tlayers.rms_norm(twx, torch.from_numpy(w).to(tdt), 1e-6)
    want = jx.layers.rms_norm(jxv, jx.jnp.asarray(w, jdt), 1e-6)
    assert got.dtype == tdt
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    got = tlayers.rope(twx, torch.from_numpy(pos), 1e6)
    want = jx.layers.rope(jxv, jx.jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    wg, wu = (rng.standard_normal((32, 48)).astype(np.float32) * 0.2
              for _ in range(2))
    wd = rng.standard_normal((48, 32)).astype(np.float32) * 0.2
    got = tlayers.swiglu(twx, *(torch.from_numpy(a).to(tdt)
                                for a in (wg, wu, wd)))
    want = jx.layers.swiglu(jxv, *(jx.jnp.asarray(a, jdt)
                                   for a in (wg, wu, wd)))
    np.testing.assert_allclose(_np(got), _np(want), atol=tol * 10,
                               rtol=tol)


@pytest.mark.parametrize("impl,ref_impl", [("k2", "pallas"), ("k2", "xla"),
                                           ("sdpa", "pallas"),
                                           ("sdpa", "xla")])
def test_gqa_full_matches_jax(jx, impl, ref_impl):
    cfg = treduced(TARCHS["qwen2-1.5b"])
    jm = jx.build_model(jx.reduced_config(jx.ARCHS["qwen2-1.5b"]))
    p = jm.init_params(jx.jax.random.PRNGKey(3))["blocks"]["l0"]["attn"]
    p = jx.jax.tree.map(lambda a: a[0], p)
    rng = np.random.default_rng(1)
    # non-zero biases: the reference initialises them to zero
    p = {k: (jx.jnp.asarray(rng.standard_normal(v.shape) * 0.1, v.dtype)
             if k.startswith("b") else v) for k, v in p.items()}
    x = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    want, wkv = jx.attention.gqa_full(p, jx.jnp.asarray(x),
                                      jx.reduced_config(
                                          jx.ARCHS["qwen2-1.5b"]),
                                      attn_impl=ref_impl)
    tp = convert.params_from_numpy(jx.jax.tree.map(np.asarray, p), "cpu")
    got, gkv = tattn.gqa_full(tp, torch.from_numpy(x), cfg, attn_impl=impl)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(_np(gkv[name]), _np(wkv[name]),
                                   atol=ATOL, rtol=ATOL)


def _lm_pair(jx, seed=0):
    jcfg = _small(jx.reduced_config(jx.ARCHS["qwen2-1.5b"]))
    tcfg = _small(treduced(TARCHS["qwen2-1.5b"]))
    jm = jx.build_model(jcfg, attn_impl="pallas")
    jparams = jm.init_params(jx.jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    # the reference draws zero biases and unit norms: perturb them so the
    # test sees them
    jparams = jx.jax.tree_util.tree_map_with_path(
        lambda path, a: (a + jx.jnp.asarray(
            rng.standard_normal(a.shape) * 0.1, a.dtype))
        if path[-1].key in ("bq", "bk", "bv", "norm", "final_norm") else a,
        jparams)
    tm = tbuild(tcfg, device="cpu")
    tparams = convert.params_from_numpy(
        jx.jax.tree.map(np.asarray, jparams), "cpu")
    return jm, jparams, tm, tparams


def test_lm_prefill_and_decode_match_jax(jx):
    jm, jparams, tm, tparams = _lm_pair(jx)
    assert tm.n_params() == jm.n_params() and tm.v_pad == 512
    b, s, t0, s_max = 2, 24, 19, 32
    toks = np.random.default_rng(2).integers(0, 500, (b, s))
    want, jcaches = jm.prefill(jparams, jx.jnp.asarray(toks[:, :t0]))
    got, tcaches = tm.prefill(tparams, torch.from_numpy(toks[:, :t0]))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
    assert bool((got[:, 500:] == np.float32(-1e30)).all())   # padded vocab
    jc_np = jx.jax.tree.map(np.asarray, jcaches)
    tc_np = convert.params_to_numpy(tcaches)
    assert jx.jax.tree.structure(jc_np) == jx.jax.tree.structure(tc_np)
    for a, c in zip(jx.jax.tree.leaves(jc_np), jx.jax.tree.leaves(tc_np)):
        np.testing.assert_allclose(c, a, atol=ATOL, rtol=ATOL)

    specs = jm.decode_cache_specs(b, s_max)

    def pad_to(spec, val):
        out = jx.jnp.zeros(spec.shape, spec.dtype)
        return out.at[tuple(slice(0, d) for d in val.shape)].set(val)

    jc = jx.jax.tree.map(pad_to, specs, jcaches)
    tc = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jc), "cpu")
    tspecs = tm.decode_cache_specs(b, s_max)
    assert [sd.shape for sd in jx.jax.tree.leaves(specs)] == \
        [sd.shape for d in tspecs[1] for sd in d.values()]
    for t in range(t0, s):
        want, jc = jm.decode_step(jparams, jx.jnp.asarray(toks[:, t]), jc,
                                  jx.jnp.int32(t))
        got, tc = tm.decode_step(tparams, torch.from_numpy(toks[:, t]), tc,
                                 t)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL,
                                   rtol=ATOL, err_msg=f"position {t}")


def test_lm_decode_matches_prefill():
    """Within the port: prefill then teacher-forced decode reproduces the
    full prefill's last logits (tests/test_arch_smoke.py's check)."""
    cfg = _small(treduced(TARCHS["qwen2-1.5b"]))
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(1))
    b, s, t0 = 2, 24, 20
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 500, (b, s)))
    full, _ = m.prefill(params, toks)
    _, pre = m.prefill(params, toks[:, :t0])
    caches = m.init_decode_caches(b, s)
    for dense, part in zip(caches[1], pre[1]):
        for name in dense:
            dense[name][..., :t0, :] = part[name]
    for t in range(t0, s):
        lg, caches = m.decode_step(params, toks[:, t], caches, t)
    np.testing.assert_allclose(_np(lg), _np(full), atol=5e-4)


def test_params_round_trip_bit_exact_including_bf16(jx):
    """JAX params (bf16 config) → port → numpy: every leaf's bits equal."""
    cfg = dataclasses.replace(jx.reduced_config(jx.ARCHS["qwen2-1.5b"]),
                              param_dtype="bfloat16")
    jparams = jx.build_model(cfg).init_params(jx.jax.random.PRNGKey(7))
    leaves = jx.jax.tree.map(np.asarray, jparams)
    tp = convert.params_from_numpy(leaves, "cpu")
    assert tp["embed"]["tokens"].dtype == torch.bfloat16
    back = convert.params_to_numpy(tp, bfloat16=jx.jnp.bfloat16)
    bits = convert.params_to_numpy(tp)
    for a, c, u in zip(jx.jax.tree.leaves(leaves), jx.jax.tree.leaves(back),
                       jx.jax.tree.leaves(bits)):
        assert c.dtype == a.dtype and c.shape == a.shape
        width = np.uint16 if a.dtype.itemsize == 2 else np.uint32
        assert np.array_equal(c.view(width), a.view(width))
        assert np.array_equal(u.view(width), a.view(width))


def test_init_params_follows_the_registry(jx):
    """Same paths, shapes and init kinds as the reference; normal leaves
    have std 0.02."""
    jm = jx.build_model(jx.ARCHS["qwen2-1.5b"])
    tm = tbuild(TARCHS["qwen2-1.5b"], device="cpu")
    assert tm.n_params() == jm.n_params() == 1_543_714_304
    assert sorted(tm.ps.infos) == sorted(jm.ps.infos)
    for path, info in jm.ps.infos.items():
        ti = tm.ps.infos[path]
        assert (ti.shape, ti.spec, ti.init, ti.std) == \
            (info.shape, info.spec, info.init, info.std), path
        assert ti.dtype == torch.bfloat16
    small = tbuild(_small(treduced(TARCHS["qwen2-1.5b"])), device="cpu")
    p = small.init_params(torch.Generator().manual_seed(0))
    assert float(p["embed"]["tokens"].std()) == pytest.approx(0.02, rel=0.05)
    assert torch.equal(p["blocks"]["l0"]["attn"]["bq"],
                       torch.zeros_like(p["blocks"]["l0"]["attn"]["bq"]))
    assert torch.equal(p["final_norm"], torch.ones_like(p["final_norm"]))


def test_unported_families_raise():
    # the encoder-decoder builds at full size (no allocation)
    from repro_torch.models import EncDecLM
    m = tbuild(TARCHS["seamless-m4t-large-v2"], device="cpu")
    assert isinstance(m, EncDecLM) and m.n_params() == 2_034_886_656
    # the SSM family and the hybrid build at full size (no allocation)
    for name in ("mamba2-370m", "jamba-v0.1-52b"):
        assert tbuild(TARCHS[name], device="cpu").cfg.name == name
    m = tbuild(_small(treduced(TARCHS["qwen2-1.5b"])), device="cpu")
    with pytest.raises(ValueError):
        tattn.gqa_full({}, torch.zeros(1, 1, 64), m.cfg, attn_impl="xla")
    # the MoE (MLA and GQA), SSM and hybrid families train: a finite loss
    # of CE + the router aux (positive exactly where there are experts)
    # and a finite gradient in every leaf
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, (2, 16)))
    for name in ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "mamba2-370m",
                 "jamba-v0.1-52b"):
        m = tbuild(treduced(TARCHS[name]), attn_impl="sdpa", device="cpu")
        p = m.init_params(torch.Generator().manual_seed(0))
        leaves = [v.requires_grad_(True) for v in _leaves(p)]
        loss, met = m.train_loss(p, {"tokens": toks, "labels": toks})
        grads = torch.autograd.grad(loss, leaves)
        assert torch.isfinite(loss) and torch.equal(
            loss, met["ce"] + met["aux"]), name
        assert (float(met["aux"].detach()) > 0) == bool(m.cfg.n_experts), name
        assert all(torch.isfinite(g).all() for g in grads), name


def _leaves(tree):
    if isinstance(tree, dict):
        return [v for k in sorted(tree) for v in _leaves(tree[k])]
    return [tree]


def test_init_params_scales_in_place_with_the_same_bits():
    """The in-place scale draws what ``(randn · std).to(dtype)`` draws,
    bit for bit, leaf by leaf in sorted path order."""
    for dtype in (torch.float32, torch.bfloat16):
        ps = tlayers.ParamSet(dtype=dtype)
        ps.add("b/w", (37, 19), (None, None), std=0.006)
        ps.add("a/w", (3, 5, 7), (None, None, None))
        ps.add("a/n", (7,), (None,), init="ones")
        got = ps.init_params(torch.Generator().manual_seed(3))
        gen = torch.Generator().manual_seed(3)
        for path, std in (("a/w", 0.02), ("b/w", 0.006)):
            shape = ps.infos[path].shape
            want = (torch.randn(shape, generator=gen, dtype=torch.float32)
                    * std).to(dtype)
            part, leaf = path.split("/")
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            assert torch.equal(got[part][leaf].view(bits),
                               want.view(bits)), (path, dtype)


# -- the SSM family (mamba2) and the hybrid (jamba) -------------------------

SSM_CASES = [("mamba2-370m", 1), ("mamba2-370m", 3), ("jamba-v0.1-52b", 8),
             ("jamba-v0.1-52b", 16)]


def _ssm_lm_pair(jx, arch, n_layers, seed=0):
    """The reduced config at ``n_layers`` (1 or 3 blocks of mamba2's
    pattern, 1 or 2 of jamba's) in both packages, the reference's weights
    with its constant leaves perturbed, carried to the port."""
    jcfg = dataclasses.replace(jx.reduced_config(jx.ARCHS[arch]),
                               n_layers=n_layers)
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), n_layers=n_layers)
    jm = jx.build_model(jcfg, attn_impl="pallas")
    rng = np.random.default_rng(seed)
    jparams = jx.jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * (0.5 if path[-1].key in ("a_log", "dt_bias")
                           else 0.1)
        if a.ndim - (path[0].key == "blocks") == 1 else np.asarray(a),
        jm.init_params(jx.jax.random.PRNGKey(seed)))
    tm = tbuild(tcfg, device="cpu")
    return jm, jparams, tm, convert.params_from_numpy(jparams, "cpu")


@pytest.mark.parametrize("arch,n_layers", SSM_CASES)
def test_ssm_lm_prefill_and_decode_match_jax(jx, arch, n_layers):
    """Prefill logits and caches (SSM conv and state, the hybrid's K/V),
    then teacher-forced decode steps from the reference's padded caches:
    the port's logits equal the reference's at ATOL. Prompts of 21 tokens
    (a chunk of 16 and a padded one) decoded to 27."""
    jm, jparams, tm, tparams = _ssm_lm_pair(jx, arch, n_layers)
    assert tm.n_params() == jm.n_params()
    b, s, t0, s_max = 2, 27, 21, 32
    toks = np.random.default_rng(2).integers(0, 512, (b, s))
    want, jcaches = jm.prefill(jparams, jx.jnp.asarray(toks[:, :t0]))
    got, tcaches = tm.prefill(tparams, torch.from_numpy(toks[:, :t0]))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
    jc_np = jx.jax.tree.map(np.asarray, jcaches)
    tc_np = convert.params_to_numpy(tcaches)
    assert jx.jax.tree.structure(jc_np) == jx.jax.tree.structure(tc_np)
    for a, c in zip(jx.jax.tree.leaves(jc_np), jx.jax.tree.leaves(tc_np)):
        np.testing.assert_allclose(c, a, atol=ATOL, rtol=ATOL)

    specs = jm.decode_cache_specs(b, s_max)
    assert [sd.shape for sd in jx.jax.tree.leaves(specs)] == [
        tuple(t.shape) for t in jx.jax.tree.leaves(convert.params_to_numpy(
            tm.init_decode_caches(b, s_max)))]

    def pad_to(spec, val):
        out = jx.jnp.zeros(spec.shape, spec.dtype)
        return out.at[tuple(slice(0, d) for d in val.shape)].set(val)

    jc = jx.jax.tree.map(pad_to, specs, jcaches)
    tc = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jc), "cpu")
    for t in range(t0, s):
        want, jc = jm.decode_step(jparams, jx.jnp.asarray(toks[:, t]), jc,
                                  jx.jnp.int32(t))
        got, tc = tm.decode_step(tparams, torch.from_numpy(toks[:, t]), tc,
                                 t)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL,
                                   rtol=ATOL, err_msg=f"position {t}")
    for a, c in zip(jx.jax.tree.leaves(jx.jax.tree.map(np.asarray, jc)),
                    jx.jax.tree.leaves(convert.params_to_numpy(tc))):
        np.testing.assert_allclose(c, a, atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("arch,n_layers", SSM_CASES)
def test_ssm_lm_decode_matches_prefill(arch, n_layers):
    """Within the port: prefill(S) then teacher-forced decode reproduces
    prefill(S + k)'s last logits (the reference's 5e-4), from prompts
    shorter than K−1, shorter than a chunk and longer than one."""
    from repro_torch.launch import serve_lm
    cfg = dataclasses.replace(treduced(TARCHS[arch]), n_layers=n_layers)
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(1))
    b, s = 2, 30
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (b, s)))
    full, _ = m.prefill(params, toks)
    for t0 in (2, 11, 20):
        _, pre = m.prefill(params, toks[:, :t0])
        caches = m.init_decode_caches(b, s)
        serve_lm.write_caches(caches, pre, t0)
        for t in range(t0, s):
            lg, caches = m.decode_step(params, toks[:, t], caches, t)
        np.testing.assert_allclose(_np(lg), _np(full), atol=5e-4,
                                   err_msg=f"prefill of {t0}")


@pytest.mark.parametrize("arch", ["mamba2-370m", "jamba-v0.1-52b"])
def test_ssm_full_registry_and_n_params_equal_the_reference(jx, arch):
    """The full-size registries (no allocation): paths, shapes, specs and
    inits the reference's; per layer kind, the SSM leaves under
    ``l<i>/ssm`` and the hybrid's GQA at index 4."""
    jm = jx.build_model(jx.ARCHS[arch])
    tm = tbuild(TARCHS[arch], device="cpu")
    assert tm.n_params() == jm.n_params()
    assert sorted(tm.ps.infos) == sorted(jm.ps.infos)
    for path, info in jm.ps.infos.items():
        ti = tm.ps.infos[path]
        assert (ti.shape, ti.spec, ti.init, ti.std) == \
            (info.shape, info.spec, info.init, info.std), path
    assert "blocks/l0/ssm/w_in" in tm.ps.infos
    if arch == "jamba-v0.1-52b":
        assert "blocks/l4/attn/wq" in tm.ps.infos
        assert "blocks/l4/ssm/w_in" not in tm.ps.infos
        assert "blocks/l1/moe/w_gate" in tm.ps.infos
        assert 45e9 < tm.n_params() < 58e9
    else:
        assert tm.n_blocks == 48
