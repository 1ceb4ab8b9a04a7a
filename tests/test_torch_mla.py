"""The port's MLA attention and MoE LMs ≡ the JAX package's.

* ``mla_full`` (output and the compressed caches) and ``mla_decode`` over
  several steps at ``reduced_config(deepseek-v2-lite-16b)`` (f32), atol
  1e-5;
* the full deepseek-v2-lite and kimi-k2 registries (MLA and MoE leaves)
  and parameter counts equal the reference's (no allocation);
* ``LM.prefill`` and teacher-forced ``decode_step`` logits of both reduced
  configs, at tests/test_torch_lm.py's ATOL, and decode ≡ prefill within
  the port at the reference's own 5e-4;
* ``serve_lm.serve`` of the reduced models on the CPU: every request
  finishes, no page leaks, each prompt lands in its own slot's cache rows.

Weights cross over through ``convert``; inputs come from numpy seeds.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402

ATOL = 1e-5
LM_ATOL = 1e-4                      # tests/test_torch_lm.py
MOE_ARCHS = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")


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


def _np(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _perturbed(jx, tree, seed):
    """Numpy copies of the reference's leaves, with its unit norms
    perturbed so the tests see them."""
    rng = np.random.default_rng(seed)
    return jx.jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.1
        if "norm" in path[-1].key else np.array(a), tree)


def _mla_params(jx, seed):
    jcfg = jx.reduced_config(jx.ARCHS["deepseek-v2-lite-16b"])
    ps = jx.layers.ParamSet(dtype=jx.jnp.float32)
    jx.attention.register_mla(ps, "attn", jcfg, ())
    # ×4: larger scores, so the softmax is far from uniform
    p = ps.init_params(jx.jax.random.PRNGKey(seed))["attn"]
    p = {k: v * 4 if v.ndim == 2 else v for k, v in p.items()}
    return jcfg, _perturbed(jx, p, seed)


def test_mla_full_matches_jax(jx):
    jcfg, p = _mla_params(jx, 0)
    tcfg = treduced(TARCHS["deepseek-v2-lite-16b"])
    x = np.random.default_rng(1).standard_normal(
        (2, 13, tcfg.d_model)).astype(np.float32)
    want, wc = jx.attention.mla_full(p, jx.jnp.asarray(x), jcfg)
    got, gc = tattn.mla_full(convert.params_from_numpy(p, "cpu"),
                             torch.from_numpy(x), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
    assert sorted(gc) == sorted(wc) == ["c_kv", "k_pe"]
    for name in wc:
        assert tuple(gc[name].shape) == wc[name].shape
        np.testing.assert_allclose(_np(gc[name]), _np(wc[name]), atol=ATOL,
                                   rtol=ATOL)


def test_mla_decode_matches_jax_over_several_steps(jx):
    """Prefill 9 positions with ``mla_full``, pad into 16-long caches, then
    5 absorbed decode steps: every step's output and the caches, written in
    place in the port, equal the reference's."""
    jcfg, p = _mla_params(jx, 2)
    tcfg = treduced(TARCHS["deepseek-v2-lite-16b"])
    b, t0, s_max, steps = 2, 9, 16, 5
    x = np.random.default_rng(3).standard_normal(
        (b, t0 + steps, tcfg.d_model)).astype(np.float32)
    _, pre = jx.attention.mla_full(p, jx.jnp.asarray(x[:, :t0]), jcfg)
    jc = {k: jx.jnp.zeros((b, s_max, v.shape[-1]), jx.jnp.float32)
          .at[:, :t0].set(v) for k, v in pre.items()}
    tc = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jc), "cpu")
    tp = convert.params_from_numpy(p, "cpu")
    spec = tattn.mla_cache_spec(tcfg, b, s_max, torch.float32)
    assert {k: sd.shape for k, sd in spec.items()} == \
        {k: v.shape for k, v in jc.items()}
    for i in range(steps):
        t = t0 + i
        want, jc = jx.attention.mla_decode(
            p, jx.jnp.asarray(x[:, t:t + 1]), jc, jx.jnp.int32(t), jcfg)
        got, out = tattn.mla_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc,
                                    t, tcfg)
        assert out["c_kv"] is tc["c_kv"]           # written in place
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL,
                                   err_msg=f"position {t}")
        for name in jc:
            np.testing.assert_allclose(_np(tc[name]), _np(jc[name]),
                                       atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_full_registry_and_n_params_equal_the_reference(jx, arch):
    jm = jx.build_model(jx.ARCHS[arch])
    tm = tbuild(TARCHS[arch], device="cpu")
    assert tm.n_params() == jm.n_params()
    assert sorted(tm.ps.infos) == sorted(jm.ps.infos)
    for path, info in jm.ps.infos.items():
        ti = tm.ps.infos[path]
        assert (ti.shape, ti.spec, ti.init, ti.std) == \
            (info.shape, info.spec, info.init, info.std), path
    if arch == "deepseek-v2-lite-16b":
        assert tm.n_params() == 15_706_484_224
        assert "blocks/l0/attn/w_dkv" in tm.ps.infos
        assert "blocks/l0/attn/wk" not in tm.ps.infos    # MLA, not GQA
    else:
        assert "blocks/l0/attn/wk" in tm.ps.infos


def _lm_pair(jx, arch, seed=0):
    jcfg = jx.reduced_config(jx.ARCHS[arch])
    jm = jx.build_model(jcfg)
    jparams = _perturbed(jx, jm.init_params(jx.jax.random.PRNGKey(seed)),
                         seed)
    tm = tbuild(treduced(TARCHS[arch]), device="cpu")
    return jm, jparams, tm, convert.params_from_numpy(jparams, "cpu")


def _padded(jx, jm, jcaches, b, s_max):
    def pad_to(spec, val):
        out = jx.jnp.zeros(spec.shape, spec.dtype)
        return out.at[tuple(slice(0, d) for d in val.shape)].set(val)
    return jx.jax.tree.map(pad_to, jm.decode_cache_specs(b, s_max), jcaches)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_prefill_and_decode_match_jax(jx, arch):
    jm, jparams, tm, tparams = _lm_pair(jx, arch)
    assert tm.n_params() == jm.n_params()
    b, s, t0, s_max = 2, 20, 15, 24
    toks = np.random.default_rng(2).integers(0, 512, (b, s))
    want, jcaches = jm.prefill(jparams, jx.jnp.asarray(toks[:, :t0]))
    got, tcaches = tm.prefill(tparams, torch.from_numpy(toks[:, :t0]))
    np.testing.assert_allclose(_np(got), _np(want), atol=LM_ATOL,
                               rtol=LM_ATOL)
    jc_np = jx.jax.tree.map(np.asarray, jcaches)
    tc_np = convert.params_to_numpy(tcaches)
    assert jx.jax.tree.structure(jc_np) == jx.jax.tree.structure(tc_np)
    for a, c in zip(jx.jax.tree.leaves(jc_np), jx.jax.tree.leaves(tc_np)):
        np.testing.assert_allclose(c, a, atol=LM_ATOL, rtol=LM_ATOL)

    jc = _padded(jx, jm, jcaches, b, s_max)
    tc = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jc), "cpu")
    tspecs = jm.decode_cache_specs(b, s_max)
    assert [sd.shape for sd in jx.jax.tree.leaves(tspecs)] == [
        tuple(t.shape) for t in jx.jax.tree.leaves(
            convert.params_to_numpy(tm.init_decode_caches(b, s_max)))]
    for t in range(t0, s):
        want, jc = jm.decode_step(jparams, jx.jnp.asarray(toks[:, t]), jc,
                                  jx.jnp.int32(t))
        got, tc = tm.decode_step(tparams, torch.from_numpy(toks[:, t]), tc,
                                 t)
        np.testing.assert_allclose(_np(got), _np(want), atol=LM_ATOL,
                                   rtol=LM_ATOL, err_msg=f"position {t}")


def _fill(caches, pre, n):
    """Write prefill caches (length n) into the first n rows of decode
    caches of the same batch."""
    for dense, part in zip(serve_lm._leaves(caches), serve_lm._leaves(pre)):
        dense[..., :n, :] = part


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_lm_decode_matches_prefill(arch):
    """Within the port: prefill then teacher-forced decode reproduces the
    full prefill's last logits (tests/test_arch_smoke.py's check; reduced
    capacity factor 4.0, so neither drops)."""
    m = tbuild(treduced(TARCHS[arch]), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(1))
    b, s, t0 = 2, 24, 18
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (b, s)))
    full, _ = m.prefill(params, toks)
    _, pre = m.prefill(params, toks[:, :t0])
    caches = m.init_decode_caches(b, s)
    _fill(caches, pre, t0)
    for t in range(t0, s):
        lg, caches = m.decode_step(params, toks[:, t], caches, t)
    np.testing.assert_allclose(_np(lg), _np(full), atol=5e-4)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_write_prompt_fills_only_its_slot(arch):
    """A prompt's prefill caches land in its own slot's rows of every
    leaf — axis 0 of a prefix leaf, axis 1 of a stacked block leaf, for
    MLA's (B, S, r) and GQA's (B, Hkv, S, Dh) alike — zero past the
    prompt, and the other slots keep what they held."""
    m = tbuild(treduced(TARCHS[arch]), device="cpu")
    params = m.init_params(torch.Generator().manual_seed(2))
    slots, s_max, n = 3, 16, 7
    caches = m.init_decode_caches(slots, s_max)
    for leaf in serve_lm._leaves(caches):
        leaf.fill_(5.0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (1, n)))
    _, pre = m.prefill(params, toks)
    serve_lm._write_prompt(caches, pre, 1, n)
    for axis, dense, part in zip((0, 1), caches, pre):
        leaves = list(zip(serve_lm._leaves(dense), serve_lm._leaves(part)))
        assert leaves
        for d, p in leaves:
            rows = d.select(axis, 1)
            assert torch.equal(rows[..., :n, :], p.select(axis, 0))
            assert bool((rows[..., n:, :] == 0).all())
            for other in (0, 2):
                assert bool((d.select(axis, other) == 5.0).all())


def _greedy(m, params, prompt, new_tokens, s_max):
    """Prefill ``prompt`` alone, then greedy decode steps: the tokens after
    the first, as the batcher records them."""
    toks = torch.from_numpy(prompt[None]).long()
    logits, pre = m.prefill(params, toks)
    caches = m.init_decode_caches(1, s_max)
    _fill(caches, pre, len(prompt))
    out = []
    for i in range(new_tokens):
        nxt = torch.argmax(logits, dim=-1)
        logits, caches = m.decode_step(params, nxt, caches, len(prompt) + i)
        out.append(int(torch.argmax(logits[0])))
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_reduced_moe_on_the_cpu(arch):
    """Five requests through 2 slots finish with their tokens and leak no
    page; through one slot each request's stream equals a greedy run of
    its prompt alone (so each prompt was written into its slot's rows)."""
    cfg = treduced(TARCHS[arch])
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    reqs = serve_lm.make_requests(5, cfg.vocab_size, prompt_min=9,
                                  prompt_max=20, new_tokens=5, seed=4)
    kw = dict(slots=2, s_max=32, page_size=8, n_pages=16)
    report = serve_lm.serve(m, params, reqs, **kw)
    assert sorted(f.uid for f in report.finished) == list(range(5))
    assert all(len(f.tokens) == 5 for f in report.finished)
    assert report.n_free == kw["n_pages"] and report.logits_finite
    summary = report.summary()
    assert summary["prefills"] == 5 and summary["generated_tokens"] == 25
    solo = serve_lm.serve(m, params, reqs, **{**kw, "slots": 1})
    assert solo.n_free == kw["n_pages"]
    for f, r in zip(solo.finished, reqs):
        assert f.uid == r.uid
        assert f.tokens == _greedy(m, params, r.prompt, 5, kw["s_max"])
