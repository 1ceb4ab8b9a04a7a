"""The port's Mamba2 SSM layer ≡ the JAX package's.

* ``register_ssm``: leaf for leaf the reference's registry (shapes, specs,
  inits), at the reduced and the full mamba2-370m and jamba configs;
* ``_causal_conv`` with and without a carried window, ``ssd_chunked``
  with and without an initial state (atol 1e-5), and the chunked SSD ≡
  the naive step-by-step recurrence (tests/test_arch_smoke.py's oracle,
  run in torch: atol 2e-4); its gradients ≡ ``jax.grad`` of the
  reference's at chunks 16 and 64 (1e-5 + 1e-4·|ref|), and at chunk 128,
  where the reference's is NaN, finite and ≡ the f64 recurrence's (1e-4 +
  1e-4·|f64|);
* ``ssm_full`` output and decode hand-off (atol 1e-5) at S a chunk
  multiple, S not one (the padding rule) and S < K−1 (the left-padded
  conv tail); ``ssm_decode`` from the reference's caches over several
  steps (atol 1e-5), writing the caches it is given in place;
* SSM weights and decode caches cross ``convert`` bit for bit, bf16
  included; ``serve_lm._write_prompt`` copies SSM leaves whole.

Reduced mamba2-370m and jamba configs in f32; weights cross over through
``convert``; inputs come from numpy seeds.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ATOL = 1e-5
SSM_ARCHS = ("mamba2-370m", "jamba-v0.1-52b")


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.models import build_model, layers, reduced_config, ssm
    return types.SimpleNamespace(jax=jax, jnp=jnp, ARCHS=ARCHS, ssm=ssm,
                                 layers=layers, build_model=build_model,
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


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _ssm_params(jx, arch, seed):
    """The reference's SSM leaves at the reduced config, with its constant
    leaves (conv bias, A, dt bias, skip, norms) perturbed and ``w_in`` ×4
    (a wider spread of dt), as numpy."""
    jcfg = jx.reduced_config(jx.ARCHS[arch])
    ps = jx.layers.ParamSet(dtype=jx.jnp.float32)
    jx.ssm.register_ssm(ps, "ssm", jcfg, ())
    p = ps.init_params(jx.jax.random.PRNGKey(seed))["ssm"]
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in p.items():
        v = np.array(v)
        if k == "w_in":
            v = v * 4
        elif v.ndim == 1:
            v = v + rng.standard_normal(v.shape).astype(np.float32) * (
                0.5 if k in ("a_log", "dt_bias") else 0.1)
        out[k] = v
    return jcfg, treduced(TARCHS[arch]), out


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_register_ssm_matches_the_reference(jx, arch, reduced):
    jcfg, tcfg = jx.ARCHS[arch], TARCHS[arch]
    if reduced:
        jcfg, tcfg = jx.reduced_config(jcfg), treduced(tcfg)
    jps = jx.layers.ParamSet(dtype=jx.jnp.bfloat16)
    tps = tlayers.ParamSet(dtype=torch.bfloat16)
    jx.ssm.register_ssm(jps, "blocks/l0/ssm", jcfg, (3,))
    tssm.register_ssm(tps, "blocks/l0/ssm", tcfg, (3,))
    assert list(tps.infos) == list(jps.infos)
    for path, info in jps.infos.items():
        ti = tps.infos[path]
        assert (ti.shape, ti.spec, ti.init, ti.std) == \
            (info.shape, info.spec, info.init, info.std), path
        assert ti.dtype == torch.bfloat16
    assert tssm._dims(tcfg) == jx.ssm._dims(jcfg)
    assert {k: tuple(v.shape) for k, v in
            tssm.ssm_cache_spec(tcfg, 2, torch.float32).items()} == \
        {k: tuple(v.shape) for k, v in
         jx.ssm.ssm_cache_spec(jcfg, 2, jx.jnp.float32).items()}


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv_matches_jax(jx, with_prev):
    rng = np.random.default_rng(1)
    xbc = rng.standard_normal((2, 11, 40)).astype(np.float32)
    w = rng.standard_normal((4, 40)).astype(np.float32)
    b = rng.standard_normal((40,)).astype(np.float32)
    prev = rng.standard_normal((2, 3, 40)).astype(np.float32) \
        if with_prev else None
    want = jx.ssm._causal_conv(
        jx.jnp.asarray(xbc), jx.jnp.asarray(w), jx.jnp.asarray(b),
        None if prev is None else jx.jnp.asarray(prev))
    got = tssm._causal_conv(_t(xbc), _t(w), _t(b),
                            None if prev is None else _t(prev))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)


def _ssd_inputs(seed, b=2, s=48, h=3, p=8, n=16):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.05, 0.8, (b, s, h)).astype(np.float32),
            -rng.uniform(0.1, 1.0, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32),
            rng.standard_normal((b, h, p, n)).astype(np.float32))


@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("chunk", [16, 48, 64])
def test_ssd_chunked_matches_jax(jx, with_h0, chunk):
    x, dt, a, bm, cm, h0 = _ssd_inputs(2)
    h0 = h0 if with_h0 else None
    want_y, want_h = jx.ssm.ssd_chunked(
        *(jx.jnp.asarray(v) for v in (x, dt, a, bm, cm)), chunk=chunk,
        h0=None if h0 is None else jx.jnp.asarray(h0))
    got_y, got_h = tssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                                    chunk=chunk,
                                    h0=None if h0 is None else _t(h0))
    np.testing.assert_allclose(_np(got_y), _np(want_y), atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(_np(got_h), _np(want_h), atol=ATOL, rtol=ATOL)


def test_ssd_matches_naive_recurrence():
    """Chunked SSD == step-by-step linear recurrence (the reference's
    mamba2 oracle, tests/test_arch_smoke.py, on the port)."""
    x, dt, a, bm, cm, _ = _ssd_inputs(0)
    b, s, h, p = x.shape
    y, hfin = tssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)),
                               chunk=16)
    hstate = np.zeros((b, h, p, bm.shape[-1]), np.float32)
    ys = np.zeros((b, s, h, p), np.float32)
    for t in range(s):
        decay = np.exp(dt[:, t] * a)
        hstate = hstate * decay[..., None, None] + np.einsum(
            "bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        ys[:, t] = np.einsum("bhpn,bn->bhp", hstate, cm[:, t])
    np.testing.assert_allclose(_np(y), ys, atol=2e-4)
    np.testing.assert_allclose(_np(hfin), hstate, atol=2e-4)


def _ssd_grads(fn, x, dt, a, bm, cm, r, dtype=torch.float32):
    """Gradients of sum(y · r) over (x, dt, a, bmat, cmat) in ``dtype``."""
    args = [torch.from_numpy(v).to(dtype).requires_grad_(True)
            for v in (x, dt, a, bm, cm)]
    y = fn(*args)
    g = torch.autograd.grad((y * torch.from_numpy(r).to(dtype)).sum(), args)
    return [v.numpy() for v in g]


def _recurrence_y(x, dt, a, bm, cm):
    """The step-by-step recurrence (tests/test_arch_smoke.py's oracle) in
    torch, so autograd differentiates it: h ← exp(dt·a)·h + dt·x⊗B,
    y = h·C."""
    b, s, h, p = x.shape
    hstate = torch.zeros((b, h, p, bm.shape[-1]), dtype=x.dtype)
    ys = []
    for t in range(s):
        hstate = hstate * torch.exp(dt[:, t] * a)[..., None, None] + \
            torch.einsum("bh,bhp,bn->bhpn", dt[:, t], x[:, t], bm[:, t])
        ys.append(torch.einsum("bhpn,bn->bhp", hstate, cm[:, t]))
    return torch.stack(ys, dim=1)


def _long_chunk_inputs(seed=5, s=128):
    """dt·|a| near 1 a step: within a chunk of 128 the masked-out exponents
    cum_i − cum_j (j > i) sum past 88.7, where f32 exp overflows."""
    rng = np.random.default_rng(seed)
    b, h, p, n = 1, 2, 4, 8
    return (rng.standard_normal((b, s, h, p)).astype(np.float32),
            rng.uniform(0.8, 1.2, (b, s, h)).astype(np.float32),
            -rng.uniform(0.9, 1.1, (h,)).astype(np.float32),
            rng.standard_normal((b, s, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, s, n)).astype(np.float32) * 0.5,
            rng.standard_normal((b, s, h, p)).astype(np.float32))


def test_ssd_gradient_is_finite_at_chunk_128_and_matches_the_recurrence(jx):
    """At chunk 128 the reference's gradient is NaN: it takes exp of the
    masked-out upper triangle too (``src/repro/models/ssm.py:94``), and
    0·inf there is NaN. The port masks the exponent first (a departure on
    purpose, ROADMAP.md): its f32 gradients are finite and equal those of
    the f64 step-by-step recurrence within 1e-4 + 1e-4·|f64|."""
    x, dt, a, bm, cm, r = _long_chunk_inputs()
    assert float(np.max(np.cumsum(-dt[0, :, 0] * a[0]))) > 88.8

    def jfn(*v):
        y, _ = jx.ssm.ssd_chunked(*v, chunk=128)
        return jx.jnp.sum(y * r)
    jg = jx.jax.grad(jfn, argnums=(0, 1, 2, 3, 4))(
        *(jx.jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    assert not np.isfinite(np.asarray(jg[1])).all()      # the reference's dt
    got = _ssd_grads(lambda *v: tssm.ssd_chunked(*v, chunk=128)[0],
                     x, dt, a, bm, cm, r)
    want = _ssd_grads(_recurrence_y, x, dt, a, bm, cm, r, torch.float64)
    for name, g, w in zip(("x", "dt", "a", "bmat", "cmat"), got, want):
        assert np.isfinite(g).all(), name
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=name)
    # the forward is the reference's at the same chunk
    y, _ = tssm.ssd_chunked(*(_t(v) for v in (x, dt, a, bm, cm)), chunk=128)
    want_y, _ = jx.ssm.ssd_chunked(
        *(jx.jnp.asarray(v) for v in (x, dt, a, bm, cm)), chunk=128)
    np.testing.assert_allclose(_np(y), _np(want_y), atol=ATOL, rtol=ATOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_gradient_matches_jax(jx, chunk):
    """Where the reference's gradient is finite (chunk 16, the reduced
    configs'; 64) the port's equals it within 1e-5 + 1e-4·|ref|."""
    x, dt, a, bm, cm, _ = _ssd_inputs(3, s=128)
    r = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def jfn(*v):
        y, _ = jx.ssm.ssd_chunked(*v, chunk=chunk)
        return jx.jnp.sum(y * r)
    want = jx.jax.grad(jfn, argnums=(0, 1, 2, 3, 4))(
        *(jx.jnp.asarray(v) for v in (x, dt, a, bm, cm)))
    got = _ssd_grads(lambda *v: tssm.ssd_chunked(*v, chunk=chunk)[0],
                     x, dt, a, bm, cm, r)
    for name, g, w in zip(("x", "dt", "a", "bmat", "cmat"), got, want):
        assert np.isfinite(np.asarray(w)).all(), name
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=1e-4,
                                   err_msg=name)


@pytest.mark.parametrize("arch", SSM_ARCHS)
@pytest.mark.parametrize("s", [32, 40, 2, 16, 7])
def test_ssm_full_matches_jax(jx, arch, s):
    """S 32 and 16 are chunk multiples (chunk 16), 40 is padded to 48 with
    identity steps, 7 runs one chunk of 7, and 2 < K−1 = 3 left-pads the
    conv tail."""
    jcfg, tcfg, p = _ssm_params(jx, arch, seed=3)
    x = np.random.default_rng(4).standard_normal(
        (2, s, jcfg.d_model)).astype(np.float32)
    want, wc = jx.ssm.ssm_full({k: jx.jnp.asarray(v) for k, v in p.items()},
                               jx.jnp.asarray(x), jcfg)
    got, gc = tssm.ssm_full(convert.params_from_numpy(p, "cpu"), _t(x), tcfg)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=ATOL)
    assert sorted(gc) == sorted(wc) == ["conv", "state"]
    for k in wc:
        assert tuple(gc[k].shape) == wc[k].shape, k
        np.testing.assert_allclose(_np(gc[k]), _np(wc[k]), atol=ATOL,
                                   rtol=ATOL, err_msg=k)
    if s < jcfg.ssm_conv - 1:
        assert bool((gc["conv"][:, :jcfg.ssm_conv - 1 - s] == 0).all())


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_decode_matches_jax_in_place(jx, arch):
    """From the reference's prefill caches, four decode steps: outputs and
    caches equal the reference's, and the cache tensors passed in hold the
    new caches (written in place, not rebound)."""
    jcfg, tcfg, p = _ssm_params(jx, arch, seed=5)
    jp = {k: jx.jnp.asarray(v) for k, v in p.items()}
    tp = convert.params_from_numpy(p, "cpu")
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 10, jcfg.d_model)).astype(np.float32)
    _, jc = jx.ssm.ssm_full(jp, jx.jnp.asarray(x), jcfg)
    tc = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jc), "cpu")
    ptrs = {k: v.data_ptr() for k, v in tc.items()}
    for step in range(4):
        xt = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        want, jc = jx.ssm.ssm_decode(jp, jx.jnp.asarray(xt), jc, jcfg)
        passed = dict(tc)
        got, tc = tssm.ssm_decode(tp, _t(xt), passed, tcfg)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL,
                                   rtol=ATOL, err_msg=f"step {step}")
        for k in jc:
            assert tc[k] is passed[k] and tc[k].data_ptr() == ptrs[k], k
            np.testing.assert_allclose(_np(tc[k]), _np(jc[k]), atol=ATOL,
                                       rtol=ATOL, err_msg=f"{k} {step}")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_ssm_leaves_and_caches_cross_convert_bit_for_bit_in_bf16(jx, arch):
    """The reference's bf16 weights and its prefill caches (SSM conv and
    state, and the hybrid's K/V) → the port → numpy: every leaf's bits
    equal, and the structure is the port's own."""
    jcfg = dataclasses.replace(jx.reduced_config(jx.ARCHS[arch]),
                               param_dtype="bfloat16",
                               activation_dtype="bfloat16")
    jm = jx.build_model(jcfg)
    jparams = jm.init_params(jx.jax.random.PRNGKey(8))
    toks = np.random.default_rng(8).integers(0, 512, (2, 9))
    _, jcaches = jm.prefill(jparams, jx.jnp.asarray(toks))
    tm = tbuild(dataclasses.replace(treduced(TARCHS[arch]),
                                    param_dtype="bfloat16",
                                    activation_dtype="bfloat16"),
                device="cpu")
    for tree in (jparams, jcaches):
        leaves = jx.jax.tree.map(np.asarray, tree)
        tt = convert.params_from_numpy(leaves, "cpu")
        bits = convert.params_to_numpy(tt)
        assert jx.jax.tree.structure(bits) == jx.jax.tree.structure(leaves)
        for a, u in zip(jx.jax.tree.leaves(leaves), jx.jax.tree.leaves(bits)):
            assert a.dtype.name == "bfloat16" and u.shape == a.shape
            assert np.array_equal(u.view(np.uint16), a.view(np.uint16))
    tc = convert.params_from_numpy(jx.jax.tree.map(np.asarray, jcaches),
                                   "cpu")
    for d, spec in zip(tc[1], tm.decode_cache_specs(2, 16)[1],
                       strict=True):
        assert sorted(d) == sorted(spec)
        for k, v in d.items():
            assert v.dtype == torch.bfloat16
            if k in ("conv", "state"):
                assert tuple(v.shape) == spec[k].shape, k


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_write_prompt_copies_ssm_leaves_whole(arch):
    """A prompt shorter than ``ssm_head_dim`` (5 < 16): the SSM conv window
    and state land whole in the slot, attention leaves in the slot's first
    rows with zeros past them, the other slots untouched."""
    cfg = treduced(TARCHS[arch])
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(2))
    slots, s_max, n = 3, 16, 5
    assert n < cfg.ssm_head_dim
    caches = m.init_decode_caches(slots, s_max)
    for leaf in serve_lm._leaves(caches):
        leaf.fill_(5.0)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (1, n)))
    _, pre = m.prefill(params, toks)
    serve_lm._write_prompt(caches, pre, 1, n)
    kinds = set()
    for axis, dense, part in zip((0, 1), caches, pre):
        for (key, d), (_, p) in zip(serve_lm._keyed_leaves(dense),
                                    serve_lm._keyed_leaves(part)):
            kinds.add(key)
            rows = d.select(axis, 1)
            if key in ("conv", "state"):
                assert torch.equal(rows, p.select(axis, 0)), key
            else:
                assert torch.equal(rows[..., :n, :], p.select(axis, 0))
                assert bool((rows[..., n:, :] == 0).all())
            for other in (0, 2):
                assert bool((d.select(axis, other) == 5.0).all())
    assert {"conv", "state"} <= kinds
    assert ({"k", "v"} <= kinds) == (arch == "jamba-v0.1-52b")
