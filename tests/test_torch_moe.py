"""The port's MoE layer ≡ the JAX package's (``repro.models.moe``).

``moe_layer`` at the reduced deepseek-v2-lite and kimi-k2 configs (f32),
under scatter and gather dispatch, at capacity factor 4.0 (no drops) and
1.0 (drops): output atol 1e-5, aux rtol 1e-6, expert indices and kept
mask exact (the reference's routing is recomputed here with its own
functions, lines 79-95 of its ``moe_layer``); at 1.0 the gradients of x
and every leaf ≡ ``jax.grad``'s (1e-5 + 1e-4·|ref|). Ties among the top-k
probabilities go to the lower expert index, as ``jax.lax.top_k`` orders
them. Inputs come from numpy seeds; the reference's weights cross over
through ``convert``.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402

ATOL = 1e-5
AUX_RTOL = 1e-6
MOE_ARCHS = ("deepseek-v2-lite-16b", "kimi-k2-1t-a32b")


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.models import layers, moe, reduced_config
    return types.SimpleNamespace(jax=jax, jnp=jnp, ARCHS=ARCHS, layers=layers,
                                 moe=moe, reduced_config=reduced_config)


@pytest.fixture(autouse=True)
def _single_thread():
    """One torch CPU thread keeps the parity tests deterministic (see
    tests/test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfgs(jx, arch, **upd):
    return (dataclasses.replace(treduced(TARCHS[arch]), **upd),
            dataclasses.replace(jx.reduced_config(jx.ARCHS[arch]), **upd))


def _params(jx, jcfg, seed):
    """The reference's MoE weights (its init, unit norm perturbed) as numpy
    leaves."""
    ps = jx.layers.ParamSet(dtype=jx.jnp.float32)
    jx.moe.register_moe(ps, "moe", jcfg, ())
    p = jx.jax.tree.map(np.array,
                        ps.init_params(jx.jax.random.PRNGKey(seed))["moe"])
    rng = np.random.default_rng(seed)
    p["norm"] = p["norm"] + rng.standard_normal(p["norm"].shape).astype(
        np.float32) * 0.1
    return p


def _jax_routing(jx, p, x, cfg):
    """The reference's routing, step for step (``moe.py`` :75-95): expert
    indices (T, k), positions and kept mask (T·k,)."""
    jnp = jx.jnp
    xn = jx.layers.rms_norm(jnp.asarray(x), p["norm"], cfg.norm_eps)
    xt = xn.reshape(-1, x.shape[-1])
    cap = jx.moe.capacity(xt.shape[0], cfg)
    logits = jnp.einsum("td,de->te", xt, p["router"]).astype(jnp.float32)
    probs = jx.jax.nn.softmax(logits, axis=-1)
    _, expert_idx = jx.jax.lax.top_k(probs, cfg.top_k)
    flat_e = expert_idx.reshape(-1)
    onehot = jx.jax.nn.one_hot(flat_e, cfg.n_experts, dtype=jnp.int32)
    pos_all = jnp.cumsum(onehot, axis=0) - onehot
    pos = jnp.take_along_axis(pos_all, flat_e[:, None], axis=1)[:, 0]
    return (np.asarray(expert_idx), np.asarray(pos),
            np.asarray(pos < cap))


def _port_routing(tp, x, cfg):
    xt = tlayers.rms_norm(x, tp["norm"], cfg.norm_eps).reshape(
        -1, x.shape[-1])
    _, expert_idx, _ = tmoe.route(xt, tp["router"], cfg)
    _, pos, keep = tmoe.positions(expert_idx, cfg.n_experts,
                                  tmoe.capacity(xt.shape[0], cfg))
    return expert_idx.numpy(), pos.numpy(), keep.numpy()


def _assert_layer_matches(jx, tcfg, jcfg, p, x):
    want, want_aux = jx.moe.moe_layer(p, jx.jnp.asarray(x), jcfg)
    tp = convert.params_from_numpy(p, "cpu")
    tx = torch.from_numpy(x)
    got, got_aux = tmoe.moe_layer(tp, tx, tcfg)
    assert got.dtype == torch.float32 and got_aux.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(float(got_aux), float(want_aux),
                               rtol=AUX_RTOL)
    jidx, jpos, jkeep = _jax_routing(jx, p, x, jcfg)
    tidx, tpos, tkeep = _port_routing(tp, tx, tcfg)
    np.testing.assert_array_equal(tidx, jidx)
    np.testing.assert_array_equal(tpos, jpos)
    np.testing.assert_array_equal(tkeep, jkeep)
    return tkeep


@pytest.mark.parametrize("capacity_factor", [4.0, 1.0])
@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_matches_jax(jx, arch, dispatch, capacity_factor):
    tcfg, jcfg = _cfgs(jx, arch, moe_dispatch=dispatch,
                       capacity_factor=capacity_factor)
    p = _params(jx, jcfg, seed=1)
    x = np.random.default_rng(2).standard_normal(
        (4, 16, tcfg.d_model)).astype(np.float32)
    keep = _assert_layer_matches(jx, tcfg, jcfg, p, x)
    # 64 tokens × top-2 over 8 experts: capacity 64 at factor 4, 16 at 1
    assert keep.all() == (capacity_factor == 4.0)


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_gradients_with_dropped_assignments_match_jax(jx, arch,
                                                          dispatch):
    """Capacity factor 1.0 drops assignments. The gradients of sum(out ·
    r) + aux with respect to x and every MoE leaf ≡ ``jax.grad`` of the
    reference's within 1e-5 + 1e-4·|ref|: through the dispatch (scatter
    into slot ``cap`` for the dropped, or the gather), the combine's
    gather at ``clamp(pos, cap − 1)`` under the kept mask, the gates of
    the stable-sort top-k and the aux loss's mean probabilities."""
    tcfg, jcfg = _cfgs(jx, arch, moe_dispatch=dispatch, capacity_factor=1.0)
    p = _params(jx, jcfg, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((4, 16, tcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    _, _, keep = _port_routing(convert.params_from_numpy(p, "cpu"),
                               torch.from_numpy(x), tcfg)
    assert 0 < (~keep).sum() < keep.size / 2         # some dropped

    def jloss(p, x):
        out, aux = jx.moe.moe_layer(p, x, jcfg)
        return jx.jnp.sum(out * r) + aux
    want_p, want_x = jx.jax.grad(jloss, argnums=(0, 1))(
        jx.jax.tree.map(jx.jnp.asarray, p), jx.jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in
          convert.params_from_numpy(p, "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = tmoe.moe_layer(tp, tx, tcfg)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum() + aux,
                                [tx, *tp.values()])
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(want_x),
                               atol=ATOL, rtol=1e-4, err_msg="x")
    for name, g in zip(tp, grads[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(want_p[name]),
                                   atol=ATOL, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("dispatch", ["scatter", "gather"])
def test_moe_layer_with_tied_router_columns_matches_jax(jx, dispatch):
    """Experts 1, 2 and 4 share one router column, so every token's
    probabilities tie among them: the order of the top-k, the positions
    in each expert and so which assignments a capacity of 1.0 drops
    follow ``jax.lax.top_k`` (lower index first)."""
    tcfg, jcfg = _cfgs(jx, "deepseek-v2-lite-16b", moe_dispatch=dispatch,
                       capacity_factor=1.0, top_k=3)
    p = _params(jx, jcfg, seed=3)
    p["router"][:, 2] = p["router"][:, 4] = p["router"][:, 1]
    p["router"] *= 20.0                 # the tied experts win more often
    x = np.random.default_rng(4).standard_normal(
        (2, 32, tcfg.d_model)).astype(np.float32)
    keep = _assert_layer_matches(jx, tcfg, jcfg, p, x)
    assert not keep.all()
    idx = _port_routing(convert.params_from_numpy(p, "cpu"),
                        torch.from_numpy(x), tcfg)[0]
    # the tied experts appear in ascending order wherever two of them do
    for row in idx:
        tied = [e for e in row if e in (1, 2, 4)]
        assert tied == sorted(tied), row


def test_top_k_orders_ties_as_jax(jx):
    probs = np.array([[.1, .3, .3, .2, .3, .05]], np.float32)
    want = jx.jax.lax.top_k(jx.jnp.asarray(probs), 3)
    got = tmoe.top_k(torch.from_numpy(probs), 3)
    assert got[1].tolist() == [[1, 2, 4]] == np.asarray(want[1]).tolist()
    # many rows of coarse values: ties everywhere
    rng = np.random.default_rng(5)
    probs = (rng.integers(0, 4, (500, 64)) / 4).astype(np.float32)
    want = jx.jax.lax.top_k(jx.jnp.asarray(probs), 6)
    got = tmoe.top_k(torch.from_numpy(probs), 6)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_capacity_equals_the_reference(jx):
    for arch in MOE_ARCHS:
        for factor in (1.0, 1.25, 4.0):
            tcfg = dataclasses.replace(TARCHS[arch], capacity_factor=factor)
            jcfg = dataclasses.replace(jx.ARCHS[arch],
                                       capacity_factor=factor)
            for t in list(range(1, 70)) + [255, 256, 1781, 2048, 8192]:
                assert tmoe.capacity(t, tcfg) == jx.moe.capacity(t, jcfg), \
                    (arch, factor, t)
    # a 4-slot decode step never drops; a 2,048-token prefill may
    cfg = TARCHS["deepseek-v2-lite-16b"]
    assert tmoe.capacity(4, cfg) == 8 and tmoe.capacity(2048, cfg) == 240


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_register_moe_infos_equal_the_reference(jx, arch):
    """The full configs' MoE leaves: paths, shapes, sharding placeholders
    (``expert_axes``), init kinds and stds (no allocation)."""
    tps = tlayers.ParamSet(dtype=torch.bfloat16)
    jps = jx.layers.ParamSet(dtype=jx.jnp.bfloat16)
    tmoe.register_moe(tps, "blocks/l0/moe", TARCHS[arch], (26,))
    jx.moe.register_moe(jps, "blocks/l0/moe", jx.ARCHS[arch], (26,))
    assert sorted(tps.infos) == sorted(jps.infos)
    for path, info in jps.infos.items():
        ti = tps.infos[path]
        assert (ti.shape, ti.spec, ti.init, ti.std) == \
            (info.shape, info.spec, info.init, info.std), path
    for upd in ({}, {"moe_ffn_unsharded": True}, {"n_experts": 16}):
        assert tmoe.expert_axes(dataclasses.replace(TARCHS[arch], **upd)) \
            == jx.moe.expert_axes(dataclasses.replace(jx.ARCHS[arch], **upd))


def test_single_expert_equals_dense():
    """top-1 over one expert (no drops) ≡ the plain SwiGLU MLP (the
    reference's MoE math oracle, tests/test_arch_smoke.py)."""
    cfg = dataclasses.replace(
        TARCHS["kimi-k2-1t-a32b"], n_experts=1, top_k=1, n_shared_experts=0,
        moe_d_ff=32, d_model=16, capacity_factor=2.0, router_aux_coef=0.0)
    ps = tlayers.ParamSet(dtype=torch.float32)
    tmoe.register_moe(ps, "moe", cfg, ())
    p = ps.init_params(torch.Generator().manual_seed(0))["moe"]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 8, 16)).astype(np.float32))
    out, aux = tmoe.moe_layer(p, x, cfg)
    xn = tlayers.rms_norm(x, p["norm"], cfg.norm_eps)
    want = x + tlayers.swiglu(xn, p["w_gate"][0], p["w_up"][0],
                              p["w_down"][0])
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=ATOL)
    assert float(aux) == 0.0


def test_gather_dispatch_equals_scatter_bit_for_bit():
    """Both dispatches fill the same (expert, position) slots with the same
    rows, so with drops (capacity factor 1.0) the outputs are bit-equal."""
    base = dataclasses.replace(
        TARCHS["kimi-k2-1t-a32b"], n_experts=8, top_k=2, n_shared_experts=1,
        moe_d_ff=32, d_model=16, capacity_factor=1.0)
    ps = tlayers.ParamSet(dtype=torch.float32)
    tmoe.register_moe(ps, "moe", base, ())
    p = ps.init_params(torch.Generator().manual_seed(0))["moe"]
    p["router"] *= 50.0                 # skewed routing: drops occur
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, 16)).astype(np.float32))
    keep = tmoe.positions(tmoe.route(tlayers.rms_norm(
        x, p["norm"], base.norm_eps).reshape(-1, 16), p["router"], base)[1],
        8, tmoe.capacity(64, base))[2]
    assert not keep.all()
    out_s, aux_s = tmoe.moe_layer(
        p, x, dataclasses.replace(base, moe_dispatch="scatter"))
    out_g, aux_g = tmoe.moe_layer(
        p, x, dataclasses.replace(base, moe_dispatch="gather"))
    assert torch.equal(out_s, out_g) and torch.equal(aux_s, aux_g)


def test_scatter_dispatch_is_deterministic_under_the_flag():
    """The scatter's write runs under ``torch.use_deterministic_algorithms``
    and gives the same bits."""
    cfg = dataclasses.replace(treduced(TARCHS["deepseek-v2-lite-16b"]),
                              capacity_factor=1.0)
    ps = tlayers.ParamSet(dtype=torch.float32)
    tmoe.register_moe(ps, "moe", cfg, ())
    p = ps.init_params(torch.Generator().manual_seed(2))["moe"]
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    free, _ = tmoe.moe_layer(p, x, cfg)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        strict, _ = tmoe.moe_layer(p, x, cfg)
    finally:
        torch.use_deterministic_algorithms(prev)
    assert torch.equal(free, strict)
