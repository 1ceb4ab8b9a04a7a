"""Each behavior's effects ≡ the reference's, from one shared pool, context
and key.

Uniform draws are bit-exact, so every mask, count and integer channel must
be equal; normal draws go through log/cos and may differ by an ulp, so
float channels are held to 1e-5 (the engine tests hold whole steps to
1e-4).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import behaviors as jb, engine as jeng  # noqa: E402
from repro_torch.core import behaviors as tb, engine as teng  # noqa: E402

TOL = 1e-5
DOMAIN = (0.0, 40.0)


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _state(jbeh, tbeh, seed=0, cap=256, n=200, types=(0, 1, 2)):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, 39.5, (n, 3)).astype(np.float32)
    pos[:5, 0] = 39.99                                 # walks hit the wall
    kw = dict(position=pos, diameter=rng.uniform(1, 3, n).astype(np.float32),
              agent_type=rng.choice(types, n).astype(np.int32))
    extra = {}
    if any(isinstance(b, jb.Infection) for b in jbeh):
        extra["infect_timer"] = rng.integers(-1, 4, n).astype(np.int32)
    if any(isinstance(b, jb.NeuriteGrowth) for b in jbeh):
        d = rng.standard_normal((n, 3)).astype(np.float32)
        extra["direction"] = d / np.linalg.norm(d, axis=1, keepdims=True)
        extra["path_len"] = rng.uniform(0, 2.5, n).astype(np.float32)
    jpool = jeng.stage_pool(cap, jbeh, extra_init=extra, **kw)
    tpool = teng.stage_pool(cap, tbeh, extra_init=extra, device="cpu",
                            **kw)
    alive = np.arange(cap) < n
    alive[rng.choice(n, 10, replace=False)] = False    # holes: not owned
    jpool.alive = jnp.asarray(alive)
    tpool.alive = torch.from_numpy(alive)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    return jpool, tpool, key, tkey, rng


def _ctx(mod, xp, pool, gradient=None, results=None, apply=None):
    tensor = jnp.asarray if xp is jnp else torch.tensor
    return mod.StepContext(
        config=None, dt=0.3,
        domain_lo=tensor((DOMAIN[0],) * 3), domain_hi=tensor((DOMAIN[1],) * 3),
        iteration=tensor(4), owned=pool.alive, neighbor_apply=apply,
        substance_gradient=gradient, substance_value=None,
        neighbor_results=results or {})


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_effects(want, got):
    def same(w, g, what):
        w, g = _np(w), _np(g)
        assert g.dtype == w.dtype and g.shape == w.shape, what
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=what)
        else:
            np.testing.assert_array_equal(g, w, err_msg=what)
    assert set(want.set_channels) == set(got.set_channels)
    for k in want.set_channels:
        same(want.set_channels[k], got.set_channels[k], k)
    for name in ("birth_valid", "death_mask", "secretion"):
        w, g = getattr(want, name), getattr(got, name)
        assert (w is None) == (g is None), name
        if w is not None:
            same(w, g, name)
    assert (want.birth_channels is None) == (got.birth_channels is None)
    if want.birth_channels is not None:
        assert set(want.birth_channels) == set(got.birth_channels)
        for k in want.birth_channels:
            same(want.birth_channels[k], got.birth_channels[k], "birth " + k)


@pytest.mark.parametrize("name,kw", [
    ("RandomWalk", dict(sigma=0.8)),
    ("RandomWalk", dict(sigma=2.0, applies_to=1)),
    ("RandomDeath", dict(rate=0.2)),
    ("RandomDeath", dict(rate=0.5, applies_to=2)),
    ("Secretion", dict(rate=2.0)),
    ("Secretion", dict(rate=1.5, applies_to=0)),
    ("GrowDivide", dict(rate=3.0, threshold_diameter=3.5)),
])
def test_simple_behaviors_match(name, kw):
    jbeh, tbeh = getattr(jb, name)(**kw), getattr(tb, name)(**kw)
    jpool, tpool, key, tkey, _ = _state([jbeh], [tbeh])
    want = jbeh(_ctx(jeng, jnp, jpool), jpool, key)
    got = tbeh(_ctx(teng, torch, tpool), tpool, tkey)
    _assert_effects(want, got)


@pytest.mark.parametrize("fused", [True, False])
def test_infection_matches(fused):
    kw = dict(radius=3.0, beta=0.6, recovery_time=5)
    jbeh, tbeh = jb.Infection(**kw), tb.Infection(**kw)
    jpool, tpool, key, tkey, rng = _state([jbeh], [tbeh])
    exposed = rng.integers(0, 3, jpool.capacity).astype(np.int32)
    jres = {"exposed": jnp.asarray(exposed)}
    tres = {"exposed": torch.from_numpy(exposed)}
    if fused:
        jctx = _ctx(jeng, jnp, jpool, results={"infection": jres})
        tctx = _ctx(teng, torch, tpool, results={"infection": tres})
    else:       # the sequential path asks neighbor_apply for its sweep
        jctx = _ctx(jeng, jnp, jpool, apply=lambda fn, specs: jres)
        tctx = _ctx(teng, torch, tpool, apply=lambda fn, specs: tres)
    want = jbeh(jctx, jpool, key)
    got = tbeh(tctx, tpool, tkey)
    _assert_effects(want, got)
    t = got.set_channels["agent_type"]
    assert bool((t == tb.INFECTED).any()) and bool((t == tb.RECOVERED).any())
    assert tb.SUSCEPTIBLE == jb.SUSCEPTIBLE and tb.INFECTED == jb.INFECTED \
        and tb.RECOVERED == jb.RECOVERED


def test_infection_kernel_is_inclusive_at_the_radius():
    """dist² ≤ r²: a neighbor at exactly the radius exposes the query."""
    fn = tb.Infection(radius=3.0).neighbor_kernels()[0].pair_fn
    q = {"position": torch.zeros((1, 3))}
    nbr = {"position": torch.tensor([[[3.0, 0.0, 0.0], [0.0, 3.0001, 0.0]]]),
           "alive": torch.ones((1, 2), dtype=torch.bool),
           "agent_type": torch.full((1, 2), tb.INFECTED, dtype=torch.int32)}
    valid = torch.tensor([[True, True]])
    assert fn(q, nbr, valid, torch.zeros(1, dtype=torch.int32)
              )["exposed"].tolist() == [1]
    valid = torch.tensor([[False, True]])
    assert fn(q, nbr, valid, torch.zeros(1, dtype=torch.int32)
              )["exposed"].tolist() == [0]


def test_chemotaxis_matches():
    jbeh, tbeh = jb.Chemotaxis(speed=0.35), tb.Chemotaxis(speed=0.35)
    jpool, tpool, key, tkey, rng = _state([jbeh], [tbeh])
    g = rng.standard_normal((jpool.capacity, 3)).astype(np.float32)
    g[:3] = 0.0                                     # a flat spot
    want = jbeh(_ctx(jeng, jnp, jpool, gradient=lambda p: jnp.asarray(g)),
                jpool, key)
    got = tbeh(_ctx(teng, torch, tpool,
                    gradient=lambda p: torch.from_numpy(g)), tpool, tkey)
    _assert_effects(want, got)


@pytest.mark.parametrize("seed", [0, 1])
def test_neurite_growth_matches(seed):
    kw = dict(speed=0.8, noise=0.2, bifurcation_prob=0.3)
    jbeh, tbeh = jb.NeuriteGrowth(**kw), tb.NeuriteGrowth(**kw)
    types = (tb.SOMA, tb.NEURITE_SEGMENT, tb.GROWTH_CONE)
    jpool, tpool, key, tkey, _ = _state([jbeh], [tbeh], seed=seed,
                                        types=types)
    want = jbeh(_ctx(jeng, jnp, jpool), jpool, key)
    got = tbeh(_ctx(teng, torch, tpool), tpool, tkey)
    _assert_effects(want, got)
    valid = got.birth_valid
    c = tpool.capacity
    assert valid.shape == (2 * c,)
    assert bool(valid[:c].any()) and bool(valid[c:].any())


def test_extra_channel_specs_match():
    for name in ("Infection", "NeuriteGrowth", "RandomWalk", "Secretion"):
        want = getattr(jb, name)().extra_specs()
        got = getattr(tb, name)().extra_specs()
        assert set(want) == set(got)
        for k, (sfx, dt, fill) in want.items():
            assert got[k][0] == sfx and got[k][2] == fill
            assert str(got[k][1]).split(".")[-1] == np.dtype(dt).name
