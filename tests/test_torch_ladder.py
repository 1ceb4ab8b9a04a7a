"""Capacity ladder and narrowed dtypes: the port ≡ the reference.

The single-device tests of tests/test_ladder.py, each run through the port
and, where they compare trajectories or schedules, through the reference
on the same numpy inputs:

  * the restage building blocks (``grow_pool`` keeps the live prefix and
    the dtypes, ``repack_slabs``, ``next_rung``) equal the reference's;
  * narrowed pools cost the reference's bytes per agent, and each
    behavior's one-step effects on a bf16/f16/int16 pool equal the
    reference's bit for bit (a Python scalar meets a narrowed channel as
    JAX's weak-typed scalar does: rounded to the channel's dtype first);
  * a ladder run equals, bit for bit, a run pre-sized at its final rungs,
    and its rung schedule equals the reference's — across capacity,
    ``max_per_run`` and ``max_pairs`` rungs, with forces in K1's plain
    version and in the streamed sweep;
  * ``max_capacity`` raises ``CapacityExhausted`` with the last-good state
    attached, and a step leaves its input state unchanged.

Each reference ladder compiles once per rung, so the reference side of a
comparison runs once per module (module-scoped fixtures).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import behaviors as jb  # noqa: E402
from repro.core import compaction as jcomp, engine as jeng  # noqa: E402
from repro.core import agents as jagents, grid as jgrid  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import behaviors as tb  # noqa: E402
from repro_torch.core import compaction as tcomp, engine as teng  # noqa: E402
from repro_torch.core import agents as tagents, grid as tgrid  # noqa: E402
from repro_torch.core import rand as trand  # noqa: E402

LEAN = dict(aux_float="bfloat16", compact_ints=True)


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True, scope="module")
def _partitionable_keys():
    """The port splits keys as jax does with jax_threefry_partitionable
    on (jax ≥ 0.5's default)."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", prev)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.float().numpy()
        return x.numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _live_sorted(pool):
    a = _np(pool.alive).astype(bool)
    p = _np(pool.position)[a]
    o = np.lexsort(p.T)
    return p[o], _np(pool.diameter)[a][o], _np(pool.agent_type)[a][o]


def _same_live(a, b):
    for x, y, what in zip(_live_sorted(a), _live_sorted(b),
                          ("position", "diameter", "agent_type")):
        np.testing.assert_array_equal(x, y, err_msg=what)


def _schedule(rungs):
    return [(r["iteration"], r["field"], r["old"], r["new"]) for r in rungs]


# ---------------------------------------------------------------------------
# restage and dtype-policy building blocks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("old,demand,factor,round_to", [
    (96, 97, 2.0, 32), (96, 500, 2.0, 32), (384, 399, 2.0, 1),
    (1024, 1025, 2.0, 64), (1024, 10_000, 1.5, 64), (7, 3, 1.1, 1),
    (1, 0, 1.0, 1), (100, 1000, 3.0, 7)])
def test_next_rung_matches_reference(old, demand, factor, round_to):
    assert teng.next_rung(old, demand, factor, round_to) == \
        jeng.next_rung(old, demand, factor, round_to)


def _lean_pools(cap=8, policy=LEAN):
    rng = np.random.default_rng(0)
    pos = rng.uniform(0, 10, (5, 3)).astype(np.float32)
    kw = dict(position=pos, diameter=rng.uniform(1, 3, 5).astype(np.float32),
              agent_type=np.arange(5, dtype=np.int32))
    jp = jagents.make_pool(cap, extra_specs={"t": ((), jnp.int32, 7),
                                             "f": ((3,), jnp.float32, 0.5)},
                           policy=jagents.DtypePolicy(**policy), **kw)
    tp = tagents.make_pool(cap, extra_specs={"t": ((), torch.int32, 7),
                                             "f": ((3,), torch.float32, 0.5)},
                           policy=tagents.DtypePolicy(**policy),
                           device="cpu", **kw)
    return jp, tp


@pytest.mark.parametrize("policy", [dict(), LEAN,
                                    dict(aux_float="float16",
                                         compact_ints=True)])
def test_grow_pool_preserves_live_prefix_and_dtypes(policy):
    jp, tp = _lean_pools(policy=policy)
    jg = jcomp.grow_pool(jp, 32)
    tg = tcomp.grow_pool(tp, 32)
    assert tg.capacity == 32
    for k, v in tp.channels().items():
        g = tg.channels()[k]
        assert g.dtype == v.dtype, k
        assert torch.equal(g[:8], v), k
        np.testing.assert_array_equal(_np(g), _np(jg.channels()[k]),
                                      err_msg=k)
        assert str(g.dtype).split(".")[-1] == str(jg.channels()[k].dtype), k
    assert not bool(tg.alive[8:].any())
    assert int(tg.n_live) == int(tp.n_live) == 5
    with pytest.raises(ValueError):
        tcomp.grow_channels(tp.channels(), 4)
    same = tp.channels()
    assert tcomp.grow_channels(same, 8) is same


def test_grow_channels_does_not_alias_its_input():
    ch = {"a": torch.arange(12, dtype=torch.float32).reshape(6, 2),
          "alive": torch.tensor([True, True, False, True, False, False])}
    out = tcomp.grow_channels(ch, 10)
    out["a"][0, 0] = 99.0
    assert float(ch["a"][0, 0]) == 0.0
    assert out["a"].shape == (10, 2) and not bool(out["alive"][6:].any())


def test_repack_slabs_matches_reference():
    rng = np.random.default_rng(2)
    ch = {"position": rng.uniform(0, 9, (12, 3)).astype(np.float32),
          "alive": rng.integers(0, 2, 12).astype(bool),
          "agent_type": rng.integers(0, 5, 12).astype(np.int16)}
    want = jcomp.repack_slabs({k: jnp.asarray(v) for k, v in ch.items()},
                              3, 4, 6)
    got = tcomp.repack_slabs(ch, 3, 4, 6)
    for k in ch:
        assert isinstance(got[k], np.ndarray)
        assert got[k].dtype == np.asarray(want[k]).dtype
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    with pytest.raises(ValueError):
        tcomp.repack_slabs(ch, 3, 4, 2)


@pytest.mark.parametrize("policy", [dict(), LEAN,
                                    dict(aux_float="float16")])
def test_dtype_policy_bytes_per_agent_match_reference(policy):
    """benchmarks/capacity.py's _bytes_per_agent: 32 for float32, 26 lean."""
    def per_agent(pool, nbytes):
        return sum(nbytes(v) for v in pool.channels().values()) / 8.0
    jp = jagents.make_pool(8, policy=jagents.DtypePolicy(**policy))
    tp = tagents.make_pool(8, policy=tagents.DtypePolicy(**policy),
                           device="cpu")
    got = per_agent(tp, lambda v: v.numel() * v.element_size())
    assert got == per_agent(jp, lambda v: v.nbytes)
    if policy == LEAN:
        assert got == 26.0
        assert tp.position.dtype == torch.float32       # never narrowed
        assert tp.born_iter.dtype == torch.int32        # iteration counter
        assert tp.force_nnz.dtype == torch.int16
    elif not policy:
        assert got == 32.0


def test_rand_rows_are_capacity_stable():
    key = trand.prng_key(42, "cpu")
    assert torch.equal(trand.uniform_rows(key, 50),
                       trand.uniform_rows(key, 5000)[:50])
    assert torch.equal(trand.normal_rows(key, 50, 3),
                       trand.normal_rows(key, 700, 3)[:50])


# ---------------------------------------------------------------------------
# narrowed arithmetic: each behavior one step, bit for bit
# ---------------------------------------------------------------------------

def _behavior_pools(policy, jbeh, tbeh, n=200, cap=256, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0.5, 39.5, (n, 3)).astype(np.float32)
    kw = dict(position=pos, diameter=rng.uniform(1, 6, n).astype(np.float32),
              agent_type=rng.choice((0, 1, 2, 12), n).astype(np.int32))
    extra = {}
    if isinstance(jbeh, jb.Infection):
        extra["infect_timer"] = rng.integers(-1, 4, n).astype(np.int32)
    if isinstance(jbeh, jb.NeuriteGrowth):
        d = rng.standard_normal((n, 3)).astype(np.float32)
        extra["direction"] = d / np.linalg.norm(d, axis=1, keepdims=True)
        extra["path_len"] = rng.uniform(0, 2.5, n).astype(np.float32)
    jpool = jeng.stage_pool(cap, [jbeh], extra_init=extra,
                            policy=jagents.DtypePolicy(**policy), **kw)
    tpool = teng.stage_pool(cap, [tbeh], extra_init=extra,
                            policy=tagents.DtypePolicy(**policy),
                            device="cpu", **kw)
    key = jax.random.fold_in(jax.random.PRNGKey(seed), 7)
    tkey = torch.from_numpy(np.asarray(key).astype(np.int64))
    exposed = rng.integers(0, 3, cap).astype(np.int32)
    return jpool, tpool, key, tkey, exposed


def _ctx(mod, xp, pool, results):
    tensor = jnp.asarray if xp is jnp else torch.tensor
    return mod.StepContext(
        config=None, dt=0.3, domain_lo=tensor((0.0,) * 3),
        domain_hi=tensor((40.0,) * 3), iteration=tensor(4),
        owned=pool.alive, neighbor_apply=None,
        substance_gradient=lambda p: p * 0.01, substance_value=None,
        neighbor_results=results)


def _bits(x):
    """A channel's bits: narrowed floats by their 16-bit patterns."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            return x.view(torch.int16).numpy(), str(x.dtype).split(".")[-1]
        return x.numpy(), str(x.numpy().dtype)
    x = np.asarray(x)
    if x.dtype.name in ("bfloat16", "float16"):
        return x.view(np.int16), x.dtype.name
    return x, str(x.dtype)


@pytest.mark.parametrize("aux", ["bfloat16", "float16"])
@pytest.mark.parametrize("name,kw", [
    ("GrowDivide", dict(rate=0.55, threshold_diameter=6.0)),
    ("GrowDivide", dict(rate=3.0, threshold_diameter=3.5)),
    ("RandomWalk", dict(sigma=0.6)),
    ("Infection", dict(radius=3.0, beta=0.6, recovery_time=5)),
    ("Chemotaxis", dict(speed=0.35)),
    ("NeuriteGrowth", dict(speed=0.8, noise=0.2, bifurcation_prob=0.3,
                           segment_every=1.0)),
])
def test_behavior_on_a_narrowed_pool_matches_reference_bits(aux, name, kw):
    policy = dict(aux_float=aux, compact_ints=True)
    jbeh, tbeh = getattr(jb, name)(**kw), getattr(tb, name)(**kw)
    jpool, tpool, key, tkey, exposed = _behavior_pools(policy, jbeh, tbeh)
    jres = {"infection": {"exposed": jnp.asarray(exposed)}}
    tres = {"infection": {"exposed": torch.from_numpy(exposed)}}
    want = jbeh(_ctx(jeng, jnp, jpool, jres), jpool, key)
    got = tbeh(_ctx(teng, torch, tpool, tres), tpool, tkey)
    pairs = [(f"set {k}", want.set_channels[k], got.set_channels[k])
             for k in want.set_channels]
    assert set(want.set_channels) == set(got.set_channels)
    if want.birth_channels is not None:
        pairs += [(f"birth {k}", want.birth_channels[k],
                   got.birth_channels[k]) for k in want.birth_channels]
        pairs.append(("birth_valid", want.birth_valid, got.birth_valid))
    for what, w, g in pairs:
        wb, wd = _bits(w)
        gb, gd = _bits(g)
        assert gd == wd, f"{what}: dtype {gd} != {wd}"
        if what.endswith("position") or what.endswith("direction"):
            # float32 from the normal draws: log/cos may differ by an ulp
            np.testing.assert_allclose(_np(g), _np(w), atol=1e-5, rtol=1e-5,
                                       err_msg=what)
        else:
            np.testing.assert_array_equal(gb, wb, err_msg=what)


@pytest.mark.parametrize("aux", ["bfloat16", "float16"])
def test_pair_force_on_narrowed_diameters_matches_reference(aux):
    from repro.core import forces as jf
    from repro_torch.core import forces as tf
    rng = np.random.default_rng(3)
    b, m = 64, 24
    qp = rng.uniform(0, 6, (b, 3)).astype(np.float32)
    npos = rng.uniform(0, 6, (b, m, 3)).astype(np.float32)
    qd = rng.uniform(1, 4, b).astype(np.float32)
    nd = rng.uniform(1, 4, (b, m)).astype(np.float32)
    qt = rng.integers(0, 2, b).astype(np.int16)
    nt = rng.integers(0, 2, (b, m)).astype(np.int16)
    valid = rng.random((b, m)) < 0.8
    adh = np.array([[0.1, 0.3], [0.3, 0.2]], np.float32)
    for adhesion in (None, adh):
        want = jf.pair_force(
            jnp.asarray(qp), jnp.asarray(qd).astype(aux), jnp.asarray(qt),
            jnp.asarray(npos), jnp.asarray(nd).astype(aux), jnp.asarray(nt),
            jnp.asarray(valid), jf.ForceParams(k_rep=1.7),
            None if adhesion is None else jnp.asarray(adhesion))
        tdt = getattr(torch, aux)
        got = tf.pair_force(
            torch.from_numpy(qp), torch.from_numpy(qd).to(tdt),
            torch.from_numpy(qt), torch.from_numpy(npos),
            torch.from_numpy(nd).to(tdt), torch.from_numpy(nt),
            torch.from_numpy(valid), tf.ForceParams(k_rep=1.7),
            None if adhesion is None else torch.from_numpy(adhesion))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-6, rtol=1e-5)


# ---------------------------------------------------------------------------
# overflow provenance
# ---------------------------------------------------------------------------

def test_overflow_provenance_demands_match_reference():
    rng = np.random.default_rng(1)
    n = 48
    kw = dict(capacity=n, domain_lo=(0, 0, 0), domain_hi=(24.0,) * 3,
              interaction_radius=4.0, dt=1.0, max_per_box=2, query_chunk=64,
              use_forces=False)
    pos = rng.uniform(1, 9, (n, 3)).astype(np.float32)
    dia = np.full(n, 5.0, np.float32)
    jsim = jeng.Simulation(jeng.EngineConfig(**kw),
                           [jb.GrowDivide(rate=3.0, threshold_diameter=6.0)])
    tsim = teng.Simulation(teng.EngineConfig(**kw),
                           [tb.GrowDivide(rate=3.0, threshold_diameter=6.0)],
                           device="cpu")
    js = jsim.step(jsim.init_state(pos, diameter=dia)).stats
    ts = tsim.step(tsim.init_state(pos, diameter=dia)).stats
    for f in ts.keys():
        assert int(ts[f]) == int(js[f]), f
    assert int(ts["birth_overflow"]) > 0
    assert int(ts["capacity_demand"]) == int(ts["n_live"]) + int(
        ts["birth_overflow"])
    assert int(ts["box_overflow"]) == 1
    assert int(ts["box_demand"]) > tsim.spec.run_capacity


# ---------------------------------------------------------------------------
# the ladder: bit parity with a pre-sized pool, the reference's schedule
# ---------------------------------------------------------------------------

_BASE = dict(domain_lo=(0, 0, 0), domain_hi=(96.0,) * 3,
             interaction_radius=4.0, dt=1.0, max_per_box=4, query_chunk=256)
_STEPS = 9


def _scenario(mod):
    return [mod.GrowDivide(rate=0.8, threshold_diameter=6.0),
            mod.RandomWalk(sigma=0.3), mod.RandomDeath(rate=0.01)]


def _seeds():
    rng = np.random.default_rng(0)
    return (rng.uniform(4, 92, (64, 3)).astype(np.float32),
            np.full(64, 5.2, np.float32))


@pytest.fixture(scope="module")
def reference_ladder():
    """The reference's ladder run of tests/test_ladder.py, once."""
    pos, dia = _seeds()
    lad = jeng.CapacityLadder(
        jeng.EngineConfig(capacity=96, force=jb_force(0.5), **_BASE),
        _scenario(jb), jeng.LadderConfig(growth_factor=2.0, round_to=32))
    st = lad.run(lad.init_state(pos, diameter=dia), _STEPS)
    return lad, st


def jb_force(max_displacement):
    from repro.core import ForceParams
    return ForceParams(max_displacement=max_displacement)


def tb_force(max_displacement):
    from repro_torch.core import ForceParams
    return ForceParams(max_displacement=max_displacement)


@pytest.mark.parametrize("force_impl", ["k1", "streamed"])
def test_ladder_bit_parity_vs_presized(force_impl, reference_ladder):
    pos, dia = _seeds()
    lad = teng.CapacityLadder(
        teng.EngineConfig(capacity=96, force=tb_force(0.5),
                          force_impl=force_impl, **_BASE),
        _scenario(tb), teng.LadderConfig(growth_factor=2.0, round_to=32),
        device="cpu")
    st = lad.run(lad.init_state(pos, diameter=dia), _STEPS)
    fields = {r["field"] for r in lad.rungs}
    assert "capacity" in fields, lad.rungs
    assert lad.recompiles == len(lad.rungs) >= 3

    jlad, jst = reference_ladder
    assert _schedule(lad.rungs) == _schedule(jlad.rungs)
    assert lad.config.capacity == jlad.config.capacity
    assert int(st.stats["n_live"]) == int(jst.stats["n_live"])

    sim = teng.Simulation(lad.config, _scenario(tb), device="cpu")
    st2 = sim.run(sim.init_state(pos, diameter=dia), _STEPS,
                  check_overflow=True)
    assert int(st.stats["n_live"]) == int(st2.stats["n_live"]) > 64
    _same_live(st.pool, st2.pool)


@pytest.fixture(scope="module")
def reference_box_rung():
    rng = np.random.default_rng(3)
    pos = rng.uniform(1, 23, (256, 3)).astype(np.float32)
    dia = np.full(256, 3.0, np.float32)
    lad = jeng.CapacityLadder(_box_cfg(jeng, jb_force),
                              [jb.GrowDivide(rate=0.5, threshold_diameter=5.0)])
    lad.run(lad.init_state(pos, diameter=dia), 5)
    return lad, pos, dia


def _box_cfg(mod, force, **kw):
    return mod.EngineConfig(capacity=1024, domain_lo=(0, 0, 0),
                            domain_hi=(24.0,) * 3, interaction_radius=4.0,
                            dt=0.5, max_per_box=3, query_chunk=128,
                            force=force(0.5), **kw)


@pytest.mark.parametrize("force_impl", ["k1", "streamed"])
def test_ladder_box_rung_bit_parity(force_impl, reference_box_rung):
    """A max_per_run rung mid-run: the streamed sweep at a wider run width
    (more zero lanes) and K1 must give bit-identical trajectories."""
    jlad, pos, dia = reference_box_rung
    lad = teng.CapacityLadder(_box_cfg(teng, tb_force, force_impl=force_impl),
                              [tb.GrowDivide(rate=0.5, threshold_diameter=5.0)],
                              device="cpu")
    st = lad.run(lad.init_state(pos, diameter=dia), 5)
    assert any(r["field"] == "max_per_run" for r in lad.rungs), lad.rungs
    assert _schedule(lad.rungs) == _schedule(jlad.rungs)
    sim = teng.Simulation(lad.config,
                          [tb.GrowDivide(rate=0.5, threshold_diameter=5.0)],
                          device="cpu")
    st2 = sim.run(sim.init_state(pos, diameter=dia), 5, check_overflow=True)
    _same_live(st.pool, st2.pool)
    assert torch.equal(st.pool.force_nnz, st2.pool.force_nnz)


def _sir(mod, sim, n, pos):
    types = np.zeros(n, np.int32)
    types[: n // 20] = mod.INFECTED
    return sim.init_state(pos, diameter=np.full(n, 2.5, np.float32),
                          agent_type=types,
                          extra_init={"infect_timer": np.full(n, 8, np.int32)})


def _pl_cfg(mod, grid, n, max_pairs, **kw):
    return mod.EngineConfig(capacity=n, domain_lo=(0, 0, 0),
                            domain_hi=(48.0,) * 3, interaction_radius=3.0,
                            max_per_box=32, query_chunk=256,
                            pairlist=grid.PairListConfig(
                                skin=kw.pop("skin", 0.0),
                                max_pairs=max_pairs), **kw)


@pytest.fixture(scope="module")
def reference_pair_rungs():
    """tests/test_pairlist.py's max_pairs rung runs (every step, and the
    every_k cache), once each."""
    out = {}
    for cached in (False, True):
        n = 900
        rng = np.random.default_rng(5 if cached else 4)
        pos = rng.uniform(2, 46, (n, 3)).astype(np.float32)
        kw = {}
        if cached:
            kw = dict(skin=0.9, rebuild=jgrid.RebuildPolicy(
                mode="every_k", k=8, displacement_bound=0.45))
        lad = jeng.CapacityLadder(
            _pl_cfg(jeng, jgrid, n, 2, **kw),
            [jb.Infection(radius=3.0, beta=0.4, recovery_time=8)])
        st = _sir(jb, lad, n, pos)
        for _ in range(6 if cached else 4):
            st = lad.step(st)
        out[cached] = (lad, pos)
    return out


@pytest.mark.parametrize("force_impl", ["k1", "streamed"])
@pytest.mark.parametrize("cached", [False, True])
def test_max_pairs_rung_rewind_bit_parity(cached, force_impl,
                                          reference_pair_rungs):
    """A max_pairs rung: the pair-list sweep at a wider list width must
    give what a pre-sized run gives, bit for bit; under every_k the cached
    list is grown by zero padding."""
    jlad, pos = reference_pair_rungs[cached]
    n, steps = 900, (6 if cached else 4)
    kw = dict(force_impl=force_impl)
    if cached:
        kw.update(skin=0.9, rebuild=tgrid.RebuildPolicy(
            mode="every_k", k=8, displacement_bound=0.45))
    beh = lambda: [tb.Infection(radius=3.0, beta=0.4, recovery_time=8)]
    lad = teng.CapacityLadder(_pl_cfg(teng, tgrid, n, 2, **dict(kw)), beh(),
                              device="cpu")
    st = _sir(tb, lad, n, pos)
    for _ in range(steps):
        st = lad.step(st)
    assert any(r["field"] == "max_pairs" for r in lad.rungs), lad.rungs
    assert _schedule(lad.rungs) == _schedule(jlad.rungs)
    grown = lad.config.pairlist.max_pairs
    pre = teng.Simulation(_pl_cfg(teng, tgrid, n, grown, **dict(kw)), beh(),
                          device="cpu")
    sp = _sir(tb, pre, n, pos)
    for _ in range(steps):
        sp = pre.step(sp)
    for ch in ("position", "agent_type", "force_nnz"):
        assert torch.equal(getattr(st.pool, ch), getattr(sp.pool, ch)), ch


def test_ladder_max_capacity_raises_with_state_attached():
    rng = np.random.default_rng(5)
    pos = rng.uniform(4, 92, (64, 3)).astype(np.float32)
    lad = teng.CapacityLadder(
        teng.EngineConfig(capacity=96, force=tb_force(0.5), **_BASE),
        [tb.GrowDivide(rate=2.0, threshold_diameter=6.0)],
        teng.LadderConfig(max_capacity=128), device="cpu")
    st = lad.init_state(pos, diameter=np.full(64, 5.5, np.float32))
    with pytest.raises(RuntimeError, match="ladder exhausted") as e:
        lad.run(st, 6)
    exc = e.value
    assert isinstance(exc, teng.CapacityExhausted)
    assert exc.state is not None and exc.stats is not None
    assert exc.iteration == int(exc.state.iteration)
    assert exc.rung > exc.max_capacity == 128 and exc.demand > 96
    assert int(exc.stats["birth_overflow"]) > 0
    lad.sim.step(exc.state)                  # the carried state steps


def test_ladder_reads_the_flags_once_a_step(monkeypatch):
    """_diagnose reads every flag and demand in one host transfer."""
    pos, dia = _seeds()
    lad = teng.CapacityLadder(
        teng.EngineConfig(capacity=96, force=tb_force(0.5), **_BASE),
        _scenario(tb), device="cpu")
    st = lad.init_state(pos, diameter=dia)
    calls = []
    orig = torch.Tensor.tolist

    def counting(self):
        calls.append(tuple(self.shape))
        return orig(self)
    monkeypatch.setattr(torch.Tensor, "tolist", counting)
    lad.step(st)
    monkeypatch.undo()
    assert calls and all(c == (len(lad._READ),) for c in calls)
    assert len(calls) == 1 + lad.recompiles


# ---------------------------------------------------------------------------
# narrowed trajectories
# ---------------------------------------------------------------------------

def _lean_sim(mod, policy, force_impl=None, device=None):
    kw = dict(capacity=512, domain_lo=(0, 0, 0), domain_hi=(64.0,) * 3,
              interaction_radius=4.0, dt=0.5, max_per_box=16,
              query_chunk=256, dtypes=mod.DtypePolicy(**policy),
              force=(jb_force if mod is jeng else tb_force)(0.5))
    if force_impl is not None:
        kw["force_impl"] = force_impl
    beh = [(jb if mod is jeng else tb).GrowDivide(rate=0.25,
                                                  threshold_diameter=4.5)]
    if mod is jeng:
        return mod.Simulation(mod.EngineConfig(**kw), beh)
    return mod.Simulation(mod.EngineConfig(**kw), beh, device=device)


def _lean_seeds():
    rng = np.random.default_rng(7)
    return (rng.uniform(4, 60, (200, 3)).astype(np.float32),
            np.full(200, 3.0, np.float32))


@pytest.fixture(scope="module")
def reference_lean():
    pos, dia = _lean_seeds()
    out = {}
    for name, policy in (("f32", {}), ("lean", LEAN)):
        sim = _lean_sim(jeng, policy)
        out[name] = sim.run(sim.init_state(pos, diameter=dia), 6,
                            check_overflow=True)
    return out


@pytest.mark.parametrize("force_impl", ["k1", "streamed"])
def test_dtype_policy_trajectory_parity_within_tolerance(force_impl,
                                                         reference_lean):
    """bf16 aux channels trade precision for bytes: the lean run tracks the
    float32 run (the reference test's tolerance: counts within 5%,
    positions within 1.5), and steps as the reference's lean run does."""
    pos, dia = _lean_seeds()
    s32 = _lean_sim(teng, {}, force_impl, "cpu")
    lean = _lean_sim(teng, LEAN, force_impl, "cpu")
    st32 = s32.run(s32.init_state(pos, diameter=dia), 6, check_overflow=True)
    stbf = lean.run(lean.init_state(pos, diameter=dia), 6,
                    check_overflow=True)
    assert stbf.pool.diameter.dtype == torch.bfloat16
    assert stbf.pool.force_nnz.dtype == torch.int16
    assert stbf.pool.agent_type.dtype == torch.int16
    n32, nbf = int(st32.stats["n_live"]), int(stbf.stats["n_live"])
    assert abs(n32 - nbf) <= 0.05 * n32, (n32, nbf)
    if n32 == nbf:
        p1, _, _ = _live_sorted(st32.pool)
        p2, _, _ = _live_sorted(stbf.pool)
        assert float(np.abs(p1 - p2).max()) < 1.5
    # the port's lean run against the reference's: integers equal, floats
    # 1e-4 (the engine tests' tolerance between the two packages)
    want = reference_lean["lean"]
    for f in stbf.stats.keys():
        assert int(stbf.stats[f]) == int(want.stats[f]), f
    for k, w in want.pool.channels().items():
        g = stbf.pool.channels()[k]
        wn, gn = _np(w), _np(g)
        if wn.dtype.kind == "f":
            np.testing.assert_allclose(gn, wn, atol=1e-4, rtol=1e-4,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(gn, wn, err_msg=k)


def test_lean_state_crosses_packages_bit_for_bit():
    """convert carries bf16/f16/int16 channels both ways, bit for bit."""
    import ml_dtypes
    for policy in (LEAN, dict(aux_float="float16", compact_ints=True)):
        pos, dia = _lean_seeds()
        sim = _lean_sim(jeng, policy)
        st = sim.step(sim.init_state(pos, diameter=dia))
        leaves = {"pool": {k: np.asarray(v)
                           for k, v in st.pool.channels().items()},
                  "rng": np.asarray(st.rng),
                  "iteration": np.asarray(st.iteration),
                  "stats": {f: np.asarray(st.stats[f])
                            for f in st.stats.keys()},
                  "conc": np.asarray(st.conc)}
        tst = convert.state_from_numpy(leaves, "cpu")
        assert tst.pool.diameter.dtype == getattr(torch, policy["aux_float"])
        assert tst.pool.agent_type.dtype == torch.int16
        back = convert.state_to_numpy(tst, bfloat16=ml_dtypes.bfloat16)
        for k, w in leaves["pool"].items():
            g = back["pool"][k]
            assert g.dtype == w.dtype, k
            np.testing.assert_array_equal(g.view(np.uint8), w.view(np.uint8),
                                          err_msg=k)
        bits = convert.state_to_numpy(tst)["pool"]["diameter"]
        assert bits.dtype == (np.uint16 if policy["aux_float"] == "bfloat16"
                              else np.float16)


# ---------------------------------------------------------------------------
# rewind needs a pure step
# ---------------------------------------------------------------------------

def _tensors(state):
    out = {}

    def walk(x, path):
        if isinstance(x, torch.Tensor):
            out[path] = x.clone()
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}.{f.name}")
        elif isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{path}/{k}")
    walk(state, "")
    return out


@pytest.mark.parametrize("setup", ["k1", "streamed", "pairlist", "every_k",
                                   "lean"])
def test_step_leaves_its_input_state_unchanged(setup):
    n = 300
    rng = np.random.default_rng(11)
    pos = rng.uniform(2, 46, (n, 3)).astype(np.float32)
    kw = dict(force_impl="streamed" if setup == "streamed" else "k1")
    if setup == "pairlist":
        kw["pairlist"] = tgrid.PairListConfig(skin=0.0, max_pairs=64)
    if setup == "every_k":
        kw.update(rebuild=tgrid.RebuildPolicy(mode="every_k", k=4,
                                              displacement_bound=0.5),
                  pairlist=tgrid.PairListConfig(skin=1.0, max_pairs=64))
    if setup == "lean":
        kw["dtypes"] = tagents.DtypePolicy(**LEAN)
    cfg = teng.EngineConfig(capacity=400, domain_lo=(0, 0, 0),
                            domain_hi=(48.0,) * 3, interaction_radius=3.0,
                            dt=0.5, max_per_box=32, query_chunk=128, **kw)
    beh = [tb.GrowDivide(rate=0.8, threshold_diameter=3.0),
           tb.RandomWalk(sigma=0.2), tb.RandomDeath(rate=0.05),
           tb.Infection(radius=3.0, beta=0.5, recovery_time=4)]
    sim = teng.Simulation(cfg, beh, device="cpu")
    types = np.zeros(n, np.int32)
    types[:30] = tb.INFECTED
    st = sim.init_state(pos, diameter=np.full(n, 2.5, np.float32),
                        agent_type=types,
                        extra_init={"infect_timer": np.full(n, 4, np.int32)})
    st = sim.step(st)
    before = _tensors(st)
    nxt = sim.step(st)
    assert int(nxt.stats["births"]) > 0 and int(nxt.stats["deaths"]) > 0
    after = _tensors(st)
    assert before.keys() == after.keys()
    for k in before:
        assert torch.equal(before[k], after[k]), k
