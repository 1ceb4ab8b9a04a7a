"""Port ``RebuildPolicy(mode="every_k")`` ≡ the reference's cached build.

Contracts, as the reference's tests/test_rebuild.py and test_pairlist.py
state them: every_k skips builds only where the skip is invisible (a
forces-only run matches the every-step schedule while skipping), a birth
or a death forces a rebuild on the next step, and a state with a warm
cache (``EngineState.env``) carried across by ``convert`` steps on in the
port as in the reference: integers and the ``rebuilds`` /
``rebuild_skips`` / ``pair_demand`` counters exact, floats within 1e-5.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import Simulation as JSim, grid as jgrid  # noqa: E402
from repro.core.behaviors import INFECTED  # noqa: E402
from repro.core.behaviors import Infection as JInfection  # noqa: E402
from repro.core.behaviors import RandomDeath as JDeath  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import Simulation as TSim, grid as tgrid  # noqa: E402
from repro_torch.core.behaviors import GrowDivide  # noqa: E402
from repro_torch.core.behaviors import Infection as TInfection  # noqa: E402
from repro_torch.core.behaviors import RandomDeath as TDeath  # noqa: E402

TOL = 1e-5
_GRID = ("origin", "box_size", "keys", "order", "rank", "starts", "counts",
         "max_count", "max_run_count")


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _partitionable_keys():
    """The port splits keys as jax does with jax_threefry_partitionable on
    (jax ≥ 0.5's default)."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _leaves(st):
    """``np.asarray`` on every leaf of a reference state, the cache too."""
    out = {"pool": {k: np.asarray(v) for k, v in st.pool.channels().items()},
           "rng": np.asarray(st.rng), "iteration": np.asarray(st.iteration),
           "stats": {f: np.asarray(st.stats[f]) for f in st.stats.FIELDS},
           "conc": np.asarray(st.conc), "env": None}
    e = st.env
    if e is not None:
        out["env"] = {
            "grid": {f: np.asarray(getattr(e.grid, f)) for f in _GRID},
            "steps_since": np.asarray(e.steps_since),
            "disp_accum": np.asarray(e.disp_accum),
            "dirty": np.asarray(e.dirty),
            "pairs": None if e.pairs is None else {
                f: np.asarray(getattr(e.pairs, f))
                for f in ("idx", "run_off", "count", "demand")},
            "pair_disp": None if e.pair_disp is None
            else np.asarray(e.pair_disp)}
    return out


def _close(want, got, what):
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL,
                                   err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _assert_match(want, got):
    for k, w in want["pool"].items():
        assert got["pool"][k].dtype == w.dtype, k
        _close(w, got["pool"][k], k)
    for f, w in want["stats"].items():
        np.testing.assert_array_equal(got["stats"][f], w, err_msg=f)
    np.testing.assert_array_equal(got["rng"], want["rng"])
    we, ge = want["env"], got["env"]
    assert (we is None) == (ge is None)
    if we is None:
        return
    for f in _GRID:
        _close(np.asarray(we["grid"][f]), np.asarray(ge["grid"][f]), f)
    for f in ("steps_since", "disp_accum", "dirty", "pair_disp"):
        assert (we[f] is None) == (ge[f] is None), f
        if we[f] is not None:
            _close(we[f], ge[f], f)
    assert (we["pairs"] is None) == (ge["pairs"] is None)
    if we["pairs"] is not None:
        for f, w in we["pairs"].items():
            np.testing.assert_array_equal(ge["pairs"][f], w, err_msg=f)


def _forces_kw(side, capacity=512, **kw):
    return dict(capacity=capacity, domain_lo=(0., 0., 0.),
                domain_hi=(side,) * 3, interaction_radius=3.0,
                max_per_box=32, **kw)


def _live_by_id(st):
    a = st.pool.alive.numpy()
    return st.pool.position.numpy()[a][np.argsort(
        st.pool.agent_type.numpy()[a])]


def test_every_k_skips_and_matches_every_step():
    """Forces only, identities in agent_type: the cached schedule skips
    builds and ends where the every-step schedule does."""
    rng = np.random.default_rng(0)
    side, n = 24.0, 400
    pos = rng.uniform(1.0, side - 1.0, (n, 3)).astype(np.float32)
    dia = np.full((n,), 2.2, np.float32)
    ids = np.arange(n, dtype=np.int32)
    pol = tgrid.RebuildPolicy(mode="every_k", k=4, displacement_bound=1.0)
    sim_a = TSim(TConfig(**_forces_kw(side)), [], device="cpu")
    sim_b = TSim(TConfig(**_forces_kw(side, rebuild=pol)), [], device="cpu")
    sa = sim_a.init_state(pos, dia, ids)
    sb = sim_b.init_state(pos, dia, ids)
    assert sa.env is None and bool(sb.env.dirty)
    steps, rebuilds, skips = 20, 0, 0
    for _ in range(steps):
        sa, sb = sim_a.step(sa), sim_b.step(sb)
        assert int(sa.stats["rebuilds"]) == 1
        assert int(sa.stats["rebuild_skips"]) == 0
        rebuilds += int(sb.stats["rebuilds"])
        skips += int(sb.stats["rebuild_skips"])
    assert rebuilds + skips == steps and skips > 0
    assert int(sb.stats["n_live"]) == n
    d = float(np.abs(_live_by_id(sa) - _live_by_id(sb)).max())
    assert d < 1e-3, d


def test_births_force_rebuild_next_step():
    rng = np.random.default_rng(1)
    side, n = 24.0, 64
    pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
    pol = tgrid.RebuildPolicy(mode="every_k", k=64, displacement_bound=100.0)
    sim = TSim(TConfig(**_forces_kw(side, capacity=1024, rebuild=pol)),
               [GrowDivide(rate=0.5, threshold_diameter=3.0)], device="cpu")
    st = sim.init_state(pos, np.full((n,), 2.8, np.float32))
    births, rebuilds = [], []
    for _ in range(8):
        st = sim.step(st)
        births.append(int(st.stats["births"]))
        rebuilds.append(int(st.stats["rebuilds"]))
        assert bool(st.env.dirty) == (births[-1] > 0)
    assert rebuilds[0] == 1 and sum(births) > 0
    for t in range(len(births) - 1):
        if births[t] > 0:
            assert rebuilds[t + 1] == 1, (t, births, rebuilds)
    assert 0 in rebuilds, "no step skipped its build"


def test_a_death_under_every_k_rebuilds_and_matches_reference():
    """Deaths under every_k: the step after a death rebuilds (the cached
    tables indexed the layout the compaction changed), skipped steps keep
    the live agents in front, and the run matches the reference's."""
    rng = np.random.default_rng(2)
    side, n = 24.0, 300
    pos = rng.uniform(1.0, side - 1.0, (n, 3)).astype(np.float32)
    kw = _forces_kw(side, capacity=384, dt=0.2)
    jsim = JSim(JConfig(**kw, rebuild=jgrid.RebuildPolicy("every_k", 6, 2.0)),
                [JDeath(rate=0.01)])
    tsim = TSim(TConfig(**kw, rebuild=tgrid.RebuildPolicy("every_k", 6,
                                                          2.0)),
                [TDeath(rate=0.01)], device="cpu")
    js = jsim.init_state(pos, diameter=np.full(n, 2.0, np.float32))
    ts = convert.state_from_numpy(_leaves(js), "cpu")
    deaths, rebuilds = [], []
    for _ in range(10):
        js, ts = jsim.step(js), tsim.step(ts)
        _assert_match(_leaves(js), convert.state_to_numpy(ts))
        deaths.append(int(ts.stats["deaths"]))
        rebuilds.append(int(ts.stats["rebuilds"]))
        n_live = int(ts.stats["n_live"])
        assert bool(ts.pool.alive[:n_live].all())
        assert not bool(ts.pool.alive[n_live:].any())
    assert sum(deaths) > 0 and 0 in rebuilds, (deaths, rebuilds)
    for t in range(len(deaths) - 1):
        if deaths[t] > 0:
            assert rebuilds[t + 1] == 1, (t, deaths, rebuilds)


def _sir_pair(mode, force_impl):
    """(reference sim, port sim, reference state after 3 steps) for forces
    + SIR under every_k, with or without a pair list."""
    ref_impl = {"streamed": "xla", "k1": "pallas"}[force_impl]
    kw = dict(capacity=384, domain_lo=(0, 0, 0), domain_hi=(24.0,) * 3,
              interaction_radius=3.0, dt=0.2, max_per_box=16,
              query_chunk=64)
    jx = dict(rebuild=jgrid.RebuildPolicy("every_k", 4, 0.5))
    tx = dict(rebuild=tgrid.RebuildPolicy("every_k", 4, 0.5))
    if mode == "pairlist":
        jx["pairlist"] = jgrid.PairListConfig(skin=1.0, max_pairs=64)
        tx["pairlist"] = tgrid.PairListConfig(skin=1.0, max_pairs=64)
    jsim = JSim(JConfig(**kw, **jx, force_impl=ref_impl),
                [JInfection(radius=3.0, beta=0.5)])
    tsim = TSim(TConfig(**kw, **tx, force_impl=force_impl),
                [TInfection(radius=3.0, beta=0.5)], device="cpu")
    rng = np.random.default_rng(0)
    n = 300
    types = np.zeros(n, np.int32)
    types[:15] = INFECTED
    s = jsim.init_state(rng.uniform(1, 23, (n, 3)).astype(np.float32),
                        diameter=np.full(n, 2.5, np.float32),
                        agent_type=types,
                        extra_init={"infect_timer": np.full(n, 8, np.int32)})
    return jsim, tsim, jsim.run(s, 3)


@pytest.mark.parametrize("mode,force_impl", [
    ("every_k", "streamed"), ("pairlist", "streamed"), ("pairlist", "k1")])
def test_warm_cache_carried_over_steps_on_like_reference(mode, force_impl):
    """A reference state with a warm cache, carried into the port, steps 5
    times in both packages: integers, counters and the cache exact, floats
    within 1e-5; some steps skip their build."""
    jsim, tsim, js = _sir_pair(mode, force_impl)
    assert js.env is not None and not bool(js.env.dirty)
    ts = convert.state_from_numpy(_leaves(js), "cpu")
    skips = 0
    for _ in range(5):
        js, ts = jsim.step(js), tsim.step(ts)
        _assert_match(_leaves(js), convert.state_to_numpy(ts))
        skips += int(ts.stats["rebuild_skips"])
    assert skips > 0
    if mode == "pairlist":
        assert 0 < int(ts.stats["pair_demand"]) <= 64


def test_cache_round_trips_bit_equal():
    _, _, js = _sir_pair("pairlist", "streamed")
    leaves = _leaves(js)
    back = convert.state_to_numpy(convert.state_from_numpy(leaves, "cpu"))
    assert back["env"]["grid"]["keys"].dtype == np.uint32
    assert back["env"]["grid"]["counts"].dtype == \
        leaves["env"]["grid"]["counts"].dtype
    _assert_match(leaves, back)
    t = convert.state_from_numpy(leaves, "cpu")
    assert isinstance(t.env, tgrid.RebuildState)
    assert isinstance(t.env.pairs, tgrid.PairList)
    assert dataclasses.is_dataclass(t.env.grid)
