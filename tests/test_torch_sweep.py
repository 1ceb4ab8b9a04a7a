"""Port streamed sweep ≡ the reference's, on the resident pool.

The pool is built by the reference's resident builder (jitted, as its
engine runs it) and carried into the port, so both sides sweep the same
layout and tables. Integer outputs must be equal, float outputs within
1e-4; on the port's own side the fused sweep equals the sequential sweeps
bit for bit, and the result does not depend on how rows are chunked.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import compaction as jcomp, engine as jeng  # noqa: E402
from repro.core import forces as jforces, grid as jgrid  # noqa: E402
from repro.core.behaviors import INFECTED  # noqa: E402
from repro.core.behaviors import Infection as JInfection  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import compaction as tcomp, engine as teng  # noqa: E402
from repro_torch.core import forces as tforces, grid as tgrid  # noqa: E402
from repro_torch.core.agents import pool_from_channels  # noqa: E402
from repro_torch.core.behaviors import Infection as TInfection  # noqa: E402
from repro_torch.core.behaviors import Behavior as TBehavior  # noqa: E402

ATOL = RTOL = 1e-4


@pytest.fixture(autouse=True)
def _single_thread():
    """One torch thread: multi-threaded CPU kernels were seen to return a
    worker's chunk of float32 sqrt results ~3e-4 off on some hosts."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _count_fn(q, nbr, valid, q_slot):
    """Integer kernel: the number of valid candidates (either package)."""
    n = valid.sum(-1)
    return {"n": n.astype(jnp.int32) if isinstance(n, jnp.ndarray)
            else n.to(torch.int32)}


def _setup(n=300, cap=384, side=24.0, radius=3.0, max_per_box=8,
           chunk=64, seed=0, adhesion=None):
    """A reference build of a random pool (some dead slots, 5% infected)
    and its port twin: (spec, port spec, grid, channels, port grid, port
    channels)."""
    rng = np.random.default_rng(seed)
    kw = dict(capacity=cap, domain_lo=(0, 0, 0), domain_hi=(side,) * 3,
              interaction_radius=radius, max_per_box=max_per_box,
              query_chunk=chunk, adhesion=adhesion)
    jcfg = JConfig(**kw)
    inf = JInfection(radius=radius, beta=0.5)
    sim = jeng.Simulation(jcfg, [inf])
    types = (rng.random(n) < 0.05).astype(np.int32) * INFECTED
    st = sim.init_state(rng.uniform(0.5, side - 0.5, (n, 3)).astype(
        np.float32), diameter=rng.uniform(1.5, 3.5, n).astype(np.float32),
        agent_type=types)
    alive = np.asarray(st.pool.alive).copy()
    alive[rng.choice(n, n // 10, replace=False)] = False
    st.pool.alive = jnp.asarray(alive)
    spec = jcfg.grid_spec
    origin = jnp.zeros(3, jnp.float32)
    build = jgrid.make_builder(spec, method="resident")
    res = jax.jit(lambda p: build(p, origin, jnp.float32(jcfg.cell_size)))(
        st.pool)
    jch = res.pool.channels()
    tch = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in jch.items()}
    tpool = pool_from_channels(tch)
    tspec = TConfig(**kw).grid_spec
    tres = tgrid.make_builder(tspec)(tpool, torch.zeros(3), jcfg.cell_size)
    for k, v in tres.pool.channels().items():   # already grid-ordered
        np.testing.assert_array_equal(v.numpy(), tch[k].numpy(), err_msg=k)
    return spec, tspec, res.grid, jch, tres.grid, tch


def _assert_out(want, got):
    assert set(want) == set(got)
    for name, w in want.items():
        w = np.asarray(w)
        g = got[name].numpy()
        assert g.dtype == w.dtype, name
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, atol=ATOL, rtol=RTOL,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


def test_run_bounds_match_reference():
    spec, tspec, jg, jch, tg, tch = _setup()
    rng = np.random.default_rng(3)
    q = rng.uniform(-2, 26, (500, 3)).astype(np.float32)  # outside too
    js, jn = jax.jit(lambda g, p: jgrid.run_bounds(spec, g, p))(jg, q)
    ts, tn = tgrid.run_bounds(tspec, tg, torch.from_numpy(q))
    assert ts.dtype == tn.dtype == torch.int32
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    inside = np.asarray(jn) > 0
    np.testing.assert_array_equal(ts.numpy()[inside], np.asarray(js)[inside])


@pytest.mark.parametrize("active", [0.3, 1.0])
@pytest.mark.parametrize("adhesion", [None, ((0.3, 0.05), (0.05, 0.3))])
def test_resident_apply_force_matches_reference(active, adhesion):
    spec, tspec, jg, jch, tg, tch = _setup(adhesion=adhesion)
    rng = np.random.default_rng(5)
    mask = np.asarray(jch["alive"]) & (rng.random(len(jch["alive"]))
                                       < active)
    jadh = None if adhesion is None else jnp.asarray(adhesion, jnp.float32)
    tadh = None if adhesion is None else torch.tensor(adhesion)
    jfn = jforces.make_force_pair_fn(jforces.ForceParams(), jadh)
    tfn = tforces.make_force_pair_fn(tforces.ForceParams(), tadh)
    want = jax.jit(lambda g, ch, m: jgrid.resident_apply(
        spec, g, ch, m, jfn, jforces.FORCE_OUT_SPECS, 64))(
            jg, {k: v for k, v in jch.items() if "." not in k},
            jnp.asarray(mask))
    got = tgrid.resident_apply(tspec, tg, tch, torch.from_numpy(mask), tfn,
                               tforces.FORCE_OUT_SPECS, 64)
    _assert_out(want, got)
    assert int(got["force_nnz"].sum()) > 0
    assert not got["force"][~torch.from_numpy(mask)].any()


def test_resident_apply_truncates_at_run_capacity():
    """A crowded grid: runs hold more agents than max_per_run; both sides
    cut every run to its first run_capacity candidates."""
    spec, tspec, jg, jch, tg, tch = _setup(n=360, side=8.0, max_per_box=4)
    assert int(np.asarray(jg.max_run_count)) > spec.run_capacity
    mask = np.asarray(jch["alive"]).copy()
    want = jax.jit(lambda g, ch, m: jgrid.resident_apply(
        spec, g, ch, m, _count_fn, {"n": ((), jnp.int32)}, 64))(
            jg, {k: v for k, v in jch.items() if "." not in k},
            jnp.asarray(mask))
    got = tgrid.resident_apply(tspec, tg, tch, torch.from_numpy(mask),
                               _count_fn, {"n": ((), torch.int32)}, 64)
    _assert_out(want, got)


def _kernels(mod, inf_cls, force_mask, jax_side):
    fp = (jforces if jax_side else tforces)
    force = mod.PairKernel("force", fp.make_force_pair_fn(fp.ForceParams()),
                           fp.FORCE_OUT_SPECS, reads=fp.FORCE_READS,
                           query_mask=force_mask)
    inf = inf_cls(radius=3.0).neighbor_kernels()[0]
    return [force, inf]


def test_fused_matches_reference_and_sequential():
    spec, tspec, jg, jch, tg, tch = _setup(seed=1)
    rng = np.random.default_rng(7)
    alive = np.asarray(jch["alive"]).copy()
    fmask = alive & (rng.random(len(alive)) < 0.5)
    jks = _kernels(jgrid, JInfection, jnp.asarray(fmask), True)
    tks = _kernels(tgrid, TInfection, torch.from_numpy(fmask), False)
    want = jax.jit(lambda g, ch, m: jgrid.resident_apply_fused(
        spec, g, ch, jks, m, 64))(jg, jch, jnp.asarray(alive))
    got = tgrid.resident_apply_fused(tspec, tg, tch, tks,
                                     torch.from_numpy(alive), 64)
    for name in ("force", "infection"):
        _assert_out(want[name], got[name])
    assert int(got["infection"]["exposed"].sum()) > 0
    # each kernel ≡ its own sequential sweep, bit for bit
    seq_ch = {k: v for k, v in tch.items() if "." not in k}
    for k, m in zip(tks, (torch.from_numpy(fmask), torch.from_numpy(alive))):
        one = tgrid.resident_apply(tspec, tg, seq_ch, m, k.pair_fn,
                                   k.out_specs, 64)
        for name, v in one.items():
            assert torch.equal(v, got[k.name][name]), (k.name, name)


@pytest.mark.parametrize("chunk,lanes", [(8, None), (64, 4096), (1, 2000)])
def test_sweep_result_does_not_depend_on_chunking(monkeypatch, chunk, lanes):
    spec, tspec, jg, jch, tg, tch = _setup(seed=2)
    alive = torch.from_numpy(np.asarray(jch["alive"]).copy())
    tks = _kernels(tgrid, TInfection, None, False)
    whole = tgrid.resident_apply_fused(tspec, tg, tch, tks, alive, 512)
    if lanes is not None:
        monkeypatch.setattr(tgrid, "SWEEP_LANES", lanes)
    part = tgrid.resident_apply_fused(tspec, tg, tch, tks, alive, chunk)
    for kname, outs in whole.items():
        for name, v in outs.items():
            assert torch.equal(v, part[kname][name]), (kname, name)


def test_fused_sweep_checks_its_registry():
    spec, tspec, jg, jch, tg, tch = _setup(n=60, cap=64)
    alive = tch["alive"]
    inf = TInfection(radius=3.0).neighbor_kernels()[0]
    with pytest.raises(ValueError, match="duplicate"):
        tgrid.resident_apply_fused(tspec, tg, tch, [inf, inf], alive)

    def reads_diameter(q, nbr, valid, q_slot):
        return {"x": (nbr["diameter"] * valid).sum(-1)}
    sneaky = tgrid.PairKernel("sneaky", reads_diameter,
                              {"x": ((), torch.float32)},
                              reads=("position", "alive"))
    with pytest.raises(KeyError):
        tgrid.resident_apply_fused(tspec, tg, tch, [sneaky], alive)
    missing = tgrid.PairKernel("m", reads_diameter,
                               {"x": ((), torch.float32)},
                               reads=("extra.nothing",))
    with pytest.raises(KeyError, match="not in the pool"):
        tgrid.resident_apply_fused(tspec, tg, tch, [missing], alive)
    assert tgrid.resident_apply_fused(tspec, tg, tch, [], alive) == {}
    wrong = tgrid.initial_pairlist(len(alive) + 1, 4)   # another pool's
    with pytest.raises(ValueError, match="pairs must list"):
        tgrid.resident_apply_fused(tspec, tg, tch, [inf], alive,
                                   pairs=wrong)


def test_footprints_match_reference():
    kw = dict(capacity=64, domain_lo=(0, 0, 0), domain_hi=(20,) * 3,
              interaction_radius=3.0)
    want = jeng.check_kernel_footprints(JConfig(**kw), [JInfection()])
    got = teng.check_kernel_footprints(TConfig(**kw), [TInfection()])
    assert got == want == teng.realized_footprint(TConfig(**kw),
                                                  [TInfection()])

    class Sneaky(TBehavior):
        name = "sneaky"

        def neighbor_kernels(self):
            def fn(q, nbr, valid, q_slot):
                return {"x": (nbr["diameter"] * valid).sum(-1)}
            return (tgrid.PairKernel("sneaky", fn, {"x": ((),
                                                         torch.float32)},
                                     reads=("position",)),)
    with pytest.raises(KeyError, match="did not declare"):
        teng.check_kernel_footprints(TConfig(**kw), [Sneaky()])


@pytest.mark.parametrize("p", [0.0, 0.02, 0.5, 1.0])
def test_active_lists_match_reference(rng, p):
    active = rng.random(300) < p
    for block in (1, 7, 64):
        want = jcomp.active_block_list(jnp.asarray(active), block)
        got = tcomp.active_block_list(torch.from_numpy(active), block)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = jcomp.active_index_list(jnp.asarray(active))
    got = tcomp.active_index_list(torch.from_numpy(active))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
