"""Port engine ≡ reference engine: one step from a shared state, and the
population over many steps.

The state crosses over through ``convert.state_from_numpy`` (``np.asarray``
on every leaf of the JAX ``EngineState``). After one step integer channels
and every ``StepStats`` field must match exactly, floats to atol/rtol 1e-4 —
the tolerance tests/test_engine_kernel.py holds the reference's own two
force paths to. The reference runs its default streamed XLA sweep (and, in
one small case, its Pallas K1); the port runs K1's plain version.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import EngineConfig as JConfig  # noqa: E402
from repro.core import ForceParams as JForce, Simulation as JSim  # noqa: E402
from repro.core.behaviors import GrowDivide as JGrow  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import EngineConfig as TConfig  # noqa: E402
from repro_torch.core import ForceParams as TForce  # noqa: E402
from repro_torch.core import GrowDivide as TGrow  # noqa: E402
from repro_torch.core import DtypePolicy, RebuildPolicy  # noqa: E402
from repro_torch.core import Simulation as TSim  # noqa: E402
from repro_torch.launch import simulate as tlaunch  # noqa: E402


@pytest.fixture(autouse=True)
def _single_thread():
    """torch's multi-threaded CPU kernels were seen to return a whole
    worker's chunk of float32 sqrt results off by ~3e-4 (relative) on some
    hosts; one thread keeps the parity tests deterministic."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def _partitionable_keys():
    """The port's engine splits keys as jax does with
    jax_threefry_partitionable on (jax ≥ 0.5's default)."""
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        yield
    finally:
        jax.config.update("jax_threefry_partitionable", prev)


def _leaves(st):
    return {"pool": {k: np.asarray(v) for k, v in st.pool.channels().items()},
            "rng": np.asarray(st.rng), "iteration": np.asarray(st.iteration),
            "stats": {f: np.asarray(st.stats[f]) for f in st.stats.FIELDS},
            "conc": np.asarray(st.conc)}


def _assert_states_match(want, got, atol=1e-4, rtol=1e-4):
    assert set(want["pool"]) == set(got["pool"])
    for k, w in want["pool"].items():
        g = got["pool"][k]
        assert g.dtype == w.dtype, k
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    for f, w in want["stats"].items():
        assert got["stats"][f].dtype == w.dtype, f
        np.testing.assert_array_equal(got["stats"][f], w, err_msg=f)
    np.testing.assert_array_equal(got["rng"], want["rng"])
    np.testing.assert_array_equal(got["iteration"], want["iteration"])


def _quickstart(capacity=1024):
    """examples/quickstart.py's configuration at a reduced capacity."""
    kw = dict(capacity=capacity, domain_lo=(0, 0, 0),
              domain_hi=(120, 120, 120), interaction_radius=14.0, dt=0.2,
              sort_frequency=10, max_per_box=64)
    rng = np.random.default_rng(0)
    pos = rng.uniform(50, 70, (128, 3)).astype(np.float32)
    dia = np.full(128, 8.0, np.float32)
    jsim = JSim(JConfig(**kw, force=JForce(max_displacement=1.0)),
                [JGrow(rate=1.0, threshold_diameter=12.0)])
    tsim = TSim(TConfig(**kw, force=TForce(max_displacement=1.0)),
                [TGrow(rate=1.0, threshold_diameter=12.0)], device="cpu")
    return jsim, tsim, jsim.init_state(pos, diameter=dia)


def _fig6(n):
    """benchmarks/scaling.py's Fig-6 proliferation configuration."""
    side = max(40.0, (n ** (1 / 3)) * 4.0)
    kw = dict(capacity=int(n * 1.3), domain_lo=(0, 0, 0),
              domain_hi=(side,) * 3, interaction_radius=4.0, dt=0.05,
              max_per_box=32, query_chunk=4096)
    rng = np.random.default_rng(1)
    pos = rng.uniform(2.0, side - 2.0, (n, 3)).astype(np.float32)
    jsim = JSim(JConfig(**kw, force=JForce(max_displacement=0.5)),
                [JGrow(rate=0.01, threshold_diameter=6.0)])
    tsim = TSim(TConfig(**kw, force=TForce(max_displacement=0.5)),
                [TGrow(rate=0.01, threshold_diameter=6.0)], device="cpu")
    return jsim, tsim, jsim.init_state(pos,
                                       diameter=np.full(n, 3.0, np.float32))


def _one_step(jsim, tsim, s0, until_births=False):
    s1 = jsim.step(s0)
    while until_births and int(s1.stats["births"]) == 0:
        s0, s1 = s1, jsim.step(s1)       # the first step that divides
    want = _leaves(s1)
    got = convert.state_to_numpy(tsim.step(
        convert.state_from_numpy(_leaves(s0), "cpu")))
    return want, got


def test_one_step_parity_quickstart():
    want, got = _one_step(*_quickstart(), until_births=True)
    assert int(want["stats"]["births"]) > 0
    _assert_states_match(want, got)


def test_one_step_parity_fig6():
    want, got = _one_step(*_fig6(3000))
    assert int(want["stats"]["n_live"]) == 3000
    _assert_states_match(want, got)


@pytest.mark.parametrize("adhesion", [None, ((0.3, 0.05), (0.05, 0.3))])
def test_one_step_parity_against_pallas_k1(rng, adhesion):
    """The reference's own K1 path (Pallas, interpret mode)."""
    pos = rng.uniform(4, 28, (80, 3)).astype(np.float32)
    types = rng.integers(0, 2, 80).astype(np.int32)
    kw = dict(capacity=128, domain_lo=(0, 0, 0), domain_hi=(32, 32, 32),
              interaction_radius=4.0, dt=0.1, max_per_box=64,
              adhesion=adhesion)
    jsim = JSim(JConfig(**kw, force_impl="pallas",
                        force=JForce(max_displacement=0.5)), [])
    tsim = TSim(TConfig(**kw, force=TForce(max_displacement=0.5)), [],
                device="cpu")
    s0 = jsim.init_state(pos, diameter=np.full(80, 3.0, np.float32),
                         agent_type=types)
    want, got = _one_step(jsim, tsim, s0)
    assert int(want["stats"]["n_active"]) == 80
    _assert_states_match(want, got)


def test_population_matches_over_30_steps():
    """Division depends only on diameter, which does not depend on slot
    order, so n_live and births match at every step even after float
    differences reorder slots."""
    jsim, tsim, s0 = _quickstart()
    js = s0
    ts = convert.state_from_numpy(_leaves(s0), "cpu")
    for i in range(30):
        js = jsim.step(js)
        ts = tsim.step(ts)
        for f in ("n_live", "births", "deaths", "box_overflow",
                  "birth_overflow"):
            assert int(ts.stats[f]) == int(js.stats[f]), (i, f)
        assert ts.stats.health_bits() == 0 and not ts.stats.any_overflow()
    assert int(ts.stats["n_live"]) == 256


def test_state_round_trip_bit_equal():
    jsim, _, s0 = _quickstart()
    s1 = jsim.step(s0)
    leaves = _leaves(s1)
    back = convert.state_to_numpy(convert.state_from_numpy(leaves, "cpu"))
    for k, w in leaves["pool"].items():
        assert back["pool"][k].dtype == w.dtype
        np.testing.assert_array_equal(back["pool"][k], w)
    for f, w in leaves["stats"].items():
        np.testing.assert_array_equal(back["stats"][f], w)
    assert back["rng"].dtype == np.uint32
    np.testing.assert_array_equal(back["rng"], leaves["rng"])
    np.testing.assert_array_equal(back["iteration"], leaves["iteration"])


def test_init_state_matches_reference():
    jsim, tsim, s0 = _quickstart()
    rng = np.random.default_rng(0)
    pos = rng.uniform(50, 70, (128, 3)).astype(np.float32)
    t0 = tsim.init_state(pos, diameter=np.full(128, 8.0, np.float32))
    _assert_states_match(_leaves(s0), convert.state_to_numpy(t0), 0, 0)


def test_run_raises_on_run_overflow_like_reference():
    """The reference CLI's proliferation density overflows its run
    capacity; the port raises the same error."""
    sim, st = tlaunch.build("proliferation", 10_000, "cli", device="cpu")
    with pytest.raises(RuntimeError, match="grid run overflow"):
        sim.run(st, 1, check_overflow=True)


@pytest.mark.parametrize("change", [
    dict(environment="hash_grid"), dict(force_impl="xla"),
    dict(detect_static=True), dict(diffusion=object()),
    dict(rebuild=RebuildPolicy(mode="every_k", k=2)),
])
def test_options_outside_the_slice_raise(change):
    cfg = TConfig(capacity=128, domain_lo=(0, 0, 0), domain_hi=(8, 8, 8),
                  interaction_radius=2.0, **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        TSim(cfg, [], device="cpu")


def test_narrowed_dtype_policy_raises():
    with pytest.raises(NotImplementedError):
        DtypePolicy(aux_float="bfloat16")


def test_config_validation_matches_reference():
    with pytest.raises(ValueError):
        TConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(1, 1, 1),
                interaction_radius=1.0, sort_impl="bogus")
    with pytest.raises(ValueError):
        TConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(1, 1, 1),
                interaction_radius=1.0, force_impl="pallas")
    cfg = TConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(30, 30, 30),
                  interaction_radius=4.0)
    ref = JConfig(capacity=8, domain_lo=(0, 0, 0), domain_hi=(30, 30, 30),
                  interaction_radius=4.0)
    assert cfg.grid_spec.dims == ref.grid_spec.dims
    assert cfg.grid_spec.run_capacity == ref.grid_spec.run_capacity
