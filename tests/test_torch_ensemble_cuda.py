"""The ensemble on the card: lanes ≡ their solo runs, one K1 launch a tick.

Card-only (``cuda`` marker; they skip without a CUDA device and import no
JAX, so the GPU host runs them with ``python -m pytest -q
tests/test_torch_ensemble_cuda.py -m cuda``). Lanes of 96 agents in
capacity 192 (not a multiple of 128, so K1's packing pads each lane to
whole row blocks): the lane-aware column map kernel ≡ its plain version
entry for entry, with per-lane overflow flags; every lane of an SIR and
of a K1 ensemble ≡ its solo run on the card bit for bit, RNG keys
included; K1 and the column map launch once a tick for all lanes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (EngineConfig, EnsembleEngine,  # noqa: E402
                              ScenarioParams, Simulation, build_env,
                              make_iteration_core)
from repro_torch.core import behaviors as tb  # noqa: E402
from repro_torch.core.lanes import Lanes  # noqa: E402
from repro_torch.kernels import block_cols as colmap  # noqa: E402
from repro_torch.kernels import collision_force as tk1  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

N, CAP, LANES = 96, 192, 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _cfg(**over):
    kw = dict(capacity=CAP, domain_lo=(0.0,) * 3, domain_hi=(30.0,) * 3,
              interaction_radius=3.0, use_forces=False, detect_static=False,
              query_chunk=1024, max_per_box=32)
    kw.update(over)
    return EngineConfig(**kw)


def _inputs(seed):
    r = np.random.RandomState(seed)
    pos = r.uniform(0, 30, (N, 3)).astype(np.float32)
    at = np.zeros((N,), np.int32)
    at[:8] = tb.INFECTED
    timer = np.zeros((N,), np.int32)
    timer[:8] = 40
    return pos, np.full((N,), 2.5, np.float32), at, {"infect_timer": timer}


def _sir():
    return [tb.RandomWalk(sigma=0.8),
            tb.Infection(radius=3.0, beta=lambda ctx: ctx.params["beta"],
                         recovery_time=40)]


@pytest.mark.cuda
@pytest.mark.parametrize("maxb,span", [(64, 8), (2, 8), (64, 1)])
def test_lane_column_map_kernel_equals_plain(maxb, span):
    dev = _card()
    cfg = _cfg(use_forces=True)
    eng = EnsembleEngine(cfg, [], LANES, device=dev)
    st = eng.init_state()
    for lane in range(LANES):
        st = eng.admit(st, lane, eng.stage_lane(*_inputs(lane)[:2],
                                                seed=lane))
    ln = Lanes(LANES, CAP)
    origin = torch.zeros(3, device=dev)
    res = build_env(cfg, cfg.grid_spec, st.pool, origin, cfg.cell_size, ln)
    pool, g = res.pool, res.grid
    active = pool.alive.clone()
    active[CAP:CAP + 40] = False                 # part of lane 1 inactive
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            active, g.starts, g.counts, origin, cfg.cell_size,
            cfg.grid_spec.dims, maxb, None, ln)
    colmap.column_map.launches = 0
    got = tops.k1_inputs(*args)
    want = tops.k1_inputs_plain(*args)
    assert colmap.column_map.launches == 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b.to(a.device))
    assert got[0].shape[1] == LANES * 256 and got[2].shape == (LANES,)
    # each row block lists column blocks of its own lane only
    rb_lane = torch.arange(got[1].shape[0], device=dev) // 2
    cols = got[1]
    assert bool(((cols < 0) | (cols // 2 == rb_lane[:, None])).all())
    if span == 8 and maxb == 64:
        out = tk1.collision_force(got[0], got[1], k_rep=2.0, adhesion=None,
                                  adhesion_band=0.4)
        plain = tk1.collision_force_plain(got[0], got[1], k_rep=2.0,
                                          adhesion=None, adhesion_band=0.4)
        assert float((out[:3] - plain[:3]).abs().max()) <= 1e-4
        assert torch.equal(out[3], plain[3]) and int(out[3].sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("force_impl", [None, "k1", "streamed"])
def test_lanes_equal_solo_on_the_card(force_impl):
    """Bit for bit, keys included; with forces in the streamed sweep the
    floats are held to 1e-4 (integers and keys exact): torch may sum a
    row's candidates in another order at L·C rows than at C."""
    dev = _card()
    cfg = _cfg(use_forces=force_impl is not None,
               **({"force_impl": force_impl} if force_impl else {}))
    betas = [0.2, 0.35, 0.5]
    eng = EnsembleEngine(cfg, _sir(), LANES, ScenarioParams.of(beta=0.0),
                         device=dev)
    st = eng.init_state()
    for lane in range(LANES):
        st = eng.admit(st, lane, eng.stage_lane(*_inputs(lane), seed=lane),
                       ScenarioParams.of(beta=betas[lane]))
    tk1.collision_force.launches = colmap.column_map.launches = 0
    for _ in range(4):
        st = eng.step(st)
    if force_impl == "k1":
        assert tk1.collision_force.launches == 4
        assert colmap.column_map.launches == 4
    core = make_iteration_core(cfg, _sir(), dev)
    for lane in range(LANES):
        solo = Simulation(cfg, _sir(), device=dev).init_state(
            *_inputs(lane), seed=lane)
        pool, conc, rng, it = solo.pool, solo.conc, solo.rng, solo.iteration
        for _ in range(4):
            pool, conc, rng, _, _ = core(pool, conc, rng, it, None,
                                         ScenarioParams.of(beta=betas[lane]))
            it = it + 1
        got = eng.read_lane(st, lane)
        for k, v in pool.channels().items():
            g = got.pool.channels()[k]
            if force_impl == "streamed" and v.is_floating_point():
                torch.testing.assert_close(g, v, atol=1e-4, rtol=1e-4)
            else:
                assert torch.equal(v, g), (lane, k)
        assert torch.equal(rng, got.rng)
