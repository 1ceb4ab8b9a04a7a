"""The non-resident environments on the card: ≡ the CPU and ≡ themselves.

Card-only (``cuda`` marker; they skip without a CUDA device and import no
JAX, so the GPU host runs them with ``python -m pytest -q
tests/test_torch_envs_cuda.py -m cuda``). The pool has a box holding far
more agents than ``max_per_box`` (the scatter table's column K-1 must take
the box's last agent, whichever write a CUDA scatter would keep) and a hash
table of 64 buckets (many collisions). The builds' tables, overflows and
demands and the sweeps' integer outputs are equal between the card and
the CPU, the sweeps' forces within 1e-4 (torch sums a row's lanes in
another order on each device); a phased hash sweep, the wide scatter
sweep, Morton-sorted engine steps and the slot-order K1 wrapper are equal
bit for bit between two card runs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import agents as ta, compaction as tcomp  # noqa: E402
from repro_torch.core import grid as TG  # noqa: E402
from repro_torch.core.engine import EngineConfig, Simulation  # noqa: E402
from repro_torch.core.forces import ForceParams  # noqa: E402
from repro_torch.core.forces import make_force_pair_fn  # noqa: E402
from repro_torch.kernels import collision_force as tk1  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

OUT = {"force": ((3,), torch.float32), "force_nnz": ((), torch.int32)}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pool(device, c=4096, n=3500):
    rng = np.random.default_rng(21)
    pos = rng.uniform(0.0, 40.0, (n, 3)).astype(np.float32)
    pos[:300] = rng.uniform(10.1, 11.9, (300, 3))      # 300 in one box
    dia = rng.uniform(0.8, 1.4, n).astype(np.float32)
    pool = ta.make_pool(c, position=pos, diameter=dia, device=device)
    alive = pool.alive.clone()
    alive[::97] = False
    return dataclasses.replace(pool, alive=alive)


def _sweeps(device):
    pool = _pool(device)
    spec = TG.GridSpec(dims=(20, 20, 20), max_per_box=16, query_chunk=512)
    origin = torch.zeros(3, device=device)
    out = {}
    sg = TG.make_builder(spec, method="scatter")(pool, origin, 2.0)
    hg = TG.make_builder(spec, method="hash", n_buckets=64)(pool, origin,
                                                             2.0)
    out["scatter_table"] = sg.grid.table
    out["scatter_counts"] = sg.grid.counts
    for f in ("keys", "cell_keys", "order", "starts", "counts"):
        out[f"hash_{f}"] = getattr(hg.grid, f)
    out["overflow"] = torch.stack([sg.overflow, hg.overflow, sg.demand,
                                   hg.demand])
    ch = {k: v for k, v in pool.channels().items()
          if not k.startswith("extra.")}
    pair = make_force_pair_fn(ForceParams())
    idx, nq = tcomp.active_index_list(pool.alive)

    def hash_phase(q_pos, q_slot, j):
        ids, valid = TG.hash_grid_probe(spec, hg.grid, q_pos, j)
        return ids, valid & (ids != q_slot[:, None])

    def scatter_cand(q_pos, q_slot):
        ids, valid = TG.scatter_grid_candidates(spec, sg.grid, q_pos)
        return ids, valid & (ids != q_slot[:, None])
    for name, res in (
            ("hash", TG.phased_chunk_apply(ch, ch, idx, nq, hash_phase, 27,
                                           pair, OUT, spec.query_chunk,
                                           64 * 4)),
            ("scatter", TG.chunk_apply(ch, ch, idx, nq, scatter_cand, pair,
                                       OUT, spec.query_chunk, 27 * 16))):
        for k, v in res.items():
            out[f"{name}_{k}"] = v
    return {k: v.cpu() for k, v in out.items()}


@pytest.mark.cuda
def test_builds_and_sweeps_on_the_card_equal_the_cpu_and_themselves():
    dev = _card()
    want = _sweeps("cpu")
    assert int(want["scatter_counts"].max()) > 16        # an overfull box
    assert int(want["overflow"][0]) > 0 and int(want["overflow"][1]) > 0
    runs = [_sweeps(dev) for _ in range(2)]
    for k, w in want.items():
        assert torch.equal(runs[0][k], runs[1][k]), k
        if w.dtype.is_floating_point:
            torch.testing.assert_close(runs[0][k], w, atol=1e-4, rtol=1e-4)
        else:
            assert torch.equal(runs[0][k], w), k


def _engine_run(device, env):
    cfg = EngineConfig(capacity=4096, domain_lo=(0, 0, 0),
                       domain_hi=(40,) * 3, interaction_radius=2.0, dt=0.1,
                       max_per_box=16, sort_frequency=2, environment=env,
                       query_chunk=512)
    pool = _pool("cpu")
    sim = Simulation(cfg, [], device=device)
    n = int(pool.alive.sum())
    st = sim.init_state(pool.position[pool.alive], diameter=pool.diameter[
        pool.alive])
    assert int(st.pool.alive.sum()) == n
    st = sim.run(st, 3)
    return {k: v.cpu() for k, v in st.pool.channels().items()}


@pytest.mark.cuda
@pytest.mark.parametrize("env", ["scatter_grid", "hash_grid", "brute_force"])
def test_engine_steps_on_the_card_equal_two_card_runs(env):
    """Three steps with the Morton sort on the card: two runs are equal bit
    for bit, and integers equal the CPU's, floats within 1e-4."""
    dev = _card()
    a, b = _engine_run(dev, env), _engine_run(dev, env)
    want = _engine_run("cpu", env)
    for k, v in a.items():
        assert torch.equal(v, b[k]), k
        if v.dtype.is_floating_point:
            torch.testing.assert_close(v, want[k], atol=1e-4, rtol=1e-4)
        else:
            assert torch.equal(v, want[k]), k


@pytest.mark.cuda
def test_slot_order_k1_on_the_card_equals_its_plain_version():
    dev = _card()
    pool = _pool(dev)
    args = (pool.position, pool.diameter, pool.agent_type, pool.alive,
            pool.alive, torch.zeros(3, device=dev), 2.0)
    before = tk1.collision_force.launches
    f, nnz, ovf = tops.collision_force(*args, dims=(20, 20, 20))
    assert tk1.collision_force.launches == before + 1
    pf, pnnz, povf = tops.collision_force_plain(*args, dims=(20, 20, 20))
    assert tk1.collision_force.launches == before + 1
    torch.testing.assert_close(f, pf, atol=1e-4, rtol=0)
    assert torch.equal(nnz, pnnz) and bool(ovf) == bool(povf)
    f2, nnz2, _ = tops.collision_force(*args, dims=(20, 20, 20))
    assert torch.equal(f, f2) and torch.equal(nnz, nnz2)
