"""Port neighbor environments ≡ the reference's and ≡ brute force.

Ported from tests/test_env_parity.py and tests/test_grid.py: every
environment (the sorted build with ``neighbor_apply``, the resident
build, the scatter table, the streamed hash probes, brute force) agrees
with the brute-force oracle in both packages — force within 1e-4, nnz
exactly — on a cubic and an anisotropic grid; the builds' tables, the
overflow and demand of every method and the slot-order K1 wrapper equal
the reference's. The reference's builders run eagerly here with an array
box size, so the port passes a tensor (``morton.cell_of`` divides).
"""

import dataclasses
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import agents as ja, grid as JG  # noqa: E402
from repro.core.forces import ForceParams as JFP  # noqa: E402
from repro.core.forces import make_force_pair_fn as j_pair  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core import agents as ta, compaction as tcomp  # noqa: E402
from repro_torch.core import grid as TG  # noqa: E402
from repro_torch.core.forces import ForceParams as TFP  # noqa: E402
from repro_torch.core.forces import make_force_pair_fn as t_pair  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402

J_OUT = {"force": ((3,), jnp.float32), "force_nnz": ((), jnp.int32)}
T_OUT = {"force": ((3,), torch.float32), "force_nnz": ((), torch.int32)}


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cloud(rng, n, hi, dia=(0.8, 1.4)):
    hi = np.asarray(hi, np.float32)
    pos = rng.uniform(0.5, hi - 0.5, (n, 3)).astype(np.float32)
    return pos, rng.uniform(*dia, (n,)).astype(np.float32)


def _pools(pos, dia, c=None, alive=None):
    c = len(pos) if c is None else c
    jp = ja.make_pool(c, position=jnp.asarray(pos), diameter=jnp.asarray(dia))
    tp = ta.make_pool(c, position=pos, diameter=dia, device="cpu")
    if alive is not None:
        jp = dataclasses.replace(jp, alive=jnp.asarray(alive))
        tp = dataclasses.replace(tp, alive=torch.from_numpy(alive.copy()))
    return jp, tp


def _ch(pool):
    return {k: v for k, v in pool.channels().items()
            if not k.startswith("extra.")}


def _t_envs(pool, spec, box):
    """Forces of every port environment, in slot order."""
    c = pool.capacity
    ch = _ch(pool)
    pair = t_pair(TFP())
    origin, r = torch.zeros(3), torch.tensor(box)
    all_idx = torch.arange(c, dtype=torch.int32)
    out = {}
    sres = TG.make_builder(spec, method="sorted")(pool, origin, r)
    assert int(sres.overflow) == 0
    out["sorted"] = TG.neighbor_apply(spec, sres.grid, ch, all_idx, c, pair,
                                      T_OUT)
    rres = TG.make_builder(spec, method="resident")(pool, origin, r)
    res = TG.resident_apply(spec, rres.grid, _ch(rres.pool), rres.pool.alive,
                            pair, T_OUT)
    o = rres.order.long()
    out["resident"] = {k: torch.zeros_like(v).index_copy_(0, o, v)
                       for k, v in res.items()}
    sg = TG.make_builder(spec, method="scatter")(pool, origin, r).grid
    hg = TG.make_builder(spec, method="hash")(pool, origin, r).grid

    def scatter_cand(q_pos, q_slot):
        ids, valid = TG.scatter_grid_candidates(spec, sg, q_pos)
        return ids, valid & (ids != q_slot[:, None])
    out["scatter"] = TG.chunk_apply(ch, ch, all_idx, c, scatter_cand, pair,
                                    T_OUT, spec.query_chunk)

    def hash_phase(q_pos, q_slot, j):
        ids, valid = TG.hash_grid_probe(spec, hg, q_pos, j)
        return ids, valid & (ids != q_slot[:, None])
    out["hash"] = TG.phased_chunk_apply(ch, ch, all_idx, c, hash_phase, 27,
                                        pair, T_OUT, spec.query_chunk)
    out["brute"] = TG.brute_force_apply(ch, pool.alive, pair, T_OUT)
    return out


def _j_envs(pool, spec, box):
    c = pool.capacity
    ch = _ch(pool)
    pair = j_pair(JFP())
    origin, r = jnp.zeros(3), jnp.asarray(box)
    all_idx = jnp.arange(c, dtype=jnp.int32)
    hg = JG.make_builder(spec, method="hash")(pool, origin, r).grid

    def hash_phase(q_pos, q_slot, j):
        ids, valid = JG.hash_grid_probe(spec, hg, q_pos, j)
        return ids, valid & (ids != q_slot[:, None])
    return {"hash": JG.phased_chunk_apply(ch, ch, all_idx, jnp.int32(c),
                                          hash_phase, 27, pair, J_OUT,
                                          spec.query_chunk),
            "brute": JG.brute_force_apply(ch, pool.alive, pair, J_OUT)}


def _close(got, want, what):
    np.testing.assert_allclose(got["force"].numpy(),
                               np.asarray(want["force"]), atol=1e-4,
                               err_msg=what)
    np.testing.assert_array_equal(got["force_nnz"].numpy(),
                                  np.asarray(want["force_nnz"]), err_msg=what)


GRIDS = [((16.0, 16.0, 16.0), (8, 8, 8), 300),
         ((40.0, 16.0, 8.0), (20, 8, 4), 350)]     # anisotropic table


@pytest.mark.parametrize("domain,dims,n", GRIDS)
def test_all_environments_agree_with_brute_force(domain, dims, n):
    pos, dia = _cloud(np.random.default_rng(0), n, domain)
    jp, tp = _pools(pos, dia)
    spec_t = TG.GridSpec(dims=dims, max_per_box=n, max_per_run=n,
                         query_chunk=128)
    spec_j = JG.GridSpec(dims=dims, max_per_box=n, max_per_run=n,
                         query_chunk=128)
    got = _t_envs(tp, spec_t, 2.0)
    want = _j_envs(jp, spec_j, 2.0)
    _close(got["brute"], want["brute"], "brute vs reference brute")
    _close(got["hash"], want["hash"], "hash vs reference hash")
    for name in ("sorted", "resident", "scatter", "hash"):
        _close(got[name], {k: np.asarray(v.numpy()) for k, v in
                           got["brute"].items()}, name)
    assert int(got["brute"]["force_nnz"].sum()) > 0


def test_hash_bucket_collision_no_double_count():
    """Cells (34,129,23) and (35,128,21) collide into one bucket and both
    lie in the stencil of a query in (34,128,22): the cell_keys re-check
    keeps the neighbor from being counted twice (test_env_parity.py:106)."""
    dims = (40, 132, 25)
    pos = np.asarray([[138.0, 514.0, 90.0], [138.5, 516.5, 92.5]],
                     np.float32)
    dia = np.full((2,), 4.0, np.float32)
    jp, tp = _pools(pos, dia)
    spec = TG.GridSpec(dims=dims, max_per_box=4, max_per_run=8, query_chunk=2)
    hg = TG.make_builder(spec, method="hash")(tp, torch.zeros(3),
                                              torch.tensor(4.0)).grid
    assert int(hg.keys[0]) != int(hg.keys[1])
    ch = _ch(tp)
    pair = t_pair(TFP())

    def hash_phase(q_pos, q_slot, j):
        ids, valid = TG.hash_grid_probe(spec, hg, q_pos, j)
        return ids, valid & (ids != q_slot[:, None])
    res = TG.phased_chunk_apply(ch, ch, torch.arange(2, dtype=torch.int32), 2,
                                hash_phase, 27, pair, T_OUT, 2)
    ref = TG.brute_force_apply(ch, tp.alive, pair, T_OUT)
    assert int(ref["force_nnz"][0]) == 1
    np.testing.assert_array_equal(res["force_nnz"].numpy(),
                                  ref["force_nnz"].numpy())
    np.testing.assert_allclose(res["force"].numpy(), ref["force"].numpy(),
                               atol=1e-4)
    # the wide candidates hold the neighbor once, as the reference's do
    ids, valid = TG.hash_grid_candidates(spec, hg, tp.position)
    jhg = JG.make_builder(JG.GridSpec(dims=dims, max_per_box=4, max_per_run=8,
                                      query_chunk=2), method="hash")(
        jp, jnp.zeros(3), jnp.asarray(4.0)).grid
    jids, jvalid = JG.hash_grid_candidates(
        JG.GridSpec(dims=dims, max_per_box=4, max_per_run=8, query_chunk=2),
        jhg, jp.position)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert int((valid[0] & (ids[0] == 1)).sum()) == 1


def _crowded(rng, c=256, n=200, k=8):
    """A cloud with one box holding far more than ``k`` agents, and dead
    slots among the live ones."""
    pos = rng.uniform(0.0, 20.0, (n, 3)).astype(np.float32)
    pos[:40] = rng.uniform(4.1, 5.9, (40, 3))        # 40 in box (2, 2, 2)
    dia = np.full(n, 1.0, np.float32)
    alive = np.zeros(c, bool)
    alive[:n] = True
    alive[[3, 50, 77]] = False
    full = np.zeros((c, 3), np.float32)
    full[:n] = pos
    fdia = np.zeros(c, np.float32)
    fdia[:n] = dia
    return full, fdia, alive


def _spec_pair(**kw):
    return TG.GridSpec(**kw), JG.GridSpec(**kw)


def test_sorted_build_tables_equal_reference():
    pos, dia, alive = _crowded(np.random.default_rng(1))
    jp, tp = _pools(pos, dia, alive=alive)
    ts, js = _spec_pair(dims=(10, 10, 10), max_per_box=8, query_chunk=64)
    tg = TG.make_builder(ts, method="sorted")(tp, torch.zeros(3),
                                              torch.tensor(2.0)).grid
    jg = JG.make_builder(js, method="sorted")(jp, jnp.zeros(3),
                                              jnp.asarray(2.0)).grid
    for f in ("keys", "order", "rank", "starts", "counts", "max_count",
              "max_run_count"):
        np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                      np.asarray(getattr(jg, f)), err_msg=f)
    ch = _ch(tp)
    for f, v in TG.sort_channels(tg, ch).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(
            JG.sort_channels(jg, _ch(jp))[f]), err_msg=f)
    q = tp.position[:64]
    for got, want in zip(TG.neighbor_candidates(ts, tg, q),
                         JG.neighbor_candidates(js, jg, jp.position[:64])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_hash_build_tables_equal_reference():
    pos, dia, alive = _crowded(np.random.default_rng(2))
    jp, tp = _pools(pos, dia, alive=alive)
    ts, js = _spec_pair(dims=(10, 10, 10), max_per_box=8)
    for nb in (1 << 14, 64):          # 64 buckets: many collisions
        tg = TG.make_builder(ts, method="hash", n_buckets=nb)(
            tp, torch.zeros(3), torch.tensor(2.0)).grid
        jg = JG.make_builder(js, method="hash", n_buckets=nb)(
            jp, jnp.zeros(3), jnp.asarray(2.0)).grid
        for f in ("keys", "cell_keys", "order", "starts", "counts",
                  "max_bucket_count"):
            np.testing.assert_array_equal(getattr(tg, f).numpy(),
                                          np.asarray(getattr(jg, f)),
                                          err_msg=f"{f} at {nb} buckets")
        for j in (0, 13, 26):
            for got, want in zip(TG.hash_grid_probe(ts, tg, tp.position, j),
                                 JG.hash_grid_probe(js, jg, jp.position, j)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k", [8, 1])
def test_scatter_table_equal_reference_with_an_overfull_box(k):
    """40 agents in one box against K = 8 (and 1): the columns below K-1
    hold the box's first agents, column K-1 its last in sorted order — the
    write the reference's scatter keeps."""
    pos, dia, alive = _crowded(np.random.default_rng(3))
    jp, tp = _pools(pos, dia, alive=alive)
    ts, js = _spec_pair(dims=(10, 10, 10), max_per_box=k)
    tg = TG.make_builder(ts, method="scatter")(tp, torch.zeros(3),
                                               torch.tensor(2.0)).grid
    jg = JG.make_builder(js, method="scatter")(jp, jnp.zeros(3),
                                               jnp.asarray(2.0)).grid
    np.testing.assert_array_equal(tg.table.numpy(), np.asarray(jg.table))
    np.testing.assert_array_equal(tg.counts.numpy(), np.asarray(jg.counts))
    assert int(tg.counts.max()) >= 39         # one of the 40 is dead
    for got, want in zip(TG.scatter_grid_candidates(ts, tg, tp.position),
                         JG.scatter_grid_candidates(js, jg, jp.position)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("method", ["resident", "sorted", "scatter", "hash"])
def test_build_result_overflow_and_demand_equal_reference(method):
    pos, dia, alive = _crowded(np.random.default_rng(4))
    jp, tp = _pools(pos, dia, alive=alive)
    ts, js = _spec_pair(dims=(10, 10, 10), max_per_box=8, max_per_run=20)
    tr = TG.make_builder(ts, method=method)(tp, torch.zeros(3),
                                            torch.tensor(2.0))
    jr = JG.make_builder(js, method=method)(jp, jnp.zeros(3),
                                            jnp.asarray(2.0))
    for f in ("overflow", "demand", "order"):
        got, want = getattr(tr, f), getattr(jr, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f)
    assert int(tr.overflow) > 0
    for f, v in _ch(tr.pool).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(_ch(jr.pool)[f]),
                                      err_msg=f)


@pytest.mark.parametrize("name,args", [
    ("build", ()), ("build_resident", ()), ("build_scatter_grid", ()),
    ("build_hash_grid", (1 << 10,))])
def test_deprecated_builders_warn_and_match_make_builder(name, args):
    pos, dia, alive = _crowded(np.random.default_rng(5))
    _, tp = _pools(pos, dia, alive=alive)
    spec = TG.GridSpec(dims=(10, 10, 10), max_per_box=8)
    with pytest.warns(TG.GridBuilderDeprecationWarning, match="make_builder"):
        out = getattr(TG, name)(spec, tp, torch.zeros(3), 2.0, *args)
    method = {"build": "sorted", "build_resident": "resident",
              "build_scatter_grid": "scatter", "build_hash_grid": "hash"}[name]
    kw = {"n_buckets": args[0]} if args else {}
    res = TG.make_builder(spec, method=method, **kw)(tp, torch.zeros(3), 2.0)
    grid = out[1] if name == "build_resident" else out
    for f in dataclasses.fields(grid):
        a, b = getattr(grid, f.name), getattr(res.grid, f.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), f.name
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        TG.make_builder(spec, method=method, **kw)(tp, torch.zeros(3), 2.0)


def _count_pair(q, nbr, valid, q_slot):
    d = nbr["position"] - q["position"][:, None, :]
    ok = valid & nbr["alive"] & ((d * d).sum(-1) <= 4.0)
    return {"cnt": ok.sum(-1).to(torch.int32)}


def _brute_counts(pos, r):
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    return ((d2 <= r * r) & ~np.eye(len(pos), dtype=bool)).sum(1)


@pytest.mark.parametrize("n,c,chunk", [(50, 64, 16), (333, 512, 128)])
def test_sorted_neighbor_apply_matches_brute_force(n, c, chunk):
    rng = np.random.default_rng(n)
    pos = rng.uniform(0, 20, (n, 3)).astype(np.float32)
    tp = ta.make_pool(c, position=pos, diameter=np.ones(n, np.float32),
                      device="cpu")
    alive = tp.alive.clone()
    alive[5:9] = False                      # dead rows are no candidates
    tp = dataclasses.replace(tp, alive=alive)
    spec = TG.GridSpec(dims=(10, 10, 10), max_per_box=32, query_chunk=chunk)
    g = TG.make_builder(spec, method="sorted")(tp, torch.zeros(3), 2.0).grid
    idx, nq = tcomp.active_index_list(tp.alive)
    out = TG.neighbor_apply(spec, g, _ch(tp), idx, nq, _count_pair,
                            {"cnt": ((), torch.int32)})
    keep = alive.numpy()
    np.testing.assert_array_equal(out["cnt"].numpy()[keep],
                                  _brute_counts(pos[keep[:n]], 2.0))
    assert int(out["cnt"][~torch.from_numpy(keep)].abs().sum()) == 0


def test_phased_chunk_apply_grouping_changes_no_bit(monkeypatch):
    """Every chunk of the capacity is evaluated with the lanes past
    n_query masked: the rows per chunk (from the lane budget) change no
    output, and rows outside the query list stay zero."""
    pos, dia = _cloud(np.random.default_rng(9), 200, (16.0,) * 3)
    _, tp = _pools(pos, dia, c=256)
    spec = TG.GridSpec(dims=(8, 8, 8), max_per_box=64, query_chunk=32)
    hg = TG.make_builder(spec, method="hash")(tp, torch.zeros(3), 2.0).grid
    ch = _ch(tp)
    pair = t_pair(TFP())
    mask = tp.alive & (torch.arange(256) % 3 != 0)
    idx, nq = tcomp.active_index_list(mask)

    def phase(q_pos, q_slot, j):
        ids, valid = TG.hash_grid_probe(spec, hg, q_pos, j)
        return ids, valid & (ids != q_slot[:, None])

    runs = []
    for lanes in (TG.SWEEP_LANES, 256 * 7, 100):
        monkeypatch.setattr(TG, "SWEEP_LANES", lanes)
        runs.append(TG.phased_chunk_apply(ch, ch, idx, nq, phase, 27, pair,
                                          T_OUT, 32, width=256))
    for r in runs[1:]:
        for k in T_OUT:
            assert torch.equal(r[k], runs[0][k]), k
    assert int(runs[0]["force_nnz"][~mask].abs().sum()) == 0
    assert float(runs[0]["force"][~mask].abs().sum()) == 0.0


@pytest.mark.parametrize("domain,dims,n", GRIDS)
def test_slot_order_collision_force_matches_reference(domain, dims, n):
    """ops.collision_force (plain K1 on the CPU) ≡ the reference's
    kops.collision_force (Pallas K1, interpret mode) and ≡ the sorted
    grid's neighbor_apply, in the caller's slot order."""
    c = 384
    rng = np.random.default_rng(11)
    pos, _ = _cloud(rng, n, domain)
    dia = rng.uniform(0.5, 1.4, (n,)).astype(np.float32)
    P = np.zeros((c, 3), np.float32)
    P[:n] = pos
    D = np.zeros(c, np.float32)
    D[:n] = dia
    alive = np.zeros(c, bool)
    alive[:n] = True
    alive[[4, 40]] = False
    active = alive.copy()
    active[7] = False
    order = rng.permutation(c)                    # any slot order
    P, D, alive, active = P[order], D[order], alive[order], active[order]
    jf, jnnz, jovf = jops.collision_force(
        jnp.asarray(P), jnp.asarray(D), jnp.zeros((c,), jnp.int32),
        jnp.asarray(alive), jnp.asarray(active), jnp.zeros(3),
        jnp.asarray(2.0), dims=dims, k_rep=2.0, adhesion=None,
        adhesion_band=0.4)
    tf, tnnz, tovf = tops.collision_force(
        torch.from_numpy(P), torch.from_numpy(D),
        torch.zeros(c, dtype=torch.int32), torch.from_numpy(alive),
        torch.from_numpy(active), torch.zeros(3), torch.tensor(2.0),
        dims=dims, k_rep=2.0, adhesion=None, adhesion_band=0.4)
    assert bool(tovf) == bool(jovf) is False
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=1e-4)
    np.testing.assert_array_equal(tnnz.numpy(), np.asarray(jnnz))
    assert int(tnnz.sum()) > 0
    # its plain version is the same computation on the CPU
    pf, pnnz, _ = tops.collision_force_plain(
        torch.from_numpy(P), torch.from_numpy(D),
        torch.zeros(c, dtype=torch.int32), torch.from_numpy(alive),
        torch.from_numpy(active), torch.zeros(3), torch.tensor(2.0),
        dims=dims)
    assert torch.equal(pf, tf) and torch.equal(pnnz, tnnz)
    # and the sorted grid's streamed form agrees
    tp = ta.make_pool(c, position=P, diameter=D, device="cpu")
    tp = dataclasses.replace(tp, alive=torch.from_numpy(alive))
    spec = TG.GridSpec(dims=dims, max_per_box=c, query_chunk=128)
    g = TG.make_builder(spec, method="sorted")(tp, torch.zeros(3),
                                               torch.tensor(2.0)).grid
    idx, nq = tcomp.active_index_list(torch.from_numpy(active & alive))
    res = TG.neighbor_apply(spec, g, _ch(tp), idx, nq, t_pair(TFP()), T_OUT)
    np.testing.assert_allclose(tf.numpy(), res["force"].numpy(), atol=1e-4)
    np.testing.assert_array_equal(tnnz.numpy(), res["force_nnz"].numpy())
