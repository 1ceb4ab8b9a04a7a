"""The distributed engine on the card: 4 shards stacked as lanes of one
device ≡ the same run on the CPU, and the kernels of the path launched once
a step for all shards.

Card-only (``cuda`` marker; they skip without a CUDA device and import no
JAX, so the GPU host runs them with ``python -m pytest -q
tests/test_torch_distributed_cuda.py -m cuda``):

* forces + SIR over 4 shards with K1 (halo bands, migration, rebalance):
  every step's stats equal the CPU run's, each shard's live agents equal
  as sets (integers exact, positions 1e-4); K1 and its column map launch
  once a step;
* the sharded diffusion case: secretion launches once a step for every
  shard, the grid within 1e-4 of the CPU run's scale;
* a skin-0 pair list over the shards: the build and the pairs map once a
  step, the run ≡ the stencil map's bit for bit;
* the distributed ladder ≡ a run pre-sized at its final rungs, bit for bit;
* over ranks of a process group (``launch/distributed.py``): one NCCL
  rank holding all 4 shards, and 2 or 4 ranks one card each (skipped
  with fewer than 2 cards), ≡ the lanes run on card 0 byte for byte;
* the LM's sharded training (FSDP over a (W, 1) mesh, reduced qwen3-14b
  in f32, 3 steps, deterministic algorithms): one NCCL rank ≡ the
  unsharded step on the card bit for bit, and 2 or 4 ranks one card each
  (skipped with fewer than 2 cards) within 1e-5 + 1e-4·|x| of it.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import (DiffusionSpec, DistConfig,  # noqa: E402
                              DistributedCapacityLadder,
                              DistributedSimulation, EngineConfig,
                              ForceParams, PairListConfig)
from repro_torch.core import behaviors as tb  # noqa: E402
from repro_torch.kernels import block_cols as colmap  # noqa: E402
from repro_torch.kernels import collision_force as tk1  # noqa: E402
from repro_torch.kernels import pair_cols, pairlist, secretion  # noqa: E402

SIDE = 48.0
COUNTERS = {"k1": tk1.collision_force, "map": colmap.column_map,
            "build": pairlist.build_list,
            "pairs_map": pair_cols.column_map_from_pairs,
            "secretion": secretion.add}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _reset():
    for fn in COUNTERS.values():
        fn.launches = 0


def _counts():
    return {k: fn.launches for k, fn in COUNTERS.items()}


class Drift(tb.Behavior):
    name = "drift"

    def __call__(self, ctx, pool, rng):
        step = torch.tensor([1.2, 0.0, 0.0], device=pool.device) * ctx.dt
        new_pos = torch.where(ctx.owned[:, None], pool.position + step,
                              pool.position)
        return tb.BehaviorEffects(set_channels={"position": torch.clamp(
            new_pos, ctx.domain_lo, ctx.domain_hi)})


def _sir(n=600, force_impl="k1", pairlist_cfg=None):
    rng = np.random.default_rng(2)
    cfg = EngineConfig(capacity=1024, domain_lo=(0, 0, 0),
                       domain_hi=(SIDE,) * 3, interaction_radius=4.0,
                       dt=0.5, max_per_box=64, query_chunk=128,
                       force=ForceParams(max_displacement=0.5),
                       force_impl=force_impl, pairlist=pairlist_cfg)
    pos = rng.uniform(1, SIDE - 1, (n, 3)).astype(np.float32)
    types = np.zeros(n, np.int32)
    types[:12] = tb.INFECTED
    init = dict(diameter=np.full(n, 2.5, np.float32), agent_type=types,
                extra_init={"infect_timer": np.full(n, 5, np.int32)})
    dcfg = DistConfig(engine=cfg, n_shards=4, local_capacity=512,
                      halo_capacity=256, migrate_capacity=128,
                      rebalance_frequency=3)
    beh = lambda: [Drift(), tb.Infection(radius=4.0, beta=1.0,  # noqa
                                         recovery_time=4)]
    return dcfg, beh, pos, init


def _run(dcfg, beh, pos, init, steps, device):
    dsim = DistributedSimulation(dcfg, beh(), device=device)
    st = dsim.init_state(pos, **init)
    stats = []
    for _ in range(steps):
        st = dsim.step(st)
        stats.append({f: v.tolist() for f, v in st.stats.items()})
    return st, stats


def _shards(st, c, names):
    ch = {k: v.cpu().numpy() for k, v in st.channels.items()}
    out = []
    for s in range(len(ch["alive"]) // c):
        sl = slice(s * c, (s + 1) * c)
        a = ch["alive"][sl]
        p = ch["position"][sl][a]
        o = np.lexsort(p.T)
        out.append([p[o]] + [ch[k][sl][a][o] for k in names])
    return out


@pytest.mark.cuda
def test_four_shards_on_the_card_equal_the_cpu():
    dev = _card()
    dcfg, beh, pos, init = _sir()
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu, cpu_stats = _run(dcfg, beh, pos, init, 12, "cpu")
    finally:
        torch.set_num_threads(prev)
    _reset()
    card, card_stats = _run(dcfg, beh, pos, init, 12, dev)
    assert _counts()["k1"] == 12 and _counts()["map"] == 12
    assert card_stats == cpu_stats
    names = ("agent_type", "extra.infect_timer", "born_iter")
    for w, g in zip(_shards(cpu, 512, names), _shards(card, 512, names)):
        assert w[0].shape == g[0].shape
        np.testing.assert_allclose(g[0], w[0], rtol=0, atol=1e-4)
        for a, b in zip(w[1:], g[1:]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_sharded_secretion_launches_once_a_step():
    dev = _card()
    rng = np.random.default_rng(0)
    dspec = DiffusionSpec(dims=(16, 8, 8), coefficient=0.2, decay=0.01,
                          voxel=3.0)
    cfg = EngineConfig(capacity=256, domain_lo=(0, 0, 0),
                       domain_hi=(SIDE, 24, 24), interaction_radius=4.0,
                       dt=0.5, use_forces=False, max_per_box=64,
                       query_chunk=64, diffusion=dspec, diffusion_substeps=2)
    pos = rng.uniform(1, 23, (200, 3)).astype(np.float32)
    pos[:, 0] = rng.uniform(1, SIDE - 1, 200)
    init = dict(diameter=np.full(200, 2.0, np.float32))
    dcfg = DistConfig(engine=cfg, n_shards=4, local_capacity=128,
                      halo_capacity=64, migrate_capacity=32)
    beh = lambda: [tb.Secretion(rate=2.0), tb.Chemotaxis(speed=0.8)]  # noqa
    cpu, _ = _run(dcfg, beh, pos, init, 6, "cpu")
    _reset()
    card, _ = _run(dcfg, beh, pos, init, 6, dev)
    assert _counts()["secretion"] == 6
    ref = cpu.conc.numpy()
    assert np.abs(card.conc.cpu().numpy() - ref).max() <= 1e-4 * max(
        1.0, float(ref.max()))


@pytest.mark.cuda
def test_pair_list_over_shards_launches_once_a_step():
    dev = _card()
    out = {}
    for pl in (None, PairListConfig(skin=0.0, max_pairs=96)):
        dcfg, beh, pos, init = _sir(pairlist_cfg=pl)
        _reset()
        out[pl is None], _ = _run(dcfg, beh, pos, init, 6, dev)
        if pl is not None:
            c = _counts()
            assert c["build"] == 6 and c["pairs_map"] == 6 and c["k1"] == 6
    for k, v in out[True].channels.items():
        assert torch.equal(v, out[False].channels[k]), k


@pytest.mark.cuda
def test_distributed_ladder_on_the_card_equals_presized():
    dev = _card()
    dcfg, beh, pos, init = _sir(n=900)
    small = dataclasses.replace(dcfg, local_capacity=160, halo_capacity=64,
                                migrate_capacity=16)
    lad = DistributedCapacityLadder(small, beh(), device=dev)
    st = lad.run(lad.init_state(pos, **init), 8)
    assert lad.rungs
    pre = DistributedSimulation(lad.dcfg, beh(), device=dev)
    sp = pre.run(pre.init_state(pos, **init), 8, check_overflow=True)
    for k, v in st.channels.items():
        assert torch.equal(v, sp.channels[k]), k


# ---------------------------------------------------------------------------
# ranks of a process group (launch/distributed.py), one card each over NCCL
# ---------------------------------------------------------------------------

RANK_JOBS = ({"scenario": "sir", "force_impl": "k1", "steps": 8,
              "name": "sir_k1"},
             {"scenario": "every_k", "skin": 0.0, "steps": 6,
              "name": "every_k"})


def _ranks_equal_lanes(tmp_path, ranks: int) -> None:
    """Each job on ``ranks`` NCCL ranks ≡ its lanes run on card 0, every
    array byte for byte (the final state, every step's stats)."""
    from repro_torch.launch import distributed as launcher
    launcher.launch(list(RANK_JOBS), ranks, str(tmp_path), device="cuda")
    for job in RANK_JOBS:
        got = dict(np.load(tmp_path / f"{job['name']}.npz"))
        want = launcher.run_job(job, None, "cuda")["arrays"]
        assert sorted(got) == sorted(want)
        for k, w in want.items():
            assert got[k].dtype == w.dtype and got[k].tobytes() == \
                w.tobytes(), (job["name"], k)


@pytest.mark.cuda
def test_one_nccl_rank_equals_the_lanes_run(tmp_path):
    _card()
    _ranks_equal_lanes(tmp_path, 1)


@pytest.mark.cuda
def test_nccl_ranks_on_several_cards_equal_the_lanes_run(tmp_path):
    _card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 cards for 2 NCCL ranks, {n} visible")
    _ranks_equal_lanes(tmp_path, 4 if n >= 4 else 2)


# ---------------------------------------------------------------------------
# the LM's sharded training over NCCL ranks (rank_cases.run_train_case)
# ---------------------------------------------------------------------------

TRAIN_OPT = dict(lr=1e-2, warmup_steps=2, total_steps=10)
TRAIN_CASE = dict(name="qwen3", arch="qwen3-14b", steps=3, batch=4, seq=16,
                  opt=TRAIN_OPT, deterministic=True)


def _unsharded_on_the_card():
    """The same case on card 0 with no mesh: the port's one-device step."""
    from repro_torch.configs import ARCHS
    from repro_torch.data import DataConfig, batch_at
    from repro_torch.models import build_model, reduced_config
    from repro_torch.train import AdamWConfig, init_state, make_train_step
    cfg = reduced_config(ARCHS["qwen3-14b"])
    model = build_model(cfg, attn_impl="sdpa", device="cuda")
    p = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    oc = AdamWConfig(**TRAIN_OPT)
    st, step, out = init_state(oc, p), make_train_step(model, oc), []
    dcfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4,
                      seed=1234, d_model=cfg.d_model)
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        for i in range(3):
            p, st, m = step(p, st, batch_at(dcfg, i, device="cuda"))
            out.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
    finally:
        torch.use_deterministic_algorithms(prev)
    return out


def _sharded_on_ranks(tmp_path, ranks: int):
    import json

    import rank_cases
    from repro_torch.launch import distributed as launcher
    launcher.spawn_ranks(rank_cases.run_train_cases,
                         ([TRAIN_CASE], str(tmp_path)), ranks, "cuda")
    return json.loads((tmp_path / "cases.json").read_text())[0]["metrics"]


@pytest.mark.cuda
def test_one_nccl_rank_trains_as_the_unsharded_step(tmp_path, monkeypatch):
    _card()
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    assert _sharded_on_ranks(tmp_path, 1) == _unsharded_on_the_card()


@pytest.mark.cuda
def test_fsdp_on_several_cards_trains_as_one_card(tmp_path, monkeypatch):
    _card()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip(f"needs 2 cards for 2 NCCL ranks, {n} visible")
    monkeypatch.setenv("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    got = _sharded_on_ranks(tmp_path, 4 if n >= 4 else 2)
    for g, w in zip(got, _unsharded_on_the_card()):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], atol=1e-5, rtol=1e-4,
                                       err_msg=k)
