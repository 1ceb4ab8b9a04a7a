"""The distributed engine over the ranks of a gloo process group on the
CPU (``launch/distributed.py``, ``core/transport.py``) ≡ the same runs
with every shard a lane of one device (``ShardAxis``), bit for bit.

The cases run in one subprocess per world size (each with a timeout),
through the launcher's ``spawn_ranks`` and ``run_jobs``: W = 4, one
shard a rank, and W = 2, two shards a rank. The launcher's own jobs run
as ``run_job`` runs them; the ladder, the supervised drill and the
checkpoint chain through ``rank_cases.run_case`` (this directory). For
each, every array of every job equals the lanes run of this process byte
for byte: the whole run's final channels (ints, f32, int16 and bf16
channels), grid, keys, every step's stats of every shard and every step's
slab boundaries. The jobs:

* forces in the streamed sweep and in K1 (its plain version here);
* SIR with drift, births, deaths, migration and a rebalance every 3
  steps;
* sharded diffusion with secretion and chemotaxis;
* every_k with a pair list, the shards' rebuild flags differing within a
  step (shards 0-2 rebuild, shard 3 reuses its cache);
* SIR with narrowed channels (bf16 diameters, int16 types);
* the capacity ladder: the same rungs on every rank, ≡ a run pre-sized
  at its final rungs;
* a supervised run with a NaN drill: every rank rolls back to the same
  checkpoint with the same remedy.

And checkpoints across rank counts: a lanes checkpoint resumed on 4
ranks, their checkpoint resumed on 2 ranks and on the lanes, each ≡ the
uninterrupted lanes run.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
from rank_cases import ROOT, run_case  # noqa: E402
from repro_torch.core import DistributedSimulation, restore_dist_state  # noqa
from repro_torch.core.transport import pack_rows, unpack_rows  # noqa: E402
from repro_torch.launch import distributed as launcher  # noqa: E402

CPU = "cpu"
WORLDS = (4, 2)
SUP = {"checkpoint_every": 4}
JOBS = (
    {"name": "forces_streamed", "scenario": "forces", "steps": 4},
    {"name": "forces_k1", "scenario": "forces", "force_impl": "k1",
     "steps": 4},
    {"name": "sir", "scenario": "sir", "steps": 10},
    {"name": "diffusion", "scenario": "diffusion", "steps": 6},
    {"name": "every_k", "scenario": "every_k", "steps": 8},
    {"name": "narrowed", "scenario": "narrowed", "steps": 5},
    {"name": "ladder", "scenario": "ladder", "ladder": True, "steps": 7},
    {"name": "supervised", "scenario": "forces", "steps": 10,
     "nan_drill": {"iteration": 6, "row": 3}},
)
NAMES = [j["name"] for j in JOBS]
CK_AT = 4                            # the lanes checkpoint's step


@pytest.fixture(scope="module", autouse=True)
def _single_thread():
    """One torch thread for the module's runs, its fixtures' included (as
    every rank runs): threaded CPU kernels may round a chunk otherwise."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _supervised(job, ckpt_dir) -> dict:
    return dict(job, supervised=dict(SUP, ckpt_dir=str(ckpt_dir)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: {name: (arrays, meta)}} of the ranks, and the lanes'
    {name: run_job result}, with the checkpoint chain."""
    d = tmp_path_factory.mktemp("ranks")
    ck_lanes, ck4 = d / "ck_lanes", d / "ck4"
    run_case({"scenario": "every_k", "steps": CK_AT, "save": str(ck_lanes)},
             None, CPU)
    chain = {4: {"name": "resumed", "scenario": "every_k", "steps": CK_AT,
                 "resume": str(ck_lanes), "save": str(ck4)},
             2: {"name": "resumed", "scenario": "every_k", "steps": CK_AT,
                 "resume": str(ck4)}}
    ranks = {}
    for world in WORLDS:
        out = d / f"w{world}"
        jobs = [_supervised(j, d / f"sup{world}") if "nan_drill" in j
                else j for j in JOBS] + [chain[world]]
        rank_cases.launch(jobs, world, out)
        ranks[world] = {j["name"]: (dict(np.load(out / f"{j['name']}.npz")),
                                    json.loads((out / f"{j['name']}.json")
                                               .read_text()))
                        for j in jobs}
    lanes = {j["name"]: run_case(
        _supervised(j, d / "sup_lanes") if "nan_drill" in j else j, None,
        CPU) for j in JOBS}
    lanes["whole"] = run_case({"scenario": "every_k", "steps": 3 * CK_AT},
                              None, CPU)
    return ranks, lanes, {"ck4": ck4}


def _equal(got: dict, want: dict, what: str, keys=None) -> None:
    for k in keys or sorted(want):
        g, w = got[k], want[k]
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert g.tobytes() == w.tobytes(), (what, k)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("world", WORLDS)
def test_ranks_equal_the_lanes_run(runs, world, name):
    ranks, lanes, _ = runs
    got, meta = ranks[world][name]
    want = lanes[name]["arrays"]
    assert sorted(got) == sorted(want)
    _equal(got, want, f"W={world} {name}")
    assert meta["world"] == world and len(meta["ranks"]) == world


def test_the_jobs_cover_what_they_claim(runs):
    """The lanes runs themselves: migration and a rebalance in the SIR,
    births and deaths, mixed rebuild flags under every_k, narrowed
    dtypes, rungs grown, a rollback."""
    _, lanes, _ = runs
    fields = list(lanes["sir"]["arrays"]["fields"])

    def total(name, f):
        return lanes[name]["arrays"]["stats"][:, fields.index(f)].sum(0)
    sir = lanes["sir"]["arrays"]
    assert total("sir", "births").sum() > 0
    assert not np.array_equal(sir["bounds"][0], sir["bounds"][-1])
    n_live = sir["stats"][:, fields.index("n_live")]
    assert (np.diff(n_live, axis=0) != 0).any(), "no agent changed shard"
    skips = lanes["every_k"]["arrays"]["stats"][:, fields.index(
        "rebuild_skips")]
    builds = lanes["every_k"]["arrays"]["stats"][:, fields.index("rebuilds")]
    assert ((skips > 0).any(1) & (builds > 0).any(1)).any(), \
        "no step with mixed rebuild flags"
    narrowed = lanes["narrowed"]["arrays"]
    assert narrowed["ch.agent_type"].dtype == np.int16
    assert lanes["ladder"]["own"]["rungs"], "the ladder never grew"
    ivs = lanes["supervised"]["own"]["report"]["interventions"]
    assert [iv["rolled_back_to"] for iv in ivs] == [4]


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_takes_the_lanes_rungs(runs, world):
    ranks, lanes, _ = runs
    _, meta = ranks[world]["ladder"]
    want = lanes["ladder"]["own"]
    for r in meta["ranks"]:
        assert r["rungs"] == want["rungs"]
        assert r["final_rungs"] == want["final_rungs"]


def test_the_ladder_over_ranks_equals_presized(runs):
    """The 4 ranks' ladder run ≡ a lanes run pre-sized at its final
    rungs."""
    ranks, _, _ = runs
    got, meta = ranks[4]["ladder"]
    pre = run_case({"scenario": "ladder", "steps": 7,
                    "rungs": meta["ranks"][0]["final_rungs"]},
                   None, CPU)["arrays"]
    _equal(got, pre, "ladder vs pre-sized",
           [k for k in pre if k.startswith("ch.")] + ["rng"])


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_rolls_back_alike(runs, world):
    ranks, lanes, _ = runs
    _, meta = ranks[world]["supervised"]
    want = lanes["supervised"]["own"]["report"]
    for r in meta["ranks"]:
        assert r["report"]["interventions"] == want["interventions"]
        assert r["report"]["checkpoints"] == want["checkpoints"]


@pytest.mark.parametrize("world", WORLDS)
def test_a_resumed_checkpoint_continues_the_lanes_run(runs, world):
    """W=4 resumed the lanes' checkpoint of step 4 and wrote one at step
    8; W=2 resumed that: each ≡ the uninterrupted lanes run, its final
    state and its steps' stats."""
    ranks, lanes, _ = runs
    got, _ = ranks[world]["resumed"]
    end = CK_AT * (2 if world == 4 else 3)
    want = (lanes["every_k"] if world == 4 else lanes["whole"])["arrays"]
    _equal(got, want, f"resumed on {world} ranks",
           [k for k in want if k.startswith("ch.")] + ["rng", "conc"])
    np.testing.assert_array_equal(got["stats"],
                                  lanes["whole"]["arrays"]["stats"][
                                      end - CK_AT:end])
    np.testing.assert_array_equal(got["bounds"],
                                  lanes["whole"]["arrays"]["bounds"][
                                      end - CK_AT:end + 1])


def test_a_four_rank_checkpoint_resumes_on_the_lanes(runs):
    ranks, lanes, paths = runs
    job = launcher.scenario({"scenario": "every_k"})
    st, dcfg = restore_dist_state(str(paths["ck4"]), job.dcfg,
                                  job.behaviors(), device=CPU)
    assert int(st.iteration) == 2 * CK_AT
    sim = DistributedSimulation(dcfg, job.behaviors(), device=CPU)
    st = sim.run(st, CK_AT)
    want = lanes["whole"]["arrays"]
    for k, v in st.channels.items():
        assert v.numpy().tobytes() == want["ch." + k].tobytes(), k
    assert st.rng.numpy().tobytes() == want["rng"].tobytes()


@pytest.mark.parametrize("shapes", [[(5, 3), (5,), (5, 2, 2)], [(1, 7)]])
def test_a_move_packs_every_channel_into_one_byte_buffer(shapes):
    """``pack_rows`` / ``unpack_rows``: rows of every dtype the pool holds
    (gloo's all-gather refuses int16) through one uint8 buffer and back,
    bit for bit."""
    g = torch.Generator().manual_seed(len(shapes))
    dts = (torch.float32, torch.bfloat16, torch.int16, torch.int64,
           torch.bool, torch.uint8)
    ts = [torch.randint(0, 2 if dt == torch.bool else 100, shape,
                        generator=g).to(dt)
          for shape in shapes for dt in dts]
    buf = pack_rows(ts)
    assert buf.dtype == torch.uint8 and buf.shape[0] == shapes[0][0]
    assert buf.shape[1] == sum(t[0].numel() * t.element_size() for t in ts)
    for a, b in zip(ts, unpack_rows(buf, ts)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_the_launcher_cli_on_two_ranks_equals_the_lanes_run(tmp_path):
    """``python -m repro_torch.launch.distributed --ranks 2 --device cpu``
    (spawned gloo ranks, two shards a rank) writes the lanes run's arrays
    and one record a rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.distributed", "--ranks",
         "2", "--device", "cpu", "--scenario", "forces", "--steps", "3",
         "--out", str(tmp_path)], env=env, capture_output=True, text=True,
        timeout=rank_cases.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    got = dict(np.load(tmp_path / "forces.npz"))
    meta = json.loads((tmp_path / "forces.json").read_text())
    want = launcher.run_job({"scenario": "forces", "steps": 3}, None,
                            CPU)["arrays"]
    assert sorted(got) == sorted(want)
    _equal(got, want, "the CLI on 2 ranks")
    assert meta["world"] == 2 and len(meta["ranks"]) == 2
    assert all(len(r["ms"]) == 3 for r in meta["ranks"])


def test_the_example_on_four_ranks_prints_the_lanes_run(monkeypatch,
                                                         capsys):
    """``epidemiology --distributed --ranks 4`` (one shard a gloo rank,
    rank 0 printing) prints the table of ``--distributed`` (the 4 shards
    as lanes of one device) line for line."""
    from repro_torch.examples import epidemiology
    knobs = {"EXAMPLE_N": "800", "EXAMPLE_EPOCHS": "1"}
    for k, v in knobs.items():
        monkeypatch.setenv(k, v)
    epidemiology.main(["--device", "cpu", "--distributed"])
    want = capsys.readouterr().out
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), **knobs)
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.epidemiology",
         "--device", "cpu", "--distributed", "--ranks", "4"], env=env,
        capture_output=True, text=True, timeout=rank_cases.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "OK:" in want and proc.stdout == want
