"""The port's roofline: the step tracer, the H100 terms, the report tables.

* ``trace_step`` under fake tensors gives the same FLOPs, argument bytes
  and peak live bytes as the same tracer over real CPU tensors, on a
  reduced dense config and a reduced MoE config (2 microbatches), and
  bytes moved within 0.1% (``F.one_hot`` decomposes otherwise on fake
  tensors: an ``arange`` compare, where the CPU checks the range and
  scatters); its FLOPs are within 10% of ``analytic_step_flops``
  (matmuls only, and the attention scores over the whole square, where
  the analytic count takes the causal half);
* the tracer's rules: a broadcast counts once, views and detach move
  nothing, an in-place op counts its operand read and written, a storage
  stops counting when its last tensor dies;
* ``analyze``: no collectives recorded → ``collective_s`` None and the
  dominant term of the other two; the H100 constants;
* ``refresh_record`` recomputes the terms with those constants;
* the dry-run and hill-climb tables have the reference's rows on the same
  records.
"""

import copy
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import reduced_config  # noqa: E402
from repro_torch.models.layers import ShapeDtype  # noqa: E402
from repro_torch.roofline import analysis as A  # noqa: E402
from repro_torch.roofline import refresh as trefresh  # noqa: E402
from repro_torch.roofline import report as treport  # noqa: E402

SHAPE = ShapeSpec("train_tiny", 32, 4, "train")
FLOPS_RTOL = 0.10
BYTES_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cell(arch, micro):
    cfg = reduced_config(TARCHS[arch])
    return cfg, tcells.build_cell(cfg, SHAPE, tmesh.make_host_mesh(),
                                  tmesh.mesh_axes(False), force_micro=micro)


@pytest.mark.parametrize("arch,micro", [("qwen2-1.5b", 1),
                                        ("deepseek-v2-lite-16b", 2)])
def test_fake_trace_equals_the_real_one(arch, micro):
    cfg, cell = _cell(arch, micro)
    fake = A.trace_step(cell.fn, *cell.args)
    real = A.trace_step(cell.fn, *cell.args, fake=False)
    assert (fake.flops, fake.argument_bytes, fake.peak_bytes) == \
        (real.flops, real.argument_bytes, real.peak_bytes)
    assert abs(fake.bytes_moved / real.bytes_moved - 1) < BYTES_RTOL
    assert fake.peak_bytes > fake.argument_bytes > 0
    want = tcells.analytic_step_flops(cfg, SHAPE)
    assert abs(fake.flops / want - 1) < FLOPS_RTOL, (fake.flops, want)


def test_trace_of_given_tensors_keeps_them_alive():
    """Tensors among the arguments count as arguments, fake or not."""
    x = torch.ones(256)
    for fake in (True, False):
        cost = A.trace_step(lambda t: t * 2, x, fake=fake)
        assert cost.argument_bytes == 1024
        assert cost.peak_bytes == 2048
        assert cost.bytes_moved == 2048 and cost.n_ops == 1


def test_tracer_rules():
    n = 1000

    def step(a, b, row):
        v = a.view(10, 100).t()          # views: nothing moved
        d = a.detach()                   # nothing moved
        c = a + row.expand(n)            # broadcast read once: 4n + 4 + 4n
        c.add_(b)                        # in place: 4n + 4n + 4n
        del c                            # freed before e
        e = (v.sum() + d.sum()).reshape(1)
        return e

    args = (ShapeDtype((n,), torch.float32),
            ShapeDtype((n,), torch.float32),
            ShapeDtype((1,), torch.float32))
    for fake in (True, False):
        cost = A.trace_step(step, *args, fake=fake)
        assert cost.argument_bytes == 8 * n + 4
        # the expand is a view; add reads a (4n) and the row once (4),
        # writes c (4n); add_ 12n; two sums read 4n each and write 4;
        # their add reads 8 and writes 4; reshape of a 0-dim is a view
        assert cost.bytes_moved == (8 * n + 4) + 12 * n + 2 * (4 * n + 4) \
            + 12, fake
        assert cost.peak_bytes == cost.argument_bytes + 4 * n, fake


def test_tensor_bytes_counts_a_broadcast_once():
    x = torch.zeros(3, 1, 5)
    assert A.tensor_bytes(x.expand(3, 7, 5)) == 60
    assert A.tensor_bytes(torch.zeros(0, 4)) == 0
    assert A.tensor_bytes(torch.zeros(4, dtype=torch.bfloat16)) == 8


def test_h100_constants():
    assert A.PEAK_FLOPS == 989e12
    assert A.HBM_BW == 3.35e12
    assert A.NVLINK_BW == 450e9
    assert 80e9 < A.HBM_BYTES < 80 * 2**30


def test_analyze_leaves_unrecorded_terms_null():
    rl = A.analyze({"flops": 989e12, "bytes accessed": 6.7e12})
    assert rl.compute_s == 1.0 and rl.memory_s == 2.0
    assert rl.collective_s is None and rl.wire_bytes_per_device is None
    assert rl.dominant == "memory" and rl.step_time_bound_s == 2.0
    rl = A.analyze({"flops": 989e12, "bytes accessed": None})
    assert rl.memory_s is None and rl.dominant == "compute"
    rl = A.analyze({"flops": 989e12, "bytes accessed": 0.0},
                   {"all-reduce": 900e9, "all-gather": 450e9})
    assert rl.collective_s == 3.0 and rl.dominant == "collective"
    assert rl.collective_breakdown == {"all-reduce": 900e9,
                                       "all-gather": 450e9}
    assert rl.as_dict()["collective_s"] == 3.0


def _record(cell, arch, shape, status="ok", n_dev=1, mem=True):
    """A record as ``dryrun.run_cell`` writes it."""
    if status != "ok":
        return {"cell": cell, "status": status,
                ("reason" if status == "skipped" else "error"): "why"}
    rl = A.analyze({"flops": 2e15 / n_dev,
                    "bytes accessed": 1e13 if mem else None})
    temp = 3 * 2**30 if mem else None
    return {"cell": cell, "status": "ok", "arch": arch, "shape": shape,
            "mesh": [1, 1] if n_dev == 1 else [16, 16], "n_devices": n_dev,
            "n_params": 1_543_714_304, "n_active_params": 1_543_714_304,
            "note": "microbatches=1", "trace_s": 8.4,
            "memory": {"argument_bytes_per_device": 2**30,
                       "temp_bytes_per_device": temp,
                       "total_bytes_per_device": temp and temp + 2**30,
                       "hbm_budget_bytes": A.HBM_BYTES},
            "roofline": rl.as_dict(), "model_flops": 1.5e15,
            "analytic_flops_global": 2e15, "useful_flops_ratio": 0.75,
            "roofline_fraction": 1.5e15 / n_dev / A.PEAK_FLOPS
            / rl.step_time_bound_s,
            "step_time_bound_s": rl.step_time_bound_s}


RECORDS = [
    _record("qwen2-1.5b__decode_32k__host", "qwen2-1.5b", "decode_32k"),
    _record("qwen2-1.5b__long_500k__pod1", None, None, status="skipped"),
    _record("qwen2-1.5b__train_4k__pod1", "qwen2-1.5b", "train_4k",
            n_dev=256, mem=False),
    _record("yi-6b__train_4k__pod1", None, None, status="error"),
    _record("yi-6b__train_4k__pod2", "yi-6b", "train_4k", n_dev=512,
            mem=False),
]


def _as_reference(rec):
    """The same record in the reference's layout: ``compile_s`` for the
    trace's seconds and zeros for the null terms it cannot print."""
    r = copy.deepcopy(rec)
    if r["status"] != "ok":
        return r
    r["compile_s"] = r["trace_s"]
    mem = r["memory"]
    if mem["total_bytes_per_device"] is None:
        mem["total_bytes_per_device"] = mem["argument_bytes_per_device"]
    for k in ("memory_s", "collective_s"):
        r["roofline"][k] = r["roofline"][k] or 0.0
    r["roofline"]["collective_breakdown"] = {}
    return r


def _rows(table):
    return [[c.strip() for c in row.strip("|").split("|")]
            for row in table.splitlines()[2:]]


@pytest.fixture(scope="module")
def rreport():
    pytest.importorskip("jax")
    from repro.roofline import report
    return report


@pytest.mark.parametrize("pod", ["host", "pod1", "pod2"])
def test_report_tables_have_the_reference_rows(rreport, pod):
    ref = [_as_reference(r) for r in RECORDS]
    got, want = (_rows(treport.dryrun_table(RECORDS, pod)),
                 _rows(rreport.dryrun_table(ref, pod)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        # cell, status, params, bytes/device; trace s; note
        assert g[:4] == w[:4] and g[5:] == w[5:], (g, w)
    got, want = (_rows(treport.roofline_table(RECORDS, pod)),
                 _rows(rreport.roofline_table(ref, pod)))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g[:3] == w[:3] and g[5:8] == w[5:8], (g, w)
        for a, b in zip(g[3:5], w[3:5]):
            assert a in ("-", b), (g, w)


def test_report_marks_nulls_and_the_card_budget():
    table = treport.dryrun_table(RECORDS, "pod1")
    head = f"fits {A.HBM_BYTES / 1e9:.0f}G"
    assert head in table.splitlines()[0] and "trace s" in table
    row = _rows(treport.roofline_table(RECORDS, "pod1"))[0]
    assert row[3] == row[4] == "-" and row[5] == "**compute**"


def test_perf_table_has_the_reference_rows(rreport, tmp_path):
    rl = A.analyze({"flops": 1e14, "bytes accessed": None})
    rec = {"variant": "q3_decode_v1_kv_tp", "hypothesis": "h" * 100,
           "roofline": rl.as_dict(), "step_time_bound_s": rl.compute_s,
           "roofline_fraction": 0.5}
    (tmp_path / "q3_decode_v1_kv_tp.json").write_text(json.dumps(rec))
    got = _rows(treport.perf_table(str(tmp_path)))
    ref = copy.deepcopy(rec)
    ref["roofline"].update(memory_s=0.0, collective_s=0.0)
    (tmp_path / "q3_decode_v1_kv_tp.json").write_text(json.dumps(ref))
    want = _rows(rreport.perf_table(str(tmp_path)))
    assert len(got) == len(want) == 1
    assert got[0][:3] == want[0][:3] and got[0][5:] == want[0][5:]
    assert got[0][3] == got[0][4] == "-"


def test_refresh_record_uses_the_h100_constants():
    rec = copy.deepcopy(RECORDS[0])
    rec["roofline"].update(compute_s=123.0, memory_s=9.0, dominant="memory")
    rec["memory"]["hbm_budget_bytes"] = 16 * 2**30
    out = trefresh.refresh_record(rec)
    analytic = tcells.analytic_step_flops(TARCHS["qwen2-1.5b"],
                                          TSHAPES["decode_32k"])
    assert out["roofline"]["compute_s"] == analytic / A.PEAK_FLOPS
    assert out["roofline"]["memory_s"] == 1e13 / A.HBM_BW
    assert out["roofline"]["collective_s"] is None
    assert out["memory"]["hbm_budget_bytes"] == A.HBM_BYTES
    assert out["step_time_bound_s"] == max(out["roofline"]["compute_s"],
                                           out["roofline"]["memory_s"])
    assert out["useful_flops_ratio"] == out["model_flops"] / analytic
    assert trefresh.refresh_record(RECORDS[1]) == RECORDS[1]
