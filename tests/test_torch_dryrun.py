"""The port's dry-run cells ≡ the JAX package's, on its own meshes.

* ``resolve_spec`` equals the reference's ``tuple(PartitionSpec)`` for
  every placeholder under every ``MeshAxes`` the meshes and the
  hill-climb's ``tp_only`` give, and raises as it does;
* ``ParamSet.spec_tree`` / ``shape_tree`` equal the reference's for every
  config of ``ARCHS``;
* ``Mesh.shard_shape`` of every parameter leaf equals
  ``NamedSharding(AbstractMesh, spec).shard_shape`` on 16 × 16 and 2 × 16
  × 16, and takes the ceiling where the reference raises;
* ``probe_config`` equals the reference's at k = 1 and 2;
* ``build_cell`` on both production meshes, for every applicable (config
  × shape) and every hill-climb variant: the same leaves (tree paths,
  shapes, dtypes by name, specs), ``model_flops``, ``n_params``,
  ``n_active_params`` and ``note`` as the reference's on an
  ``AbstractMesh``;
* the hill-climb's ``_variants()`` equal the reference's;
* ``run_cell`` on the host mesh writes a record with every key filled; on
  the production mesh its ``argument_bytes_per_device`` is the sum of the
  reference's shard shapes times the itemsize.

Full registries are shapes only; nothing here is traced at full size
except one decode cell (fake tensors, no memory).
"""

import dataclasses
import json
import math
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs import SHAPES as TSHAPES  # noqa: E402
from repro_torch.configs import shape_applicable  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.launch import dryrun as tdryrun  # noqa: E402
from repro_torch.launch import hillclimb as thill  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402

PLACEHOLDERS = ((None,), ("fsdp",), ("tp",), ("batch",), ("fsdp", "tp"),
                ("tp", "fsdp"), ("batch", None, "tp"), (None, "fsdp", None),
                ())
MESHES = {"pod1": ((16, 16), ("data", "model")),
          "pod2": ((2, 16, 16), ("pod", "data", "model"))}


def _axes_cases():
    """(id, MeshAxes) of both meshes and of the hill-climb's tp_only."""
    cases = [("pod1", tmesh.mesh_axes(False)), ("pod2", tmesh.mesh_axes(True))]
    for pod, batch in (("pod1", ("data",)), ("pod2", ("pod", "data"))):
        cases.append((f"{pod}-tp_only", tlayers.MeshAxes(
            fsdp=(), tp="model", batch_axes=batch)))
    return cases


AXES = _axes_cases()


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

    from repro.configs import ARCHS, SHAPES
    from repro.launch import cells
    from repro.models import build_model
    from repro.models import layers
    return types.SimpleNamespace(
        ARCHS=ARCHS, SHAPES=SHAPES, cells=cells, build_model=build_model,
        layers=layers, P=PartitionSpec, NamedSharding=NamedSharding,
        meshes={k: AbstractMesh(*v) for k, v in MESHES.items()})


@pytest.fixture
def ref_hints(jx, monkeypatch):
    """The reference's ``build_cell`` installs its mesh axes for the
    sharding hints in a module global; restore it after the test."""
    monkeypatch.setattr(jx.layers, "_HINT_AXES", jx.layers._HINT_AXES)


def _ref_axes(jx, axes):
    return jx.layers.MeshAxes(fsdp=axes.fsdp, tp=axes.tp,
                              batch_axes=axes.batch_axes)


def _ref_leaves(jx, tree):
    """{path: leaf} of a reference tree, a path as dict keys and indices."""
    import jax
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (jx.P, jx.NamedSharding)))
    out = {}
    for path, leaf in flat:
        out[tuple(getattr(k, "key", getattr(k, "idx", None))
                  for k in path)] = leaf
    return out


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("axes_id,axes", AXES, ids=[a for a, _ in AXES])
def test_resolve_spec_equals_the_reference(jx, axes_id, axes):
    raxes = _ref_axes(jx, axes)
    for spec in PLACEHOLDERS:
        assert tlayers.resolve_spec(spec, axes) == \
            tuple(jx.layers.resolve_spec(spec, raxes)), (axes_id, spec)
    for bad in (("data",), ("fsdp", "model")):
        with pytest.raises(ValueError, match="unknown axis placeholder"):
            tlayers.resolve_spec(bad, axes)
        with pytest.raises(ValueError, match="unknown axis placeholder"):
            jx.layers.resolve_spec(bad, raxes)
    assert axes.batch == raxes.batch


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_spec_and_shape_trees_equal_the_reference(jx, arch):
    tps = tbuild(TARCHS[arch], device="meta").ps
    rps = jx.build_model(jx.ARCHS[arch]).ps
    shapes = tps.shape_tree()
    got_shapes = {p: sd for p, sd, _ in
                  tcells.leaves_with_specs(shapes, shapes)}
    want_shapes = _ref_leaves(jx, rps.shape_tree())
    assert set(got_shapes) == set(want_shapes)
    for path, sd in got_shapes.items():
        assert sd.shape == want_shapes[path].shape, path
        assert _dtype_name(sd.dtype) == str(want_shapes[path].dtype), path
    for _, axes in AXES:
        got = {p: s for p, _, s in tcells.leaves_with_specs(
            tps.shape_tree(), tps.spec_tree(axes))}
        want = _ref_leaves(jx, rps.spec_tree(_ref_axes(jx, axes)))
        assert got == {p: tuple(s) for p, s in want.items()}, arch


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_shard_shapes_equal_named_sharding(jx, arch):
    tps = tbuild(TARCHS[arch], device="meta").ps
    for pod, multi in (("pod1", False), ("pod2", True)):
        mesh = tmesh.make_production_mesh(multi_pod=multi)
        assert (mesh.shape, mesh.axis_names) == MESHES[pod]
        axes = tmesh.mesh_axes(multi)
        for path, sd, spec in tcells.leaves_with_specs(
                tps.shape_tree(), tps.spec_tree(axes)):
            got = mesh.shard_shape(sd.shape, spec)
            sharding = jx.NamedSharding(jx.meshes[pod], jx.P(*spec))
            try:
                want = sharding.shard_shape(sd.shape)
            except ValueError:       # the reference refuses an uneven dim
                want = tuple(-(-d // mesh.axis_size(e))
                             for d, e in zip(sd.shape, spec))
            assert got == tuple(want), (arch, pod, path, spec)


def test_mesh_shapes_and_ceiling():
    host = tmesh.make_host_mesh()
    assert (host.shape, host.axis_names, host.size) == \
        ((1, 1), ("data", "model"), 1)
    pod2 = tmesh.make_production_mesh(multi_pod=True)
    assert pod2.size == 512
    assert pod2.shard_shape((33, 48), (("pod", "data"), "model")) == (2, 3)
    assert pod2.shard_shape((33, 48), ("model",)) == (3, 48)
    with pytest.raises(ValueError, match="not on the mesh"):
        host.shard_shape((4,), ("pod",))
    assert tmesh.mesh_axes(True) == tlayers.MeshAxes(fsdp=("pod", "data"))


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_probe_config_equals_the_reference(jx, arch):
    for k in (1, 2):
        got = tcells.probe_config(TARCHS[arch], k)
        want = jx.cells.probe_config(jx.ARCHS[arch], k)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), (arch, k)


def _same_cell(jx, got, want, what):
    assert got.model_flops == want.model_flops, what
    assert got.n_params == want.n_params, what
    assert got.n_active_params == want.n_active_params, what
    assert got.note == want.note, what
    assert len(got.args) == len(want.args), what
    structs = _ref_leaves(jx, want.args)
    shardings = _ref_leaves(jx, want.in_shardings)
    seen = set()
    for path, sd, spec in tcells.leaves_with_specs(got.args,
                                                   got.in_shardings):
        seen.add(path)
        ref = structs[path]
        assert sd.shape == tuple(ref.shape), (what, path)
        assert _dtype_name(sd.dtype) == str(ref.dtype), (what, path)
        assert spec == tuple(shardings[path].spec), (what, path)
    assert seen == set(structs) == set(shardings), what


CELLS = [(a, s, pod) for a in sorted(TARCHS) for s in TSHAPES
         for pod in MESHES
         if shape_applicable(TARCHS[a], TSHAPES[s])[0]]


@pytest.mark.parametrize("arch,shape,pod", CELLS,
                         ids=[f"{a}-{s}-{p}" for a, s, p in CELLS])
def test_build_cell_equals_the_reference(jx, ref_hints, arch, shape, pod):
    multi = pod == "pod2"
    mesh = tmesh.make_production_mesh(multi_pod=multi)
    axes = tmesh.mesh_axes(multi)
    got = tcells.build_cell(TARCHS[arch], TSHAPES[shape], mesh, axes)
    want = jx.cells.build_cell(jx.ARCHS[arch], jx.SHAPES[shape],
                               jx.meshes[pod], _ref_axes(jx, axes))
    _same_cell(jx, got, want, (arch, shape, pod))


def _ref_hillclimb(jx, monkeypatch):
    """The reference's hill-climb module, imported without letting its
    first line's XLA_FLAGS reach this process's later JAX use."""
    import jax
    jax.devices()                 # the backend starts with today's flags
    monkeypatch.setenv("XLA_FLAGS", "")
    from repro.launch import hillclimb
    return hillclimb


def test_variants_equal_the_reference(jx, monkeypatch):
    want = _ref_hillclimb(jx, monkeypatch)._variants()
    got = thill._variants()
    assert list(got) == list(want)
    for key in want:
        g, w = dict(got[key]), dict(want[key])
        assert dataclasses.asdict(g.pop("cfg")) == \
            dataclasses.asdict(w.pop("cfg")), key
        assert g == w, key


VARIANTS = sorted(thill._variants())


@pytest.mark.parametrize("key", VARIANTS)
def test_variant_cells_equal_the_reference(jx, ref_hints, monkeypatch, key):
    """The hill-climb's knobs (bf16 gradient sync, the KV sequence axis,
    TP-only weights) build the reference's cells."""
    spec = thill._variants()[key]
    rspec = _ref_hillclimb(jx, monkeypatch)._variants()[key]
    axes = tmesh.mesh_axes(False)
    if spec.get("axes_override") == "tp_only":
        axes = tlayers.MeshAxes(fsdp=(), tp="model", batch_axes=("data",))
    kw = dict(grad_sync_dtype=spec.get("grad_sync_dtype"),
              cache_seq_axis=spec.get("cache_seq_axis"))
    got = tcells.build_cell(spec["cfg"], TSHAPES[spec["shape"]],
                            tmesh.make_production_mesh(), axes, **kw)
    want = jx.cells.build_cell(rspec["cfg"], jx.SHAPES[rspec["shape"]],
                               jx.meshes["pod1"], _ref_axes(jx, axes), **kw)
    _same_cell(jx, got, want, key)


def test_build_cell_refuses_an_axis_off_the_mesh():
    with pytest.raises(ValueError, match="not on the mesh"):
        tcells.build_cell(TARCHS["qwen2-1.5b"], TSHAPES["decode_32k"],
                          tmesh.make_host_mesh(), tmesh.mesh_axes(True))


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """One decode cell dry-run on the host mesh and on the single pod."""
    d = tmp_path_factory.mktemp("dryrun")
    host = tdryrun.run_cell("qwen2-1.5b", "decode_32k", False,
                            results_dir=str(d), mesh=tmesh.make_host_mesh())
    pod1 = tdryrun.run_cell("qwen2-1.5b", "decode_32k", False,
                            results_dir=str(d))
    return d, host, pod1


def _walk(rec, path=()):
    for k, v in rec.items():
        if isinstance(v, dict):
            yield from _walk(v, path + (k,))
        else:
            yield path + (k,), v


def test_run_cell_host_record_is_filled(records):
    d, host, _ = records
    assert host["cell"] == "qwen2-1.5b__decode_32k__host"
    assert json.loads((d / (host["cell"] + ".json")).read_text()) == host
    # on one device every key has a value; only the collective term is
    # not recorded (the port counts no collectives yet)
    not_recorded = {("roofline", "wire_bytes_per_device"),
                    ("roofline", "collective_s"),
                    ("roofline", "collective_breakdown")}
    for path, v in _walk(host):
        assert (v is None) == (path in not_recorded), path
    mem = host["memory"]
    assert mem["total_bytes_per_device"] == \
        mem["argument_bytes_per_device"] + mem["temp_bytes_per_device"]
    assert mem["temp_bytes_per_device"] > 0
    assert host["roofline"]["memory_s"] > 0
    assert host["step_time_bound_s"] == max(host["roofline"]["compute_s"],
                                            host["roofline"]["memory_s"])
    assert "pending" not in host and host["n_devices"] == 1


def test_run_cell_production_argument_bytes_equal_reference_shards(
        jx, ref_hints, records):
    _, _, pod1 = records
    assert pod1["pending"] == tdryrun.PENDING
    assert pod1["memory"]["temp_bytes_per_device"] is None
    assert pod1["roofline"]["memory_s"] is None
    assert pod1["roofline"]["dominant"] == "compute"
    want_cell = jx.cells.build_cell(
        jx.ARCHS["qwen2-1.5b"], jx.SHAPES["decode_32k"], jx.meshes["pod1"],
        _ref_axes(jx, tmesh.mesh_axes(False)))
    structs = _ref_leaves(jx, want_cell.args)
    shardings = _ref_leaves(jx, want_cell.in_shardings)
    want = sum(math.prod(shardings[p].shard_shape(sd.shape))
               * sd.dtype.itemsize for p, sd in structs.items())
    assert pod1["memory"]["argument_bytes_per_device"] == want


def test_run_variant_records_what_the_port_can_reckon(tmp_path):
    """A hill-climb variant through the dry run on the single pod: the
    compute term and argument bytes, and nulls that say why."""
    key = "q3_decode_v2_tp_only_weights"
    spec = thill._variants()[key]
    rec = thill.run_variant(key, spec, results_dir=str(tmp_path))
    assert json.loads((tmp_path / f"{key}.json").read_text()) == rec
    cfg, shape = spec["cfg"], TSHAPES[spec["shape"]]
    rl = rec["roofline"]
    assert rl["compute_s"] == \
        tcells.analytic_step_flops(cfg, shape) / 256 / tdryrun.roofline.PEAK_FLOPS
    assert rl["memory_s"] is rl["collective_s"] is None
    assert rec["temp_bytes_per_device"] is None
    assert rec["pending"] == tdryrun.PENDING
    assert rec["step_time_bound_s"] == rl["compute_s"]
    # TP-only weights: replicated over 'data', so each device holds more
    # than with the weights sharded over it too (the same cache specs)
    mesh = tmesh.make_production_mesh()
    fsdp = tcells.build_cell(cfg, shape, mesh, tmesh.mesh_axes(False),
                             cache_seq_axis="model")
    assert rec["argument_bytes_per_device"] > \
        tdryrun.argument_bytes_per_device(fsdp, mesh)
