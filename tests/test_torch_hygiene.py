"""The port stands alone and never falls back.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the
  JAX package ``repro``;
* entry points default to the CUDA card and raise where there is none;
* the kernel wrappers and the kernel build catch no exception.
"""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), \
            f"{path.relative_to(ROOT)} imports {name}"


def test_import_check_covers_the_examples():
    """The examples package is part of the port: every module of it is
    among the files the import check reads."""
    names = {p.stem for p in PORT_FILES if p.parent.name == "examples"}
    assert {"quickstart", "oncology", "neuroscience", "cell_clustering",
            "ensemble_sweep", "serve_lm", "epidemiology",
            "check_footprints", "train_lm"} <= names, names


def test_import_check_covers_the_distributed_engine():
    assert PORT / "core" / "distributed.py" in PORT_FILES


def test_import_check_covers_the_transport_and_its_launcher():
    assert PORT / "core" / "transport.py" in PORT_FILES
    assert PORT / "launch" / "distributed.py" in PORT_FILES


def test_import_check_covers_the_moe_layer():
    assert PORT / "models" / "moe.py" in PORT_FILES


def test_import_check_covers_the_ssm_layer():
    assert PORT / "models" / "ssm.py" in PORT_FILES


def test_import_check_covers_the_encoder_decoder():
    assert PORT / "models" / "encdec.py" in PORT_FILES


def test_import_check_covers_the_sharded_runtime():
    assert PORT / "models" / "sharding.py" in PORT_FILES
    assert PORT / "launch" / "mesh.py" in PORT_FILES


@pytest.mark.parametrize("make", ["make_device_mesh", "rank_batch_at"])
def test_sharded_runtime_defaults_to_cuda_and_raises_without_it(make):
    """The device mesh and a rank's rows of a batch go on the card unless
    asked for the CPU."""
    from repro_torch.data import DataConfig, rank_batch_at
    from repro_torch.launch import mesh as lmesh
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    calls = {
        "make_device_mesh": lambda: lmesh.make_device_mesh(
            lmesh.Mesh((1, 1), ("data", "model"))),
        "rank_batch_at": lambda: rank_batch_at(
            DataConfig(vocab_size=16, seq_len=4, global_batch=2), 0, 0, 2)}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[make]()


def test_port_core_exports_what_the_reference_core_exports():
    """Every name of ``repro.core.__all__`` is exported by
    ``repro_torch.core`` too, the distributed engine's included."""
    repro_core = pytest.importorskip("repro.core")
    import repro_torch.core
    missing = set(repro_core.__all__) - set(repro_torch.core.__all__)
    assert not missing, sorted(missing)


@pytest.mark.parametrize("pkg", ["train", "data"])
def test_port_train_and_data_export_what_the_reference_exports(pkg):
    """Every public name of ``repro.train`` / ``repro.data`` (functions,
    classes and submodules) is a name of the port's package too."""
    import importlib
    ref = importlib.import_module(f"repro.{pkg}")
    port = importlib.import_module(f"repro_torch.{pkg}")
    want = {n for n in dir(ref) if not n.startswith("_")}
    missing = want - set(dir(port))
    assert not missing, sorted(missing)


def test_train_driver_and_example_default_to_cuda_and_raise_without_it(
        tmp_path):
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.examples import train_lm
    from repro_torch.launch import train
    from repro_torch.models import reduced_config
    if torch.cuda.is_available():
        assert train.resolve_device(None).type == "cuda"
        return
    arch = dataclasses.replace(reduced_config(ARCHS["qwen2-1.5b"]),
                               n_layers=1)
    job = train.TrainJob(arch=arch, steps=1, seq_len=8, global_batch=1)
    for call in (lambda: train.run(job),
                 lambda: train_lm.main(["--steps", "1", "--ckpt",
                                        str(tmp_path)])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert not any(tmp_path.iterdir())


def test_simulation_defaults_to_cuda_and_raises_without_it():
    from repro_torch.core import EngineConfig, Simulation
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    cfg = EngineConfig(capacity=128, domain_lo=(0, 0, 0),
                       domain_hi=(8, 8, 8), interaction_radius=2.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Simulation(cfg, [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert Simulation(cfg, [], device="cpu").device.type == "cpu"


@pytest.mark.parametrize("make", ["make_pool", "stage_pool", "prng_key",
                                  "StepStats.zeros", "restore_state",
                                  "CapacityLadder", "restore_dist_state",
                                  "DistributedCapacityLadder", "run_job"])
def test_public_constructors_default_to_cuda_and_raise_without_it(make,
                                                                  tmp_path):
    """The pool, key and stats constructors, the restore, the ladder and
    the launcher's job put their tensors on the card unless asked for the
    CPU."""
    import numpy as np
    from repro_torch.core import (CapacityLadder, EngineConfig, StepStats,
                                  make_pool, rand, restore_state, save_state,
                                  stage_pool)
    cfg = EngineConfig(capacity=16, domain_lo=(0, 0, 0),
                       domain_hi=(8, 8, 8), interaction_radius=2.0)
    pos = np.zeros((2, 3), np.float32)
    from repro_torch.core import (DistConfig, DistributedCapacityLadder,
                                  restore_dist_state, save_dist_state)
    from repro_torch.launch import distributed as launcher
    dcfg = DistConfig(engine=cfg, n_shards=2, local_capacity=8,
                      halo_capacity=4, migrate_capacity=4)
    if make == "restore_state":
        from repro_torch.core import Simulation
        save_state(str(tmp_path),
                   Simulation(cfg, [], device="cpu").init_state(pos), cfg)
    if make == "restore_dist_state":
        from repro_torch.core import DistributedSimulation
        save_dist_state(str(tmp_path), DistributedSimulation(
            dcfg, [], device="cpu").init_state(pos), dcfg)
    calls = {
        "make_pool": lambda **kw: make_pool(16, **kw),
        "stage_pool": lambda **kw: stage_pool(16, [], pos, **kw),
        "prng_key": lambda **kw: rand.prng_key(0, **kw),
        "StepStats.zeros": lambda **kw: StepStats.zeros(**kw),
        "restore_state": lambda **kw: restore_state(str(tmp_path), cfg, [],
                                                    **kw)[0].pool,
        "CapacityLadder": lambda **kw: CapacityLadder(cfg, [], **kw).sim,
        "restore_dist_state": lambda **kw: restore_dist_state(
            str(tmp_path), dcfg, [], **kw)[0].channels["position"],
        "DistributedCapacityLadder": lambda **kw: DistributedCapacityLadder(
            dcfg, [], **kw).sim,
        "run_job": lambda **kw: launcher.run_job(
            {"scenario": "forces", "steps": 0}, **kw)[
                "state"].channels["position"],
    }
    fn = calls[make]

    def device_of(out):                 # StepStats: one tensor per field
        return getattr(out, "device", None) or out.n_live.device
    if torch.cuda.is_available():
        assert device_of(fn()).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    assert device_of(fn(device="cpu")).type == "cpu"


@pytest.mark.parametrize("rel", ["kernels/collision_force.py",
                                 "kernels/block_cols.py",
                                 "kernels/flash_attention.py",
                                 "kernels/build.py", "kernels/ops.py",
                                 "kernels/pairlist.py",
                                 "kernels/pair_cols.py",
                                 "kernels/secretion.py"])
def test_kernel_path_swallows_no_error(rel):
    tree = ast.parse((PORT / rel).read_text())
    handlers = [n for n in ast.walk(tree) if isinstance(n, ast.ExceptHandler)]
    assert not handlers, f"{rel} has an except clause at line " \
                         f"{handlers[0].lineno}"


def test_kernel_wrapper_raises_on_a_device_it_cannot_run():
    from repro_torch.kernels import collision_force as k1
    data = torch.zeros((8, 128), device="meta")
    cols = torch.full((1, 4), -1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        k1.collision_force(data, cols, k_rep=2.0, adhesion=None,
                           adhesion_band=0.4)


def test_column_map_raises_on_a_device_it_cannot_run():
    from repro_torch.kernels import ops
    cells = torch.zeros((128, 3), dtype=torch.int32, device="meta")
    table = torch.zeros(8, dtype=torch.int32, device="meta")
    act = torch.zeros(128, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError):
        ops.build_block_cols(cells, table, table, act, (2, 2, 2), 4)


def test_slice_kernels_raise_on_a_device_they_cannot_run():
    """The pair-list build, the pairs column map and secretion launch
    their kernels for any tensor off the CPU, and raise where they cannot;
    none falls back to its plain version."""
    from repro_torch.core import diffusion, grid
    from repro_torch.kernels import ops
    meta = dict(device="meta")
    spec = grid.GridSpec(dims=(2, 2, 2))
    g = grid.initial_rebuild_state(spec, 128, torch.zeros(3, **meta),
                                   1.0).grid
    pos = torch.zeros((128, 3), **meta)
    alive = torch.ones(128, dtype=torch.bool, **meta)
    with pytest.raises(ValueError):
        grid.build_pairlist(spec, g, pos, alive, radius=1.0, max_pairs=4)
    pairs = grid.initial_pairlist(128, 4, "meta")
    with pytest.raises(ValueError):
        ops.build_block_cols_from_pairs(pairs, alive, 128, 4)
    dspec = diffusion.DiffusionSpec(dims=(2, 2, 2))
    with pytest.raises(ValueError):
        diffusion.add_sources(dspec, torch.zeros((2, 2, 2), **meta), pos,
                              torch.ones(128, **meta),
                              torch.zeros(3, **meta))


def test_k2_wrapper_raises_on_a_device_it_cannot_run():
    from repro_torch.kernels import flash_attention as k2
    q = torch.zeros((1, 2, 8, 32), device="meta")
    kv = torch.zeros((1, 1, 8, 32), device="meta")
    with pytest.raises(ValueError):
        k2.flash_attention(q, kv, kv)


def test_lm_and_serve_default_to_cuda_and_raise_without_it():
    import dataclasses
    from repro_torch.configs import ARCHS
    from repro_torch.launch import serve_lm
    from repro_torch.models import LM, build_model, reduced_config
    from repro_torch.serve import ContinuousBatcher, PagedCacheSpec
    cfg = dataclasses.replace(reduced_config(ARCHS["qwen2-1.5b"]),
                              n_layers=1)
    if torch.cuda.is_available():
        assert LM(cfg).device.type == "cuda"
        return
    encdec = reduced_config(ARCHS["seamless-m4t-large-v2"])
    for make in (lambda: LM(cfg), lambda: build_model(cfg),
                 lambda: build_model(encdec),
                 lambda: ContinuousBatcher(PagedCacheSpec(1, 1, 16), None,
                                           None),
                 lambda: serve_lm.main(["--layers", "1"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert build_model(cfg, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("module,entry", [
    ("collision_force", "k1_collision_force"),
    ("block_cols", "k1_block_cols"),
    ("flash_attention", "k2_flash_attention"),
    ("pairlist", "pairlist_build"),
    ("pair_cols", "k1_pair_cols"),
    ("secretion", "secretion_add")])
def test_ctypes_signature_matches_the_cuda_entry_point(module, entry):
    """The wrapper's argtypes follow the C entry point parameter for
    parameter (a short list is only caught when the library is called)."""
    import ctypes
    import importlib
    import re
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    src = (PORT / "kernels" / "csrc" / f"{module}.cu").read_text()
    sig = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert sig, f"{entry} not found in csrc/{module}.cu"
    params = [p.strip() for p in sig.group(1).split(",")]
    want = [ctypes.c_void_p if "*" in p else
            ctypes.c_float if p.startswith("float") else
            ctypes.c_longlong if p.startswith("long long") else ctypes.c_int
            for p in params]
    assert mod.ARGTYPES == want
