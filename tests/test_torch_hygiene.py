"""The port stands alone and never falls back.

* ``src/repro_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the
  JAX package ``repro``;
* entry points default to the CUDA card and raise where there is none;
* the K1 wrapper and the kernel build catch no exception.
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


@pytest.mark.parametrize("rel", ["kernels/collision_force.py",
                                 "kernels/build.py", "kernels/ops.py"])
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
