"""The reference's examples as entry points of the port
(``repro_torch.examples``).

  * each example's configuration equals the reference example's field for
    field (the reference loaded from ``examples/`` by path), and its
    behaviors are the same classes with the same knobs. Neither package's
    example names a ``force_impl``, so each runs its own package's default:
    the reference's XLA sweep, the port's K1 on the uniform grid and its
    streamed sweep elsewhere;
  * each example's ``main`` runs on the CPU (``--device cpu``) at a small
    size and passes its own closing assertion.
"""

import dataclasses
import importlib
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import EngineConfig  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
KNOBS = ("EXAMPLE_N", "EXAMPLE_EPOCHS", "EXAMPLE_LANES", "EXAMPLE_POINTS",
         "EXAMPLE_STEPS")


@pytest.fixture(autouse=True)
def _defaults(monkeypatch):
    """Every example at its default size unless a test sets a knob; one
    torch thread (the port's CPU parity convention)."""
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _reference(name):
    """examples/<name>.py, loaded by path (it imports ``repro`` and JAX)."""
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return importlib.import_module(f"repro_torch.examples.{name}")


def _plain(v):
    """A config value as plain data: dataclasses as dicts, tuples as
    lists, callables as one marker."""
    if dataclasses.is_dataclass(v):
        return {f.name: _plain(getattr(v, f.name))
                for f in dataclasses.fields(v)}
    if isinstance(v, (tuple, list)):
        return [_plain(x) for x in v]
    if callable(v):
        return "<callable>"
    return v


def _same_config(tcfg, jcfg):
    got, want = _plain(tcfg), _plain(jcfg)
    # the port's default force_impl for the environment; the reference's
    # example leaves its own default ("xla") in place
    assert want.pop("force_impl") == "xla"
    assert got.pop("force_impl") == EngineConfig(
        capacity=1, domain_lo=(0, 0, 0), domain_hi=(1, 1, 1),
        interaction_radius=1.0, environment=tcfg.environment).force_impl
    assert got == want


def _same_behaviors(tbs, jbs):
    assert [type(b).__name__ for b in tbs] == [type(b).__name__ for b in jbs]
    for tb_, jb_ in zip(tbs, jbs):
        assert {k: _plain(v) for k, v in vars(tb_).items()} == \
            {k: _plain(v) for k, v in vars(jb_).items()}, type(tb_).__name__


CONFIG_CASES = [("quickstart", {}), ("oncology", {}), ("neuroscience", {}),
                ("epidemiology", {}), ("cell_clustering", {}),
                ("cell_clustering", {"pairlist": True, "skin": 1.5})]


@pytest.mark.parametrize("name,kw", CONFIG_CASES,
                         ids=[f"{n}{'-pairlist' if kw else ''}"
                              for n, kw in CONFIG_CASES])
def test_config_and_behaviors_equal_the_reference_example(name, kw):
    ref, port = _reference(name), _port(name)
    _same_config(port.make_config(**kw), ref.make_config(**kw))
    _same_behaviors(port.behaviors(), ref.behaviors())


def test_ensemble_sweep_service_equals_the_reference_example(monkeypatch):
    """The sweep's service (its config, behaviors, lanes and params
    template) and a request equal the reference example's."""
    import numpy as np
    monkeypatch.setenv("EXAMPLE_N", "100")     # the reference reads it once
    ref, port = _reference("ensemble_sweep"), _port("ensemble_sweep")
    jsvc = ref.make_service()
    tsvc = port.make_service(device="cpu")
    _same_config(tsvc.driver.config, jsvc.driver.config)
    _same_behaviors(tsvc.driver.behaviors, jsvc.driver.behaviors)
    assert tsvc.n_lanes == jsvc.n_lanes
    assert sorted(tsvc.driver.params_template.rates) == \
        sorted(jsvc.driver.params_template.rates)
    tr, jr = port.make_request(3, 0.3, 20), ref.make_request(3, 0.3, 20)
    for f in ("position", "diameter", "agent_type"):
        np.testing.assert_array_equal(getattr(tr, f), getattr(jr, f))
    np.testing.assert_array_equal(tr.extra_init["infect_timer"],
                                  jr.extra_init["infect_timer"])
    assert (tr.uid, tr.seed, tr.max_steps) == (jr.uid, jr.seed, jr.max_steps)
    assert {k: float(v) for k, v in tr.params.rates.items()} == \
        {k: float(v) for k, v in jr.params.rates.items()}


def test_serve_lm_model_and_cache_equal_the_reference_example():
    """The reference example builds its model and paged cache inline in
    ``main``; these are its values."""
    from repro.configs import ARCHS as JARCHS
    from repro.serve import kv_cache as jkvc
    port = _port("serve_lm")
    want = dataclasses.replace(
        JARCHS["qwen2-1.5b"], name="qwen2-serve", n_layers=2, d_model=128,
        n_heads=4, n_kv_heads=2, d_head=32, d_ff=512, vocab_size=8192,
        param_dtype="float32", activation_dtype="float32", remat="none")
    arch = port.make_arch()
    assert _plain(arch) == _plain(want)
    jspec = jkvc.PagedCacheSpec(
        n_layers=want.n_layers, n_kv_heads=want.n_kv_heads,
        d_head=want.d_head, page_size=16, n_pages=96, max_seqs=4,
        max_pages_per_seq=128 // 16, dtype="float32")
    assert _plain(port.make_cache_spec(arch)) == _plain(jspec)


# the smallest sizes at which each example's own assertions bind: the
# quickstart's first divisions come after ~22 steps, the oncology ladder's
# rung check from iteration 30 on
MAIN_CASES = [
    ("quickstart", {"EXAMPLE_EPOCHS": "3"}, []),
    ("oncology", {"EXAMPLE_EPOCHS": "3"}, []),
    ("neuroscience", {"EXAMPLE_EPOCHS": "2"}, []),
    ("cell_clustering", {"EXAMPLE_N": "400", "EXAMPLE_EPOCHS": "1"}, []),
    ("cell_clustering", {"EXAMPLE_N": "400", "EXAMPLE_EPOCHS": "1"},
     ["--pairlist"]),
    ("ensemble_sweep", {"EXAMPLE_N": "64", "EXAMPLE_LANES": "2",
                        "EXAMPLE_POINTS": "4", "EXAMPLE_STEPS": "20"}, []),
    ("serve_lm", {}, []),
    # at 800 agents the epidemic passes its 20 seeds within one epoch
    ("epidemiology", {"EXAMPLE_N": "800", "EXAMPLE_EPOCHS": "1"}, []),
    ("epidemiology", {"EXAMPLE_N": "800", "EXAMPLE_EPOCHS": "1"},
     ["--distributed"]),
    ("check_footprints", {}, []),
]


@pytest.mark.parametrize("name,env,argv", MAIN_CASES,
                         ids=["-".join([n, *(x.strip("-") for x in a)])
                              for n, _, a in MAIN_CASES])
def test_example_main_runs_on_the_cpu(name, env, argv, monkeypatch,
                                      tmp_path, capsys):
    import tempfile
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _port(name).main(["--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "OK:" in out, out


@pytest.mark.parametrize("name", ["quickstart", "oncology", "neuroscience",
                                  "cell_clustering", "ensemble_sweep",
                                  "serve_lm", "epidemiology"])
def test_example_defaults_to_cuda_and_raises_without_it(name):
    from repro_torch.device import resolve_device
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port(name).main([])


def test_epidemiology_distributed_defaults_to_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _port("epidemiology").main(["--distributed"])


def test_check_footprints_tables_equal_the_reference():
    """The pinned footprints and the pair-list variants are the reference
    script's, and both scripts pass."""
    import sys
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        ref = _reference("check_footprints")
        assert ref.main() == 0
    finally:
        sys.path.remove(str(ROOT / "examples"))
    port = _port("check_footprints")
    assert {k: tuple(v) for k, v in port.EXPECTED.items()} == \
        {k: tuple(v) for k, v in ref.EXPECTED.items()}
    assert sorted(port.PAIRLIST_VARIANTS) == sorted(ref.PAIRLIST_VARIANTS)
    for k, (_, want) in ref.PAIRLIST_VARIANTS.items():
        assert tuple(port.PAIRLIST_VARIANTS[k][1]) == tuple(want)
    assert port.main([]) == 0
