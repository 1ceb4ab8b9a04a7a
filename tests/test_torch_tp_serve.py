"""Serving over a tensor-parallel mesh on gloo ranks on the CPU: the
reduced config of every LM family in f32 served over a (1, 2) ("data",
"model") ``DeviceMesh`` ≡ the JAX reference's serving cells.

The families: dense qwen3-14b (qk-norm), vlm phi-3-vision-4.2b (its
frontend embeddings ahead of the prompt), mamba2-370m (SSM), jamba (SSM,
GQA and experts over "tp"), deepseek-v2-lite-16b (MLA, a dense first
layer, experts and a shared expert; also at 32 experts, whose FFN dim
goes over "tp") and seamless-m4t-large-v2 (encoder-decoder). One set of weights a family is drawn here (the
port's init, matrices ×10 and the constant leaves perturbed, so greedy
decoding does not repeat one token and a rank's slice of a per-head leaf
shows) and carried to both packages (``convert.params_from_numpy``).

Two subprocesses run side by side, each with a timeout: the reference's
``make_prefill_step`` and ``make_decode_step`` jitted with
``launch/cells.build_cell``'s shardings on a (1, 2) host mesh
(``--xla_force_host_platform_device_count=2``; ``build_cell``'s default
``attn_impl="xla"``, its plain attention, where the port's prefill runs
K2's plain version on the CPU), and the port's on two gloo ranks
(``rank_cases.launch_serve``: the whole weights laid out by the spec
tree, ``sharding.for_serve``, ``make_prefill_step(model, tp)``,
``make_decode_step(model, tp)``). Meanwhile this process serves the same
traffic through the one-rank port.

It shows: the last-position logits of the prefill and of 4
teacher-forced decode steps ≡ the reference's at
``tests/test_torch_serve.py``'s 1e-4, and bit for bit equal on both
ranks; K2 given the rank's heads in every GQA prefill; the decode caches
the rank's; ``serve`` on (1, 2) gives the one-rank serve's greedy token
streams; a prefill and a decode step issue only the model axis's
forward collectives ``roofline/analysis.reckon_serve_collectives``
reckons, none over the data axis, and the serve tree is the DTensors'
own blocks (no weight copied) but for the SSM's rank columns; no op of a
decode step copies a weight; a (2, 1) mesh raises NotImplementedError.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.roofline import analysis  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ATOL = RTOL = 1e-4                        # tests/test_torch_serve.py
FAMILIES = {"dense": "qwen3-14b", "vlm": "phi-3-vision-4.2b",
            "ssm": "mamba2-370m", "hybrid": "jamba-v0.1-52b",
            "mla_moe": "deepseek-v2-lite-16b",
            "mla_moe32": "deepseek-v2-lite-16b",
            "encdec": "seamless-m4t-large-v2"}
# ArchConfig fields over the reduced config: at 32 experts deepseek's go
# over "data" and their FFN dim over "model", as at full width
# (``reduced_config`` gives every MoE config 8, which go over "model")
OVER = {"mla_moe32": dict(n_experts=32)}
BATCH, PROMPT, STEPS, S_MAX = 2, 12, 4, 32
SERVE = dict(requests=3, prompt_min=5, prompt_max=14, new_tokens=4,
             slots=2, s_max=S_MAX, page_size=8, n_pages=16)


@pytest.fixture(scope="module", autouse=True)
def _single_thread():
    """One torch thread for the module (as every rank runs)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _cfg(name):
    return dataclasses.replace(treduced(TARCHS[FAMILIES[name]]),
                               **OVER.get(name, {}))


def _weights(name, seed):
    """The port's seeded init of ``name``'s reduced config, matrices ×10,
    the other leaves plus N(0, 0.3²): flat numpy leaves."""
    model = tbuild(_cfg(name), device="cpu")
    whole = model.init_params(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in rank_cases._flat(whole).items():
        a = leaf.numpy()
        if a.ndim - path.split("/")[0].endswith("blocks") >= 2:
            a = a * 10
        else:
            a = a + rng.standard_normal(a.shape).astype(np.float32) * 0.3
        out[path] = a.astype(np.float32)
    return out


def _inputs(name, seed):
    cfg = _cfg(name)
    rng = np.random.default_rng(seed + 100)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, PROMPT)),
           "decode_tokens": rng.integers(0, cfg.vocab_size, (STEPS, BATCH))}
    if cfg.frontend != "none":
        out["frontend_embeds"] = rng.standard_normal(
            (BATCH, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return out


_REF_SCRIPT = """
import dataclasses, os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import numpy as np
import jax
import jax.numpy as jnp
from repro.configs import ARCHS
from repro.configs.base import ShapeSpec
from repro.launch.cells import build_cell
from repro.models import reduced_config
from repro.models.layers import MeshAxes, set_hint_axes

def nest(flat):
    out = {}
    for path, leaf in flat.items():
        node = out
        parts = path.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return out

cases, out = json.loads(sys.argv[1]), sys.argv[2]
mesh = jax.make_mesh((1, 2), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
axes = MeshAxes(fsdp=("data",))
rec = {}
for c in cases:
    cfg = dataclasses.replace(reduced_config(ARCHS[c["arch"]]), **c["cfg"])
    with np.load(c["weights"]) as z:
        flat = {k: z[k] for k in z.files}
    with np.load(c["inputs"]) as z:
        inp = {k: z[k] for k in z.files}
    b, s = inp["tokens"].shape
    with mesh:
        pre = build_cell(cfg, ShapeSpec("prefill", s, b, "prefill"), mesh,
                         axes)
        params = jax.device_put(nest(flat), pre.in_shardings[0])
        batch = {"tokens": jnp.asarray(inp["tokens"], jnp.int32)}
        if "frontend_embeds" in inp:
            batch["frontend_embeds"] = jnp.asarray(inp["frontend_embeds"])
        batch = jax.device_put(batch, pre.in_shardings[1])
        logits, caches = jax.jit(pre.fn, in_shardings=pre.in_shardings)(
            params, batch)
        dec = build_cell(cfg, ShapeSpec("decode", c["s_max"], b, "decode"),
                         mesh, axes)
        enc = inp["frontend_embeds"].shape[1] if cfg.encoder_layers else 0
        specs = (dec.model.decode_cache_specs(b, c["s_max"], enc)
                 if cfg.encoder_layers
                 else dec.model.decode_cache_specs(b, c["s_max"]))
        def pad_to(spec, val):
            z = jnp.zeros(spec.shape, spec.dtype)
            return z.at[tuple(slice(0, d) for d in val.shape)].set(val)
        caches = jax.tree.map(pad_to, specs, caches)
        n = s + (0 if cfg.encoder_layers or "frontend_embeds" not in inp
                 else inp["frontend_embeds"].shape[1])
        step = jax.jit(dec.fn, in_shardings=dec.in_shardings)
        outs = [np.asarray(logits)]
        for i, tok in enumerate(inp["decode_tokens"]):
            # the cell's cache shardings again: the step returns GSPMD's
            caches = jax.device_put(caches, dec.in_shardings[2])
            lg, caches = step(params, jnp.asarray(tok, jnp.int32), caches,
                              jnp.int32(n + i))
            outs.append(np.asarray(lg))
    set_hint_axes(None)
    np.save(os.path.join(out, c["name"] + "_ref.npy"), np.stack(outs))
    rec[c["name"]] = len(params["final_norm"].sharding.device_set)
print(json.dumps(rec))
"""


def _reference(cases, out: Path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT, json.dumps(cases), str(out)],
        env=env, capture_output=True, text=True,
        timeout=rank_cases.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _one_rank_serve(name, weights):
    """The one-rank port's ``serve`` of ``SERVE``'s traffic: {uid:
    tokens}."""
    cfg = _cfg(name)
    model = tbuild(cfg, device="cpu")
    params = convert.params_from_numpy(rank_cases.unflatten(weights), "cpu")
    kw = dict(SERVE)
    reqs = serve_lm.make_requests(kw.pop("requests"), cfg.vocab_size,
                                  prompt_min=kw.pop("prompt_min"),
                                  prompt_max=kw.pop("prompt_max"),
                                  new_tokens=kw.pop("new_tokens"), seed=4)
    rep = serve_lm.serve(model, params, reqs,
                         frames=serve_lm.make_frames(cfg, reqs, 4), **kw)
    return [[f.uid, list(map(int, f.tokens))] for f in rep.finished]


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(records of the gloo cases by name, the reference's logits by
    family, the one-rank serves' streams by family, the scratch
    directory)."""
    from concurrent.futures import ThreadPoolExecutor
    pytest.importorskip("jax")
    d = tmp_path_factory.mktemp("tp_serve")
    cases, weights = [], {}
    for i, name in enumerate(FAMILIES):
        weights[name] = _weights(name, i)
        np.savez(d / f"{name}_w.npz", **weights[name])
        np.savez(d / f"{name}_in.npz", **_inputs(name, i))
        cases.append(dict(name=name, arch=FAMILIES[name], s_max=S_MAX,
                          cfg=OVER.get(name, {}),
                          weights=str(d / f"{name}_w.npz"),
                          inputs=str(d / f"{name}_in.npz"),
                          serve=dict(SERVE, seed=4)))
    gloo = cases + [dict(cases[0], name="data2", mesh=(2, 1), raises=True,
                         serve=None)]
    with ThreadPoolExecutor(2) as pool:
        fut_ref = pool.submit(_reference, cases, d)
        fut_tp = pool.submit(rank_cases.launch_serve, gloo, 2, d / "w2")
        one = {name: _one_rank_serve(name, weights[name])
               for name in FAMILIES}
        devices = fut_ref.result()
        recs = {r["name"]: r for r in fut_tp.result()}
    assert devices == {name: 2 for name in FAMILIES}
    ref = {name: np.load(d / f"{name}_ref.npy") for name in FAMILIES}
    return recs, ref, one, d


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_prefill_and_decode_match_the_reference_cells(both, name):
    """The last-position logits of the prefill and of 4 teacher-forced
    decode steps on (1, 2) ≡ the reference's prefill and decode cells on
    a (1, 2) host mesh, at test_torch_serve.py's 1e-4; the logits are the
    same bytes on both ranks."""
    recs, ref, _, d = both
    got = np.load(d / "w2" / f"{name}_logits.npy")
    want = ref[name]
    assert got.shape == want.shape == (STEPS + 1, BATCH, got.shape[-1])
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert recs[name]["logits_equal_on_ranks"]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_serve_streams_equal_the_one_rank_serve(both, name):
    """``serve`` on (1, 2), every rank running the same batcher on the
    same requests, gives the one-rank port's greedy token streams, the
    same on both ranks; the pool leaks no page."""
    recs, _, one, _ = both
    rec = recs[name]
    assert rec["streams"] == one[name]
    assert rec["streams_equal_on_ranks"] and rec["n_free"] == SERVE[
        "n_pages"]
    assert len({t for _, toks in one[name] for t in toks}) > 3


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_serve_steps_issue_only_the_reckoned_model_collectives(both,
                                                                  name):
    """A prefill and a decode step on (1, 2) issue the model axis's
    forward collectives that ``reckon_serve_collectives`` reckons, by op,
    count and payload, and none over the data axis: no weight is gathered
    per call (the SSM's columns are the serve tree's)."""
    recs, _, _, _ = both
    cfg = _cfg(name)
    model = tbuild(cfg, device="cpu")
    fe = cfg.frontend_tokens if cfg.frontend != "none" else 0
    for kind, key in (("prefill", "prefill_collectives"),
                      ("decode", "decode_collectives")):
        want = analysis.reckon_serve_collectives(
            model, 2, kind, BATCH, PROMPT, enc_len=fe,
            frontend_len=0 if cfg.encoder_layers else fe)
        got = recs[name][key]
        assert got == want, (kind, got, want)
        assert set(got) == {"model"}
        assert "reduce-scatter" not in got["model"]["counts"]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_tp_decode_step_copies_no_weight(both, name):
    """No op of a decode step on (1, 2) copies a serve-tree leaf
    (``rank_cases._weight_copies``: a cast, clone, concatenation, gather
    or copy that reads a leaf's storage), so a step reads each weight
    where it lies; the collectives above cannot see a local copy."""
    recs, _, _, _ = both
    assert recs[name]["decode_weight_copies"] == []


SSM_LEAVES = ("w_in", "conv_w", "conv_b", "a_log", "dt_bias", "d_skip",
              "out_norm")


@pytest.mark.parametrize("name", list(FAMILIES))
def test_serve_tree_is_the_rank_blocks_and_the_caches_the_rank_heads(both,
                                                                     name):
    """Every serve-tree leaf is a view of its DTensor's block but for an
    SSM layer's rank columns (its z, x and dt, all of B and C) and parts
    (its heads, its channels); K2 runs on the rank's heads
    (Hq / 2, Hkv / 2) in every GQA prefill; the decode caches hold the
    rank's kv heads and SSM channels and heads, MLA's the whole latent."""
    recs, _, _, _ = both
    rec, cfg = recs[name], _cfg(name)
    di = cfg.ssm_expand * cfg.d_model
    h, n = (di // cfg.ssm_head_dim, cfg.ssm_state) if di else (0, 0)
    cols = {"w_in": di + 2 * n + h // 2, "conv_w": di // 2 + 2 * n,
            "conv_b": di // 2 + 2 * n, "a_log": h // 2, "dt_bias": h // 2,
            "d_skip": h // 2, "out_norm": di // 2}
    for path, view in rec["views"].items():
        leaf = path.split("/")[-1]
        if "/ssm/" in path and leaf in SSM_LEAVES:
            assert rec["local_shapes"][path][-1] == cols[leaf], path
        else:
            assert view, path
    shapes = rec["k2_shapes"]
    gqa = (not cfg.mla) and cfg.n_heads
    assert bool(shapes) == bool(gqa)
    for q, k in shapes:
        assert q[1] == cfg.n_heads // 2 and k[1] == cfg.n_kv_heads // 2
        assert q[-1] == cfg.d_head
    model = tbuild(cfg, device="cpu")
    enc = (cfg.frontend_tokens,) if cfg.encoder_layers else ()
    want = [list(x.shape) for x in serve_lm._leaves(
        model.init_decode_caches(BATCH, S_MAX, *enc, model_ranks=2))]
    assert rec["cache_shapes"] == want
    if name == "hybrid":
        assert [1, BATCH, cfg.ssm_conv - 1, di // 2 + 2 * n] in want


def test_a_data_axis_of_two_ranks_raises(both):
    """``sharding.for_serve`` on a (2, 1) mesh: NotImplementedError naming
    ROADMAP 15c (serving over data ranks)."""
    rec = both[0]["data2"]
    assert rec["raised"][0] == "NotImplementedError", rec
    assert "15c" in rec["raised"][1]


@pytest.mark.parametrize("d_head,bad", [(128, False), (96, False),
                                        (80, True)])
def test_check_divides_refuses_a_head_dim_k2_does_not_take(d_head, bad):
    """A (1, T) serving mesh through K2 also needs the GQA head dim among
    K2's; training (no ``attn_impl``) and MLA do not."""
    cfg = dataclasses.replace(TARCHS["qwen3-14b"], d_head=d_head)
    mesh = tmesh.Mesh((1, 2), ("data", "model"))
    tmesh.check_divides(cfg, mesh)
    tmesh.check_divides(TARCHS["deepseek-v2-lite-16b"], mesh,
                        attn_impl="k2")
    if bad:
        with pytest.raises(ValueError, match="head dim 80"):
            tmesh.check_divides(cfg, mesh, attn_impl="k2")
    else:
        tmesh.check_divides(cfg, mesh, attn_impl="k2")


def test_serve_lm_cli_spawns_model_ranks(tmp_path):
    """``serve_lm --model-ranks 2 --device cpu``: two gloo ranks serve the
    same requests over a (1, 2) mesh; rank 0 writes the report (every
    request's tokens, the pool whole, K2's launches by rank)."""
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_lm", "--arch",
         "mamba2-370m", "--layers", "2", "--requests", "3", "--new-tokens",
         "2", "--prompt-min", "8", "--prompt-max", "12", "--slots", "2",
         "--s-max", "64", "--pages", "16", "--device", "cpu",
         "--model-ranks", "2", "--out", str(out)], env=env,
        capture_output=True, text=True, timeout=rank_cases.TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-4000:]
    rep = json.loads(out.read_text())
    assert rep["model_ranks"] == 2 and rep["k2_launches_by_rank"] == [0, 0]
    assert rep["requests"] == 3 and rep["generated_tokens"] == 3 * 2
    assert rep["n_free"] == rep["n_pages"] == 16 and rep["logits_finite"]
