"""The port's encoder-decoder (``models/encdec.EncDecLM``) ≡ the JAX
package's ``EncDecLM``.

On ``reduced_config(seamless-m4t-large-v2)`` (2 encoder + 2 decoder
layers, d_model 64, 4 heads of 16, vocab 512, 8 frames, f32), with the
reference's weights carried over by ``convert.params_from_numpy`` and
inputs from numpy seeds, within 1e-5 + 1e-4·|ref|: ``encode``,
``_cross_full`` and ``_cross_decode``; prefill logits and every cache
leaf (``k``, ``v``, ``xk``, ``xv``); tests/test_arch_smoke.py's
decode-after-prefill contract, each step against the reference's and the
last against the full prefill (5e-4). Also the full config's registry
and ``n_params`` (no allocation); params through ``convert`` both ways,
bf16 bit for bit; where K2 runs; ``_write_prompt`` with cross leaves.
The reference runs as its own tests run it (``attn_impl="xla"``); the
port's ``"k2"`` on CPU tensors is K2's plain version.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import EncDecLM  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import lm as tlm  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402

ARCH = "seamless-m4t-large-v2"
ATOL, RTOL = 1e-5, 1e-4                  # against the reference
LM_TOL = 1e-4                            # card ≡ CPU (chip_smoke.py's)
DECODE_TOL = 5e-4                        # tests/test_arch_smoke.py


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.models import build_model, lm, reduced_config
    return types.SimpleNamespace(jax=jax, jnp=jnp, ARCHS=ARCHS, lm=lm,
                                 build_model=build_model,
                                 reduced_config=reduced_config)


@pytest.fixture(scope="module")
def pair(jx):
    """The reduced model in both packages: the reference's weights with
    its constant leaves (the norms) perturbed, carried to the port."""
    jm = jx.build_model(jx.reduced_config(jx.ARCHS[ARCH]))
    rng = np.random.default_rng(0)

    def perturb(path, a):
        a = np.asarray(a)
        if path[-1].key in ("norm", "enc_norm", "final_norm"):
            return a + rng.standard_normal(a.shape).astype(np.float32) * 0.1
        return a
    jp = jx.jax.tree_util.tree_map_with_path(
        perturb, jm.init_params(jx.jax.random.PRNGKey(0)))
    return types.SimpleNamespace(
        jm=jm, jp=jp, tm=tbuild(treduced(TARCHS[ARCH]), device="cpu"),
        tp=convert.params_from_numpy(jp, "cpu"))


@pytest.fixture(autouse=True)
def _single_thread():
    """One torch CPU thread keeps the parity tests deterministic (see
    tests/test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().float().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close(got, want, what, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=rtol,
                               err_msg=what)


def _inputs(cfg, b=2, s=24, seed=1):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    frames = rng.standard_normal((b, cfg.frontend_tokens, cfg.d_model)
                                 ).astype(np.float32)
    return toks, frames


def _pad_to(jx, spec, val):
    out = jx.jnp.zeros(spec.shape, spec.dtype)
    return out.at[tuple(slice(0, d) for d in val.shape)].set(val)


def test_build_model_gives_an_encdec_lm_with_the_full_registry(jx):
    """seamless at full size (no allocation): an ``EncDecLM`` whose paths,
    shapes, specs, inits and stds are the reference's, ``n_params``
    2,034,886,656, vocab padded to 256,256, bf16 leaves."""
    jm = jx.build_model(jx.ARCHS[ARCH])
    tm = tbuild(TARCHS[ARCH], device="cpu")
    assert isinstance(tm, EncDecLM)
    assert tm.n_params() == jm.n_params() == 2_034_886_656
    assert tm.v_pad == jm.v_pad == 256_256
    assert list(tm.ps.infos) == list(jm.ps.infos)          # registry order
    for path, info in jm.ps.infos.items():
        ti = tm.ps.infos[path]
        assert (ti.shape, ti.spec, ti.init, ti.std) == \
            (info.shape, info.spec, info.init, info.std), path
        assert ti.dtype == torch.bfloat16
    assert tm.ps.infos["dec_blocks/l0/xattn/wq"].shape == (24, 1024, 1024)
    assert tm.ps.infos["enc_blocks/l0/attn/wq"].shape == (24, 1024, 1024)
    assert not any("xattn" in p for p in tm.ps.infos
                   if p.startswith("enc_blocks"))


def test_encode_matches_jax(jx, pair):
    """The non-causal encoder stack, rope at arange(S_enc), both of the
    port's attention paths against the reference."""
    _, frames = _inputs(pair.tm.cfg)
    want = pair.jm.encode(pair.jp, jx.jnp.asarray(frames))
    for impl in ("k2", "sdpa"):
        m = tbuild(pair.tm.cfg, attn_impl=impl, device="cpu")
        with torch.no_grad():
            got = m.encode(pair.tp, torch.from_numpy(frames))
        _close(got, want, f"encode ({impl})")


def _block0(jx, tree):
    return jx.jax.tree.map(lambda a: a[0], tree)


def test_cross_full_and_decode_match_jax(jx, pair):
    """``_cross_full`` (output, xk, xv) and ``_cross_decode`` over its
    cache, on one decoder layer's ``xattn`` weights."""
    cfg, jcfg = pair.tm.cfg, pair.jm.cfg
    p = _block0(jx, pair.jp["dec_blocks"]["l0"]["xattn"])
    tp = convert.params_from_numpy(p, "cpu")
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    want, wc = jx.lm._cross_full(p, jx.jnp.asarray(x), jx.jnp.asarray(enc),
                                 jcfg)
    got, gc = tlm._cross_full(tp, torch.from_numpy(x), torch.from_numpy(enc),
                              cfg)
    _close(got, want, "_cross_full")
    assert set(gc) == set(wc) == {"xk", "xv"}
    for k in ("xk", "xv"):
        assert tuple(gc[k].shape) == (2, cfg.n_kv_heads, 8, cfg.d_head)
        _close(gc[k], wc[k], f"_cross_full {k}")
    x1 = x[:, :1]
    want = jx.lm._cross_decode(p, jx.jnp.asarray(x1), wc, jcfg)
    got = tlm._cross_decode(tp, torch.from_numpy(x1), gc, cfg)
    _close(got, want, "_cross_decode")


def test_prefill_logits_and_caches_match_jax(jx, pair):
    toks, frames = _inputs(pair.tm.cfg)
    want, jc = pair.jm.prefill(pair.jp, jx.jnp.asarray(toks),
                               jx.jnp.asarray(frames))
    got, tc = pair.tm.prefill(pair.tp, torch.from_numpy(toks),
                              torch.from_numpy(frames))
    _close(got, want, "prefill logits")
    jc_np = jx.jax.tree.map(np.asarray, jc)
    tc_np = convert.params_to_numpy(tc)
    assert jx.jax.tree.structure(jc_np) == jx.jax.tree.structure(tc_np)
    assert sorted(tc[1][0]) == ["k", "v", "xk", "xv"]
    for path, a in jx.jax.tree_util.tree_flatten_with_path(jc_np)[0]:
        c = tc[1][0][path[-1].key]
        _close(c, a, f"prefill cache {path[-1].key}")


def test_decode_after_prefill_matches_jax_and_the_full_prefill(jx, pair):
    """tests/test_arch_smoke.py:50-66: prefill t0 tokens with the frames,
    pad the caches into ``decode_cache_specs(b, smax, s_enc)`` (the frames
    do not offset the positions), decode the rest teacher-forced. Each
    step's logits ≡ the reference's, and the last ≡ the full prefill's,
    the reference's and the port's own."""
    jnp = jx.jnp
    jm, jp, tm, tp = pair.jm, pair.jp, pair.tm, pair.tp
    toks, frames = _inputs(tm.cfg, s=24, seed=3)
    b, s, t0, s_enc = 2, 24, 20, frames.shape[1]
    jfull, _ = jm.prefill(jp, jnp.asarray(toks), jnp.asarray(frames))
    tfull, _ = tm.prefill(tp, torch.from_numpy(toks),
                          torch.from_numpy(frames))
    _, jpre = jm.prefill(jp, jnp.asarray(toks[:, :t0]), jnp.asarray(frames))
    _, tpre = tm.prefill(tp, torch.from_numpy(toks[:, :t0]),
                         torch.from_numpy(frames))
    specs = jm.decode_cache_specs(b, s, s_enc)
    tspecs = tm.decode_cache_specs(b, s, s_enc)
    assert [tuple(sd.shape) for sd in jx.jax.tree.leaves(specs)] == \
        [sd.shape for sd in (tspecs[1][0][k] for k in sorted(tspecs[1][0]))]
    jc = jx.jax.tree.map(lambda sd, v: _pad_to(jx, sd, v), specs, jpre)
    tc = tm.init_decode_caches(b, s, s_enc)
    serve_lm.write_caches(tc, tpre, t0)
    for t in range(t0, s):
        want, jc = jm.decode_step(jp, jnp.asarray(toks[:, t]), jc,
                                  jnp.int32(t))
        got, tc = tm.decode_step(tp, torch.from_numpy(toks[:, t]), tc, t)
        _close(got, want, f"decode position {t}")
    _close(got, tfull, "decode vs the port's prefill", atol=DECODE_TOL,
           rtol=0)
    _close(got, jfull, "decode vs the reference's prefill", atol=DECODE_TOL,
           rtol=0)


def test_decode_writes_self_caches_in_place_and_reads_cross_caches(pair):
    tm, tp = pair.tm, pair.tp
    toks, frames = _inputs(tm.cfg, s=6)
    _, pre = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(frames))
    caches = tm.init_decode_caches(2, 16, frames.shape[1])
    serve_lm.write_caches(caches, pre, 6)
    before = {k: v.clone() for k, v in caches[1][0].items()}
    ptrs = {k: v.data_ptr() for k, v in caches[1][0].items()}
    _, out = tm.decode_step(tp, torch.tensor([3, 4]), caches, 6)
    leaves = out[1][0]
    assert {k: v.data_ptr() for k, v in leaves.items()} == ptrs
    for k in ("xk", "xv"):
        assert torch.equal(leaves[k], before[k]), k
    for k in ("k", "v"):
        assert not torch.equal(leaves[k][..., 6, :], before[k][..., 6, :])
        assert torch.equal(leaves[k][..., :6, :], before[k][..., :6, :])


def test_k2_runs_on_every_self_attention(monkeypatch, pair):
    """Under ``"k2"`` a prefill calls K2 once per encoder layer
    (non-causal, S_enc keys) and once per decoder layer (causal); the
    cross-attention is the plain ``_sdpa``. Under ``"sdpa"`` none."""
    calls = []
    real = kops.flash_attention

    def spy(q, k, v, causal=True, **kw):
        calls.append((bool(causal), tuple(q.shape), tuple(k.shape)))
        return real(q, k, v, causal=causal, **kw)
    monkeypatch.setattr(kops, "flash_attention", spy)
    cfg = pair.tm.cfg
    toks, frames = _inputs(cfg, s=10)
    pair.tm.prefill(pair.tp, torch.from_numpy(toks),
                    torch.from_numpy(frames))
    h, dh = cfg.n_heads, cfg.d_head
    enc = (False, (2, h, 8, dh), (2, cfg.n_kv_heads, 8, dh))
    dec = (True, (2, h, 10, dh), (2, cfg.n_kv_heads, 10, dh))
    assert calls == [enc] * cfg.encoder_layers + [dec] * cfg.n_layers
    calls.clear()
    tbuild(cfg, attn_impl="sdpa", device="cpu").prefill(
        pair.tp, torch.from_numpy(toks), torch.from_numpy(frames))
    assert calls == []


def test_prefill_needs_frames_and_attn_impl_is_checked(pair):
    with pytest.raises(ValueError, match="frame embeddings"):
        pair.tm.prefill(pair.tp, torch.zeros((1, 4), dtype=torch.int64))
    with pytest.raises(ValueError, match="attn_impl"):
        EncDecLM(pair.tm.cfg, attn_impl="xla", device="cpu")
    m = tbuild(pair.tm.cfg, attn_impl="k2", device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="K2 has no backward"):
        m.train_loss(pair.tp, {"tokens": toks, "labels": toks,
                               "frontend_embeds": torch.zeros((1, 8, 64))})


def test_params_round_trip_bit_exact_including_bf16(jx):
    """The reference's encoder-decoder tree (bf16 config) → port → numpy:
    every leaf's bits equal, and the tree is the reference's."""
    cfg = dataclasses.replace(jx.reduced_config(jx.ARCHS[ARCH]),
                              param_dtype="bfloat16")
    jparams = jx.build_model(cfg).init_params(jx.jax.random.PRNGKey(7))
    leaves = jx.jax.tree.map(np.asarray, jparams)
    tp = convert.params_from_numpy(leaves, "cpu")
    assert tp["dec_blocks"]["l0"]["xattn"]["wq"].dtype == torch.bfloat16
    back = convert.params_to_numpy(tp, bfloat16=jx.jnp.bfloat16)
    assert jx.jax.tree.structure(back) == jx.jax.tree.structure(leaves)
    for a, c in zip(jx.jax.tree.leaves(leaves), jx.jax.tree.leaves(back)):
        assert c.dtype == a.dtype and c.shape == a.shape
        assert np.array_equal(c.view(np.uint16), a.view(np.uint16))


def test_write_prompt_copies_cross_leaves_whole(pair):
    """One prompt's prefill into slot 1 of three: ``k`` / ``v`` in the
    first n positions and zero past them, ``xk`` / ``xv`` whole; slots 0
    and 2 as they were."""
    tm, tp = pair.tm, pair.tp
    toks, frames = _inputs(tm.cfg, b=1, s=5)
    _, pre = tm.prefill(tp, torch.from_numpy(toks), torch.from_numpy(frames))
    dense = tm.init_decode_caches(3, 12, frames.shape[1])
    gen = torch.Generator().manual_seed(0)
    for leaf in dense[1][0].values():
        leaf.copy_(torch.randn(leaf.shape, generator=gen))
    before = {k: v.clone() for k, v in dense[1][0].items()}
    serve_lm._write_prompt(dense, pre, 1, 5)
    for k, leaf in dense[1][0].items():
        src = pre[1][0][k][:, 0]
        for other in (0, 2):
            assert torch.equal(leaf[:, other], before[k][:, other]), k
        if k in ("xk", "xv"):
            assert torch.equal(leaf[:, 1], src), k
        else:
            assert torch.equal(leaf[:, 1, :, :5], src), k
            assert not leaf[:, 1, :, 5:].any(), k


@pytest.mark.cuda
def test_reduced_encdec_on_the_card_matches_the_cpu():
    """The reduced model in f32: prefill logits and 4 greedy decode steps
    on the card ≡ on the CPU from the same weights, frames and tokens
    (1e-4), greedy tokens equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K2 has no CPU mode")
    cfg = treduced(TARCHS[ARCH])
    leaves = convert.params_to_numpy(tbuild(cfg, device="cpu").init_params(
        torch.Generator().manual_seed(3)))
    toks, frames = _inputs(cfg, s=40, seed=4)
    runs = {}
    for dev in ("cuda", "cpu"):
        m = tbuild(cfg, device=dev)
        p = convert.params_from_numpy(leaves, dev)
        logits, pre = m.prefill(p, torch.from_numpy(toks).to(dev),
                                torch.from_numpy(frames).to(dev))
        caches = m.init_decode_caches(2, 48, frames.shape[1])
        serve_lm.write_caches(caches, pre, 40)
        out = [logits.cpu()]
        fed = runs["cuda"][1] if dev == "cpu" else []
        for i in range(4):
            nxt = fed[i] if dev == "cpu" else torch.argmax(logits, -1).cpu()
            if dev == "cuda":
                fed.append(nxt)
            logits, caches = m.decode_step(p, nxt.to(dev), caches, 40 + i)
            out.append(logits.cpu())
        runs[dev] = (out, fed)
    for i, (g, w) in enumerate(zip(runs["cuda"][0], runs["cpu"][0])):
        _close(g, w, f"step {i}", atol=LM_TOL, rtol=LM_TOL)
        assert torch.equal(g.argmax(-1), w.argmax(-1)), i
