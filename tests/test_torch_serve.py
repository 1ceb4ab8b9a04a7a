"""The port's serving path ≡ the JAX package's.

* the paged pool: under the same admit / append / release sequence the
  allocator's integers (free stack, n_free, block table, seq_len, active)
  equal the reference's after every operation, and the gathered K/V too;
* the never-leaks property of tests/test_train_serve.py, on the port;
* the serve loop of ``repro_torch.launch.serve_lm`` against the same loop
  built here from the JAX package's functions: same requests, same
  weights, equal token streams;
* the SSM family (mamba2) and the hybrid (jamba) served on the CPU at
  their reduced configs, with prompts shorter than ``ssm_head_dim`` and
  longer than ``ssm_chunk``: the greedy tokens equal the JAX package's
  ``LM.decode_step`` loop over each prompt alone (the reference example's
  way of writing a prompt), and jamba's 2-slot serve equals the JAX
  mirror of the port's loop (attention leaves written by position, SSM
  leaves whole);
* the encoder-decoder (seamless) at its reduced config with one block of
  frames per request: with 2 slots and prompts of one length each
  request's greedy tokens equal the JAX package's ``EncDecLM.prefill``
  (prompt and frames) + ``decode_step`` loop over that request alone;
  with prompts of unequal lengths the serve equals the JAX mirror of the
  port's loop (cross leaves ``xk`` / ``xv`` written whole).
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.kernels import flash_attention as tk2  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.serve import kv_cache as tkvc  # noqa: E402

SPEC_ARGS = dict(n_layers=2, n_kv_heads=2, d_head=8, page_size=4,
                 n_pages=32, max_seqs=4, max_pages_per_seq=8,
                 dtype="float32")
TSPEC = tkvc.PagedCacheSpec(**SPEC_ARGS)


@pytest.fixture
def jx():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCHS
    from repro.models import build_model, reduced_config
    from repro.serve import ContinuousBatcher, Request
    from repro.serve import kv_cache as kvc
    return types.SimpleNamespace(jax=jax, jnp=jnp, ARCHS=ARCHS,
                                 build_model=build_model,
                                 reduced_config=reduced_config, kvc=kvc,
                                 ContinuousBatcher=ContinuousBatcher,
                                 Request=Request)


@pytest.fixture(autouse=True)
def _single_thread():
    """One torch CPU thread keeps the parity tests deterministic (see
    tests/test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _ints(state):
    return {f: np.asarray(getattr(state, f)).astype(np.int64)
            for f in ("free_stack", "n_free", "block_table", "seq_len",
                      "seq_active")}


def _assert_same_ints(tst, jst, what):
    got, want = _ints(tst), _ints(jst)
    for f in want:
        assert np.array_equal(got[f], want[f]), f"{f} differs after {what}"


def test_paged_pool_integers_match_jax(jx):
    jspec = jx.kvc.PagedCacheSpec(**SPEC_ARGS)
    jst = jx.kvc.init_cache(jspec)
    tst = tkvc.init_cache(TSPEC, "cpu")
    rng = np.random.default_rng(0)
    script = [("admit", 0, 5), ("admit", 1, 0), ("append",), ("append",),
              ("admit", 2, 9), ("admit", 1, 3), ("append",), ("append",),
              ("append",), ("release", 0), ("admit", 3, 16), ("append",),
              ("admit", 0, 30), ("append",), ("release", 2), ("append",),
              ("admit", 2, 1), ("append",), ("append",), ("release", 1),
              ("release", 1), ("admit", 1, 12), ("append",)]
    for op in script:
        if op[0] == "admit":
            jst, jok = jx.kvc.admit_sequence(jspec, jst, jx.jnp.int32(op[1]),
                                             jx.jnp.int32(op[2]))
            tst, tok = tkvc.admit_sequence(TSPEC, tst, op[1], op[2])
            assert bool(tok) == bool(jok), op
        elif op[0] == "release":
            jst = jx.kvc.release_sequence(jspec, jst, jx.jnp.int32(op[1]))
            tst = tkvc.release_sequence(TSPEC, tst, op[1])
        else:
            k, v = (rng.standard_normal((2, 4, 2, 8)).astype(np.float32)
                    for _ in range(2))
            jst, jw = jx.kvc.append_token(jspec, jst, jx.jnp.asarray(k),
                                          jx.jnp.asarray(v))
            tst, tw = tkvc.append_token(TSPEC, tst, torch.from_numpy(k),
                                        torch.from_numpy(v))
            assert np.array_equal(tw.numpy(), np.asarray(jw)), op
        _assert_same_ints(tst, jst, op)
    for slot in range(4):
        for layer in range(2):
            jk, jv, jvalid = jx.kvc.gather_kv(jspec, jst, jx.jnp.int32(layer),
                                              jx.jnp.int32(slot), s_max=16)
            tk, tv, tvalid = tkvc.gather_kv(TSPEC, tst, layer, slot, 16)
            assert np.array_equal(tvalid.numpy(), np.asarray(jvalid))
            n = int(tvalid.sum())
            assert np.array_equal(tk[:n].numpy(), np.asarray(jk)[:n])
            assert np.array_equal(tv[:n].numpy(), np.asarray(jv)[:n])


def test_pool_exhaustion_blocks_admission():
    spec = tkvc.PagedCacheSpec(n_layers=1, n_kv_heads=1, d_head=4,
                               page_size=4, n_pages=4, max_seqs=4,
                               max_pages_per_seq=4, dtype="float32")
    st_ = tkvc.init_cache(spec, "cpu")
    st_, ok1 = tkvc.admit_sequence(spec, st_, 0, 16)
    assert bool(ok1)
    st_, ok2 = tkvc.admit_sequence(spec, st_, 1, 4)
    assert not bool(ok2)                 # pool exhausted → graceful refusal
    st_ = tkvc.release_sequence(spec, st_, 0)
    assert sorted(st_.free_stack.tolist()) == list(range(4))
    st_, ok3 = tkvc.admit_sequence(spec, st_, 1, 4)
    assert bool(ok3)


@settings(max_examples=20, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["admit", "release", "append"]),
                          st.integers(0, 3), st.integers(1, 20)),
                min_size=1, max_size=30))
def test_allocator_never_leaks_property(ops):
    """Pages held + pages free == pool under any admit/append/release
    interleaving (the paper's allocator invariant)."""
    st_ = tkvc.init_cache(TSPEC, "cpu")
    zero = torch.zeros((2, 4, 2, 8))
    for kind, slot, plen in ops:
        if kind == "admit":
            st_, _ = tkvc.admit_sequence(TSPEC, st_, slot, plen)
        elif kind == "release":
            st_ = tkvc.release_sequence(TSPEC, st_, slot)
        else:
            st_, _ = tkvc.append_token(TSPEC, st_, zero, zero)
        held = int((st_.block_table >= 0).sum())
        assert held + int(st_.n_free) == TSPEC.n_pages


def _jax_serve(jx, jm, jparams, requests, *, slots, s_max, page_size,
               n_pages, frames=None):
    """The port's serve loop, written with the JAX package's functions:
    prefill writes the slot's rows of the dense caches (zero past the
    prompt), decode passes lens.max() as the shared position. An
    encoder-decoder takes ``frames``, one block per request, found by the
    prompt array as the port finds them."""
    jnp = jx.jnp
    spec = jx.kvc.PagedCacheSpec(
        n_layers=jm.cfg.n_layers, n_kv_heads=jm.cfg.n_kv_heads,
        d_head=jm.cfg.d_head, page_size=page_size, n_pages=n_pages,
        max_seqs=slots, max_pages_per_seq=s_max // page_size,
        dtype="float32")
    if frames is None:
        caches = jm.init_decode_caches(slots, s_max)
    else:
        by_prompt = {id(r.prompt): f for r, f in zip(requests, frames)}
        caches = jx.jax.tree.map(
            lambda sd: jnp.zeros(sd.shape, sd.dtype),
            jm.decode_cache_specs(slots, s_max, frames[0].shape[0]))
    lens = np.zeros(slots, np.int64)

    def prefill_fn(prompt, slot, batcher):
        nonlocal caches
        fe = () if frames is None else (
            jnp.asarray(by_prompt[id(prompt)][None]),)
        logits, pre = prefill(jparams, jnp.asarray(prompt[None]), *fe)
        n = len(prompt)

        def put(path, dense, part):
            # a stacked block leaf: (n_blocks, slots, ...); SSM leaves
            # (conv, state) and cross leaves (xk, xv) whole, K/V at
            # positions [0, n), zero past
            rows = part[:, 0]
            if path[-1].key not in ("conv", "state", "xk", "xv"):
                rows = jnp.zeros(dense.shape[:1] + dense.shape[2:],
                                 dense.dtype).at[..., :n, :].set(rows)
            return dense.at[:, slot].set(rows)
        caches = jx.jax.tree_util.tree_map_with_path(put, caches, pre)
        lens[slot] = n
        return None, int(jnp.argmax(logits[0]))

    def decode_fn(p, tokens, pool_state, active):
        nonlocal caches
        logits, caches = decode(p, tokens, caches,
                                        jnp.int32(int(lens.max())))
        lens[np.asarray(active)] += 1
        knew = jnp.zeros((spec.n_layers, slots, spec.n_kv_heads,
                          spec.d_head), jnp.float32)
        st_, _ = jx.kvc.append_token(spec, pool_state, knew, knew)
        return jnp.argmax(logits, axis=-1), st_

    prefill = jx.jax.jit(jm.prefill)
    decode = jx.jax.jit(jm.decode_step)
    batcher = jx.ContinuousBatcher(spec, prefill_fn, decode_fn, eos_token=-1)
    for r in requests:
        batcher.submit(jx.Request(uid=r.uid, prompt=r.prompt,
                                  max_new_tokens=r.max_new_tokens))
    batcher.run_until_drained(jparams, max_steps=1000)
    return batcher


def test_serve_token_streams_match_jax(jx):
    jcfg = dataclasses.replace(jx.reduced_config(jx.ARCHS["qwen2-1.5b"]),
                               n_layers=2, vocab_size=500)
    tcfg = dataclasses.replace(treduced(TARCHS["qwen2-1.5b"]), n_layers=2,
                               vocab_size=500)
    jm = jx.build_model(jcfg)
    # weights ×10 so greedy decoding does not just repeat one token
    jparams = jx.jax.tree.map(lambda a: a * 10 if a.ndim >= 2 else a,
                              jm.init_params(jx.jax.random.PRNGKey(4)))
    tm = tbuild(tcfg, device="cpu")
    tparams = convert.params_from_numpy(
        jx.jax.tree.map(np.asarray, jparams), "cpu")
    # two prompt lengths: slots of unequal length, two prefill compiles
    reqs = serve_lm.make_requests(4, 500, prompt_min=12, prompt_max=13,
                                  new_tokens=6, seed=3)
    kw = dict(slots=2, s_max=48, page_size=8, n_pages=12)
    report = serve_lm.serve(tm, tparams, reqs, **kw)
    jb = _jax_serve(jx, jm, jparams, reqs, **kw)
    assert [f.uid for f in report.finished] == [f.uid for f in jb.finished]
    for got, want in zip(report.finished, jb.finished):
        assert got.tokens == [int(t) for t in want.tokens], got.uid
    assert report.n_free == int(jb.state.n_free) == kw["n_pages"]
    assert report.logits_finite
    summary = report.summary()
    assert summary["requests"] == summary["prefills"] == 4
    assert summary["generated_tokens"] == 4 * 6
    assert len({t for f in report.finished for t in f.tokens}) > 6


PHI3 = "phi-3-vision-4.2b"


def test_phi3_vision_at_head_dim_96_served_through_k2_matches_jax_pallas(jx):
    """phi-3-vision-4.2b's head dim, 96, through K2: the reduced vlm config
    (MHA, 4 heads) with ``d_head=96`` in both packages, the reference's
    weights carried across by ``convert.params_from_numpy``. The port's
    ``"k2"`` prefill logits ≡ the reference's ``"pallas"`` (interpret mode)
    within 1e-4 (f32; the test_torch_lm.py bound), and the served greedy
    token streams equal the JAX mirror of the port's serve loop. Text-only
    prompts: no frontend embeddings, as the reference's ``LM.prefill``
    takes them."""
    jcfg = dataclasses.replace(jx.reduced_config(jx.ARCHS[PHI3]), d_head=96)
    tcfg = dataclasses.replace(treduced(TARCHS[PHI3]), d_head=96)
    assert jcfg.family == tcfg.family == "vlm"
    assert tcfg.n_kv_heads == tcfg.n_heads and tcfg.d_head == 96
    jm = jx.build_model(jcfg, attn_impl="pallas")
    # weights ×10 so greedy decoding does not just repeat one token
    jparams = jx.jax.tree.map(lambda a: a * 10 if a.ndim >= 2 else a,
                              jm.init_params(jx.jax.random.PRNGKey(7)))
    tm = tbuild(tcfg, device="cpu")
    assert tm.attn_impl == "k2"
    tparams = convert.params_from_numpy(
        jx.jax.tree.map(np.asarray, jparams), "cpu")
    toks = np.random.default_rng(7).integers(0, tcfg.vocab_size, (2, 37))
    want, _ = jm.prefill(jparams, jx.jnp.asarray(toks))
    before = tk2.flash_attention.launches
    got, _ = tm.prefill(tparams, torch.from_numpy(toks))
    assert tk2.flash_attention.launches == before      # CPU: plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    reqs = serve_lm.make_requests(3, tcfg.vocab_size, prompt_min=11,
                                  prompt_max=14, new_tokens=5, seed=9)
    kw = dict(slots=2, s_max=32, page_size=8, n_pages=8)
    report = serve_lm.serve(tm, tparams, reqs, **kw)
    jb = _jax_serve(jx, jm, jparams, reqs, **kw)
    assert [f.uid for f in report.finished] == [f.uid for f in jb.finished]
    for got_f, want_f in zip(report.finished, jb.finished):
        assert got_f.tokens == [int(t) for t in want_f.tokens], got_f.uid
    assert report.logits_finite and report.n_free == kw["n_pages"]


def test_serve_refuses_requests_that_overflow_s_max():
    cfg = dataclasses.replace(treduced(TARCHS["qwen2-1.5b"]), n_layers=1)
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    reqs = serve_lm.make_requests(1, cfg.vocab_size, prompt_min=40,
                                  prompt_max=40, new_tokens=8, seed=0)
    with pytest.raises(ValueError, match="s_max"):
        serve_lm.serve(m, params, reqs, slots=1, s_max=48, page_size=8,
                       n_pages=8)


SSM_ARCHS = ("mamba2-370m", "jamba-v0.1-52b")


def _ssm_pair(jx, arch):
    """The reduced config in both packages (mamba2 at 2 layers), the
    reference's weights ×10 (so greedy decoding does not repeat one token)
    with its constant leaves perturbed, carried to the port."""
    n_layers = 2 if arch == "mamba2-370m" else 8
    jcfg = dataclasses.replace(jx.reduced_config(jx.ARCHS[arch]),
                               n_layers=n_layers)
    tcfg = dataclasses.replace(treduced(TARCHS[arch]), n_layers=n_layers)
    jm = jx.build_model(jcfg)
    rng = np.random.default_rng(5)

    def scaled(path, a):
        if a.ndim - (path[0].key == "blocks") >= 2:
            return np.asarray(a) * 10
        return np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.3
    jparams = jx.jax.tree_util.tree_map_with_path(
        scaled, jm.init_params(jx.jax.random.PRNGKey(5)))
    tm = tbuild(tcfg, device="cpu")
    return jm, jparams, tm, convert.params_from_numpy(jparams, "cpu")


def _ssm_requests(vocab):
    reqs = serve_lm.make_requests(5, vocab, prompt_min=3, prompt_max=40,
                                  new_tokens=6, seed=11)
    lens = [len(r.prompt) for r in reqs]
    assert min(lens) < 16 < max(lens), lens     # ssm_head_dim, ssm_chunk
    return reqs


def _jax_decode_loop(jx, jm, jparams, prompt, new_tokens, s_max):
    """The reference example's way: the prompt written by one
    ``decode_step`` per token into batch-1 caches, then greedy steps; the
    tokens after the first, as the batcher records them."""
    jnp = jx.jnp
    decode = jx.jax.jit(jm.decode_step)
    caches = jm.init_decode_caches(1, s_max)
    for t, tok in enumerate(prompt):
        logits, caches = decode(jparams, jnp.full((1,), int(tok), jnp.int32),
                                caches, jnp.int32(t))
    out = []
    for i in range(new_tokens):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, caches = decode(jparams, nxt, caches,
                                jnp.int32(len(prompt) + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


@pytest.mark.parametrize("arch,slots", [("mamba2-370m", 1),
                                        ("mamba2-370m", 2),
                                        ("jamba-v0.1-52b", 1)])
def test_serve_ssm_token_streams_match_the_jax_decode_loop(jx, arch, slots):
    """Each request's greedy tokens equal the reference's decode-step loop
    over its prompt alone. mamba2 also with 2 slots: an SSM slot's state
    advances one token a step whatever the other slot holds (the shared
    position does not reach it) and is overwritten when the slot is next
    admitted."""
    jm, jparams, tm, tparams = _ssm_pair(jx, arch)
    reqs = _ssm_requests(tm.cfg.vocab_size)
    kw = dict(slots=slots, s_max=64, page_size=8, n_pages=32)
    report = serve_lm.serve(tm, tparams, reqs, **kw)
    assert sorted(f.uid for f in report.finished) == list(range(len(reqs)))
    assert report.n_free == kw["n_pages"] and report.logits_finite
    by_uid = {f.uid: f.tokens for f in report.finished}
    for r in reqs:
        want = _jax_decode_loop(jx, jm, jparams, r.prompt, r.max_new_tokens,
                                kw["s_max"])
        assert by_uid[r.uid] == want, (r.uid, len(r.prompt))
    assert len({t for f in report.finished for t in f.tokens}) > 6


def test_serve_hybrid_token_streams_match_jax_with_shared_slots(jx):
    """jamba through 2 slots: the port's serve ≡ the same loop built from
    the JAX package's prefill and decode_step (the shared position
    ``lens.max()`` reaches the attention layer, so this is the loop's own
    semantics, not each prompt alone)."""
    jm, jparams, tm, tparams = _ssm_pair(jx, "jamba-v0.1-52b")
    reqs = _ssm_requests(tm.cfg.vocab_size)
    kw = dict(slots=2, s_max=64, page_size=8, n_pages=32)
    report = serve_lm.serve(tm, tparams, reqs, **kw)
    jb = _jax_serve(jx, jm, jparams, reqs, **kw)
    assert [f.uid for f in report.finished] == [f.uid for f in jb.finished]
    for got, want in zip(report.finished, jb.finished):
        assert got.tokens == [int(t) for t in want.tokens], got.uid
    assert report.n_free == int(jb.state.n_free) == kw["n_pages"]


def test_serve_mamba2_pool_has_zero_size_pages_that_decide_admission():
    """mamba2 has no attention: the paged pool's spec is (n_kv_heads 0,
    d_head 0), its pages hold nothing, and admission still waits for free
    pages (3 pages of 8 tokens for prompts of up to 20 + 4 new tokens
    admit one request at a time)."""
    cfg = dataclasses.replace(treduced(TARCHS["mamba2-370m"]), n_layers=1)
    assert (cfg.n_kv_heads, cfg.d_head) == (0, 0)
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    reqs = serve_lm.make_requests(3, cfg.vocab_size, prompt_min=12,
                                  prompt_max=20, new_tokens=4, seed=2)
    report = serve_lm.serve(m, params, reqs, slots=2, s_max=32, page_size=8,
                            n_pages=3)
    assert sorted(f.uid for f in report.finished) == [0, 1, 2]
    assert report.n_free == 3
    assert report.summary()["decode_iterations"] == 3 * 4


ENCDEC = "seamless-m4t-large-v2"


def _encdec_pair(jx):
    """The reduced seamless in both packages, the reference's weights ×10
    (so greedy decoding does not repeat one token) with its norms
    perturbed, carried to the port."""
    jm = jx.build_model(jx.reduced_config(jx.ARCHS[ENCDEC]))
    rng = np.random.default_rng(6)

    def scaled(path, a):
        if a.ndim >= 2:
            return np.asarray(a) * 10
        return np.asarray(a) + rng.standard_normal(a.shape).astype(
            np.float32) * 0.3
    jparams = jx.jax.tree_util.tree_map_with_path(
        scaled, jm.init_params(jx.jax.random.PRNGKey(6)))
    tm = tbuild(treduced(TARCHS[ENCDEC]), device="cpu")
    return jm, jparams, tm, convert.params_from_numpy(jparams, "cpu")


def _jax_encdec_loop(jx, jm, jparams, prompt, frames, new_tokens, s_max):
    """The reference's own way for one request: ``prefill`` of the prompt
    with its frames, the caches padded into ``decode_cache_specs(1, s_max,
    s_enc)`` (tests/test_arch_smoke.py), then greedy ``decode_step``s; the
    tokens after the first, as the batcher records them."""
    jnp = jx.jnp
    decode = jx.jax.jit(jm.decode_step)
    logits, pre = jx.jax.jit(jm.prefill)(jparams, jnp.asarray(prompt[None]),
                                         jnp.asarray(frames[None]))

    def pad_to(spec, val):
        out = jnp.zeros(spec.shape, spec.dtype)
        return out.at[tuple(slice(0, d) for d in val.shape)].set(val)
    caches = jx.jax.tree.map(pad_to, jm.decode_cache_specs(
        1, s_max, frames.shape[0]), pre)
    out = []
    for i in range(new_tokens):
        nxt = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        logits, caches = decode(jparams, nxt, caches,
                                jnp.int32(len(prompt) + i))
        out.append(int(jnp.argmax(logits[0])))
    return out


def test_serve_encdec_token_streams_match_the_jax_prefill_decode_loop(jx):
    """2 slots, 4 requests with prompts of one length (so the shared
    position is each slot's own) and a frame block each: every request's
    greedy tokens equal the reference's loop over its prompt and frames
    alone."""
    jm, jparams, tm, tparams = _encdec_pair(jx)
    reqs = serve_lm.make_requests(4, tm.cfg.vocab_size, prompt_min=13,
                                  prompt_max=13, new_tokens=6, seed=8)
    frames = serve_lm.make_frames(tm.cfg, reqs, seed=8)
    kw = dict(slots=2, s_max=32, page_size=8, n_pages=16)
    report = serve_lm.serve(tm, tparams, reqs, frames=frames, **kw)
    assert sorted(f.uid for f in report.finished) == [0, 1, 2, 3]
    assert report.n_free == kw["n_pages"] and report.logits_finite
    summary = report.summary()
    assert summary["frame_tokens"] == 4 * tm.cfg.frontend_tokens
    assert summary["prompt_tokens"] == 4 * 13
    by_uid = {f.uid: f.tokens for f in report.finished}
    for r, f in zip(reqs, frames):
        want = _jax_encdec_loop(jx, jm, jparams, r.prompt, f,
                                r.max_new_tokens, kw["s_max"])
        assert by_uid[r.uid] == want, r.uid
    assert len({t for f in report.finished for t in f.tokens}) > 6


def test_serve_encdec_matches_jax_with_shared_slots(jx):
    """Prompts of 3-20 tokens through 2 slots: the port's serve ≡ the same
    loop built from the JAX package's ``EncDecLM.prefill`` and
    ``decode_step`` (the shared position ``lens.max()``; each slot's cross
    cache its own request's)."""
    jm, jparams, tm, tparams = _encdec_pair(jx)
    reqs = serve_lm.make_requests(5, tm.cfg.vocab_size, prompt_min=3,
                                  prompt_max=20, new_tokens=5, seed=9)
    assert len({len(r.prompt) for r in reqs}) > 1
    frames = serve_lm.make_frames(tm.cfg, reqs, seed=9)
    kw = dict(slots=2, s_max=32, page_size=8, n_pages=16)
    report = serve_lm.serve(tm, tparams, reqs, frames=frames, **kw)
    jb = _jax_serve(jx, jm, jparams, reqs, frames=frames, **kw)
    assert [f.uid for f in report.finished] == [f.uid for f in jb.finished]
    for got, want in zip(report.finished, jb.finished):
        assert got.tokens == [int(t) for t in want.tokens], got.uid
    assert report.n_free == int(jb.state.n_free) == kw["n_pages"]


def test_serve_encdec_frames_are_checked():
    """An encoder-decoder needs one frame block per request, of one shape,
    told apart by the prompt arrays; a decoder-only model takes none."""
    cfg = treduced(TARCHS[ENCDEC])
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    reqs = serve_lm.make_requests(2, cfg.vocab_size, prompt_min=4,
                                  prompt_max=4, new_tokens=2, seed=0)
    frames = serve_lm.make_frames(cfg, reqs, seed=0)
    kw = dict(slots=1, s_max=16, page_size=8, n_pages=4)
    with pytest.raises(ValueError, match="frames are required"):
        serve_lm.serve(m, params, reqs, **kw)
    with pytest.raises(ValueError, match="1 frame blocks for 2"):
        serve_lm.serve(m, params, reqs, frames=frames[:1], **kw)
    with pytest.raises(ValueError, match="unequal shapes"):
        serve_lm.serve(m, params, reqs, frames=[frames[0], frames[1][:4]],
                       **kw)
    twins = [reqs[0], dataclasses.replace(reqs[1], prompt=reqs[0].prompt)]
    with pytest.raises(ValueError, match="share one prompt array"):
        serve_lm.serve(m, params, twins, frames=frames, **kw)
    dec = tbuild(dataclasses.replace(treduced(TARCHS["qwen2-1.5b"]),
                                     n_layers=1), device="cpu")
    with pytest.raises(ValueError, match="frames are not taken"):
        serve_lm.serve(dec, dec.init_params(torch.Generator().manual_seed(0)),
                       reqs, frames=frames, **kw)
    assert serve_lm.make_frames(dec.cfg, reqs, 0) is None
    assert [f.shape for f in frames] == [(8, cfg.d_model)] * 2
    assert all(f.dtype == np.float32 for f in frames)
    report = serve_lm.serve(m, params, reqs, frames=frames, **kw)
    assert report.summary()["frame_tokens"] == 16
