"""The port's serving path ≡ the JAX package's.

* the paged pool: under the same admit / append / release sequence the
  allocator's integers (free stack, n_free, block table, seq_len, active)
  equal the reference's after every operation, and the gathered K/V too;
* the never-leaks property of tests/test_train_serve.py, on the port;
* the serve loop of ``repro_torch.launch.serve_lm`` against the same loop
  built here from the JAX package's functions: same requests, same
  weights, equal token streams.
"""

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
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
               n_pages):
    """The port's serve loop, written with the JAX package's functions:
    prefill writes the slot's rows of the dense caches (zero past the
    prompt), decode passes lens.max() as the shared position."""
    jnp = jx.jnp
    spec = jx.kvc.PagedCacheSpec(
        n_layers=jm.cfg.n_layers, n_kv_heads=jm.cfg.n_kv_heads,
        d_head=jm.cfg.d_head, page_size=page_size, n_pages=n_pages,
        max_seqs=slots, max_pages_per_seq=s_max // page_size,
        dtype="float32")
    caches = jm.init_decode_caches(slots, s_max)
    lens = np.zeros(slots, np.int64)

    def prefill_fn(prompt, slot, batcher):
        nonlocal caches
        logits, pre = prefill(jparams, jnp.asarray(prompt[None]))
        n = len(prompt)

        def put(dense, part):
            idx = (Ellipsis, slot, slice(None), slice(None), slice(None))
            dense = dense.at[idx].set(0)
            return dense.at[(Ellipsis, slot, slice(None), slice(0, n),
                             slice(None))].set(part[..., 0, :, :, :])
        caches = jx.jax.tree.map(put, caches, pre)
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


def test_serve_refuses_requests_that_overflow_s_max():
    cfg = dataclasses.replace(treduced(TARCHS["qwen2-1.5b"]), n_layers=1)
    m = tbuild(cfg, device="cpu")
    params = m.init_params(torch.Generator().manual_seed(0))
    reqs = serve_lm.make_requests(1, cfg.vocab_size, prompt_min=40,
                                  prompt_max=40, new_tokens=8, seed=0)
    with pytest.raises(ValueError, match="s_max"):
        serve_lm.serve(m, params, reqs, slots=1, s_max=48, page_size=8,
                       n_pages=8)
