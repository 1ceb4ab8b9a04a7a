"""K2 in the port ≡ the reference's K2 (Pallas, interpret mode) and oracle.

Same inputs, made with numpy from a seed, go through the JAX package's
``ops.flash_attention`` and ``ref.flash_attention_ref`` and the port's
``ops.flash_attention`` (on the CPU: K2's plain version) and
``ref.flash_attention_ref``, at the tolerances ``tests/test_kernels.py``
holds Pallas K2 to (f32 2e-5, bf16 2e-2). Rows with no visible key follow
the kernel's rule (0), tested on their own. The wrapper's layout
handling (strided views go to the kernel as they lie where it can read
them) is tested on the CPU through the arguments it would pass. The CUDA
kernels (tensor-core bf16 at D 64, 96 and 128, scalar otherwise) are held
against their plain version by the card-only tests at the end, which need
no JAX (on the GPU host: ``python -m pytest -q
tests/test_torch_flash_attention.py -m cuda``).
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hypothesis_compat import given, settings, st  # noqa: E402

from repro_torch.kernels import flash_attention as tk2  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402

CASES = [   # (b, hq, hkv, sq, sk, d, causal, dtype): tests/test_kernels.py
    (2, 4, 2, 128, 128, 64, True, "float32"),
    (1, 8, 8, 256, 256, 32, True, "float32"),
    (1, 4, 1, 100, 100, 64, True, "float32"),     # non-aligned seq
    (2, 2, 2, 64, 192, 32, True, "float32"),      # chunk (Sq < Sk)
    (1, 4, 2, 128, 128, 64, False, "float32"),    # non-causal
    (1, 2, 2, 128, 128, 128, True, "bfloat16"),   # bf16 inputs
    (1, 2, 1, 384, 384, 64, True, "float32"),     # multi-block both axes
    # head dim 96 (phi-3-vision-4.2b): f32 and bf16, causal and not, GQA
    # and MHA
    (1, 4, 2, 128, 128, 96, True, "float32"),
    (1, 4, 4, 100, 100, 96, False, "float32"),
    (1, 4, 4, 130, 130, 96, True, "bfloat16"),
    (1, 4, 2, 128, 128, 96, False, "bfloat16"),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def ref():
    """The JAX reference modules (imported here, so the card-only test runs
    where JAX is not installed)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import ops, ref as oracle
    return types.SimpleNamespace(jnp=jnp, ops=ops, oracle=oracle)


@pytest.fixture(autouse=True)
def _single_thread():
    """One torch CPU thread keeps the parity tests deterministic (see
    tests/test_torch_kernels.py)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, b, hq, hkv, sq, sk, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, sq, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32),
            rng.standard_normal((b, hkv, sk, d)).astype(np.float32))


def _t(x, dtype="float32", device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=getattr(torch, dtype))


def _np(x):
    return x.float().cpu().numpy()


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,dtype", CASES)
def test_flash_attention_matches_jax(ref, b, hq, hkv, sq, sk, d, causal,
                                     dtype):
    q, k, v = _qkv(sq * 7 + d, b, hq, hkv, sq, sk, d)
    jdt = getattr(ref.jnp, dtype)
    jq, jk, jv = (ref.jnp.asarray(x, jdt) for x in (q, k, v))
    want_kernel = np.asarray(ref.ops.flash_attention(jq, jk, jv,
                                                     causal=causal),
                             np.float32)
    want_oracle = np.asarray(ref.oracle.flash_attention_ref(
        jq, jk, jv, causal=causal), np.float32)
    tq, tk, tv = (_t(x, dtype) for x in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    assert torch.equal(got, tk2.flash_attention_plain(tq, tk, tv,
                                                      causal=causal))
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(got), want_kernel, atol=tol)
    np.testing.assert_allclose(_np(got), want_oracle, atol=tol)
    oracle = tref.flash_attention_ref(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(_np(oracle), want_oracle, atol=tol)


@settings(max_examples=8, deadline=None)
@given(st.integers(1, 2), st.sampled_from([1, 2, 4]), st.integers(1, 3),
       st.sampled_from([16, 32, 64, 128]), st.integers(0, 10_000))
def test_flash_attention_plain_matches_oracle_property(b, group, hkv, d,
                                                       seed):
    rng = np.random.default_rng(seed)
    sq = int(rng.integers(2, 200))
    sk = sq + int(rng.integers(0, 64))
    q, k, v = _qkv(seed, b, group * hkv, hkv, sq, sk, d)
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = tops.flash_attention(tq, tk, tv, causal=True)
    want = tref.flash_attention_ref(tq, tk, tv, causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=3e-5)


def test_flash_attention_identical_v_returns_v():
    """softmax sanity: attending to identical V returns V."""
    b, h, s, d = 1, 2, 130, 32
    q, k, _ = _qkv(3, b, h, h, s, s, d)
    row = np.random.default_rng(4).standard_normal((1, 1, 1, d))
    v = np.broadcast_to(row.astype(np.float32), (b, h, s, d)).copy()
    out = tops.flash_attention(_t(q), _t(k), _t(v), causal=True)
    np.testing.assert_allclose(_np(out), v, atol=1e-5)


def test_flash_attention_rows_without_keys_are_zero():
    """The kernel's l = 0 → 0 rule: with Sq > Sk (kv_offset < 0), causal
    rows before the first key see nothing and are 0 (the oracle gives NaN
    there); the other rows match softmax over their visible keys. With
    sk_actual = 0 every row is 0."""
    b, hq, hkv, sq, sk, d = 1, 4, 2, 40, 24, 32
    q, k, v = _qkv(5, b, hq, hkv, sq, sk, d)
    tq, tk, tv = _t(q), _t(k), _t(v)
    out = tk2.flash_attention(tq, tk, tv, causal=True)     # kv_offset -16
    assert torch.equal(out[:, :, :sq - sk], torch.zeros_like(
        out[:, :, :sq - sk]))
    want = tref.flash_attention_ref(tq[:, :, sq - sk:], tk, tv, causal=True)
    np.testing.assert_allclose(_np(out[:, :, sq - sk:]), _np(want),
                               atol=2e-5)
    nan_rows = tref.flash_attention_ref(tq, tk, tv, causal=True)
    assert torch.isnan(nan_rows[:, :, :sq - sk]).all()
    empty = tk2.flash_attention(tq, tk, tv, causal=False, sk_actual=0)
    assert torch.equal(empty, torch.zeros_like(empty))


def test_flash_attention_sk_actual_masks_key_padding():
    """Keys at or past sk_actual do not count: same as cutting them off."""
    q, k, v = _qkv(6, 1, 4, 2, 50, 80, 64)
    tq, tk, tv = _t(q), _t(k), _t(v)
    got = tk2.flash_attention(tq, tk, tv, causal=True, sk_actual=60,
                              kv_offset=10)
    want = tops.flash_attention(tq, tk[:, :, :60], tv[:, :, :60],
                                causal=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6)


def test_flash_attention_wrapper_checks_inputs():
    q, k, v = (_t(x) for x in _qkv(7, 1, 4, 2, 16, 16, 32))
    with pytest.raises(ValueError):                   # head dim 48
        tk2.flash_attention(q[..., :24].repeat(1, 1, 1, 2),
                            k[..., :24].repeat(1, 1, 1, 2),
                            v[..., :24].repeat(1, 1, 1, 2))
    with pytest.raises(ValueError):                   # Hq % Hkv != 0
        tk2.flash_attention(q[:, :3], k, v)
    with pytest.raises(ValueError):                   # mixed dtypes
        tk2.flash_attention(q, k.to(torch.bfloat16), v)
    with pytest.raises(ValueError):                   # float16
        tk2.flash_attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError):                   # sk_actual > Sk
        tk2.flash_attention(q, k, v, sk_actual=17)
    before = tk2.flash_attention.launches
    tk2.flash_attention(q, k, v)
    assert tk2.flash_attention.launches == before     # CPU: no kernel launch


def test_k2_kernel_path_is_static_by_type_and_head_dim():
    """bf16 at D 64, 96 and 128 runs on the tensor cores, everything else
    on the scalar kernel (f32 would lose its 2e-5 tolerance in TF32)."""
    assert 96 in tk2.SUPPORTED_D
    for d in tk2.SUPPORTED_D:
        assert tk2.kernel_path(torch.float32, d) == "scalar"
        assert tk2.kernel_path(torch.bfloat16, d) == (
            "tensor_core" if d in (64, 96, 128) else "scalar")


def _transposed_v(b, hkv, s, d, dtype):
    """V as ``gqa_full`` makes it: (B, S, H, D) memory seen as (B, H, S,
    D)."""
    x = np.random.default_rng(8).standard_normal((b, s, hkv, d))
    return _t(x.astype(np.float32), dtype).transpose(1, 2)


def test_k2_wrapper_passes_a_transposed_v_as_it_lies():
    """The tensor-core kernel reads gqa_full's transposed V through its
    strides: the wrapper passes V's own pointer and strides, no copy. The
    scalar kernel takes contiguous inputs, so there V is copied."""
    q, k, _ = (_t(x, "bfloat16") for x in _qkv(9, 1, 12, 2, 77, 77, 128))
    v = _transposed_v(1, 2, 77, 128, "bfloat16")
    assert not v.is_contiguous()
    out = torch.empty_like(q)
    args, (_, _, v_in) = tk2._launch_args(q, k, v, out, True, 0.1, 77, 0)
    assert v_in is v and args[2] == v.data_ptr()
    assert args[15:18] == (q.numel(), 77 * 128, 128)            # q: packed
    assert args[21:24] == tuple(v.stride()[:3]) == (77 * 256, 128, 256)
    qf, kf, vf = q.float(), k.float(), v.float()
    args, (_, _, v_in) = tk2._launch_args(qf, kf, vf, out.float(), True,
                                          0.1, 77, 0)
    assert v_in.is_contiguous() and args[2] == v_in.data_ptr()
    assert args[21:24] == (2 * 77 * 128, 77 * 128, 128)


def test_k2_wrapper_passes_a_d96_transposed_v_as_it_lies():
    """At D 96 (phi-3-vision's MHA, 32 heads) a bf16 row is 192 bytes, a
    multiple of 16: gqa_full's transposed V goes to the tensor-core kernel
    as it lies, with its own strides."""
    q, k, _ = (_t(x, "bfloat16") for x in _qkv(13, 1, 32, 32, 45, 45, 96))
    v = _transposed_v(1, 32, 45, 96, "bfloat16")
    assert tk2.kernel_path(v.dtype, 96) == "tensor_core"
    assert tk2.kernel_takes(v, "tensor_core") and not v.is_contiguous()
    args, (q_in, k_in, v_in) = tk2._launch_args(q, k, v, torch.empty_like(q),
                                                True, 0.1, 45, 0)
    assert q_in is q and k_in is k and v_in is v and args[10] == 96
    assert args[21:24] == (45 * 32 * 96, 96, 32 * 96)


@pytest.mark.parametrize("layout", ["d_strided", "row_stride_130",
                                    "unaligned_base"])
def test_k2_wrapper_copies_what_the_kernel_cannot_read(layout):
    """Views the tensor-core kernel cannot read (D not unit-stride, a row
    stride that is not a multiple of 16 bytes, a base off 16 bytes) are
    made contiguous before the launch and passed with packed strides."""
    rng = np.random.default_rng(10)
    if layout == "d_strided":
        base = _t(rng.standard_normal((1, 2, 128, 128)).astype(np.float32),
                  "bfloat16")
        v = base.transpose(2, 3)
    elif layout == "row_stride_130":
        base = _t(rng.standard_normal((1, 2, 128, 130)).astype(np.float32),
                  "bfloat16")
        v = base[..., :128]
    else:
        flat = _t(rng.standard_normal(2 * 128 * 128 + 1).astype(np.float32),
                  "bfloat16")
        v = flat[1:].view(1, 2, 128, 128)
    assert not tk2.kernel_takes(v, "tensor_core")
    q, k, _ = (_t(x, "bfloat16") for x in _qkv(11, 1, 4, 2, 128, 128, 128))
    assert tk2.kernel_takes(k, "tensor_core")
    args, (_, k_in, v_in) = tk2._launch_args(q, k, v, torch.empty_like(q),
                                             True, 0.1, 128, 0)
    assert k_in is k and v_in is not v and v_in.is_contiguous()
    assert args[2] == v_in.data_ptr()
    assert args[21:24] == (2 * 128 * 128, 128 * 128, 128)
    assert torch.equal(v_in, v)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_transposed_v_equals_its_contiguous_copy(dtype):
    """The plain version (and so K2 on the CPU) gives the same result for
    a transposed V view and its contiguous copy."""
    q, k, _ = (_t(x, dtype) for x in _qkv(12, 2, 6, 2, 90, 90, 64))
    v = _transposed_v(2, 2, 90, 64, dtype)
    for fn in (tk2.flash_attention_plain, tk2.flash_attention):
        assert torch.equal(fn(q, k, v, causal=True),
                           fn(q, k, v.contiguous(), causal=True))


def test_k2_variants_follow_the_source():
    """launch/k2_variants.py builds its variants from the kernel source by
    text substitution: each substitution still finds its text, and the
    timed shapes include phi-3-vision's D 96."""
    from repro_torch.launch import k2_variants
    srcs = k2_variants.variant_sources()
    assert len(set(srcs.values())) == len(srcs) == 13
    assert "ex2.approx" in srcs["committed"]
    assert "  return true;\n" in srcs["ex2_approx"]
    assert "  return false;\n" in srcs["exp2f"]
    assert "wgmma_rs_n64_kmajor(s, qf[kk]" in srcs["q_in_registers"]
    ping = srcs["ping_pong"]
    assert ping.count("turn_wait();") == 3
    assert ping.count("turn_pass(false);") == 2
    assert ping.count("turn_pass(true);") == 1
    assert "bar.sync %0, 256" in ping and "bar.arrive %0, 256" in ping
    assert "constexpr int kStages = 4;" in srcs["stages_4"]
    assert {s[4] for s in k2_variants.SHAPES} == {64, 96, 128}
    assert (1, 32, 32, 1781, 96) in k2_variants.SHAPES
    assert 96 not in k2_variants.ONLY_D["q_in_registers"]
    assert "#pragma unroll 8" not in srcs["scalar_unroll_4"]
    assert "static constexpr int kLane = 4;" in srcs["scalar_lane_rows_4"]
    assert "static constexpr int kLane = 8;" in srcs["scalar_lane_rows_8"]
    assert "constexpr int kStreams = 1;" in srcs["scalar_one_stream"]
    assert "if (false) {" in srcs["scalar_no_pv"]
    assert "d < 0;" in srcs["scalar_no_qk"]
    assert "stage_rows<T, D>(vs" not in srcs["scalar_no_loads"]
    assert set(k2_variants.SCALAR) <= set(srcs)
    assert (1, 32, 32, 1000, 96) in k2_variants.F32_SHAPES


def test_k2_first_designs_are_present_and_registered():
    """K2's first designs (the tensor-core kernel with D 96 on zero
    columns, the scalar kernel of 256 threads) are kept as
    launch/variants/flash_attention_first.cu, registered in
    launch/kernel_variants.py under K2's entry point and argument list;
    the committed source holds the redesigns (64-byte swizzle and n96 at
    D 96, no padded columns; the scalar kernel of two key streams)."""
    import re
    from repro_torch.kernels import build
    from repro_torch.launch import kernel_variants
    assert kernel_variants.FIRST["flash_attention_first"] == \
        "k2_flash_attention"
    assert kernel_variants.ARGTYPES["flash_attention_first"] == tk2.ARGTYPES
    first = (kernel_variants._DIR / "flash_attention_first.cu").read_text()
    sig = re.search(r'extern "C" int k2_flash_attention\(([^)]*)\)', first)
    assert sig and len(sig.group(1).split(",")) == len(tk2.ARGTYPES)
    assert "padded<D>()" in first and "SWIZZLE_64B" not in first
    assert "constexpr int kThreads = 256;" in first
    new = (build.CSRC / "flash_attention.cu").read_text()
    assert "CU_TENSOR_MAP_SWIZZLE_64B" in new and "m64n96k16" in new
    assert "padded<" not in new and "constexpr int kStreams = 2;" in new


CUDA_CASES = [  # (b, hq, hkv, sq, sk, d, causal, dtype, sk_actual)
    (1, 12, 2, 1000, 1000, 128, True, "bfloat16", None),  # qwen2 heads
    (1, 12, 2, 1781, 1781, 128, True, "bfloat16", None),  # a served prompt
    (1, 12, 2, 1000, 1000, 128, True, "float32", None),
    (2, 4, 2, 64, 1088, 64, True, "float32", None),       # chunk
    (1, 4, 4, 200, 200, 32, False, "float32", None),      # non-causal
    (2, 8, 1, 77, 77, 16, True, "float32", None),
    (1, 4, 2, 40, 24, 64, True, "float32", None),         # empty rows
    (1, 4, 2, 130, 160, 128, True, "bfloat16", 150),      # key padding
    # the tensor-core kernel's branches (bf16, D 64 and 128)
    (1, 4, 2, 300, 300, 64, True, "bfloat16", None),      # D 64
    (1, 12, 2, 64, 1088, 128, True, "bfloat16", None),    # chunk
    (2, 4, 2, 64, 1088, 64, True, "bfloat16", None),      # chunk, D 64
    (1, 4, 4, 200, 333, 128, False, "bfloat16", None),    # non-causal
    (1, 4, 2, 200, 333, 64, False, "bfloat16", None),     # non-causal, D 64
    (1, 4, 2, 100, 200, 128, False, "bfloat16", 131),     # sk_actual % 64
    (1, 4, 2, 40, 24, 128, True, "bfloat16", None),       # empty rows
    (1, 4, 2, 40, 24, 64, True, "bfloat16", None),        # empty rows, D 64
    (1, 4, 2, 40, 24, 128, False, "bfloat16", 0),         # no key at all
    (2, 12, 2, 256, 256, 128, True, "bfloat16", None),    # B 2
    (1, 12, 2, 550, 550, 128, True, "bfloat16", None),    # shortest prompt
    (1, 8, 1, 77, 77, 16, True, "bfloat16", None),        # scalar bf16
    (1, 4, 2, 200, 200, 32, False, "bfloat16", None),     # scalar bf16
    # seamless-m4t-large-v2: the encoder (group 1, non-causal) and the
    # decoder (causal) at D 64
    (1, 16, 16, 512, 512, 64, False, "bfloat16", None),
    (1, 16, 16, 1024, 1024, 64, True, "bfloat16", None),
    # phi-3-vision-4.2b: D 96 on the tensor cores (tiles of three
    # 32-column sub-tiles in 64-byte swizzle, P·V at n96, no zero columns)
    # at its heads (MHA, 32) and the kernel's branches
    (1, 32, 32, 1781, 1781, 96, True, "bfloat16", None),
    (1, 4, 4, 300, 300, 96, False, "bfloat16", None),
    (2, 4, 2, 64, 1088, 96, True, "bfloat16", None),      # chunk, GQA
    (1, 4, 2, 40, 24, 96, True, "bfloat16", None),        # empty rows
    (1, 4, 2, 100, 200, 96, False, "bfloat16", 131),      # sk_actual % 64
    (1, 8, 2, 300, 300, 96, True, "bfloat16", None),      # group 4
    (1, 4, 2, 40, 24, 96, False, "bfloat16", 0),          # no key at all
    (1, 4, 2, 1, 1088, 96, True, "bfloat16", None),       # one query row
    (2, 8, 2, 256, 256, 96, True, "bfloat16", None),      # B 2
    # the scalar kernel in f32 at D 96 and 128: its branches (32-key
    # tiles, warps of 16 rows that skip tiles masked for all their rows)
    (1, 4, 4, 200, 200, 96, True, "float32", None),
    (1, 4, 2, 100, 200, 96, False, "float32", 131),       # sk_actual % 64
    (1, 4, 2, 100, 200, 128, False, "float32", 131),
    (2, 4, 2, 64, 1088, 96, True, "float32", None),       # chunk
    (1, 12, 2, 64, 1088, 128, True, "float32", None),
    (1, 4, 2, 40, 24, 96, True, "float32", None),         # empty rows
    (1, 4, 2, 40, 24, 128, True, "float32", None),
    (1, 4, 2, 40, 24, 96, False, "float32", 0),           # no key at all
    (1, 4, 2, 40, 24, 128, False, "float32", 0),
    (1, 4, 4, 300, 333, 96, False, "float32", None),      # non-causal
    (2, 4, 2, 200, 200, 96, True, "float32", None),       # B 2, group 2
    (2, 4, 2, 200, 200, 128, True, "float32", None),
]


def _card_check(got, want, dtype):
    assert got.dtype == want.dtype
    np.testing.assert_allclose(_np(got), _np(want), atol=TOL[dtype])
    if dtype == "bfloat16":
        # both accumulate in f32 (the tensor-core kernel's P·V is f32-exact
        # to 2^-18 through P_hi + P_lo): at most one rounding of the output
        # apart (one bf16 ulp, 2^-7 relative); rtol allows two
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-3,
                                   rtol=1.6e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,dtype,sk_actual",
                         CUDA_CASES)
def test_k2_cuda_kernel_matches_plain(b, hq, hkv, sq, sk, d, causal, dtype,
                                      sk_actual):
    """The hand-written kernel against its plain version, on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, v = (_t(x, dtype, "cuda") for x in _qkv(sq + d, b, hq, hkv, sq, sk,
                                                   d))
    before = tk2.flash_attention.launches
    got = tk2.flash_attention(q, k, v, causal=causal, sk_actual=sk_actual)
    torch.cuda.synchronize()
    assert tk2.flash_attention.launches == before + 1
    want = tk2.flash_attention_plain(q, k, v, causal=causal,
                                     sk_actual=sk_actual)
    _card_check(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 96, 128])
def test_k2_cuda_kernel_reads_a_transposed_v(d):
    """gqa_full's transposed V, read in place by the tensor-core kernel,
    gives its contiguous copy's result."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    q, k, _ = (_t(x, "bfloat16", "cuda")
               for x in _qkv(d, 1, 12, 2, 777, 777, d))
    v = _transposed_v(1, 2, 777, d, "bfloat16").cuda()
    assert tk2.kernel_takes(v, "tensor_core") and not v.is_contiguous()
    got = tk2.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    _card_check(got, tk2.flash_attention_plain(q, k, v, causal=True),
                "bfloat16")
    assert torch.equal(got, tk2.flash_attention(q, k, v.contiguous(),
                                                causal=True))
