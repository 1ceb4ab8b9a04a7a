"""Port Morton and linear keys ≡ the reference's, bit for bit.

The port holds uint32 codes in int64 tensors with explicit 32-bit masks;
every function must return the reference's values exactly: the
exhaustive small cube and a hypothesis property, as tests/test_morton.py
covers them, and the box-boundary rounding of ``cell_of`` (a float box
size multiplies by its float32 reciprocal as the reference's jitted
program does, a tensor box size divides as its eager and traced calls
do).
"""

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import morton as jm  # noqa: E402
from repro_torch.core import morton as tm  # noqa: E402


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(
        np.int64))


def test_encode_decode_3d_exhaustive_small_cube():
    g = np.arange(16, dtype=np.uint32)
    x, y, z = (a.ravel() for a in np.meshgrid(g, g, g, indexing="ij"))
    want = jm.encode3(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z))
    got = tm.encode3(torch.from_numpy(x.astype(np.int64)),
                     torch.from_numpy(y.astype(np.int64)),
                     torch.from_numpy(z.astype(np.int64)))
    _eq(got, want)
    for d_t, d_j, a in zip(tm.decode3(got), jm.decode3(want), (x, y, z)):
        _eq(d_t, d_j)
        np.testing.assert_array_equal(d_t.numpy(), a)
    assert len(np.unique(got.numpy())) == got.shape[0]


@settings(max_examples=50, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 1023), st.integers(0, 1023),
                          st.integers(0, 1023)), min_size=1, max_size=64))
def test_encode_decode_3d_property(coords):
    a = np.asarray(coords, dtype=np.uint32)
    want = jm.encode3(*(jnp.asarray(a[:, i]) for i in range(3)))
    got = tm.encode3(*(torch.from_numpy(a[:, i].astype(np.int64))
                       for i in range(3)))
    _eq(got, want)
    for d_t, d_j in zip(tm.decode3(got), jm.decode3(want)):
        _eq(d_t, d_j)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.tuples(st.integers(0, 65535), st.integers(0, 65535)),
                min_size=1, max_size=32))
def test_encode_decode_2d_property(coords):
    a = np.asarray(coords, dtype=np.uint32)
    want = jm.encode2(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]))
    got = tm.encode2(torch.from_numpy(a[:, 0].astype(np.int64)),
                     torch.from_numpy(a[:, 1].astype(np.int64)))
    _eq(got, want)
    for d_t, d_j in zip(tm.decode2(got), jm.decode2(want)):
        _eq(d_t, d_j)


@pytest.mark.parametrize("fn", ["part1by2", "compact1by2", "part1by1",
                                "compact1by1"])
def test_bit_spreads_on_full_uint32_words(fn):
    """Inputs wider than the spread's bits are masked as the reference
    masks them."""
    words = np.random.default_rng(7).integers(0, 2 ** 32, 4096,
                                              dtype=np.uint64)
    words = np.concatenate([words, [0, 2 ** 32 - 1, 0x3FF, 0xFFFF]]
                           ).astype(np.uint32)
    _eq(getattr(tm, fn)(torch.from_numpy(words.astype(np.int64))),
        getattr(jm, fn)(jnp.asarray(words)))


@pytest.mark.parametrize("dims", [(8, 8, 8), (20, 8, 4), (107, 107, 107)])
def test_morton_and_linear_keys_match(dims):
    rng = np.random.default_rng(3)
    box = 4.0
    pos = rng.uniform(-2, np.asarray(dims) * box + 2, (500, 3)
                      ).astype(np.float32)
    origin = np.zeros(3, np.float32)
    # jitted with a constant box (the engine's rounding) ...
    want = jax.jit(lambda p: jm.morton_keys(p, jnp.asarray(origin), box,
                                            dims))(jnp.asarray(pos))
    got = tm.morton_keys(torch.from_numpy(pos), torch.from_numpy(origin),
                         box, dims)
    _eq(got, want)
    # ... and eager with an array box (a division)
    want = jm.morton_keys(jnp.asarray(pos), jnp.asarray(origin),
                          jnp.float32(box), dims)
    got = tm.morton_keys(torch.from_numpy(pos), torch.from_numpy(origin),
                         torch.tensor(box), dims)
    _eq(got, want)
    lin = tm.linear_keys(torch.from_numpy(pos), torch.from_numpy(origin),
                         box, dims)
    for d_t, d_j in zip(tm.linear_decode3(lin, dims),
                        jm.linear_decode3(jnp.asarray(lin.numpy().astype(
                            np.uint32)), dims)):
        _eq(d_t, d_j)


def test_code_space_size_matches():
    for dims in [(8, 8, 8), (9, 3, 3), (107, 107, 107), (1, 1, 1),
                 (1024, 2, 2)]:
        assert tm.code_space_size(dims) == jm.code_space_size(dims)
    with pytest.raises(ValueError):
        tm.code_space_size((1025, 1, 1))


def test_cell_of_box_boundary_follows_the_reference():
    """72.0 lies on a multiple of the 4.8 box: the reference's division
    floors to 14, its jitted multiply by float32(1/4.8) to 15. A float box
    size is the jit constant, a tensor the traced value."""
    pos = np.asarray([[72.0, 9.6, 4.8 * 7]], np.float32)
    origin = np.zeros(3, np.float32)
    dims = (20, 20, 20)
    traced = jax.jit(lambda p, b: jm.cell_of(p, jnp.asarray(origin), b,
                                             dims))(jnp.asarray(pos),
                                                    jnp.float32(4.8))
    const = jax.jit(lambda p: jm.cell_of(p, jnp.asarray(origin), 4.8,
                                         dims))(jnp.asarray(pos))
    assert int(traced[0, 0]) == 14 and int(const[0, 0]) == 15
    t_div = tm.cell_of(torch.from_numpy(pos), torch.from_numpy(origin),
                       torch.tensor(4.8), dims)
    t_mul = tm.cell_of(torch.from_numpy(pos), torch.from_numpy(origin), 4.8,
                       dims)
    np.testing.assert_array_equal(t_div.numpy(), np.asarray(traced))
    np.testing.assert_array_equal(t_mul.numpy(), np.asarray(const))
