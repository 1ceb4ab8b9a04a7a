"""Port RNG ≡ reference RNG: threefry bits, row draws and the engine's keys."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import rand as jrand  # noqa: E402
from repro_torch.core import rand as trand  # noqa: E402


@pytest.fixture(autouse=True)
def _single_thread():
    """torch's multi-threaded CPU kernels were seen to return a whole
    worker's chunk of float32 sqrt results off by ~3e-4 (relative) on some
    hosts; one thread keeps the parity tests deterministic."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _key(seed):
    return jax.random.PRNGKey(seed), trand.prng_key(seed, "cpu")


def test_threefry2x32_bits_exact(rng):
    k = rng.integers(0, 2 ** 32, 2, dtype=np.uint64).astype(np.uint32)
    x = rng.integers(0, 2 ** 32, (2, 4096), dtype=np.uint64).astype(np.uint32)
    j0, j1 = jrand.threefry2x32(jnp.uint32(k[0]), jnp.uint32(k[1]),
                                jnp.asarray(x[0]), jnp.asarray(x[1]))
    t = [torch.tensor(np.asarray(a, np.int64)) for a in (k[0], k[1], *x)]
    t0, t1 = trand.threefry2x32(*t)
    np.testing.assert_array_equal(t0.numpy(), np.asarray(j0).astype(np.int64))
    np.testing.assert_array_equal(t1.numpy(), np.asarray(j1).astype(np.int64))


@pytest.mark.parametrize("seed,rows,cols", [(0, 257, None), (7, 100, 3),
                                            (123456, 33, 5)])
def test_uniform_rows_bits_exact(seed, rows, cols):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(
        trand.uniform_rows(tk, rows, cols).numpy(),
        np.asarray(jrand.uniform_rows(jk, rows, cols)))


@pytest.mark.parametrize("seed,rows,cols", [(0, 1000, 3), (11, 513, None)])
def test_normal_rows_close(seed, rows, cols):
    """log/cos may differ by an ulp between XLA and torch: 1e-6 abs."""
    jk, tk = _key(seed)
    got = trand.normal_rows(tk, rows, cols)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jrand.normal_rows(jk, rows, cols)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 7, 2 ** 31 - 1, -1])
def test_prng_key_matches_jax(seed):
    jk, tk = _key(seed)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk).astype(np.int64))


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("seed,n", [(7, 3), (0, 1), (42, 5)])
def test_split_matches_jax(partitionable, seed, n):
    prev = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        want = np.asarray(jax.random.split(jax.random.PRNGKey(seed), n))
    finally:
        jax.config.update("jax_threefry_partitionable", prev)
    got = trand.split(trand.prng_key(seed, "cpu"), n,
                      partitionable=partitionable)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
