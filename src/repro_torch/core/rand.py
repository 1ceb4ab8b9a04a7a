"""Capacity-stable per-row random draws and the engine's step keys
(port of ``repro.core.rand`` plus the ``jax.random`` calls the engines
make: ``PRNGKey(seed)``, ``split(key, n)`` and the distributed engine's
``fold_in(key, shard)``).

Keys are int64 tensors holding uint32 values: ``(2,)`` for one key, ``(n, 2)``
for ``n`` keys. An ensemble's lanes carry one key each, ``(L, 2)``: every
function here takes such a key too and gives lane ``l`` exactly the bits its
solo draw with ``key[l]`` gives. Threefry works element by element, so that
is one broadcast, not a loop over lanes. All uint32 arithmetic runs in
int64, masked to 32 bits after every add and rotate; values stay
non-negative, so ``>>`` is a logical shift. The bits equal the
reference's exactly (tests/test_torch_rand.py).
"""

from __future__ import annotations

import math

import torch

from ..device import DeviceLike, resolve_device

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor,
                 x0: torch.Tensor, x1: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One threefry-2x32 block (20 rounds) per lane: counters (x0, x1) → two
    uint32 streams, as int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: int, device: DeviceLike = None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (threefry): the key ``[0, seed]``, with a
    negative int32 seed taken modulo 2**32 as jax does. ``device=None``
    means the CUDA card and raises without one."""
    if not -2 ** 31 <= seed < 2 ** 31:
        raise ValueError(f"seed must fit int32, got {seed}")
    return torch.tensor([0, seed & _M32], dtype=torch.int64,
                        device=resolve_device(device))


def split(key: torch.Tensor, n: int, partitionable: bool = True
          ) -> torch.Tensor:
    """``jax.random.split(key, n)`` → (n, 2) keys, bit-exact; lane keys
    (L, 2) give (n, L, 2), ``[i, l]`` the ``i``-th key of lane ``l``.

    ``partitionable`` follows jax's ``jax_threefry_partitionable`` flag (on
    by default since jax 0.5): counters ``(0, i)`` give row ``i``. With the
    flag off (jax 0.4.x) the counters are ``arange(2n)`` cut in halves and
    the two output streams are concatenated before the reshape.
    """
    dev = key.device
    if key.dim() == 2:                       # lanes: (L, 1) keys × counters
        k0, k1 = key[:, :1], key[:, 1:]
    else:
        k0, k1 = key[0], key[1]
    if partitionable:
        b0, b1 = threefry2x32(k0, k1, torch.zeros(n, dtype=torch.int64,
                                                  device=dev),
                              torch.arange(n, dtype=torch.int64, device=dev))
        if key.dim() == 2:
            return torch.stack([b0.T, b1.T], dim=2)
        return torch.stack([b0, b1], dim=1)
    c = torch.arange(2 * n, dtype=torch.int64, device=dev)
    b0, b1 = threefry2x32(k0, k1, c[:n], c[n:])
    if key.dim() == 2:
        return torch.cat([b0, b1], 1).reshape(-1, n, 2).transpose(0, 1)
    return torch.cat([b0, b1]).reshape(n, 2)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` (threefry), bit-exact: the key
    (k0, k1) hashed over the counters (0, data). ``data`` is a uint32 value
    or an int tensor of them, (n,) data giving (n, 2) keys."""
    d = torch.as_tensor(data, dtype=torch.int64).to(key.device) & _M32
    b0, b1 = threefry2x32(key[0], key[1], torch.zeros_like(d), d)
    return torch.stack([b0, b1], dim=-1)


def _row_col_bits(key: torch.Tensor, rows: int, cols: int
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """(rows, cols) pairs of uint32 streams, element = f(key, row, col).
    Lane keys (L, 2) split ``rows`` into L lanes of ``rows // L``, each
    drawn with its own key and row counters from 0."""
    dev = key.device
    if key.dim() == 2:
        n_lanes = key.shape[0]
        if rows % n_lanes:
            raise ValueError(f"{rows} rows do not split into {n_lanes} "
                             f"lanes")
        per = rows // n_lanes
        r = torch.arange(per, dtype=torch.int64, device=dev)[None, :, None]
        c = torch.arange(cols, dtype=torch.int64, device=dev)[None, None, :]
        b0, b1 = threefry2x32(key[:, 0, None, None], key[:, 1, None, None],
                              r.expand(n_lanes, per, cols),
                              c.expand(n_lanes, per, cols))
        return b0.reshape(rows, cols), b1.reshape(rows, cols)
    r = torch.arange(rows, dtype=torch.int64, device=dev)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=dev)[None, :]
    return threefry2x32(key[0], key[1], r.expand(rows, cols),
                        c.expand(rows, cols))


def _to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 → float32 in [0, 1) with 24 bits of mantissa entropy (exact)."""
    return (bits >> 8).to(torch.float32) * (2.0 ** -24)


def uniform_rows(key: torch.Tensor, rows: int, cols: int | None = None
                 ) -> torch.Tensor:
    """Uniform [0, 1) draws of shape (rows,) or (rows, cols); the value at
    ``[i, j]`` depends only on ``(key, i, j)``."""
    b0, _ = _row_col_bits(key, rows, 1 if cols is None else cols)
    u = _to_unit(b0)
    return u[:, 0] if cols is None else u


# float32(2π), the constant the reference multiplies by
_TWO_PI_F32 = float(torch.tensor(2.0 * math.pi, dtype=torch.float32))


def normal_rows(key: torch.Tensor, rows: int, cols: int | None = None
                ) -> torch.Tensor:
    """Standard-normal draws (Box–Muller over the two streams of one block
    per element), capacity-stable. ``log``/``cos`` may differ from XLA's by
    an ulp, so these match the reference to ~1e-6, not bit for bit."""
    b0, b1 = _row_col_bits(key, rows, 1 if cols is None else cols)
    u1 = 1.0 - _to_unit(b0)                           # (0, 1]
    u2 = _to_unit(b1)
    z = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(_TWO_PI_F32 * u2)
    return z[:, 0] if cols is None else z
