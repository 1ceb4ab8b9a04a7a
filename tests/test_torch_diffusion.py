"""Port diffusion grid: the reference's own checks (mass conservation,
decay, sources, sampling, gradient) and parity with the jitted reference
at a voxel of 1.5, where dividing by the voxel and multiplying by its
float32 reciprocal floor differently."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import diffusion as JD  # noqa: E402
from repro_torch.core import diffusion as TD  # noqa: E402

ORIGIN = np.array([0.3, -1.0, 0.5], np.float32)
DIMS = (9, 7, 8)


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _specs(**kw):
    kw = {"dims": DIMS, "coefficient": 0.3, "decay": 0.02, "voxel": 1.5,
          **kw}
    return JD.DiffusionSpec(**kw), TD.DiffusionSpec(**kw)


def test_mass_conservation_neumann():
    _, spec = _specs(dims=(12, 12, 12), coefficient=0.2, decay=0.0,
                     voxel=1.0)
    c = torch.zeros(spec.dims)
    c[6, 6, 6] = 100.0
    dt = TD.stable_dt(spec)
    for _ in range(50):
        c = TD.step(spec, c, dt)
    np.testing.assert_allclose(float(c.sum()), 100.0, rtol=1e-5)
    assert float(c.max()) < 100.0
    assert float(c.min()) >= -1e-9


def test_decay():
    _, spec = _specs(dims=(8, 8, 8), coefficient=0.0, decay=0.1, voxel=1.0)
    c = TD.step(spec, torch.full(spec.dims, 1.0), 1.0)
    np.testing.assert_allclose(c.numpy(), 0.9, rtol=1e-6)


def test_sources_and_sample():
    _, spec = _specs(dims=(8, 8, 8), voxel=1.0)
    pos = torch.tensor([[3.5, 3.5, 3.5], [3.6, 3.4, 3.5]])
    c = TD.add_sources(spec, torch.zeros(spec.dims), pos,
                       torch.tensor([2.0, 3.0]), torch.zeros(3))
    assert float(c[3, 3, 3]) == 5.0 and float(c.sum()) == 5.0
    np.testing.assert_allclose(TD.sample(spec, c, pos, torch.zeros(3)
                                         ).numpy(), [5.0, 5.0])


def test_gradient_points_uphill():
    _, spec = _specs(dims=(16, 8, 8), voxel=1.0)
    c = torch.arange(16, dtype=torch.float32)[:, None, None].expand(
        spec.dims).contiguous()
    g = TD.gradient(spec, c, torch.tensor([[8.0, 4.0, 4.0]]), torch.zeros(3))
    np.testing.assert_allclose(g[0].numpy(), [1.0, 0.0, 0.0], atol=1e-6)


def _edge_positions():
    """Positions one to four ulps below origin + k·voxel along each axis:
    there floor(p / 1.5) and floor(p · float32(1/1.5)) part ways."""
    rows = []
    for axis in range(3):
        for k in range(DIMS[axis] + 1):
            x = np.float32(ORIGIN[axis] + k * 1.5)
            for _ in range(4):
                x = np.nextafter(x, np.float32(-100))
                p = ORIGIN + 1.0
                p[axis] = x
                rows.append(p.copy())
    return np.asarray(rows, np.float32)


def test_voxel_of_matches_jitted_reference():
    jspec, tspec = _specs()
    rng = np.random.default_rng(0)
    pos = np.concatenate([_edge_positions(),
                          rng.uniform(-2, 15, (4000, 3)).astype(np.float32)])
    want = np.asarray(jax.jit(lambda p: JD.voxel_of(
        jspec, p, jnp.asarray(ORIGIN)))(pos))
    got = TD.voxel_of(tspec, torch.from_numpy(pos), torch.from_numpy(ORIGIN))
    np.testing.assert_array_equal(got.numpy(), want)
    eager = np.asarray(JD.voxel_of(jspec, jnp.asarray(pos),
                                   jnp.asarray(ORIGIN)))
    assert (eager != want).any(), "the edge positions must tell them apart"


def test_step_gradient_sources_match_jitted_reference():
    jspec, tspec = _specs()
    rng = np.random.default_rng(1)
    c = rng.uniform(0, 5, DIMS).astype(np.float32)
    pos = np.concatenate([_edge_positions(),
                          rng.uniform(-1, 14, (3000, 3)).astype(np.float32)])
    amount = rng.uniform(0, 1, len(pos)).astype(np.float32)
    og = jnp.asarray(ORIGIN)
    tc, tp, to = (torch.from_numpy(x) for x in (c, pos, ORIGIN))
    want = np.asarray(jax.jit(lambda c: JD.step(jspec, c, 0.4))(c))
    got = TD.step(tspec, tc, 0.4).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * want.max())
    want = np.asarray(jax.jit(lambda c, p: JD.gradient(jspec, c, p, og))(
        c, pos))
    np.testing.assert_array_equal(TD.gradient(tspec, tc, tp, to).numpy(),
                                  want)
    want = np.asarray(jax.jit(lambda c, p, a: JD.add_sources(
        jspec, c, p, a, og))(c, pos, amount))
    np.testing.assert_array_equal(
        TD.add_sources(tspec, tc, tp, torch.from_numpy(amount), to).numpy(),
        want)
    want = np.asarray(jax.jit(lambda c, p: JD.sample(jspec, c, p, og))(
        c, pos))
    np.testing.assert_array_equal(TD.sample(tspec, tc, tp, to).numpy(), want)


def test_step_slab_with_external_halos_matches_reference():
    jspec, tspec = _specs()
    rng = np.random.default_rng(2)
    c, lo, hi = (rng.uniform(0, 3, s).astype(np.float32)
                 for s in (DIMS, DIMS[1:], DIMS[1:]))
    want = np.asarray(jax.jit(lambda c, lo, hi: JD.step_slab(
        jspec, c, 0.25, lo, hi))(c, lo, hi))
    got = TD.step_slab(tspec, torch.from_numpy(c), 0.25,
                       torch.from_numpy(lo), torch.from_numpy(hi))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * want.max())
    assert TD.stable_dt(tspec) == JD.stable_dt(jspec)


def test_diffusion_ops_route_to_the_functions():
    _, spec = _specs()
    ops = TD.DiffusionOps(spec, torch.from_numpy(ORIGIN))
    c = torch.rand(DIMS, generator=torch.Generator().manual_seed(0))
    p = torch.tensor([[1.0, 2.0, 3.0], [5.0, 1.0, 4.0]])
    assert torch.equal(ops.step(c, 0.1), TD.step(spec, c, 0.1))
    assert torch.equal(ops.sample(c, p), TD.sample(spec, c, p, ops.origin))
    assert torch.equal(ops.gradient(c, p),
                       TD.gradient(spec, c, p, ops.origin))
    assert torch.equal(ops.add_sources(c, p, torch.ones(2)),
                       TD.add_sources(spec, c, p, torch.ones(2), ops.origin))
