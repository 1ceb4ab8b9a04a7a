"""The port's ``launch/cells.py`` ≡ the device-independent part of the JAX
package's ``repro.launch.cells``.

For every config of ``ARCHS`` at ``TRAIN_4K``, ``PREFILL_32K`` and
``DECODE_32K``: ``analytic_step_flops`` equal, ``_count_active_params``
equal (on the full configs' registries: no allocation), and the
microbatch counts equal; ``MICROBATCHES`` equal as a table.
"""

import types

import pytest

pytest.importorskip("torch")

from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.configs import DECODE_32K, PREFILL_32K, TRAIN_4K  # noqa: E402
from repro_torch.launch import cells as tcells  # noqa: E402
from repro_torch.models import build_model as tbuild  # noqa: E402

SHAPES = (TRAIN_4K, PREFILL_32K, DECODE_32K)


@pytest.fixture(scope="module")
def jx():
    pytest.importorskip("jax")
    from repro.configs import ARCHS
    from repro.configs import DECODE_32K as J_DECODE
    from repro.configs import PREFILL_32K as J_PREFILL
    from repro.configs import TRAIN_4K as J_TRAIN
    from repro.launch import cells
    from repro.models import build_model
    return types.SimpleNamespace(ARCHS=ARCHS, cells=cells,
                                 build_model=build_model,
                                 shapes=(J_TRAIN, J_PREFILL, J_DECODE))


def test_microbatch_table_equals_the_reference(jx):
    assert tcells.MICROBATCHES == jx.cells.MICROBATCHES


@pytest.mark.parametrize("arch", sorted(TARCHS))
def test_flops_active_params_and_microbatches_equal_the_reference(jx, arch):
    tcfg, jcfg = TARCHS[arch], jx.ARCHS[arch]
    for tshape, jshape in zip(SHAPES, jx.shapes):
        assert tshape.name == jshape.name
        want = jx.cells.analytic_step_flops(jcfg, jshape)
        got = tcells.analytic_step_flops(tcfg, tshape)
        assert got == want > 0, (arch, tshape.name)
        assert tcells.microbatches(arch, tshape.name) == \
            jx.cells.microbatches(arch, jshape.name)
    got = tcells._count_active_params(tbuild(tcfg, device="cpu"), tcfg)
    want = jx.cells._count_active_params(jx.build_model(jcfg), jcfg)
    assert got == want > 0, arch
    if tcfg.n_experts:
        assert got < tbuild(tcfg, device="cpu").n_params()
