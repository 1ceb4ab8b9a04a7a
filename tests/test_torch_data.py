"""The port's synthetic token pipeline ≡ the JAX package's, bit for bit:
tokens, labels and frontend embeds for several ``(step, host_id,
n_hosts)``; ``iterate`` walks the steps; the batch lands on the device
asked for (the card by default)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.data import DataConfig, batch_at, iterate  # noqa: E402

CFG = dict(vocab_size=512, seq_len=24, global_batch=8, seed=7)
FE_CFG = dict(CFG, frontend_tokens=5, d_model=16)


@pytest.fixture
def ref():
    pytest.importorskip("jax")
    from repro import data
    return data


@pytest.mark.parametrize("kw", [CFG, FE_CFG], ids=["tokens", "frontend"])
@pytest.mark.parametrize("step,host_id,n_hosts",
                         [(0, 0, 1), (3, 0, 1), (11, 1, 2), (5, 3, 4)])
def test_batch_at_is_bit_equal_to_the_reference(ref, kw, step, host_id,
                                                n_hosts):
    want = ref.batch_at(ref.DataConfig(**kw), step, host_id, n_hosts)
    got = batch_at(DataConfig(**kw), step, host_id, n_hosts, device="cpu")
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert np.array_equal(g, w), key
    assert got["tokens"].shape == (kw["global_batch"] // n_hosts,
                                   kw["seq_len"])


def test_iterate_walks_the_steps():
    cfg = DataConfig(**CFG)
    it = iterate(cfg, start_step=2, device="cpu")
    for step in (2, 3, 4):
        assert torch.equal(next(it)["tokens"],
                           batch_at(cfg, step, device="cpu")["tokens"])


def test_tokens_stay_in_the_vocab_and_skip_the_first_two_ids():
    b = batch_at(DataConfig(**CFG), 0, device="cpu")["tokens"]
    assert int(b.min()) >= 2 and int(b.max()) < CFG["vocab_size"]


def test_batch_at_defaults_to_cuda_and_raises_without_it():
    cfg = DataConfig(**CFG)
    if torch.cuda.is_available():
        assert batch_at(cfg, 0)["tokens"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch_at(cfg, 0)
