"""Tensor parallelism of the encoder-decoder and the SSM at full width on
the CPU: a few layers of seamless-m4t-large-v2 and mamba2-370m at their
published widths, on a (1, 2) ("data", "model") mesh of gloo ranks, ≡ the
JAX reference in f32.

The reduced configs of ``test_torch_sharded_train.py`` hold every TP path
at d_model 64; these hold the same paths at the widths the four-card
smoke trains (``chip_smoke.py`` phase 39): mamba2's 32 SSM heads of 64
with state 128, chunk 128 and a fused ``w_in`` of 4,384 columns, split
16 heads a rank; seamless's 16 heads of 64 and d_ff 8,192 in both stacks
and the cross-attention, 8 heads a rank. Two layers a stack (the stacked
leaves), remat "full", 2 sequences a step. Cut: the depth, and seamless's
vocab to 4,096 (the vocab-parallel lookup, head and cross-entropy are the
dense family's, held at their full vocab by phase 37). From the
reference's step-0 weights restored on the mesh: every leaf's gradient
on step 0's batch, made whole, ≡ ``jax.grad`` of the reference, and 3
steps' loss, grad_norm and lr ≡ the reference's jitted step, at the
module's atol 1e-5 + rtol 1e-4 (the reference's SSD in chunks of 32:
``REF_CHUNK``).

Run as a script (``PYTHONPATH=src:tests python
tests/test_torch_tp_full_width.py [f32|bf16 ...]``), the module prints
what phase 39's params check reads, on the CPU: each model on (1, 2) and
on (2, 1) (FSDP) against the one-device step from the same weights,
after 3 steps at lr 3e-4 in each dtype: the loss and grad_norm gaps, the
largest gap of a leaf's step-1 gradient norm, and how many elements lie
beyond 3·lr + 2^-8·|p|, with their first moments' signs.
"""

import dataclasses
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import rank_cases  # noqa: E402

ATOL, RTOL = 1e-5, 1e-4
# the published widths, two layers a stack (configs/mamba2_370m.py,
# configs/seamless_m4t_large_v2.py)
FULL = {
    "mamba2-370m": dict(n_layers=2, d_model=1024, ssm_state=128,
                        ssm_expand=2, ssm_head_dim=64, ssm_chunk=128,
                        vocab_size=50280, remat="full"),
    "seamless-m4t-large-v2": dict(n_layers=2, encoder_layers=2,
                                  d_model=1024, n_heads=16, n_kv_heads=16,
                                  d_head=64, d_ff=8192, vocab_size=4096,
                                  frontend_tokens=64, remat="full"),
}
# two chunks of 128 for the SSM; 64 tokens and frames for seamless
SEQ = {"mamba2-370m": 256, "seamless-m4t-large-v2": 64}
# the reference's SSD chunk: at 128 its gradient is NaN (its intra-chunk
# decay takes exp before the mask, models/ssm.py), so it runs the same
# scan in chunks of 32, where its gradient is finite; the chunking is
# exact, so the port's TP run keeps the config's 128
REF_CHUNK = {"mamba2-370m": dict(ssm_chunk=32)}
BATCH, STEPS = 2, 3
OPT = dict(lr=3e-4, warmup_steps=2, total_steps=5)


def _data(cfg, arch):
    return dict(vocab_size=cfg.vocab_size, seq_len=SEQ[arch],
                global_batch=BATCH, seed=1234,
                frontend_tokens=cfg.frontend_tokens, d_model=cfg.d_model)


def _flat_np(tree, path=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat_np(tree[k], path + (k,)))
        return out
    return {"/".join(path): np.asarray(tree, np.float32)}


@pytest.fixture(scope="module", autouse=True)
def _single_thread():
    """One torch thread for the module (as every rank runs)."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Per config: the directory of the reference's step-0 checkpoint
    ``{"params", "opt"}``, the gradient of every leaf on step 0's batch
    and the metrics of 3 jitted steps."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import ARCHS
    from repro.data import DataConfig, batch_at
    from repro.models import build_model, reduced_config
    from repro.train import AdamWConfig, checkpoint, make_train_step
    from repro.train import optimizer
    d = tmp_path_factory.mktemp("full_ref")
    jc = AdamWConfig(**OPT)
    out = {}
    for arch, widths in FULL.items():
        jm = build_model(dataclasses.replace(
            reduced_config(ARCHS[arch]),
            **dict(widths, **REF_CHUNK.get(arch, {}))))
        jp = jm.init_params(jax.random.PRNGKey(0))
        ck = d / arch
        checkpoint.save(str(ck), 0, {"params": jp,
                                     "opt": optimizer.init_state(jc, jp)})
        dcfg = DataConfig(**_data(jm.cfg, arch))
        grads = jax.grad(lambda p: jm.train_loss(p, batch_at(dcfg, 0))[0])(
            jp)
        step = jax.jit(make_train_step(jm, jc))
        p, st, mets = jp, optimizer.init_state(jc, jp), []
        for i in range(STEPS):
            p, st, m = step(p, st, batch_at(dcfg, i))
            mets.append({k: float(m[k]) for k in ("loss", "grad_norm", "lr")})
        out[arch] = dict(dir=str(ck), metrics=mets,
                         grads=_flat_np(jax.tree.map(np.asarray, grads)))
        del jp, p, st, grads
    return out


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Rank 0's record of each config's 3 steps on a (1, 2) mesh from the
    reference's weights, and the directory of its step-0 gradients."""
    d = tmp_path_factory.mktemp("full_tp")
    cases = [dict(name=arch, arch=arch, mesh=(1, 2), steps=STEPS,
                  batch=BATCH, seq=SEQ[arch], opt=OPT, init=ref[arch]["dir"],
                  cfg={k: v for k, v in FULL[arch].items() if k != "remat"},
                  remat=FULL[arch]["remat"], grads=True)
             for arch in FULL]
    recs = rank_cases.launch_train(cases, 2, d)
    return {r["name"]: r for r in recs}, d


@pytest.mark.parametrize("arch", list(FULL))
def test_full_width_tp_gradients_match_reference(runs, ref, arch):
    """Every leaf's gradient on a (1, 2) mesh at full width, made whole,
    ≡ ``jax.grad`` of the reference: mamba2's ``w_in`` (each rank's 16
    heads' z, x and dt columns, B and C's summed over the ranks), conv,
    ``a_log``, ``dt_bias``, ``d_skip``, ``out_norm`` and ``w_out``;
    seamless's two stacks, its cross-attention and its vocab-parallel
    lookup and head."""
    _, d = runs
    with np.load(d / f"{arch}_grads.npz") as z:
        got = {k: z[k] for k in z.files}
    want = ref[arch]["grads"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=RTOL,
                                   err_msg=k)


@pytest.mark.parametrize("arch", list(FULL))
def test_full_width_tp_steps_match_reference(runs, ref, arch):
    """Three steps on a (1, 2) mesh at full width: loss, grad_norm and lr
    ≡ the reference's jitted step."""
    recs, _ = runs
    for i, (g, w) in enumerate(zip(recs[arch]["metrics"],
                                   ref[arch]["metrics"])):
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(g[k], w[k], atol=ATOL, rtol=RTOL,
                                       err_msg=f"{arch} step {i + 1} {k}")
    assert len(recs[arch]["metrics"]) == STEPS


# ---------------------------------------------------------------------------
# The readings (run as a script)
# ---------------------------------------------------------------------------

def _saved(ckpt_dir):
    from repro_torch.train import checkpoint
    man = checkpoint.load_manifest(ckpt_dir, STEPS)["leaves"]
    out = {}
    with np.load(Path(ckpt_dir) / f"step_{STEPS:09d}" / "arrays.npz") as z:
        for k in z.files:
            v = z[k]
            if man[k]["dtype"] == "bfloat16":
                v = (v.astype(np.uint32) << 16).view(np.float32)
            out[k] = v
    return out


def _readings(arch: str, dtype: str, out: Path) -> None:
    """Print one config's pairs in one dtype (see the module docstring)."""
    cfg = dict({k: v for k, v in FULL[arch].items() if k != "remat"},
               param_dtype=dtype, activation_dtype=dtype)
    plans = {1: [("one", (1, 1))], 2: [("tp", (1, 2)), ("fsdp", (2, 1))]}
    recs = {}
    for world, runs in plans.items():
        cases = [dict(name=name, arch=arch, mesh=mesh, steps=STEPS,
                      batch=BATCH, seq=SEQ[arch], opt=OPT, cfg=cfg,
                      remat="full", grads=True, save=str(out / name))
                 for name, mesh in runs]
        for r in rank_cases.launch_train(cases, world, out / f"w{world}"):
            recs[r["name"]] = r
    lr = OPT["lr"]
    one = _saved(out / "one")
    with np.load(out / "w1" / "one_grads.npz") as z:
        g_one = {k: float(np.linalg.norm(z[k].astype(np.float64)))
                 for k in z.files}
    for name, mesh in plans[2]:
        rel = max(abs(g[k] - w[k]) / abs(w[k])
                  for g, w in zip(recs[name]["metrics"],
                                  recs["one"]["metrics"])
                  for k in ("loss", "grad_norm"))
        with np.load(out / "w2" / f"{name}_grads.npz") as z:
            norms = {k: float(np.linalg.norm(z[k].astype(np.float64)))
                     for k in z.files}
        leaf_gap = max((abs(norms[k] - g_one[k]) / g_one[k], k)
                       for k in g_one if g_one[k])
        got = _saved(out / name)
        over = opposite = n = 0
        worst = (0.0, "")
        for k, w in one.items():
            if not k.startswith("params/"):
                continue
            ratio = np.abs(got[k] - w) / (3 * lr + 2.0 ** -8 * np.abs(w))
            beyond = ratio > 1
            mu = k.replace("params/", "opt/mu/")
            opposite += int((beyond & (one[mu] * got[mu] < 0)).sum())
            over += int(beyond.sum())
            n += ratio.size
            worst = max(worst, (float(ratio.max()), k))
        print(f"{arch} {dtype} {mesh} against one device, {STEPS} steps: "
              f"loss and grad_norm within rel {rel:.3g}; step-1 gradient "
              f"norm by leaf within rel {leaf_gap[0]:.3g} ({leaf_gap[1]}); "
              f"{over} of {n:,} elements beyond 3·lr + 2^-8·|p| ({opposite} "
              f"with first moments of opposite sign), largest ratio "
              f"{worst[0]:.4g} ({worst[1]})", flush=True)


def main(dtypes) -> None:
    torch.set_num_threads(1)
    for arch in FULL:
        for dtype in dtypes:
            out = Path(tempfile.mkdtemp(prefix="tp_full_width_"))
            try:
                _readings(arch, dtype, out)
            finally:
                shutil.rmtree(out, ignore_errors=True)


if __name__ == "__main__":
    main([{"f32": "float32", "bf16": "bfloat16"}[a]
          for a in (sys.argv[1:] or ["f32", "bf16"])])
