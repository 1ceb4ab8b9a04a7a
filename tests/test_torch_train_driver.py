"""The port's train driver and ``train_lm`` example.

* ``launch/train.run`` trains the reduced deepseek-v2-lite (2
  microbatches), mamba2 and jamba with finite losses that fall;
* ``launch/train.run`` on the CPU: a run resumed from its step-3
  checkpoint (what a kill after that save leaves on disk) ends bit for
  bit where the uninterrupted run ends — weights, moments, step and the
  logged losses;
* a checkpoint written by the reference's ``run`` continues in the port:
  the losses it logs are within rtol 1e-4 of the reference's own
  continuation, the final weights within the rounding bound below;
* ``train_lm``'s presets equal the reference example's field for field
  (loaded from ``examples/`` by path); its ``main`` trains on the CPU and
  prints ``OK``, for the qwen2 smoke preset and the port's encoder-decoder
  one.
"""

import dataclasses
import importlib.util
import re
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS as TARCHS  # noqa: E402
from repro_torch.examples import train_lm as ttrain_lm  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import reduced_config as treduced  # noqa: E402
from repro_torch.train import checkpoint as tckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
JOB = dict(steps=6, seq_len=16, global_batch=2, lr=1e-2, warmup=2,
           ckpt_every=3, log_every=1, seed=0)


@pytest.fixture(autouse=True)
def _single_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _job(arch, ckpt_dir, **kw):
    return ttrain.TrainJob(arch=arch, ckpt_dir=str(ckpt_dir), **{**JOB, **kw})


def _arrays(ckpt_dir, step):
    with np.load(Path(ckpt_dir) / f"step_{step:09d}" / "arrays.npz") as z:
        return {k: z[k] for k in z.files}


def _losses(lines):
    """{step: loss} of the log lines of `launch/train.run`."""
    out = {}
    for line in lines:
        m = re.match(r"\[train\] step (\d+)/\d+ loss=(\S+)", line)
        if m:
            out[int(m.group(1))] = float(m.group(2))
    return out


def test_resumed_run_is_bit_equal_to_the_uninterrupted_one(tmp_path):
    arch = treduced(TARCHS["qwen2-1.5b"])
    full, logs = tmp_path / "full", []
    out = ttrain.run(_job(arch, full), device="cpu", log=logs.append)
    assert out["final_loss"] < out["first_loss"]
    assert tckpt.list_steps(str(full)) == [3, 6]
    # a run killed after its step-3 save leaves that checkpoint only
    resumed, logs2 = tmp_path / "resumed", []
    (resumed).mkdir()
    shutil.copytree(full / "step_000000003", resumed / "step_000000003")
    ttrain.run(_job(arch, resumed), device="cpu", log=logs2.append)
    assert logs2[0] == "[train] resuming from checkpoint step 3"
    want, got = _arrays(full, 6), _arrays(resumed, 6)
    assert set(got) == set(want) and "opt/step" in got
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    l1, l2 = _losses(logs), _losses(logs2)
    assert sorted(l2) == [4, 5, 6]
    assert all(l2[s] == l1[s] for s in l2)


def test_reference_checkpoint_continues_in_the_port(tmp_path, monkeypatch):
    """The reference trains 6 steps, checkpointing at 3 and 6; the port
    resumes from the reference's step-3 checkpoint and trains 4-6."""
    pytest.importorskip("jax")
    from repro.configs import ARCHS
    from repro.launch import train as rtrain
    from repro.models import layers as rlayers
    from repro.models import reduced_config
    # the reference's run installs its mesh axes for the sharding hints in
    # a module global and leaves them there; restore it after this test,
    # or a later jitted reference step in this process (outside any mesh)
    # would fail on the hints
    monkeypatch.setattr(rlayers, "_HINT_AXES", rlayers._HINT_AXES)
    ref_dir, ref_logs = tmp_path / "ref", []
    rtrain.run(rtrain.TrainJob(arch=reduced_config(ARCHS["qwen3-14b"]),
                               ckpt_dir=str(ref_dir), **JOB),
               log=ref_logs.append)
    port_dir, port_logs = tmp_path / "port", []
    port_dir.mkdir()
    shutil.copytree(ref_dir / "step_000000003", port_dir / "step_000000003")
    ttrain.run(_job(treduced(TARCHS["qwen3-14b"]), port_dir), device="cpu",
               log=port_logs.append)
    assert port_logs[0] == "[train] resuming from checkpoint step 3"
    want, got = _losses(ref_logs), _losses(port_logs)
    assert sorted(got) == [4, 5, 6]
    for s in got:
        assert got[s] == pytest.approx(want[s], rel=1e-4), s
    ref_final, port_final = _arrays(ref_dir, 6), _arrays(port_dir, 6)
    assert set(port_final) == set(ref_final)
    assert int(port_final["opt/step"]) == int(ref_final["opt/step"]) == 6
    # three f32 AdamW steps at lr <= 1e-2: an element whose gradient is
    # near eps could move by up to lr a step on rounding alone; none does
    # here (1.4e-7 measured), and 1e-4 (1% of lr) says so
    for k in ref_final:
        if k.startswith("params/"):
            np.testing.assert_allclose(port_final[k], ref_final[k],
                                       atol=1e-4, rtol=0, err_msg=k)


def _reference_example():
    pytest.importorskip("jax")
    spec = importlib.util.spec_from_file_location(
        "reference_example_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("preset", ["smoke", "100m"])
def test_make_arch_equals_the_reference_example(preset):
    want = dataclasses.asdict(_reference_example().make_arch(preset))
    got = dataclasses.asdict(ttrain_lm.make_arch(preset))
    assert got == want


def test_main_trains_on_the_cpu(tmp_path, capsys):
    ttrain_lm.main(["smoke", "--device", "cpu", "--steps", "5", "--ckpt",
                    str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[-1] == "OK"
    assert tckpt.list_steps(str(tmp_path)) == [5]


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mamba2-370m",
                                  "jamba-v0.1-52b"])
def test_run_trains_the_moe_ssm_and_hybrid_families(arch):
    """``launch/train.run`` trains the reduced deepseek-v2-lite (MLA + MoE,
    2 microbatches), mamba2 and jamba: every logged loss finite, the last
    below the first."""
    logs = []
    out = ttrain.run(ttrain.TrainJob(
        arch=treduced(TARCHS[arch]), n_microbatches=2,
        **{**JOB, "ckpt_every": 100}), device="cpu", log=logs.append)
    assert len(out["losses"]) == JOB["steps"]
    assert np.isfinite(out["losses"]).all(), out["losses"]
    assert out["final_loss"] < out["first_loss"], out["losses"]


def test_main_trains_the_encoder_decoder_on_the_cpu(tmp_path, capsys):
    """The port's ``encdec-smoke`` preset: the reduced seamless trained
    through ``launch/train.run`` (frames of the sequence length on the
    encoder) prints ``OK``."""
    ttrain_lm.main(["encdec-smoke", "--device", "cpu", "--steps", "5",
                    "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("[train_lm] arch=seamless-m4t-large-v2-reduced")
    assert out[-1] == "OK"
    assert tckpt.list_steps(str(tmp_path)) == [5]
