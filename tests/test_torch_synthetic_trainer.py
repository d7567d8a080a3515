"""``SyntheticTrainer``, ``train-synth`` and ``synth-data`` of the port on the
CPU, at the small size of tests/test_train.py (n_fft 256, hop 128, 8 kHz,
0.75 s chunks, ``(129, 47)`` features, batch 4): ``fit`` with the gain and a
self-supervised objective, a resume that draws what an uninterrupted run
draws, the commands end to end, and the parser defaults of
tests/test_mix_bus.py:314-340."""

import argparse
import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpumix.cli import _resolve_patience as jax_resolve_patience
from tpumix.cli import build_parser as jax_build_parser
from tpumix.cli import cmd_synth_data as jax_cmd_synth_data
from tpumix.models.convert import load_npz as jax_load_npz
from tpumix_torch import cli
from tpumix_torch.config import FrontendConfig, TrainConfig, preset
from tpumix_torch.models.registry import build_model
from tpumix_torch.train.trainer import SyntheticTrainer, resolve_patience

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000
CHUNK = 6000
FRONTEND = FrontendConfig(n_fft=256, hop_length=128, sample_rate=SR)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    test processes side by side, and torch's default of a thread per core in
    each makes small CPU ops wait on one another many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _trainer(tmp_path, run_name, loss="gain", augment=False, **kw):
    cfg = TrainConfig(batch_size=4, num_epochs=2, checkpoint_dir=str(tmp_path), seed=0,
                      loss=loss, augment=augment, log_every_steps=1000)
    model = build_model(dataclasses.replace(preset("scalar1sL"), bn_momentum=0.99,
                                            use_dropout=False),
                        in_shape=(129, 47), for_training=True,
                        generator=torch.Generator().manual_seed(0))
    return SyntheticTrainer(model, FRONTEND, cfg, chunk_samples=CHUNK, sr=SR, run_name=run_name,
                            device="cpu", val_batches=2, context_mult=2, **kw)


@pytest.mark.parametrize("loss,bus", [("gain", None), ("lstsq", "full")])
def test_fit_is_finite_and_checkpoints(tmp_path, loss, bus):
    tr = _trainer(tmp_path, loss, loss=loss, mix_bus_kind=bus)
    assert (tr._train_step.__qualname__.startswith("make_gain_train_step")) == (loss == "gain")
    res = tr.fit(2, 7, 0, 2)
    assert len(res.train_loss) == len(res.val_loss) == 2
    assert np.isfinite(res.train_loss).all() and np.isfinite(res.val_loss).all()
    assert tr.state.step == 4 and tr.last_epoch_stats["steps"] == 2
    assert tr.last_epoch_stats["host_wait_s"] == 0.0
    assert sorted(d for d in os.listdir(tr.ckpt_dir) if d.startswith("epoch_")) == [
        "epoch_0000", "epoch_0001"]
    # the validation batches are fixed by their seed: evaluating twice agrees
    assert tr._run_val_epoch(7) == tr._run_val_epoch(7) != tr._run_val_epoch(8)


@pytest.mark.parametrize("loss,augment", [("gain", False), ("lstsq", True)])
def test_resume_draws_what_an_uninterrupted_run_draws(tmp_path, loss, augment):
    """One epoch, then a resume to two, ends in the state of two epochs in
    one run: batches and augmentation gains come from (seed, update count)."""
    whole = _trainer(tmp_path, "whole", loss=loss, augment=augment)
    whole.fit(2, 7, 0, 2)
    first = _trainer(tmp_path, "split", loss=loss, augment=augment)
    first.fit(2, 7, 0, 1)
    second = _trainer(tmp_path, "split", loss=loss, augment=augment)
    assert second.resume() == 1 and second.state.step == 2
    second.fit(2, 7, 1, 2)
    assert second.state.step == whole.state.step == 4
    for (k, a), b in zip(whole.model.state_dict().items(), second.model.state_dict().values()):
        assert torch.equal(a, b), k
    opt_a, opt_b = whole.state.optimizer.state_dict(), second.state.optimizer.state_dict()
    for i in opt_a["state"]:
        assert torch.equal(opt_a["state"][i]["exp_avg"], opt_b["state"][i]["exp_avg"])


def test_base_trainer_still_rejects_gain_and_synthetic_accepts_it(tmp_path):
    from tpumix_torch.train.trainer import Trainer

    cfg = TrainConfig(checkpoint_dir=str(tmp_path), loss="gain")
    with pytest.raises(ValueError, match="label-supervised"):
        Trainer(build_model(dataclasses.replace(preset("scalar1s"), bn_momentum=0.99),
                            in_shape=(129, 47)), FRONTEND, cfg, device="cpu")
    assert SyntheticTrainer._supports_gain_loss and not Trainer._supports_gain_loss


def test_train_synth_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["train-synth", "--checkpoint-dir", str(tmp_path), "--steps-per-epoch", "1"])


def _run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-m", "tpumix_torch", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


def test_train_synth_cli_trains_resumes_and_exports(tmp_path):
    base = ["train-synth", "--model", "scalar1sL", "--batch-size", "2", "--steps-per-epoch", "1",
            "--context-mult", "1", "--device", "cpu", "--checkpoint-dir", str(tmp_path),
            "--run-name", "s"]
    first = _run(*base, "--epochs", "1")
    second = _run(*base, "--epochs", "2", "--resume", "--mix-bus", "comp")
    assert [l.split(":")[0] for l in first.splitlines() if l.startswith("Epoch ")] == ["Epoch 0"]
    result = json.loads(first.strip().splitlines()[-1])
    assert set(result) == {"best_epoch", "best_val_loss", "stopped_early", "checkpoint_dir"}
    assert np.isfinite(result["best_val_loss"])
    assert "[resume] restored epoch 0" in second
    assert [l.split(":")[0] for l in second.splitlines() if l.startswith("Epoch ")] == ["Epoch 1"]
    npz = str(tmp_path / "s.npz")
    _run("export-checkpoint", "--checkpoint", result["checkpoint_dir"], "--out", npz)
    variables = jax_load_npz(npz)  # the JAX package reads the export
    assert variables["params"]["head1"]["fc"]["kernel"].shape == (490 * 21 + 4, 1)


def test_synth_data_cli_writes_the_jax_packages_tree(tmp_path):
    out = _run("synth-data", "--out", str(tmp_path / "port"), "--n-train", "1", "--n-test", "1",
               "--duration", "0.5", "--train-raw", "--bus", "limiter")
    assert json.loads(out.strip().splitlines()[-1]) == {
        "root": str(tmp_path / "port"), "train": 1, "test": 1}
    jax_cmd_synth_data(argparse.Namespace(out=str(tmp_path / "jax"), n_train=1, n_test=1,
                                          duration=0.5, seed=0, train_raw=True, bus="limiter"))
    files = sorted(os.path.relpath(os.path.join(d, n), tmp_path / "jax")
                   for d, _, names in os.walk(tmp_path / "jax") for n in names)
    assert "train_songlist.txt" in files and len(files) == 2 + 3 * 5
    for rel in files:
        with open(tmp_path / "jax" / rel, "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
            assert a.read() == b.read(), rel


def test_parser_defaults_follow_tpumix():
    """tests/test_mix_bus.py:314-340 on the port: per-loss patience unset, and
    ``train`` ranks checkpoints by -train_mse, ``train-synth`` by val."""
    for loss in ("lstsq", "reference", "gain"):
        assert resolve_patience(None, loss) == jax_resolve_patience(None, loss)
    assert resolve_patience(7, "lstsq") == 7
    p, jp = cli.build_parser(), jax_build_parser()
    assert p.parse_args(["train-synth"]).patience is None
    assert p.parse_args(["train", "--data", "x"]).checkpoint_score == "train"
    assert p.parse_args(["train-synth"]).checkpoint_score == "val"
    assert p.parse_args(["train", "--data", "x", "--checkpoint-score", "val"]
                        ).checkpoint_score == "val"
    ours, theirs = vars(p.parse_args(["train-synth"])), vars(jp.parse_args(["train-synth"]))
    for key in set(ours) & set(theirs) - {"fn"}:
        assert ours[key] == theirs[key], key
    assert ours["device"] == "cuda" and ours["model"] == "scalar2sL" and ours["loss"] == "gain"
