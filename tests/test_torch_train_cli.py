"""``python -m tpumix_torch train`` / ``export-checkpoint`` end to end on the
CPU: a tiny written corpus, two epochs, a resume, the export — and then the
JAX package loads that ``.npz`` (``tpumix.models.convert.load_npz``) and its
model gives the port's gains on the same features within 2e-3, the bound the
shipped checkpoints are held to."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpumix.config import preset as jax_preset
from tpumix.models.convert import load_npz as jax_load_npz
from tpumix.models.registry import build_model as jax_build_model
from tpumix_torch import cli
from tpumix_torch.config import preset
from tpumix_torch.data import wavio
from tpumix_torch.data.dataset import MultitrackAudioDataset
from tpumix_torch.models.convert import load_npz, save_npz, state_dict_from_jax, state_dict_to_jax
from tpumix_torch.models.registry import build_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
SONGS = {"SongA": 4, "SongB": 3, "SongC": 3}  # seconds


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """MedleyDB layout, PCM16: four noise stems and a fixed-gain mix a song."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(0)
    gains = dict(bass=0.9, drums=1.1, vocals=0.8, other=1.2)
    for song, seconds in SONGS.items():
        d = root / song / f"{song}_STEMS_JOINED"
        d.mkdir(parents=True)
        stems = {s: (0.1 * rng.standard_normal(SR * seconds)).astype(np.float32) for s in gains}
        for s, x in stems.items():
            wavio.write(str(d / f"{song}_STEM_{s.upper()}.wav"), np.stack([x, x]).T, SR,
                        subtype="PCM_16")
        mix = sum(gains[s] * x for s, x in stems.items())
        wavio.write(str(root / song / f"{song}_MIX.wav"), np.stack([mix, mix]).T, SR,
                    subtype="PCM_16")
    return str(root)


def _run(*args):
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-m", "tpumix_torch", *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    return res.stdout


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """train 2 epochs, resume to 3, export: ``(stdouts, run dir, npz path)``."""
    ckpt = str(tmp_path_factory.mktemp("ckpt"))
    base = ["train", "--data", corpus, "--model", "scalar1s", "--batch-size", "2", "--device",
            "cpu", "--checkpoint-dir", ckpt, "--run-name", "r", "--val-fraction", "0.34",
            "--bn-momentum", "0.99", "--transfer-dtype", "int16", "--checkpoint-score", "val"]
    first = _run(*base, "--epochs", "2")
    second = _run(*base, "--epochs", "3", "--resume")
    npz = os.path.join(ckpt, "r.npz")
    exported = _run("export-checkpoint", "--checkpoint", os.path.join(ckpt, "r"), "--out", npz)
    return (first, second, exported), os.path.join(ckpt, "r"), npz


def test_train_cli_runs_resumes_and_reports(trained):
    (first, second, exported), run_dir, npz = trained
    assert [l.split(":")[0] for l in first.splitlines() if l.startswith("Epoch ")] == [
        "Epoch 0", "Epoch 1"]
    result = json.loads(first.strip().splitlines()[-1])
    assert result["checkpoint_dir"] == run_dir and np.isfinite(result["best_val_loss"])
    assert "[resume] restored epoch 1" in second
    assert [l.split(":")[0] for l in second.splitlines() if l.startswith("Epoch ")] == ["Epoch 2"]
    assert sorted(d for d in os.listdir(run_dir) if d.startswith("epoch_")) == [
        "epoch_0000", "epoch_0001", "epoch_0002"]
    assert "using best-scored epoch" in exported
    assert json.loads(exported.strip().splitlines()[-1])["bytes"] == os.path.getsize(npz)


def test_exported_npz_loads_in_tpumix_and_reproduces_the_gains(trained):
    _, run_dir, npz = trained
    variables = jax_load_npz(npz)
    with open(os.path.join(run_dir, "scores.json")) as f:
        scores = {int(k): v for k, v in json.load(f).items()}
    best = max(scores, key=scores.get)
    saved = torch.load(os.path.join(run_dir, f"epoch_{best:04d}", "state.pt"), weights_only=True)
    model = build_model(preset("scalar1s"))
    model.load_state_dict(saved["model"])
    model.eval()
    # the trained running statistics left their initial values
    assert float((model.conv_b1.bn.running_mean).abs().max()) > 0

    feats = (20.0 * np.random.default_rng(3).standard_normal((3, 4, 1025, 87)) - 40.0).astype(np.float32)
    with torch.no_grad():
        masked, gains = model(torch.from_numpy(feats))
    jmasked, jgains = jax_build_model(jax_preset("scalar1s")).apply(variables, feats, train=False)
    np.testing.assert_allclose(gains.numpy(), np.asarray(jgains), atol=2e-3, rtol=0)
    np.testing.assert_allclose(masked.numpy(), np.asarray(jmasked), atol=0.5, rtol=1e-3)
    # and the port reads its own export back into the same state_dict
    again = state_dict_from_jax(load_npz(npz))
    for k, v in model.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(again[k], v), k


def test_run_and_epoch_directories_resolve_as_checkpoint(trained, corpus, tmp_path):
    _, run_dir, npz = trained
    from_run = cli._load_variables(run_dir)
    from_npz = cli._load_variables(npz)
    np.testing.assert_array_equal(from_run["params"]["head1"]["fc"]["kernel"],
                                  from_npz["params"]["head1"]["fc"]["kernel"])
    epoch0 = cli._load_variables(os.path.join(run_dir, "epoch_0000"))
    assert epoch0["batch_stats"]["conv_b1"]["bn"]["var"].shape == (16,)
    with pytest.raises(SystemExit, match="not a shipped artifact name"):
        cli._load_variables(str(tmp_path))
    out = _run("mix", "--data", corpus, "--song", "SongA", "--model", "scalar1s", "--checkpoint",
               run_dir, "--device", "cpu", "--out", str(tmp_path / "mixed"))
    assert "SongA_mixed.wav" in out
    audio, sr = wavio.read(str(tmp_path / "mixed" / "SongA_mixed.wav"), always_2d=True)
    assert sr == SR and audio.shape == (4 * SR, 2) and np.isfinite(audio).all()


def test_save_npz_is_the_jax_packages_tree(tmp_path):
    from tpumix.models.convert import save_npz as jax_save_npz

    model = build_model(preset("scalar2sL"), in_shape=(72, 72))
    variables = state_dict_to_jax(model.state_dict())
    save_npz(str(tmp_path / "a.npz"), variables["params"], variables["batch_stats"])
    jax_save_npz(str(tmp_path / "b.npz"), variables["params"], variables["batch_stats"])
    with np.load(tmp_path / "a.npz") as a, np.load(tmp_path / "b.npz") as b:
        assert sorted(a.files) == sorted(b.files) and len(a.files) == 5 * 6 + 4 * 4
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_train_parser_mirrors_tpumix_flag_for_flag():
    from tpumix.cli import build_parser as jax_build_parser

    def flags(parser, command):
        sub = next(a for a in parser._actions if hasattr(a, "choices") and a.choices
                   and command in a.choices).choices[command]
        return {a.dest: a.default for a in sub._actions if a.dest != "help"}

    for command, missing in (("train", set()), ("train-synth", set()),
                             ("export-checkpoint", set()), ("synth-data", set())):
        ours, theirs = flags(cli.build_parser(), command), flags(jax_build_parser(), command)
        extra = {"device"} if command.startswith("train") else set()
        assert set(theirs) - set(ours) == missing and set(ours) - set(theirs) == extra
        for dest in set(ours) & set(theirs):
            assert ours[dest] == theirs[dest], dest
    assert flags(cli.build_parser(), "train")["device"] == "cuda"
    assert flags(cli.build_parser(), "train-synth")["device"] == "cuda"


def test_dataset_is_the_jax_packages(corpus):
    from tpumix.data.dataset import MultitrackAudioDataset as JaxDataset

    kw = dict(chunk_length=1.0, seed=4, hop_length=512, augment_data=True)
    ours, theirs = MultitrackAudioDataset(corpus, **kw), JaxDataset(corpus, **kw)
    assert len(ours) == len(theirs) == sum(SONGS.values()) and ours.songlist == theirs.songlist
    for i in (0, 5, len(ours) - 1):
        (s, m), (js, jm) = ours[i], theirs[i]
        np.testing.assert_allclose(s, js, atol=1e-7)
        np.testing.assert_allclose(m, jm, atol=1e-7)
    with pytest.raises(IndexError):
        ours[len(ours)]
    f_ours = MultitrackAudioDataset(corpus, chunk_length=1.0, hop_length=512, return_features=True)
    train, gt = f_ours[1]
    assert train.shape == (4, 1025, 87) and gt.shape == (1025, 87)
