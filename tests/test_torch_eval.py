"""The port's evaluation layer against the JAX package's on the MUSDB18-layout
fixture of tests/test_eval.py: ``LoudnessEvaluator`` with the same seed and
converted weights (baseline rows equal within 1e-6 LU — the same numpy code
and generator — and the ``mix`` rows within 0.01 LU), the device meter with
its power-of-two bucketing (atol 0.1 against the host meter,
tests/test_eval.py:204), the ``evaluate`` and ``mean-loudness`` commands, the
baselines, the xlsx writer and the songlist registry (held against
``tpumix.data.songlists``)."""

import csv
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from test_data import make_song
from tpumix.assets import load_checkpoint as jax_load_checkpoint
from tpumix.config import MixConfig as JaxMixConfig
from tpumix.config import preset as jax_preset
from tpumix.data import songlists as jax_songlists
from tpumix.data.dataset import MultitrackAudioDataset as JaxDataset
from tpumix.eval.evaluator import LoudnessEvaluator as JaxEvaluator
from tpumix.infer.mixer import SongMixer as JaxSongMixer
from tpumix.models import baselines as jax_baselines
from tpumix.models.registry import build_model as jax_build_model
from tpumix.utils.xlsx import write_xlsx as jax_write_xlsx
from tpumix_torch import cli
from tpumix_torch.assets import load_checkpoint
from tpumix_torch.config import MixConfig, preset
from tpumix_torch.data import songlists
from tpumix_torch.eval.evaluator import LoudnessEvaluator
from tpumix_torch.infer.mixer import SongMixer
from tpumix_torch.models import baselines
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.ops.loudness import integrated_loudness
from tpumix_torch.utils.xlsx import write_xlsx

SR = 44100
SONGS = ["TestSong1", "TestSong2"]
STEMS = ("bass", "drums", "vocals", "other")
MODEL = "scalar1sL"
MEAN_LOUDNESS = {t: -20.0 for t in STEMS}
BASELINE_KEYS = ("sum_error", "loudnorm_error", "random_error")


@pytest.fixture(scope="module")
def musdb_root(tmp_path_factory):
    """MUSDB18-HQ-style root: test/ + manual_gain_mixes/ per song."""
    base = str(tmp_path_factory.mktemp("musdb"))
    for sub in ("test", "manual_gain_mixes"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
        for i, song in enumerate(SONGS):
            make_song(os.path.join(base, sub), song, 6.0, layout="musdb18",
                      seed=i + (0 if sub == "test" else 7))
    return base


@pytest.fixture(scope="module")
def mixer():
    model = build_model(preset(MODEL))
    model.load_state_dict(state_dict_from_jax(load_checkpoint(f"{MODEL}_synth")))
    return SongMixer(model, preset(MODEL), MixConfig(chunk_length_s=1.0, max_chunks=4),
                     device="cpu")


@pytest.fixture(scope="module")
def jax_mixer():
    cfg = jax_preset(MODEL)
    return JaxSongMixer(jax_build_model(cfg), jax_load_checkpoint(f"{MODEL}_synth"), cfg,
                        JaxMixConfig(chunk_length_s=1.0, max_chunks=4))


@pytest.fixture(scope="module")
def sweeps(musdb_root, mixer, jax_mixer, tmp_path_factory):
    out = tmp_path_factory.mktemp("sweeps")
    port = LoudnessEvaluator(mixer, MEAN_LOUDNESS, seed=0, results_dir=str(out / "p"))
    ref = JaxEvaluator(jax_mixer, MEAN_LOUDNESS, seed=0, results_dir=str(out / "j"))
    return (port.process_songlist(musdb_root, SONGS, out_path=str(out / "p" / "stats.xlsx")),
            ref.process_songlist(musdb_root, SONGS, out_path=str(out / "j" / "stats.xlsx")),
            out)


def test_baseline_rows_equal_jax(sweeps):
    port, ref, _ = sweeps
    assert [s["song_name"] for s in port] == SONGS
    for p, j in zip(port, ref):
        for key in BASELINE_KEYS:
            assert np.isfinite(p[key]) and p[key] >= 0
            assert abs(p[key] - j[key]) <= 1e-6, (key, p[key], j[key])


def test_mix_rows_match_jax(sweeps):
    port, ref, _ = sweeps
    for p, j in zip(port, ref):
        assert np.isfinite(p["mix_error"])
        assert abs(p["mix_error"] - j["mix_error"]) <= 0.01, (p["mix_error"], j["mix_error"])


def test_stats_files_match_jax(sweeps):
    _, _, out = sweeps
    rows = {}
    for side in ("p", "j"):
        with open(out / side / "stats.csv") as f:
            rows[side] = list(csv.reader(f))
        with zipfile.ZipFile(out / side / "stats.xlsx") as z:
            assert "xl/worksheets/sheet1.xml" in z.namelist()
    assert rows["p"][0] == rows["j"][0] == ["song_name", "sum_error", "random_error",
                                            "loudnorm_error", "mix_error"]
    assert len(rows["p"]) == len(rows["j"]) == len(SONGS) + 2  # header, songs, mean
    for rp, rj in zip(rows["p"][1:], rows["j"][1:]):
        assert rp[:4] == rj[:4]  # name and the baselines, as written
        assert abs(float(rp[4]) - float(rj[4])) <= 0.011  # mix, 2-4 decimals


def test_device_meter_matches_host(musdb_root, tmp_path):
    host = LoudnessEvaluator(None, MEAN_LOUDNESS, seed=0, results_dir=str(tmp_path / "h"))
    dev = LoudnessEvaluator(None, MEAN_LOUDNESS, seed=0, results_dir=str(tmp_path / "d"),
                            device_meter=True, device="cpu")
    s_host = host.process_song(musdb_root, SONGS[0])
    s_dev = dev.process_song(musdb_root, SONGS[0])
    assert np.isnan(s_dev["mix_error"])
    for k in BASELINE_KEYS:
        assert abs(s_host[k] - s_dev[k]) <= 0.1, (k, s_host[k], s_dev[k])


def test_device_meter_bucketing(tmp_path):
    ev = LoudnessEvaluator(None, MEAN_LOUDNESS, seed=0, results_dir=str(tmp_path),
                           device_meter=True, device="cpu")
    rng = np.random.default_rng(0)
    for n in (100_000, 117_001):  # both bucket to 2**17
        tracks = {t: 0.1 * rng.standard_normal(n).astype(np.float32) for t in STEMS}
        rel = ev.evaluate_loudness(tracks)
        per = [integrated_loudness(np.asarray(tracks[t]), ev.sr) for t in STEMS]
        np.testing.assert_allclose(rel, [p - float(np.mean(per)) for p in per], atol=0.1)


def test_device_meter_runs_on_the_card_by_default(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LoudnessEvaluator(None, MEAN_LOUDNESS, results_dir=str(tmp_path), device_meter=True)
    LoudnessEvaluator(None, MEAN_LOUDNESS, results_dir=str(tmp_path))  # host meter: no device


def test_wav_export(musdb_root, mixer, tmp_path):
    ev = LoudnessEvaluator(mixer, MEAN_LOUDNESS, seed=0, results_dir=str(tmp_path / "x"))
    ev.process_song(musdb_root, SONGS[0], n_random_samples=1, write_wavs_to_disk=True)
    exported = sorted(os.listdir(tmp_path / "x"))
    assert exported == sorted(f"{SONGS[0]}_{k}.wav"
                              for k in ("reference", "sum", "loudnorm", "mix", "random_0"))


def test_mean_loudness_command_matches_jax(musdb_root, tmp_path, capsys):
    out = str(tmp_path / "ml.json")
    assert cli.main(["mean-loudness", "--data", os.path.join(musdb_root, "test"),
                     "--layout", "musdb18", "--out", out]) == 0
    with open(out) as f:
        ours = json.load(f)
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == ours
    ref = JaxDataset(os.path.join(musdb_root, "test"), layout="musdb18").compute_mean_loudness()
    assert ours.keys() == ref.keys() == {*STEMS, "mix"}
    for k in ref:
        assert ours[k] == pytest.approx(ref[k], rel=1e-12, abs=1e-12)


def test_evaluate_command(musdb_root, mixer, tmp_path, monkeypatch):
    ml = tmp_path / "ml.json"
    ml.write_text(json.dumps(MEAN_LOUDNESS))
    songs = tmp_path / "songs.txt"
    songs.write_text("\n".join(SONGS) + "\n")
    seen = {}

    def load_mixer(args):  # the CLI's own mixer is 64-chunk segments: slow on the CPU
        seen["model"], seen["device"] = args.model, args.device
        return mixer

    monkeypatch.setattr(cli, "_load_mixer", load_mixer)
    for flags in ([], ["--device-meter"]):
        out = tmp_path / ("dev" if flags else "host")
        assert cli.main(["evaluate", "--data", musdb_root, "--layout", "musdb18",
                         "--songlist", str(songs), "--mean-loudness", str(ml), "--out", str(out),
                         "--device", "cpu", "--model", MODEL, *flags]) == 0
        assert (out / "stats.xlsx").exists()
    assert seen == {"model": MODEL, "device": "cpu"}
    with open(tmp_path / "host" / "stats.csv") as f:
        host = list(csv.reader(f))
    with open(tmp_path / "dev" / "stats.csv") as f:
        dev = list(csv.reader(f))
    for rh, rd in zip(host[1:], dev[1:]):
        assert rh[0] == rd[0]
        for a, b in zip(rh[1:], rd[1:]):
            assert abs(float(a) - float(b)) <= 0.1


def test_dummy_and_random_models_match_jax():
    rng = np.random.default_rng(4)
    x = (20.0 * rng.standard_normal((2, 4, 33, 9)) - 30.0).astype(np.float32)
    got = baselines.DummyModel()(torch.from_numpy(x)).numpy()
    ref = np.asarray(jax_baselines.DummyModel()(x))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-4)
    tracks = {t: rng.standard_normal((2, 1000)).astype(np.float32) for t in STEMS}
    ours = baselines.RandomModel(rng=np.random.default_rng(9))
    theirs = jax_baselines.RandomModel(rng=np.random.default_rng(9))
    for _ in range(3):
        a, b = ours.forward(tracks), theirs.forward(tracks)
        for t in STEMS:
            np.testing.assert_array_equal(a[t], b[t])
    loud = {t: -18.0 - i for i, t in enumerate(STEMS)}
    a = baselines.MeanLoudnessModel(loud).forward({**tracks, "bass": np.zeros((2, 1000))})
    b = jax_baselines.MeanLoudnessModel(loud).forward({**tracks, "bass": np.zeros((2, 1000))})
    for t in STEMS:
        np.testing.assert_array_equal(a[t], b[t])


def test_xlsx_sheet_is_the_jax_packages(tmp_path):
    rows = [["name", "x"], ["a", 1.5], ["b & <c>", 2], ["Mean", "0.25"]]
    write_xlsx(str(tmp_path / "p.xlsx"), rows)
    jax_write_xlsx(str(tmp_path / "j.xlsx"), rows)
    with zipfile.ZipFile(tmp_path / "p.xlsx") as zp, zipfile.ZipFile(tmp_path / "j.xlsx") as zj:
        assert zp.namelist() == zj.namelist()
        for name in zp.namelist():
            assert zp.read(name) == zj.read(name), name


def test_songlist_registry_is_the_jax_packages(tmp_path):
    assert songlists.available_songlists() == jax_songlists.available_songlists()
    for key in jax_songlists.available_songlists():
        assert songlists.get_songlist(key) == jax_songlists.get_songlist(key), key
    with pytest.raises(KeyError):
        songlists.get_songlist("nope")
    args = cli.build_parser().parse_args(
        ["mix", "--data", "x", "--songlist", "musdb18_test_manually_gain_mixed"])
    assert cli._songlist(args) == jax_songlists.get_songlist("musdb18_test_manually_gain_mixed")
    listing = tmp_path / "songs.txt"
    listing.write_text("A\n\nB\n")
    args = cli.build_parser().parse_args(["mix", "--data", "x", "--songlist", str(listing)])
    assert cli._songlist(args) == ["A", "B"]
