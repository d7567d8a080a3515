"""The port's host-only commands against the JAX package's, on the JAX tests'
own fixtures: ``surgery`` (tests/test_cli_and_surgery.py::TestSurgery),
``listening-prep`` / ``listening-parse`` (tests/test_eval.py:152-177),
``precompute``, the ``plot_gain_curves`` helper, the reference-shim
``mix_song_smooth`` with its bounded mixer cache, and the command list.

Tolerances: files the two packages write from the same numpy code are
compared byte for byte; the precomputed features (the same host frontend) to
1e-4 dB; where each package runs its own model, the main path's contract
(tests/test_torch_mixer.py): gains within 1e-3 (tests/test_infer.py:82), the
CNN's listening mixture within 2e-3 relative amplitude."""

import json
import os
import shutil

import numpy as np
import pytest
import torch


from tpumix.cli import build_parser as jax_build_parser
from tpumix.cli import main as jax_main
from tpumix.assets import load_checkpoint as jax_load_checkpoint
from tpumix.config import preset as jax_preset
from tpumix.data import surgery as jax_surgery
from tpumix.eval import listening as jax_listening
from tpumix.infer import mixer as jax_mixer
from tpumix.models.baselines import RandomModel as JaxRandomModel
from tpumix.models.registry import build_model as jax_build_model
from tpumix_torch import cli
from tpumix_torch.assets import load_checkpoint
from tpumix_torch.config import MixConfig, preset
from tpumix_torch.data import surgery, wavio
from tpumix_torch.eval import listening
from tpumix_torch.infer import mixer as port_mixer
from tpumix_torch.infer.catalog import plot_gain_curves
from tpumix_torch.models.baselines import RandomModel
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model

from test_data import make_song

SR = 44100
SONGS = ["TestSong1", "TestSong2"]


def _files(root):
    """``{relative path: bytes}`` of every file under ``root``."""
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture()
def raw_medleydb_root(tmp_path):
    """tests/test_cli_and_surgery.py's raw MedleyDB song (METADATA.yaml,
    per-instrument stems, the mix), twice: one tree per package."""
    import yaml

    name = "FakeBand_FakeSong"
    song = tmp_path / "ours" / name
    stems_dir = song / f"{name}_STEMS"
    stems_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    instruments = {
        "S01": ("electric bass", "bass"),
        "S02": ("drum set", ""),
        "S03": ("male singer", ""),
        "S04": ("clean electric guitar", ""),
        "S05": ("tambourine", ""),
    }
    stems_audio = {}
    for sid in instruments:
        audio = 0.1 * rng.standard_normal(SR).astype(np.float32)
        stems_audio[sid] = audio
        wavio.write(str(stems_dir / f"{name}_STEM_{sid[1:]}.wav"), audio, SR)
    wavio.write(str(song / f"{name}_MIX.wav"), sum(stems_audio.values()), SR)
    meta = {"origin": "Independent Artist",
            "stems": {sid: {"instrument": inst, "component": comp}
                      for sid, (inst, comp) in instruments.items()}}
    with open(song / f"{name}_METADATA.yaml", "w") as f:
        yaml.safe_dump(meta, f)
    shutil.copytree(tmp_path / "ours", tmp_path / "theirs")
    return str(tmp_path / "ours"), str(tmp_path / "theirs"), name, stems_audio


def test_surgery_command_writes_tpumixs_files(raw_medleydb_root, capsys):
    ours, theirs, name, stems_audio = raw_medleydb_root
    assert cli.main(["surgery", "--data", ours, "--naive-sums"]) == 0
    assert "[surgery] processed 1 songs" in capsys.readouterr().out
    assert jax_main(["surgery", "--data", theirs, "--naive-sums"]) == 0
    a, b = _files(ours), _files(theirs)
    assert a == b
    joined = os.path.join(ours, name, f"{name}_STEMS_JOINED")
    drums, _ = wavio.read(os.path.join(joined, f"{name}_STEM_DRUMS.wav"))
    np.testing.assert_allclose(drums, stems_audio["S02"] + stems_audio["S05"], atol=1e-6)
    assert os.path.exists(os.path.join(ours, name, f"{name}_SUM.wav"))


def test_surgery_tables_and_grouping_are_tpumixs(raw_medleydb_root):
    ours, _, name, _ = raw_medleydb_root
    for args in (("drum set",), ("electric bass",), ("piano", "bass"), ("female singer",),
                 ("clean electric guitar",)):
        assert surgery.classify_instrument(*args) == jax_surgery.classify_instrument(*args)
    song = os.path.join(ours, name)
    assert surgery.group_stem_ids(song) == jax_surgery.group_stem_ids(song)
    assert surgery.MANUAL_OVERRIDES == jax_surgery.MANUAL_OVERRIDES
    assert surgery.NEEDS_MANUAL_REVIEW == jax_surgery.NEEDS_MANUAL_REVIEW


def test_surgery_overrides_and_review_warning(raw_medleydb_root, monkeypatch, capsys):
    ours, theirs, name, _ = raw_medleydb_root
    overrides = {name: {"drums": ["01", "02", "05"], "bass": [], "vocals": ["03"],
                        "other": ["04"]}}
    surgery.process_root(ours, manual_overrides=overrides)
    jax_surgery.process_root(theirs, manual_overrides=overrides)
    assert _files(ours) == _files(theirs)
    monkeypatch.setattr(surgery, "NEEDS_MANUAL_REVIEW", (name,))
    surgery.process_root(ours, manual_overrides={})
    assert "WARNING" in capsys.readouterr().out


@pytest.fixture(scope="module")
def musdb_root(tmp_path_factory):
    """tests/test_eval.py's MUSDB18-HQ-style root: test/ + manual_gain_mixes/."""
    base = str(tmp_path_factory.mktemp("musdb"))
    for sub in ("test", "manual_gain_mixes"):
        os.makedirs(os.path.join(base, sub), exist_ok=True)
        for i, song in enumerate(SONGS):
            make_song(os.path.join(base, sub), song, 6.0, layout="musdb18",
                      seed=i + (0 if sub == "test" else 7))
    return base


@pytest.fixture(scope="module")
def mixers():
    """The shipped ``scalar1sL_synth`` artifact in both packages, the port's
    on the CPU.  tests/test_eval.py mixes with a random-init scalar1s; its
    gains reach ~10 (amplitude 1e5), where the two packages' float32 sums
    differ by 1.2e-2 (1e-3 relative) and the loudness-normalised mixtures by
    4e-3: a trained model keeps the comparison on the gain contract."""
    model = jax_build_model(jax_preset("scalar1sL"))
    variables = jax_load_checkpoint("scalar1sL_synth")
    ours = build_model(preset("scalar1sL"))
    ours.load_state_dict(state_dict_from_jax(load_checkpoint("scalar1sL_synth")))
    # segments of 4 chunks keep the CPU trunk runs small (the gains do not
    # depend on the segmentation, tests/test_torch_mixer.py)
    return (port_mixer.SongMixer(ours, preset("scalar1sL"),
                                 MixConfig(chunk_length_s=1.0, max_chunks=4), device="cpu"),
            jax_mixer.SongMixer(model, variables, jax_preset("scalar1sL")), ours)


def test_listening_prep_writes_tpumixs_mixtures(musdb_root, mixers, tmp_path):
    ours_dir, theirs_dir = str(tmp_path / "ours"), str(tmp_path / "theirs")
    intervals = {s: (1, 4) for s in SONGS}
    listening.process_songlist(
        musdb_root, SONGS, {"random": RandomModel(rng=np.random.default_rng(0)),
                            "mix": mixers[0]}, save_dir=ours_dir, time_intervals=intervals)
    jax_listening.process_songlist(
        musdb_root, SONGS, {"random": JaxRandomModel(rng=np.random.default_rng(0)),
                            "mix": mixers[1]}, save_dir=theirs_dir, time_intervals=intervals)
    ours, theirs = _files(ours_dir), _files(theirs_dir)
    assert sorted(ours) == sorted(theirs) and len(ours) == len(SONGS) * 4
    for fname in ours:
        if fname.endswith("_mix.wav"):  # each package's CNN
            a, _ = wavio.read(os.path.join(ours_dir, fname))
            b, _ = wavio.read(os.path.join(theirs_dir, fname))
            rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
            assert rel <= 2e-3, (fname, rel)
        else:
            assert ours[fname] == theirs[fname], fname
    assert listening.DEFAULT_TIME_INTERVALS == jax_listening.DEFAULT_TIME_INTERVALS


def test_listening_parse_command_and_parser(tmp_path, capsys):
    payload = {"pages": [{"id": "X", "elements": [
        {"id": "X_mix", "axis": [{"values": [70, 80]}]},
        {"id": "X_sum", "axis": [{"values": [30, 40]}]},
    ]}]}
    scores = str(tmp_path / "s.json")
    with open(scores, "w") as f:
        json.dump(payload, f)
    assert listening.parse_json(scores) == jax_listening.parse_json(scores)
    by_model, by_song = listening.parse_json(scores)
    assert by_model["mix"] == [[70, 80]] and by_song["X"]["sum"] == [30, 40]
    assert listening.global_scores(by_model) == jax_listening.global_scores(by_model)
    out = str(tmp_path / "figs" / "g.png")
    assert cli.main(["listening-parse", "--scores", scores, "--out", out]) == 0
    assert os.path.getsize(out) > 0 and f"boxplot at {out}" in capsys.readouterr().out


def test_precompute_command_writes_tpumixs_cache(tmp_path):
    base = str(tmp_path / "data")
    os.makedirs(base)
    make_song(base, "S1", 2.5, seed=1)
    for pkg, main in (("ours", cli.main), ("theirs", jax_main)):
        assert main(["precompute", "--data", base, "--model", "scalar1s", "--cache-dir",
                     str(tmp_path / pkg)]) == 0
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs")) == ["S1_FEATURES_1.0s_h512.npz"]
    with np.load(tmp_path / "ours" / names[0]) as a, np.load(tmp_path / "theirs" / names[0]) as b:
        assert a["train"].shape == b["train"].shape == (2, 4, 1025, 87)
        np.testing.assert_allclose(a["train"], b["train"], rtol=0, atol=1e-4)
        np.testing.assert_allclose(a["gt"], b["gt"], rtol=0, atol=1e-4)


def test_plot_gain_curves_writes_a_png(tmp_path):
    raw = {s: [1.0, 1.2, 0.9] for s in ("bass", "drums", "vocals", "other")}
    out = plot_gain_curves(raw, raw, str(tmp_path / "plots" / "g.png"), title="t")
    assert os.path.getsize(out) > 0


def test_mix_song_smooth_shim_matches_tpumix(mixers, monkeypatch):
    """One mixer serves repeated calls with one model, and its gains are
    those of the ``SongMixer`` tpumix's shim builds (tpumix/infer/mixer.py:562)."""
    ours_model = mixers[2]
    monkeypatch.setattr(port_mixer, "_SHIM_MIXERS", {})
    rng = np.random.default_rng(3)
    tracks = {s: (0.1 * rng.standard_normal((2, int(2.5 * SR)))).astype(np.float32)
              for s in ("bass", "drums", "vocals", "other")}
    mixed, raw, _ = port_mixer.mix_song_smooth(None, ours_model, tracks, device="cpu")
    again = port_mixer.mix_song_smooth(None, ours_model, tracks, device="cpu")
    assert len(port_mixer._SHIM_MIXERS) == 1 and raw == again[1]
    _, jraw, _ = mixers[1].mix_song_smooth(tracks)  # tpumix's shim runs this mixer
    for s in raw:
        assert len(raw[s]) == len(jraw[s]) == 1
        np.testing.assert_allclose(2 * np.log10(raw[s]), 2 * np.log10(jraw[s]), atol=1e-3)
        assert mixed[s].shape == tracks[s].shape


def test_mix_song_smooth_shim_cache_is_bounded_first_in_first_out(monkeypatch):
    made = []

    class Recording:
        def __init__(self, model, cfg, device=None):
            made.append(model)

        def mix_song_smooth(self, tracks):
            return tracks

    monkeypatch.setattr(port_mixer, "_SHIM_MIXERS", {})
    monkeypatch.setattr(port_mixer, "SongMixer", Recording)
    limit = port_mixer._SHIM_MIXERS_MAX
    models = [torch.nn.Identity() for _ in range(limit + 2)]
    for m in models:
        port_mixer.mix_song_smooth(None, m, {}, device="cpu")
    assert len(made) == limit + 2 and len(port_mixer._SHIM_MIXERS) == limit
    port_mixer.mix_song_smooth(None, models[-1], {}, device="cpu")  # kept: reused
    assert len(made) == limit + 2
    port_mixer.mix_song_smooth(None, models[0], {}, device="cpu")  # the oldest went first
    assert len(made) == limit + 3 and len(port_mixer._SHIM_MIXERS) == limit
    port_mixer.mix_song_smooth(None, models[-1], {}, chunk_length=2, device="cpu")
    assert len(made) == limit + 4  # another chunk length is another mixer


def test_command_list_is_tpumixs_but_bench():
    def commands(parser):
        return set(next(a for a in parser._actions if hasattr(a, "choices") and a.choices)
                   .choices)

    assert commands(jax_build_parser()) - commands(cli.build_parser()) == {"bench"}
    assert commands(cli.build_parser()) - commands(jax_build_parser()) == set()
    for command in ("precompute", "surgery", "listening-prep", "listening-parse"):
        with pytest.raises(SystemExit) as e:
            cli.main([command, "--help"])
        assert e.value.code == 0
