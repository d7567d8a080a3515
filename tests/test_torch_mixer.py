"""The slice as a whole on the CPU: the port's ``SongMixer`` (scalar2s +
``scalar2s_synth.npz``; the DIF frontend's plain version and the cuDNN-path
trunk) against the JAX package's ``SongMixer``, the scalar2sL golden gains,
the smoothing and mask ops, the wire decodes, the short-song path, the
device epilogue and the catalogue driver.  Segments of 4 chunks keep every
trunk run small (``MixConfig(max_chunks=4)``)."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpumix.assets import load_checkpoint as jax_load_checkpoint
from tpumix.config import MixConfig as JaxMixConfig
from tpumix.config import preset as jax_preset
from tpumix.data.synthetic import make_synth_song
from tpumix.infer import mixer as jax_mixer
from tpumix.models.registry import build_model as jax_build_model
from tpumix.ops import smoothing as jax_smoothing
from tpumix_torch.assets import load_checkpoint
from tpumix_torch.config import MixConfig, preset
from tpumix_torch.data import wavio
from tpumix_torch.infer import mixer as port_mixer
from tpumix_torch.infer.catalog import mix_catalog
from tpumix_torch.infer.mixer import STEMS, SongMixer
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.ops import smoothing

SR = 44100
# window-0 gains of make_synth_song(123, 12 s) under scalar2sL_synth
# (tests/test_shipped_checkpoint.py:30)
GOLDEN_W0 = np.array([1.37790, 0.90633, 0.68260, 1.52530])


def _port(name, ckpt, mix_cfg, **kw):
    model = build_model(preset(name))
    model.load_state_dict(state_dict_from_jax(load_checkpoint(ckpt)))
    return SongMixer(model, preset(name), mix_cfg, device="cpu", **kw)


@pytest.fixture(scope="module")
def song():
    """~10 s synthetic song: 5 chunks of 2 s, 4 gains."""
    presented, _, _ = make_synth_song(5, duration_s=10.5)
    tracks = {s: np.stack([presented[s], presented[s]]) for s in STEMS}  # mono == stems
    return np.stack([presented[s] for s in STEMS]), tracks


@pytest.fixture(scope="module")
def mixer():
    return _port("scalar2s", "scalar2s_synth", MixConfig(max_chunks=4))


@pytest.fixture(scope="module")
def jax_song_mixer():
    cfg = jax_preset("scalar2s")
    return jax_mixer.SongMixer(jax_build_model(cfg), jax_load_checkpoint("scalar2s_synth"), cfg,
                               JaxMixConfig(max_chunks=4))


@pytest.fixture(scope="module")
def gains(mixer, song):
    return mixer.song_gains(song[0])


def test_gains_match_jax_mixer(gains, jax_song_mixer, song):
    ref = jax_song_mixer.song_gains(song[0])
    assert gains.shape == ref.shape == (4, 4)
    assert np.ptp(ref, axis=0).max() > 1e-3  # the heads respond to the song
    for i, s in enumerate(STEMS):
        mae = np.mean(np.abs(gains[:, i] - ref[:, i]))
        assert mae <= 1e-3, (s, mae)


def test_mix_song_smooth_matches_jax(mixer, jax_song_mixer, song, gains, monkeypatch):
    _, tracks = song
    mixed_j, raw_j, smooth_j = jax_song_mixer.mix_song_smooth(tracks)
    monkeypatch.setattr(mixer, "song_gains", lambda stems: gains)
    mixed, raw, smooth = mixer.mix_song_smooth(tracks)
    for s in STEMS:
        assert mixed[s].shape == tracks[s].shape
        np.testing.assert_allclose(smooth[s], smooth_j[s], rtol=3e-3)
        np.testing.assert_allclose(raw[s], raw_j[s], rtol=3e-3)
        peak = np.abs(mixed_j[s]).max()
        assert np.abs(mixed[s] - mixed_j[s]).max() / peak < 5e-3


def test_scalar2sL_golden_window0():
    presented, _, _ = make_synth_song(123, duration_s=12.0)
    stems = np.stack([presented[s] for s in STEMS])
    m = _port("scalar2sL", "scalar2sL_synth", MixConfig(max_chunks=1))
    g = m.song_gains(stems[:, : 2 * m.chunk_samples])  # window 0 only
    np.testing.assert_allclose(g[0], GOLDEN_W0, atol=2e-3)


def test_multi_segment_equals_single_segment(song, gains):
    m = _port("scalar2s", "scalar2s_synth", MixConfig(max_chunks=3))  # segments of 3 + 1
    np.testing.assert_allclose(m.song_gains(song[0]), gains, atol=1e-5)


def test_device_epilogue_matches_host(mixer, song, gains):
    stems, _ = song
    host_tracks, _, host_smooth = mixer._apply_gains(
        {s: stems[i] for i, s in enumerate(STEMS)}, stems.shape[1], gains
    )
    d_tracks, d_mix, d_smooth = mixer.mix_song_smooth_device(stems)
    np.testing.assert_allclose(d_smooth.numpy(), np.array([host_smooth[s] for s in STEMS]),
                               rtol=1e-4)
    for i, s in enumerate(STEMS):
        np.testing.assert_allclose(d_tracks[i].numpy(), host_tracks[s], rtol=1e-4, atol=1e-6)
    total = sum(host_tracks[s] for s in STEMS)
    np.testing.assert_allclose(d_mix.numpy(), total / np.abs(total).max(), atol=1e-5)
    np.testing.assert_allclose(mixer.mix_song_device(stems).numpy(), d_mix.numpy(), atol=1e-6)


def test_short_song_passes_through(mixer):
    C = mixer.chunk_samples
    stems = np.random.default_rng(0).standard_normal((4, C + C // 2)).astype(np.float32)
    assert mixer.song_gains(stems).shape == (0, 4)
    tracks = {s: stems[i] for i, s in enumerate(STEMS)}
    mixed, raw, smooth = mixer.mix_song_smooth(tracks)
    for s in STEMS:
        np.testing.assert_array_equal(mixed[s], tracks[s])
        assert raw[s] == [] and smooth[s] == []
    d_tracks, d_mix, d_smooth = mixer.mix_song_smooth_device(stems)
    np.testing.assert_array_equal(d_tracks.numpy(), stems)
    assert d_smooth.shape == (4, 0)
    total = stems.sum(axis=0)
    np.testing.assert_allclose(d_mix.numpy(), total / np.abs(total).max(), atol=1e-6)


def test_mix_song_raw_and_mix_song(mixer, song, gains, monkeypatch):
    stems, tracks = song
    monkeypatch.setattr(mixer, "song_gains", lambda s: gains)
    C = mixer.chunk_samples
    mixed, history = mixer.mix_song_raw(tracks)
    mono = stems
    amp = (10.0 ** (0.5 * gains)).astype(np.float32)
    np.testing.assert_allclose(mixed[:C], (mono[:, :C] * amp[0][:, None]).sum(0), rtol=1e-5, atol=1e-7)
    assert np.all(mixed[4 * C:] == 0)  # the last chunk has no gain
    assert len(history["bass"]) == 4
    total = mixer.mix_song(tracks)
    assert total.shape == tracks["bass"].shape and np.abs(total).max() == pytest.approx(1.0)
    assert len(mixer.mix_songs_smooth([tracks, tracks])) == 2


@pytest.mark.parametrize("fmt", ["int16", "int12", "mulaw8"])
def test_wire_decodes_match_jax(fmt):
    rng = np.random.default_rng(1)
    src = np.clip(0.3 * rng.standard_normal((4, 3000)), -1, 1).astype(np.float32)
    scales = None
    if fmt == "int16":
        wire = np.clip(np.rint(src * 32768.0), -32768, 32767).astype(np.int16)
    elif fmt == "int12":
        wire, scales = jax_mixer._pack_int12(src)
        ours, our_scales = port_mixer._pack_int12(src)
        np.testing.assert_array_equal(ours, wire)
        np.testing.assert_array_equal(our_scales, scales)
    else:
        np.testing.assert_array_equal(port_mixer._mulaw_lut(), jax_mixer._mulaw_lut())
        pcm = np.clip(np.rint(src * 32768.0), -32768, 32767).astype(np.int32)
        wire = jax_mixer._mulaw_lut()[pcm + 32768]
    ref = np.asarray(jax_mixer._dequantize_on_device(
        jnp.asarray(wire), None if scales is None else jnp.asarray(scales)))
    got = port_mixer._dequantize_on_device(
        torch.from_numpy(wire), None if scales is None else torch.from_numpy(scales))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-7)
    assert np.abs(got.numpy() - src).max() < {"int16": 1e-4, "int12": 2e-3, "mulaw8": 0.05}[fmt]


def test_int16_wire_through_the_mixer(song, gains):
    m = _port("scalar2s", "scalar2s_synth", MixConfig(max_chunks=4), transfer_dtype="int16")
    assert np.abs(m.song_gains(song[0]) - gains).mean() < 1e-3
    with pytest.raises(ValueError):
        SongMixer(m.model, preset("scalar2s"), transfer_dtype="int8", device="cpu")


@pytest.mark.parametrize("win,poly", [(3, 2), (5, 2), (7, 1), (9, 3)])
def test_smoothing_matches_jax(win, poly):
    y = np.random.default_rng(win).uniform(0.2, 3.0, (4, 23))
    ref = jax_smoothing.savgol_smooth(y, win, poly)
    np.testing.assert_allclose(smoothing.savgol_smooth(y, win, poly), ref, rtol=1e-12)
    yf = y.astype(np.float32)
    ref_dev = np.asarray(jax_smoothing.savgol_smooth_jax(jnp.asarray(yf), win, poly))
    got_dev = smoothing.savgol_smooth_torch(torch.from_numpy(yf), win, poly).numpy()
    np.testing.assert_allclose(got_dev, ref_dev, rtol=1e-5)
    np.testing.assert_allclose(got_dev, ref, rtol=1e-5)
    for n in (4, 17, 64):
        assert smoothing.default_savgol_window(n) == jax_smoothing.default_savgol_window(n)


@pytest.mark.parametrize("n,tgt", [(5, 23), (4, 40), (7, 7)])
def test_mask_stretch_matches_jax(n, tgt):
    m = np.random.default_rng(n).uniform(0, 2, (3, n)).astype(np.float32)
    ref = np.asarray(jax_smoothing.interpolate_mask(jnp.asarray(m), tgt))
    np.testing.assert_array_equal(smoothing.interpolate_mask(torch.from_numpy(m), tgt).numpy(), ref)
    np.testing.assert_array_equal(smoothing.interpolate_mask_np(m, tgt),
                                  jax_smoothing.interpolate_mask_np(m, tgt))


def test_savgol_window_policy_bends_to_short_curves(mixer):
    # curve length caps the window; the polyorder bends to the window
    assert mixer._savgol_params(num_chunks=40, n_gains=3) == (3, 2)
    assert mixer._savgol_params(num_chunks=40, n_gains=4) == (3, 2)
    assert mixer._savgol_params(num_chunks=40, n_gains=39) == (11, 2)


def test_catalog_writes_mixed_wavs(mixer, tmp_path, song, gains, monkeypatch):
    stems, _ = song
    for name in ("SongA", "SongB"):
        d = tmp_path / "data" / name / f"{name}_STEMS_JOINED"
        d.mkdir(parents=True)
        for i, s in enumerate(STEMS):
            wavio.write(str(d / f"{name}_STEM_{s.upper()}.wav"), np.stack([stems[i]] * 2).T, SR,
                        subtype="PCM_16")
    handles = []
    monkeypatch.setattr(mixer, "song_gains_async", lambda st: handles.append(st) or [(torch.from_numpy(gains), 4)])
    out = tmp_path / "out"
    written = mix_catalog(mixer, str(tmp_path / "data"), ["SongA", "SongB"], str(out), naive_sum=True)
    assert [os.path.basename(p) for p in written] == ["SongA_mixed.wav", "SongB_mixed.wav"]
    audio, sr = wavio.read(written[0])
    assert sr == SR and audio.shape == (stems.shape[1], 2) and np.isfinite(audio).all()
    assert np.abs(audio).max() == pytest.approx(1.0, abs=1e-6)
    assert (out / "SongB_sum.wav").exists() and len(handles) == 2


def test_mix_song_smooth_meets_the_reference_pipeline_directly():
    """The North star's contract held directly, not through the JAX
    ``SongMixer``: the port's CPU ``mix_song_smooth`` against
    ``reference_mix_song_smooth`` (the reference's chunk-by-chunk torch
    pipeline) on tests/test_infer.py:60-82's fixture — scalar1s from a flax
    init, a 14 s broadband song — with that test's bounds: dB-scalar gain MAE
    <= 1e-3 and relative amplitude <= 2e-3 per stem."""
    import jax

    from tpumix.models import MixingModelScalar1s as JaxScalar1s
    from tpumix.utils.reference_pipeline import build_torch_twin, reference_mix_song_smooth

    variables = JaxScalar1s().init(jax.random.key(0), np.zeros((1, 4, 1025, 87), np.float32),
                                   train=False)
    rng = np.random.default_rng(42)
    n = 14 * SR
    t = np.arange(n) / SR

    def shaped_noise(scale, smooth):
        x = rng.standard_normal(n)
        return scale * np.convolve(x, np.ones(smooth) / smooth, mode="same")

    song = {
        "bass": 0.4 * np.sin(2 * np.pi * 80 * t) + shaped_noise(0.1, 64),
        "drums": shaped_noise(0.3, 2) * (np.sin(2 * np.pi * 3 * t) > 0.3),
        "vocals": 0.3 * np.sin(2 * np.pi * 300 * t + np.sin(2 * np.pi * 2 * t))
        + shaped_noise(0.1, 16),
        "other": shaped_noise(0.2, 8),
    }
    song = {k: v.astype(np.float32) for k, v in song.items()}
    model = build_model(preset("scalar1s"))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    _, raw, _ = SongMixer(model, preset("scalar1s"), device="cpu").mix_song_smooth(song)
    twin = build_torch_twin(variables["params"], variables["batch_stats"])
    _, raw_ref, _ = reference_mix_song_smooth(twin, song, chunk_length=1.0, sr=SR, hop=512)
    for s in STEMS:
        a, b = np.asarray(raw[s]), np.asarray(raw_ref[s])
        assert a.shape == b.shape == (13,)
        mae = np.mean(np.abs(2 * np.log10(a) - 2 * np.log10(b)))
        assert mae <= 1e-3, (s, mae)
        assert np.mean(np.abs(a - b) / np.abs(b)) <= 2e-3, s
