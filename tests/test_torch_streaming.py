"""The port's ``StreamingMixer`` against the JAX package's: the same six seeded
one-second chunks pushed through both, unsmoothed and at alpha 0.35, mono
``[4, C]`` and ``[4, 2, C]``; streamed audio and gains within rtol 2e-4 /
atol 2e-5 (tests/test_streaming.py:54).  The model is the shipped one-second
artifact (``scalar1sL_synth``): its amplitude gains are O(1), as a mix's are,
where a random initialisation gives gains of up to 300 that scale the audio
(and the float32 noise of both frameworks' convolutions) with them.  Then the streaming contracts on the
port alone: the batched gains, the one-pole history, the click-free
boundary, reset, input validation and ``push_tracks``.  Each side shares one
segment-size-1 inner mixer over all its streams."""

import numpy as np
import pytest
import torch

from tpumix.config import MixConfig as JaxMixConfig
from tpumix.config import preset as jax_preset
from tpumix.infer.mixer import SongMixer as JaxSongMixer
from tpumix.infer.streaming import StreamingMixer as JaxStreamingMixer
from tpumix.assets import load_checkpoint as jax_load_checkpoint
from tpumix.models.registry import build_model as jax_build_model
from tpumix_torch.assets import load_checkpoint
from tpumix_torch.config import MixConfig, preset
from tpumix_torch.infer.mixer import STEMS, SongMixer
from tpumix_torch.infer.streaming import StreamingMixer
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model

SR = 44100
N_CHUNKS = 6
MODEL = "scalar1sL"


@pytest.fixture(scope="module")
def sides():
    """(jax model, variables, jax inner mixer), (port model, port inner mixer)."""
    cfg = jax_preset(MODEL)
    jmodel = jax_build_model(cfg)
    variables = jax_load_checkpoint(f"{MODEL}_synth")
    j_inner = JaxSongMixer(jmodel, variables, cfg, JaxMixConfig(chunk_length_s=1.0, max_chunks=1))
    model = build_model(preset(MODEL))
    model.load_state_dict(state_dict_from_jax(load_checkpoint(f"{MODEL}_synth")))
    inner = SongMixer(model, preset(MODEL), MixConfig(chunk_length_s=1.0, max_chunks=1),
                      device="cpu")
    return (jmodel, variables, j_inner), (model, inner)


@pytest.fixture(scope="module")
def chunks():
    rng = np.random.default_rng(7)
    C = SR
    t = np.arange(N_CHUNKS * C) / SR
    # a level change every chunk moves the gains, so smoothing is visible
    level = np.repeat(rng.uniform(0.3, 1.5, size=(4, N_CHUNKS)), C, axis=1)
    stems = level * np.stack([
        0.4 * np.sin(2 * np.pi * 80 * t) + 0.1 * rng.standard_normal(len(t)),
        0.3 * rng.standard_normal(len(t)),
        0.3 * np.sin(2 * np.pi * 300 * t) + 0.05 * rng.standard_normal(len(t)),
        0.2 * rng.standard_normal(len(t)),
    ])
    return [stems[:, i * C: (i + 1) * C].astype(np.float32) for i in range(N_CHUNKS)]


def _layout(chunk, layout):
    # stereo channels whose mean is the mono chunk: the same gains, a
    # different mix per channel
    return chunk if layout == "mono" else np.stack([1.5 * chunk, 0.5 * chunk], axis=1)


@pytest.fixture(scope="module")
def run(sides, chunks):
    """``run(side, alpha, layout)`` -> outputs and ``current_gains`` of one
    stream of all chunks, computed once per key."""
    (jmodel, variables, j_inner), (model, inner) = sides
    memo = {}

    def go(side, alpha, layout="mono"):
        key = (side, alpha, layout)
        if key not in memo:
            if side == "jax":
                sm = JaxStreamingMixer(jmodel, variables, jax_preset(MODEL),
                                       smoothing_alpha=alpha, inner_mixer=j_inner)
            else:
                sm = StreamingMixer(model, preset(MODEL), smoothing_alpha=alpha,
                                    inner_mixer=inner)
            outs, gains = [], []
            for c in chunks:
                outs.append(np.asarray(sm.push(_layout(c, layout))))
                gains.append(np.asarray(sm.current_gains))
            memo[key] = (np.stack(outs), np.stack(gains))
        return memo[key]

    return go


@pytest.mark.parametrize("layout", ["mono", "stereo"])
@pytest.mark.parametrize("alpha", [1.0, 0.35])
def test_streamed_audio_matches_jax(run, alpha, layout):
    out, gains = run("port", alpha, layout)
    j_out, j_gains = run("jax", alpha, layout)
    assert out.shape == j_out.shape == ((N_CHUNKS, SR) if layout == "mono" else (N_CHUNKS, 2, SR))
    np.testing.assert_allclose(gains, j_gains, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out, j_out, rtol=2e-4, atol=2e-5)
    assert np.ptp(gains, axis=0).max() > 1e-3  # the gains move with the levels


def test_unsmoothed_gains_are_the_batched_gains(sides, chunks, run):
    _, gains = run("port", 1.0)
    model, _ = sides[1]
    batched = SongMixer(model, preset(MODEL), MixConfig(chunk_length_s=1.0, max_chunks=4),
                        device="cpu")
    song = np.concatenate(chunks + [np.zeros_like(chunks[0])], axis=1)
    ref = 10.0 ** (0.5 * batched.song_gains(song))  # [n_chunks, 4] amplitude
    np.testing.assert_allclose(gains, ref, rtol=2e-4, atol=2e-5)


def test_one_pole_history(run):
    alpha = 0.35
    _, smooth = run("port", alpha)
    _, raw = run("port", 1.0)
    expect = raw[0]
    np.testing.assert_allclose(smooth[0], expect, rtol=1e-6)
    for k in range(1, N_CHUNKS):
        expect = (1 - alpha) * expect + alpha * raw[k]
        np.testing.assert_allclose(smooth[k], expect, rtol=1e-5)


def test_first_chunk_is_the_plain_weighted_sum(run, chunks):
    out, gains = run("port", 1.0)
    np.testing.assert_allclose(out[0], np.einsum("st,s->t", chunks[0], gains[0]),
                               rtol=1e-5, atol=1e-6)


def test_boundary_is_click_free(sides, chunks):
    model, inner = sides[1]
    sm = StreamingMixer(model, preset(MODEL), smoothing_alpha=0.35, inner_mixer=inner)
    # constant stems isolate the gain trajectory: any output step at the
    # boundary is a gain discontinuity
    const = np.ones_like(chunks[0]) * np.array([[0.2], [0.1], [0.15], [0.05]], np.float32)
    a = sm.push(const)
    b = sm.push(const * 0.2)  # level drop -> gains move
    boundary_jump = abs(float(b[0]) - float(a[-1]) * 0.2)
    interior = np.max(np.abs(np.diff(b[:100])))
    assert boundary_jump <= max(5 * interior, 1e-4)
    assert np.all(np.isfinite(b))


def test_multichannel_and_reset(sides, chunks, run):
    model, inner = sides[1]
    sm = StreamingMixer(model, preset(MODEL), smoothing_alpha=1.0, inner_mixer=inner)
    stereo = _layout(chunks[0], "stereo")
    assert sm.push(stereo).shape == (2, SR)
    g1 = sm.current_gains
    sm.reset()
    assert sm.current_gains is None
    sm.push(stereo)
    np.testing.assert_allclose(sm.current_gains, g1, rtol=1e-6)
    np.testing.assert_allclose(g1, run("port", 1.0)[1][0], rtol=1e-6)


def test_input_validation(sides, chunks):
    model, inner = sides[1]
    sm = StreamingMixer(model, preset(MODEL), inner_mixer=inner)
    with pytest.raises(ValueError):
        sm.push(chunks[0][:3])
    with pytest.raises(ValueError):
        sm.push(chunks[0][:, : SR // 2])
    with pytest.raises(ValueError):
        StreamingMixer(model, preset(MODEL), smoothing_alpha=0.0, inner_mixer=inner)
    seg4 = SongMixer(model, preset(MODEL), MixConfig(chunk_length_s=1.0, max_chunks=4),
                     device="cpu")
    with pytest.raises(ValueError, match="max_chunks=1"):
        StreamingMixer(model, preset(MODEL), inner_mixer=seg4)


def test_push_tracks_dict(sides, chunks, run):
    model, inner = sides[1]
    sm = StreamingMixer(model, preset(MODEL), smoothing_alpha=1.0, inner_mixer=inner)
    out = sm.push_tracks({t: chunks[0][i] for i, t in enumerate(STEMS)})
    np.testing.assert_array_equal(out, run("port", 1.0)[0][0])


def test_built_inner_mixer_is_segment_one_on_the_given_device(sides, monkeypatch):
    model, _ = sides[1]
    sm = StreamingMixer(model, preset(MODEL), device="cpu",
                        mix_cfg=MixConfig(chunk_length_s=1.0, max_chunks=8))
    assert sm._mixer.mix_cfg.max_chunks == 1 and sm._mixer.device == torch.device("cpu")
    assert sm.chunk_samples == SR
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingMixer(model, preset(MODEL))  # device=None is the card
