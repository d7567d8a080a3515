"""The port's inverse STFT and spectral reconstruction
(tpumix_torch/ops/istft.py) against the JAX package's (tpumix/ops/istft.py)
on the same complex spectra, and held to tests/test_experiments.py's four
``TestIstft`` properties (:91-129) on that file's stems: the round trip
within 1e-4 over the samples the frames cover, the other three within 1e-3.

Port against JAX: both are float32 ``irfft`` + window + overlap-add over
the same summed squared window, so they differ by float32 rounding of the
inverse FFT and the adds: atol 1e-5 on signals of unit scale.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.config import FrontendConfig as JaxFrontendConfig
from tpumix_torch.config import FrontendConfig
from tpumix_torch.ops.istft import (
    istft,
    mix_in_spectrogram_domain,
    reconstruct_from_magnitude,
    stft_complex,
)

# the module (``tpumix.ops`` exports a function of the same name)
jist = importlib.import_module("tpumix.ops.istft")
CFG, JCFG = FrontendConfig(hop_length=512), JaxFrontendConfig(hop_length=512)


@pytest.fixture(scope="module")
def stems():
    """tests/test_experiments.py's stems."""
    rng = np.random.default_rng(3)
    n = 44100
    t = np.arange(n) / 44100

    def shaped(scale, smooth):
        k = np.ones(smooth) / smooth
        return scale * np.convolve(rng.standard_normal(n), k, mode="same")

    return np.stack([
        0.3 * np.sin(2 * np.pi * 80 * t) + shaped(0.05, 32),
        shaped(0.25, 2),
        0.25 * np.sin(2 * np.pi * 330 * t) + shaped(0.05, 8),
        shaped(0.15, 4),
    ]).astype(np.float32)


def _specs(stems):
    return torch.stack([stft_complex(torch.from_numpy(s), CFG) for s in stems])


def _cover(spec):
    return (spec.shape[-2] - 1) * CFG.hop_length - CFG.n_fft // 2


def test_stft_complex_matches_jax(stems):
    got = stft_complex(torch.from_numpy(stems), CFG).numpy()
    want = np.asarray(jist.stft_complex(jnp.asarray(stems), JCFG))
    assert got.shape == want.shape == (4, 87, 1025)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("length", [None, 40000, 44100, 50000])
def test_istft_matches_jax_on_the_same_spectra(stems, length):
    spec = np.array(jist.stft_complex(jnp.asarray(stems), JCFG))
    got = istft(torch.from_numpy(spec), CFG, length=length).numpy()
    want = np.asarray(jist.istft(jnp.asarray(spec), JCFG, length=length))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_reconstruction_and_mixdown_match_jax(stems):
    spec = np.array(jist.stft_complex(jnp.asarray(stems), JCFG))
    mag, phase = np.abs(spec), np.angle(spec)
    got = reconstruct_from_magnitude(torch.from_numpy(mag), torch.from_numpy(phase), CFG,
                                     length=44100).numpy()
    want = np.asarray(jist.reconstruct_from_magnitude(jnp.asarray(mag), jnp.asarray(phase), JCFG,
                                                      length=44100))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    gains = np.array([0.5, 1.5, 1.0, 0.8], np.float32)
    got = mix_in_spectrogram_domain(torch.from_numpy(spec), torch.from_numpy(gains), CFG,
                                    length=44100).numpy()
    want = np.asarray(jist.mix_in_spectrogram_domain(jnp.asarray(spec), jnp.asarray(gains), JCFG,
                                                     length=44100))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_roundtrip(stems):
    spec = stft_complex(torch.from_numpy(stems[0]), CFG)
    y = istft(spec, CFG, length=stems.shape[1]).numpy()
    cover = _cover(spec)
    np.testing.assert_allclose(y[:cover], stems[0][:cover], atol=1e-4)


def test_mixture_reconstruction_from_stem_specs(stems):
    specs = _specs(stems)
    mixed = mix_in_spectrogram_domain(specs, torch.ones(4), CFG, length=stems.shape[1]).numpy()
    cover = _cover(specs)
    np.testing.assert_allclose(mixed[:cover], stems.sum(axis=0)[:cover], atol=1e-3)


def test_magnitude_plus_phase(stems):
    spec = stft_complex(torch.from_numpy(stems[1]), CFG)
    y = reconstruct_from_magnitude(spec.abs(), spec.angle(), CFG, length=stems.shape[1]).numpy()
    cover = _cover(spec)
    np.testing.assert_allclose(y[:cover], stems[1][:cover], atol=1e-3)


def test_gain_weighted_spectral_mixdown(stems):
    gains = torch.tensor([0.5, 1.5, 1.0, 0.8])
    specs = _specs(stems)
    mixed = mix_in_spectrogram_domain(specs, gains, CFG, length=stems.shape[1]).numpy()
    expected = (gains.numpy()[:, None] * stems).sum(axis=0)
    cover = _cover(specs)
    np.testing.assert_allclose(mixed[:cover], expected[:cover], atol=1e-3)
