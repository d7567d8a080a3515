"""The port's DIF frontend (tpumix_torch/ops/stft_dif.py) against the JAX
package: the plain torch version — the CPU path of the K1 wrapper, which
repeats the kernel's factorization (frames through the reflect index map,
stage-A [16, 9] DFT, twiddle, stage-C [128, 128] DFT on the 9 series, the
mirror for the other bins) — vs ``stft_features_dif_pallas_tm`` in
interpret mode and vs the numpy FFT oracle.  Bounds are the JAX kernel's own
(tests/test_stft_dif_pallas.py:44-46): mean < 1e-4 dB, p99.9 < 5e-3, max
< 0.1.  The kernel itself is held to the plain version on the card in
tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpumix.config import FrontendConfig as JaxFrontendConfig
from tpumix.ops.stft import spectrogram_features_np as jax_features_np
from tpumix.ops.stft import spectrogram_features_tm as jax_features_tm
from tpumix.ops.stft_dif_pallas import stft_features_dif_pallas_tm
from tpumix_torch.config import FrontendConfig, dif_applicable
from tpumix_torch.ops.stft import (
    amplitude_to_db,
    hann_window,
    spectrogram_features,
    spectrogram_features_np,
    spectrogram_features_tm,
    stft_magnitude,
)
from tpumix_torch.ops.stft_dif import stft_features_dif, stft_features_dif_plain


def _bounds(d):
    assert d.max() < 0.1
    assert d.mean() < 1e-4
    assert np.quantile(d, 0.999) < 5e-3


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(7)
    t = np.arange(88200) / 44100.0
    sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
    sig += 0.05 * rng.standard_normal(t.size)
    return sig.astype(np.float32)


@pytest.mark.parametrize("hop", [128, 512, 1024])
def test_plain_matches_jax_dif_kernel(audio, hop):
    cfg = FrontendConfig(hop_length=hop)
    ref = np.asarray(stft_features_dif_pallas_tm(jnp.asarray(audio), JaxFrontendConfig(hop_length=hop)))
    got = stft_features_dif_plain(torch.from_numpy(audio), cfg).numpy()
    assert got.shape == ref.shape == (1 + 88200 // hop, 1025)
    _bounds(np.abs(got - ref))


@pytest.mark.parametrize("hop", [512, 1024])
def test_plain_matches_numpy_oracle(audio, hop):
    cfg = FrontendConfig(hop_length=hop)
    ref = np.swapaxes(jax_features_np(audio, JaxFrontendConfig(hop_length=hop)), -1, -2)
    got = stft_features_dif_plain(torch.from_numpy(audio), cfg).numpy()
    _bounds(np.abs(got - ref))
    # the port's numpy mirror is the JAX package's
    np.testing.assert_array_equal(
        spectrogram_features_np(audio, cfg), jax_features_np(audio, JaxFrontendConfig(hop_length=hop))
    )


@pytest.mark.parametrize("S", [1025, 1536, 2047, 4133])
@pytest.mark.parametrize("hop", [128, 512, 1024])
def test_plain_matches_jax_dif_kernel_where_the_padding_reaches_every_frame(audio, hop, S):
    """The plain version reads its frames through the reflect index map, not
    a padded copy: at lengths just over n_fft/2 nearly every frame takes
    the reflection, and it still matches the JAX kernel, which pads in XLA."""
    x = np.stack([audio[:S], audio[-S:]])
    cfg, jcfg = FrontendConfig(hop_length=hop), JaxFrontendConfig(hop_length=hop)
    ref = np.asarray(stft_features_dif_pallas_tm(jnp.asarray(x), jcfg))
    got = stft_features_dif_plain(torch.from_numpy(x), cfg).numpy()
    assert got.shape == ref.shape == (2, 1 + S // hop, 1025)
    _bounds(np.abs(got - ref))
    _bounds(np.abs(got - np.swapaxes(jax_features_np(x, jcfg), -1, -2)))


def test_wrapper_takes_plain_version_on_cpu(audio):
    cfg = FrontendConfig(hop_length=512)
    x = torch.from_numpy(audio)
    np.testing.assert_array_equal(stft_features_dif(x, cfg).numpy(),
                                  stft_features_dif_plain(x, cfg).numpy())


def test_leading_batch_dims(audio):
    cfg = FrontendConfig(hop_length=512)
    x = torch.from_numpy(np.stack([np.stack([audio, audio * 0.5])] * 3))  # [3, 2, S]
    out = stft_features_dif(x, cfg)
    assert out.shape == (3, 2, 173, 1025)
    single = stft_features_dif(torch.from_numpy(audio * 0.5), cfg)
    np.testing.assert_allclose(out[1, 1].numpy(), single.numpy(), atol=1e-5)


def test_silent_input_clamps_to_amin():
    cfg = FrontendConfig(hop_length=512)
    x = np.zeros((2, 22050), np.float32)
    got = stft_features_dif(torch.from_numpy(x), cfg).numpy()
    ref = np.asarray(stft_features_dif_pallas_tm(jnp.asarray(x), JaxFrontendConfig(hop_length=512)))
    np.testing.assert_allclose(got, ref, atol=1e-4)
    assert np.all(got == got.flat[0])
    np.testing.assert_allclose(got.flat[0], 20 * np.log10(cfg.amin), atol=1e-4)


def test_conjugate_symmetric_bins_of_a_pure_tone():
    """A tone on bin k = 16*k2 + k1 with k1 > 8 peaks in the right place:
    stage A's conjugate mirror and the natural-order write agree."""
    cfg = FrontendConfig(hop_length=512)
    k = 16 * 20 + 13
    t = np.arange(44100)
    x = np.sin(2 * np.pi * k * t / 2048).astype(np.float32)
    got = stft_features_dif(torch.from_numpy(x), cfg).numpy()
    assert np.all(got[2:-2].argmax(axis=-1) == k)


@pytest.mark.parametrize("hop", [512, 1024])
def test_fft_path_matches_jax_fft(audio, hop):
    x = np.stack([audio, audio[::-1].copy()])
    ref = np.asarray(jax_features_tm(jnp.asarray(x), JaxFrontendConfig(hop_length=hop, implementation="fft")))
    got = spectrogram_features_tm(torch.from_numpy(x), FrontendConfig(hop_length=hop, implementation="fft"))
    _bounds(np.abs(got.numpy() - ref))


def test_dispatch_and_layouts(audio):
    x = torch.from_numpy(audio)
    cfg = FrontendConfig(hop_length=512)
    assert cfg.resolved_implementation() == "dif_pallas"  # on every device
    tm = spectrogram_features_tm(x, cfg)
    np.testing.assert_array_equal(spectrogram_features(x, cfg).numpy(), tm.numpy().T)
    mag = stft_magnitude(x, cfg)
    np.testing.assert_allclose(
        amplitude_to_db(mag, cfg.amin, cfg.db_multiplier).numpy(), tm.numpy(), atol=1e-3
    )
    k = np.arange(2048)
    np.testing.assert_array_equal(hann_window(2048).numpy(),
                                  (0.5 - 0.5 * np.cos(2 * np.pi * k / 2048)).astype(np.float32))


def test_every_jax_frontend_spelling_resolves():
    # hop 64: DIF does not apply; the DIT kernel (K4) takes it, as the JAX
    # package's does on a TPU.  The XLA-level formulations "matmul" and "ct"
    # resolve to themselves on every device and "auto" never picks them.
    cfg = FrontendConfig(hop_length=64)
    assert not dif_applicable(cfg) and dif_applicable(FrontendConfig(hop_length=256))
    assert cfg.resolved_implementation() == "ct_pallas"
    assert FrontendConfig(hop_length=500).resolved_implementation() == "fft"
    assert FrontendConfig(implementation="ct_pallas").resolved_implementation() == "ct_pallas"
    for impl in ("matmul", "ct"):
        assert FrontendConfig(implementation=impl).resolved_implementation() == impl
        assert FrontendConfig(hop_length=500, implementation=impl).resolved_implementation() == impl
    with pytest.raises(ValueError):
        stft_features_dif(torch.zeros(4096), FrontendConfig(hop_length=500))
