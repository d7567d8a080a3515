"""The port's loudness meters and FIR filtering against the JAX package's:
``fir_from_biquads`` bit-equal, ``fft_filter`` on both branches (one FFT, and
overlap-save forced by a small ``block``) within 1e-5 of max|y|,
``integrated_loudness_torch`` within 0.02 LU of ``integrated_loudness_jax``
and within 0.1 LU of the host meter (tests/test_eval.py:129) on mono, stereo
and batched ``[4, 2, S]`` inputs, ``block_loudness_torch`` against
``block_loudness_jax``, silence and the channel limit, and the host meter
copy equal to the JAX package's."""

import numpy as np
import pytest
import torch

from tpumix.ops import iir as jax_iir
from tpumix.ops import loudness as jax_loudness
from tpumix_torch.ops import iir, loudness

SR = 44100


def _signal(shape, seed):
    """Noise with a level that changes every 1.5 s and a silent last
    second: both gates have blocks to remove."""
    rng = np.random.default_rng(seed)
    n = shape[-1]
    env = np.repeat(rng.uniform(0.002, 0.5, size=shape[:-1] + (n // 66150 + 1,)), 66150,
                    axis=-1)[..., :n]
    x = env * rng.standard_normal(shape)
    x[..., -SR:] = 0.0
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def sections():
    return list(loudness.k_weighting_coeffs(float(SR)))


def test_fir_from_biquads_bit_equal(sections):
    for fs in (44100.0, 48000.0):
        secs = list(loudness.k_weighting_coeffs(fs))
        np.testing.assert_array_equal(iir.fir_from_biquads(secs), jax_iir.fir_from_biquads(secs))
    np.testing.assert_array_equal(iir.fir_from_biquads(sections[:1], 4096),
                                  jax_iir.fir_from_biquads(sections[:1], 4096))


@pytest.mark.parametrize("block", [1 << 18, 1 << 15])
def test_fft_filter_matches_jax(sections, block):
    x = _signal((3, 120_000), seed=1)
    h = iir.fir_from_biquads(sections).astype(np.float32)
    ref = np.asarray(jax_iir.fft_filter(x, h, block=block))
    got = iir.fft_filter(torch.from_numpy(x), torch.from_numpy(h), block=block).numpy()
    assert got.shape == ref.shape == x.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def test_biquad_cascade_is_lfilter(sections):
    from scipy.signal import lfilter

    x = _signal((2, 30_000), seed=2)
    got = iir.biquad_cascade(torch.from_numpy(x), sections).numpy()
    ref = lfilter(*sections[1], lfilter(*sections[0], x.astype(np.float64), axis=-1), axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    one = iir.biquad(torch.from_numpy(x), *sections[0]).numpy()
    np.testing.assert_allclose(one, lfilter(*sections[0], x.astype(np.float64), axis=-1),
                               rtol=0, atol=1e-5 * np.abs(one).max())


@pytest.mark.parametrize("shape", [(SR * 6,), (2, SR * 6), (4, 2, SR * 6)],
                         ids=["mono", "stereo", "batched"])
def test_integrated_loudness_matches_jax_and_host(shape):
    x = _signal(shape, seed=len(shape))
    got = loudness.integrated_loudness_torch(torch.from_numpy(x), SR).numpy()
    ref = np.asarray(jax_loudness.integrated_loudness_jax(x, SR))
    assert got.shape == ref.shape == shape[:-2]
    np.testing.assert_allclose(got, ref, rtol=0, atol=0.02)
    rows = x.reshape(-1, *((1,) if x.ndim == 1 else x.shape[-2:-1]), x.shape[-1])
    host = np.array([loudness.integrated_loudness(r.T, SR) for r in rows]).reshape(shape[:-2])
    np.testing.assert_allclose(got, host, rtol=0, atol=0.1)


def test_silence_and_channel_limit():
    out = loudness.integrated_loudness_torch(torch.zeros(2, 2, SR), SR)
    assert out.shape == (2,) and bool(torch.isinf(out).all()) and bool((out < 0).all())
    with pytest.raises(ValueError, match="channels<=5"):
        loudness.integrated_loudness_torch(torch.zeros(6, SR), SR)
    with pytest.raises(ValueError, match="shorter"):
        loudness.integrated_loudness_torch(torch.zeros(1, SR // 4), SR)
    assert loudness.integrated_loudness(np.zeros(SR), SR) == -np.inf
    with pytest.raises(ValueError):
        loudness.integrated_loudness(np.zeros((SR, 6)), SR)


def test_block_loudness_matches_jax():
    """Within 0.02 LU on the blocks above the absolute gate (-70 LKFS).  Under
    it, both float32 meters read rounding: a block's energy is the
    difference of two much larger partial sums (1.2 LU apart between the two
    here, on a block that float64 puts at -73.6 LKFS); the gated meter drops
    such blocks."""
    x = _signal((3, SR * 4), seed=5)
    got = loudness.block_loudness_torch(torch.from_numpy(x), SR).numpy()
    ref = np.asarray(jax_loudness.block_loudness_jax(x, SR))
    assert got.shape == ref.shape == (3, 37)
    above = ref > -70.0
    assert 0 < (~above).sum() < above.sum()  # the silent second gives gated blocks
    np.testing.assert_allclose(got[above], ref[above], rtol=0, atol=0.02)


def test_host_meter_is_the_jax_packages():
    x = np.ascontiguousarray(_signal((2, SR * 5), seed=7).T)
    assert loudness.integrated_loudness(x, SR) == jax_loudness.integrated_loudness(x, SR)
    assert loudness.Meter(48000).integrated_loudness(x) == jax_loudness.Meter(
        48000).integrated_loudness(x)
    np.testing.assert_array_equal(loudness.k_weight(x, SR), jax_loudness.k_weight(x, SR))
    np.testing.assert_array_equal(loudness.normalize_loudness(x, -23.0, -20.0),
                                  jax_loudness.normalize_loudness(x, -23.0, -20.0))
