"""The port's float32 frontends ``implementation="matmul"`` and ``"ct"``
(tpumix_torch/ops/stft.py) against the JAX package's (tpumix/ops/stft.py:
222-295), on tests/test_stft.py's signal, at that file's bounds (:62-86):
max < 0.2 dB (matmul) / 0.1 dB (ct), mean < 1e-4 dB, p99.9 < 5e-3 dB, each
against ``"fft"`` and against the JAX package's same formulation.  Both are
float32 sums, so the worst bins are those near the amin clamp, where a
product of another order lands elsewhere: on a 2 s signal the port's ``ct``
reaches 0.146 dB from float64 in such bins, the JAX ``ct`` 0.058 (measured
on the CPU), while the mean stays at 1e-5 dB.

Gradients through ``spectrogram_features`` (autograd here, ``jax.grad``
there) of ``sum(features**2)``: finite, and within 1e-3 of the largest JAX
gradient element everywhere (measured: 8.6e-5 relative for matmul, 2.5e-5
for ct).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.config import FrontendConfig as JaxFrontendConfig
from tpumix.ops.stft import ct_phase_frames as jax_ct_phase_frames
from tpumix.ops.stft import spectrogram_features as jax_features
from tpumix_torch.config import FrontendConfig, ct_applicable
from tpumix_torch.ops.stft import ct_phase_frames, spectrogram_features, stft_magnitude
from tpumix_torch.train.state import make_frontend_fn

MAX_DB = {"matmul": 0.2, "ct": 0.1}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def audio():
    """tests/test_stft.py's signal."""
    rng = np.random.default_rng(0)
    t = np.arange(44100) / 44100.0
    sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
    sig += 0.05 * rng.standard_normal(44100)
    return sig.astype(np.float32)


def _bounds(d, max_db):
    assert np.max(d) < max_db
    assert np.mean(d) < 1e-4
    assert np.quantile(d, 0.999) < 5e-3


@pytest.mark.parametrize("hop", [512, 1024])
@pytest.mark.parametrize("impl", ["matmul", "ct"])
def test_formulation_matches_fft_and_the_jax_formulation(audio, impl, hop):
    cfg = FrontendConfig(hop_length=hop, implementation=impl)
    assert cfg.resolved_implementation() == impl
    got = spectrogram_features(torch.from_numpy(audio), cfg).numpy()
    assert got.shape == (1025, 1 + 44100 // hop)
    fft = spectrogram_features(torch.from_numpy(audio),
                               FrontendConfig(hop_length=hop, implementation="fft")).numpy()
    _bounds(np.abs(got - fft), MAX_DB[impl])
    want = np.asarray(jax_features(jnp.asarray(audio),
                                   JaxFrontendConfig(hop_length=hop, implementation=impl)))
    _bounds(np.abs(got - want), MAX_DB[impl])


def test_ct_phase_frames_are_the_jax_packages(audio):
    cfg, jcfg = FrontendConfig(hop_length=512), JaxFrontendConfig(hop_length=512)
    x = np.stack([audio[:22050], audio[-22050:]])
    got, lead, T = ct_phase_frames(torch.from_numpy(x), cfg)
    want, jlead, jT = jax_ct_phase_frames(jnp.asarray(x), jcfg)
    assert (tuple(lead), T) == (tuple(jlead), jT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_ct_falls_back_to_matmul_where_it_does_not_apply():
    odd = FrontendConfig(hop_length=500, implementation="ct")
    assert not ct_applicable(odd) and ct_applicable(FrontendConfig(hop_length=512))
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(22050).astype(np.float32))
    ref = spectrogram_features(x, FrontendConfig(hop_length=500, implementation="matmul"))
    np.testing.assert_allclose(spectrogram_features(x, odd).numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("impl", ["matmul", "ct"])
def test_batched_and_gradient_matches_jax(impl):
    cfg = FrontendConfig(hop_length=512, implementation=impl)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 3, 44100)).astype(np.float32)
    assert spectrogram_features(torch.from_numpy(x), cfg).shape == (2, 3, 1025, 87)
    assert stft_magnitude(torch.from_numpy(x), cfg).shape == (2, 3, 87, 1025)
    one = x[0, 0, :22050]
    xt = torch.from_numpy(one.copy()).requires_grad_()
    torch.sum(make_frontend_fn(cfg)(xt) ** 2).backward()
    jcfg = JaxFrontendConfig(hop_length=512, implementation=impl)
    want = np.asarray(jax.grad(lambda v: jnp.sum(jax_features(v, jcfg) ** 2))(jnp.asarray(one)))
    got = xt.grad.numpy()
    assert np.isfinite(got).all()
    assert np.abs(got - want).max() <= 1e-3 * np.abs(want).max()
