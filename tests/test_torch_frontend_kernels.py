"""The port's naive-basis (K3) and DIT (K4) frontends and the three
differentiable hybrids against the JAX package, on the CPU at ``n_fft=256``.

The plain torch versions — the CPU path of each wrapper, which repeat the
kernels' arithmetic in float64 — are held against ``stft_features_pallas_tm``
/ ``stft_features_ct_pallas_tm`` in interpret mode and against the numpy FFT
oracle, at the JAX kernels' own bounds (tests/test_stft.py:70-72,
tests/test_stft_ct_pallas.py:38-40): mean < 1e-4 dB, p99.9 < 5e-3 dB, max <
0.2 dB (K3) / 0.1 dB (K4).  The kernels themselves are held to the plain
versions on the card in tests/test_torch_kernels.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.config import FrontendConfig as JaxFrontendConfig
from tpumix.ops.stft import ct_applicable as jax_ct_applicable
from tpumix.ops.stft import spectrogram_features_np as jax_features_np
from tpumix.ops.stft_ct_pallas import stft_features_ct_pallas_tm, stft_features_ct_tm_hybrid
from tpumix.ops.stft_dif_pallas import dif_applicable as jax_dif_applicable
from tpumix.ops.stft_dif_pallas import stft_features_dif_tm_hybrid as jax_dif_hybrid
from tpumix.ops.stft_pallas import stft_features_pallas_tm, stft_features_tm_hybrid
from tpumix_torch.config import FrontendConfig, ct_applicable, dif_applicable
from tpumix_torch.ops import stft_basis, stft_ct, stft_dif
from tpumix_torch.ops.stft import (
    amplitude_to_db,
    spectrogram_features,
    spectrogram_features_tm,
    stft_magnitude,
)
from tpumix_torch.train.state import make_frontend_fn

SR = 8000
# (label, port wrapper, port plain version, JAX kernel, hop, max-dB bound)
KERNELS = {
    "basis": (stft_basis.stft_features_basis, stft_basis.stft_features_basis_plain,
              stft_features_pallas_tm, 128, 0.2),
    "ct": (stft_ct.stft_features_ct, stft_ct.stft_features_ct_plain,
           stft_features_ct_pallas_tm, 32, 0.1),
}


def _cfgs(hop, **kw):
    kw = dict(n_fft=256, hop_length=hop, sample_rate=SR, **kw)
    return FrontendConfig(**kw), JaxFrontendConfig(**kw)


def _bounds(d, max_db):
    assert d.max() < max_db
    assert d.mean() < 1e-4
    assert np.quantile(d, 0.999) < 5e-3


@pytest.fixture(scope="module")
def audio():
    rng = np.random.default_rng(11)
    t = np.arange(6000) / SR
    sig = 0.5 * np.sin(2 * np.pi * 440 * t) + 0.2 * np.sin(2 * np.pi * 97 * t)
    return (sig + 0.05 * rng.standard_normal((3, t.size))).astype(np.float32)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_matches_jax_kernel(audio, name):
    _, plain, jax_kernel, hop, max_db = KERNELS[name]
    cfg, jcfg = _cfgs(hop)
    ref = np.asarray(jax_kernel(jnp.asarray(audio), jcfg))
    got = plain(torch.from_numpy(audio), cfg).numpy()
    assert got.shape == ref.shape == (3, 1 + 6000 // hop, 129) and got.dtype == np.float32
    _bounds(np.abs(got - ref), max_db)


@pytest.mark.parametrize("hop", [8, 128])
def test_factorized_plain_matches_jax_kernel(audio, hop):
    """The factorization the CUDA kernel follows (256 = 16 x 16), in torch
    ops, against the JAX naive-basis kernel and the port's dense version."""
    cfg, jcfg = _cfgs(hop)
    x = audio[:, :1500] if hop == 8 else audio
    ref = np.asarray(stft_features_pallas_tm(jnp.asarray(x), jcfg))
    got = stft_basis.stft_features_basis_factorized_plain(torch.from_numpy(x), cfg).numpy()
    assert got.shape == ref.shape == (3, 1 + x.shape[-1] // hop, 129) and got.dtype == np.float32
    _bounds(np.abs(got - ref), 0.2)
    dense = stft_basis.stft_features_basis_plain(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, dense, rtol=0, atol=1e-5)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_plain_matches_numpy_oracle(audio, name):
    _, plain, _, hop, max_db = KERNELS[name]
    cfg, jcfg = _cfgs(hop)
    ref = np.swapaxes(jax_features_np(audio, jcfg), -1, -2)
    _bounds(np.abs(plain(torch.from_numpy(audio), cfg).numpy() - ref), max_db)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_float32_arithmetic_is_an_option_of_the_plain_version_only(audio, name):
    """``dtype=float32`` shows what the algorithm loses in single precision;
    the wrapper's CPU path is the float64 one."""
    wrapper, plain, _, hop, _ = KERNELS[name]
    cfg, _ = _cfgs(hop)
    x = torch.from_numpy(audio)
    f64, f32 = plain(x, cfg), plain(x, cfg, dtype=torch.float32)
    assert f32.dtype == torch.float32 and not torch.equal(f32, f64)
    assert float((f32 - f64).abs().max()) < 0.1
    assert torch.equal(wrapper(x, cfg), f64)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_silent_row_clamps_to_amin(name):
    wrapper, _, jax_kernel, hop, _ = KERNELS[name]
    cfg, jcfg = _cfgs(hop)
    x = np.zeros((2, 4000), np.float32)
    got = wrapper(torch.from_numpy(x), cfg).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_kernel(jnp.asarray(x), jcfg)), atol=1e-4)
    assert np.all(got == got.flat[0])
    np.testing.assert_allclose(got.flat[0], 20 * np.log10(cfg.amin), atol=1e-4)


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_leading_batch_dims(audio, name):
    wrapper, _, _, hop, _ = KERNELS[name]
    cfg, _ = _cfgs(hop)
    x = torch.from_numpy(np.stack([audio, 0.5 * audio]))  # [2, 3, S]
    out = wrapper(x, cfg)
    assert out.shape == (2, 3, 1 + 6000 // hop, 129)
    single = wrapper(torch.from_numpy(0.5 * audio[2]), cfg)
    np.testing.assert_allclose(out[1, 2].numpy(), single.numpy(), atol=1e-5)


def test_production_size_factorization_matches_oracle():
    """n_fft 2048 (16 x 128, the shape the CUDA kernels are built for) at
    hop 64 for the DIT frontend and hop 8 for the naive basis."""
    rng = np.random.default_rng(3)
    x = (0.1 * rng.standard_normal(6000)).astype(np.float32)
    for plain, hop, max_db in ((stft_ct.stft_features_ct_plain, 64, 0.1),
                               (stft_basis.stft_features_basis_plain, 8, 0.2)):
        ref = np.swapaxes(jax_features_np(x, JaxFrontendConfig(hop_length=hop)), -1, -2)
        got = plain(torch.from_numpy(x), FrontendConfig(hop_length=hop)).numpy()
        assert got.shape == ref.shape == (1 + 6000 // hop, 1025)
        _bounds(np.abs(got - ref), max_db)


def test_kernel_tables_are_shared_with_the_dif_kernel():
    """The DIT factorization's twiddle ``W_2048^(p*k2)`` is the ``[16, 128]``
    block of the DIF kernel's flat table, the kernel both entries launch."""
    _, twc, tws, _, _ = stft_ct._ct_tables_f64(2048)
    flat = stft_dif._kernel_tables("cpu").numpy()
    np.testing.assert_array_equal(flat[2048 : 2048 + 2048].reshape(16, 128), twc)
    np.testing.assert_array_equal(flat[4096 : 4096 + 2048].reshape(16, 128), tws)
    cosb, sinb = stft_basis._kernel_bases(256, "cpu")
    assert cosb.shape == sinb.shape == (256, 192) and cosb.dtype == torch.float64
    assert float(cosb[:, 129:].abs().max()) == 0.0 and float(sinb[:, 129:].abs().max()) == 0.0
    n = np.arange(256)
    w = 0.5 - 0.5 * np.cos(2 * np.pi * n / 256)
    np.testing.assert_allclose(cosb[:, 3].numpy(), w * np.cos(2 * np.pi * n * 3 / 256), atol=1e-15)
    np.testing.assert_allclose(sinb[:, 3].numpy(), -w * np.sin(2 * np.pi * n * 3 / 256), atol=1e-15)


@pytest.mark.parametrize("hop", [8, 32, 64, 128, 512, 1024])
def test_auto_resolves_in_the_jax_tpu_order(hop):
    """``"auto"`` equals tpumix's resolution on a TPU backend
    (tpumix/config.py:60-70) for every hop; the applicability predicates are
    the JAX package's."""
    cfg, jcfg = FrontendConfig(hop_length=hop), JaxFrontendConfig(hop_length=hop)
    assert dif_applicable(cfg) == jax_dif_applicable(jcfg)
    assert ct_applicable(cfg) == jax_ct_applicable(jcfg)
    expected = ("dif_pallas" if jax_dif_applicable(jcfg) else
                "ct_pallas" if jax_ct_applicable(jcfg) else
                "pallas" if jcfg.n_fft % hop == 0 else "fft")
    assert cfg.resolved_implementation() == expected
    assert expected == {8: "pallas", 32: "ct_pallas", 64: "ct_pallas", 128: "dif_pallas",
                        512: "dif_pallas", 1024: "dif_pallas"}[hop]


def test_spellings_and_formulations():
    # tpumix's own names, the XLA-level formulations included
    for impl in ("dif_pallas", "ct_pallas", "pallas", "fft", "matmul", "ct"):
        assert FrontendConfig(hop_length=512, implementation=impl).resolved_implementation() == impl
        assert (JaxFrontendConfig(hop_length=512, implementation=impl).resolved_implementation()
                == impl)
    assert FrontendConfig(hop_length=512, implementation="dif").resolved_implementation() == "dif_pallas"
    assert FrontendConfig(hop_length=500).resolved_implementation() == "fft"
    # "matmul" and "ct" are reached by the train step's differentiable frontend
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    for impl in ("matmul", "ct"):
        cfg = FrontendConfig(n_fft=256, hop_length=128, implementation=impl)
        np.testing.assert_array_equal(make_frontend_fn(cfg)(x).numpy(),
                                      spectrogram_features(x, cfg).numpy())
    with pytest.raises(ValueError, match="unknown frontend"):
        FrontendConfig(implementation="cufft").resolved_implementation()
    with pytest.raises(ValueError, match="ct_applicable"):
        stft_ct.stft_features_ct(torch.zeros(4096), FrontendConfig(hop_length=8))
    with pytest.raises(ValueError, match="n_fft % hop_length"):
        stft_basis.stft_features_basis(torch.zeros(4096), FrontendConfig(hop_length=500))


@pytest.mark.parametrize("impl,hop", [("pallas", 128), ("ct_pallas", 32), ("dif_pallas", 128)])
def test_stft_entry_points_route_each_spelling(audio, impl, hop):
    """``spectrogram_features{,_tm}`` and ``stft_magnitude`` reach the fused
    frontend a config names, as tpumix/ops/stft.py:298-397 does."""
    cfg, jcfg = _cfgs(hop, implementation=impl)
    wrapper = {"pallas": stft_basis.stft_features_basis, "ct_pallas": stft_ct.stft_features_ct,
               "dif_pallas": stft_dif.stft_features_dif}[impl]
    x = torch.from_numpy(audio)
    tm = spectrogram_features_tm(x, cfg)
    assert torch.equal(tm, wrapper(x, cfg))
    assert torch.equal(spectrogram_features(x, cfg), tm.transpose(-1, -2))
    np.testing.assert_allclose(amplitude_to_db(stft_magnitude(x, cfg), cfg.amin).numpy(),
                               tm.numpy(), atol=1e-3)
    from tpumix.ops.stft import spectrogram_features_tm as jax_tm

    _bounds(np.abs(tm.numpy() - np.asarray(jax_tm(jnp.asarray(audio), jcfg))), 0.2)


HYBRIDS = {
    "pallas": (stft_basis.stft_features_tm_hybrid, stft_basis.stft_features_basis,
               stft_features_tm_hybrid, 128),
    "ct_pallas": (stft_ct.stft_features_ct_tm_hybrid, stft_ct.stft_features_ct,
                  stft_features_ct_tm_hybrid, 32),
    "dif_pallas": (stft_dif.stft_features_dif_tm_hybrid, stft_dif.stft_features_dif,
                   jax_dif_hybrid, 128),
}


@pytest.mark.parametrize("impl", sorted(HYBRIDS))
def test_hybrid_forward_is_the_fused_frontend_and_gradient_matches_jax(audio, impl):
    """Forward: the wrapper's values, bit for bit.  Gradient with respect to
    the waveform: ``jax.grad`` through tpumix's hybrid of the same kernel,
    for one random cotangent.  Both backward passes are float32 FFT VJPs, so
    they agree to float32 rounding of a sum over 129 bins x ~4 frames:
    1e-4 of the largest gradient."""
    hybrid, wrapper, jax_hybrid, hop = HYBRIDS[impl]
    cfg, jcfg = _cfgs(hop, implementation=impl)
    x_np = audio[:2]
    weights = np.random.default_rng(5).standard_normal((2, 1 + 6000 // hop, 129)).astype(np.float32)

    x = torch.from_numpy(x_np).requires_grad_(True)
    y = hybrid(x, cfg)
    assert torch.equal(y.detach(), wrapper(torch.from_numpy(x_np), cfg))
    (y * torch.from_numpy(weights)).sum().backward()

    ref = np.asarray(jax.grad(lambda a: jnp.sum(jax_hybrid(a, jcfg) * weights))(jnp.asarray(x_np)))
    got = x.grad.numpy()
    assert np.isfinite(got).all() and np.abs(ref).max() > 1.0
    assert np.abs(got - ref).max() < 1e-4 * np.abs(ref).max()

    # and it is autograd's through the port's own "fft" path
    xf = torch.from_numpy(x_np).requires_grad_(True)
    fft_cfg = dataclasses.replace(cfg, implementation="fft")
    (spectrogram_features_tm(xf, fft_cfg) * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(got, xf.grad.numpy(), rtol=0, atol=1e-6 * np.abs(ref).max())


@pytest.mark.parametrize("impl,hop", [("pallas", 128), ("ct_pallas", 32), ("dif_pallas", 128),
                                      ("fft", 128)])
def test_make_frontend_fn_returns_the_configured_frontend(audio, impl, hop):
    """``[..., S] -> [..., F, T]`` from the hybrid the config names
    (tpumix/train/state.py:92-113); differentiable for every choice."""
    cfg, _ = _cfgs(hop, implementation=impl)
    x = torch.from_numpy(audio[:1]).requires_grad_(True)
    feats = make_frontend_fn(cfg)(x)
    assert feats.shape == (1, 129, 1 + 6000 // hop)
    assert torch.equal(feats.detach(), spectrogram_features(torch.from_numpy(audio[:1]), cfg))
    feats.sum().backward()
    assert torch.isfinite(x.grad).all() and float(x.grad.abs().max()) > 0
