"""The port's CUDA kernels against their plain versions, and the build and
binding layer around them.

The ``cuda`` tests need a card and skip without one; this file imports no
JAX so that they run where JAX is not installed:

    python -m pytest -m cuda --noconftest tests/test_torch_kernels.py

The other tests check, on any host, what the wrappers do before a launch:
the device dispatch, the build's cache key and the ctypes signatures.
"""

import ctypes

import numpy as np
import pytest
import torch

from tpumix_torch.config import FrontendConfig
from tpumix_torch.ops import _build
import dataclasses

from tpumix_torch.ops.conv_block import conv_block_fused, conv_block_fused_plain, fold_batchnorm
from tpumix_torch.ops.stft import spectrogram_features_tm
from tpumix_torch.ops.stft_basis import (
    stft_features_basis,
    stft_features_basis_plain,
    stft_features_tm_hybrid,
)
from tpumix_torch.ops.stft_ct import (
    stft_features_ct,
    stft_features_ct_plain,
    stft_features_ct_tm_hybrid,
)
from tpumix_torch.ops.stft_dif import (
    _dif_tables_f64,
    _kernel_tables,
    stft_features_dif,
    stft_features_dif_plain,
    stft_features_dif_tm_hybrid,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode): pytest -m cuda on the card")
    return torch.device("cuda")


def _audio(rows=3, seconds=2.0, seed=7, tone=0.03):
    rng = np.random.default_rng(seed)
    t = np.arange(int(44100 * seconds)) / 44100.0
    x = tone * np.sin(2 * np.pi * rng.uniform(40, 8000, (rows, 1)) * t)
    x = x + 0.1 * rng.standard_normal((rows, t.size))
    x[-1] = 0.0  # a silent row: the amin clamp
    return x.astype(np.float32)


def _block(xs, ws, seed=5):
    rng = np.random.default_rng(seed)
    cout = ws[-1]
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[:3]))).astype(np.float32)
    s, t = fold_batchnorm(*(torch.from_numpy(a.astype(np.float32)) for a in (
        0.1 * rng.standard_normal(cout), rng.uniform(0.5, 1.5, cout),
        0.1 * rng.standard_normal(cout), 0.1 * rng.standard_normal(cout),
        rng.uniform(0.5, 2.0, cout))), 1e-3)
    return torch.from_numpy(x), torch.from_numpy(w), s, t


# --- on the card -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [512, 1024])
@pytest.mark.parametrize("tone", [0.03, 0.1, 0.3])  # 10 dB under, at and over the noise
def test_dif_kernel_matches_plain(cuda_device, hop, tone):
    cfg = FrontendConfig(hop_length=hop)
    x = torch.from_numpy(_audio(tone=tone)).to(cuda_device)
    before = stft_features_dif.launches
    got = stft_features_dif(x, cfg)
    torch.cuda.synchronize()
    assert stft_features_dif.launches == before + 1
    assert got.shape == (3, 1 + x.shape[-1] // hop, 1025)
    d = (got - stft_features_dif_plain(x, cfg)).abs().cpu().numpy()
    assert d.max() < 0.1 and d.mean() < 1e-4 and np.quantile(d, 0.999) < 5e-3
    assert bool((got[-1] == got[-1].flatten()[0]).all())


# (wrapper, plain version, max-dB bound, hops) of the other two frontend kernels
FRONTENDS = {
    "basis": (stft_features_basis, stft_features_basis_plain, 0.2, (512, 8)),
    "ct": (stft_features_ct, stft_features_ct_plain, 0.1, (512, 64)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("tone", [0.03, 0.1, 0.3])  # 10 dB under, at and over the noise
@pytest.mark.parametrize("name,which", [("basis", 0), ("basis", 1), ("ct", 0), ("ct", 1)])
def test_frontend_kernel_matches_plain(cuda_device, name, which, tone):
    kernel, plain, max_db, hops = FRONTENDS[name]
    hop = hops[which]
    cfg = FrontendConfig(hop_length=hop)
    seconds = 2.0 if hop >= 64 else 0.1  # hop 8: 552 frames from 0.1 s
    x = torch.from_numpy(_audio(seconds=seconds, tone=tone)).to(cuda_device)
    before = kernel.launches
    got = kernel(x, cfg)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert got.shape == (3, 1 + x.shape[-1] // hop, 1025) and got.dtype == torch.float32
    d = (got - plain(x, cfg)).abs().cpu().numpy()
    assert d.max() < max_db and d.mean() < 1e-4 and np.quantile(d, 0.999) < 5e-3
    assert bool((got[-1] == got[-1].flatten()[0]).all())
    # a silent row is the same float32 from every frontend kernel
    silent = stft_features_dif(torch.zeros((1, 4096), device=cuda_device),
                               FrontendConfig(hop_length=512))
    assert float(got[-1].flatten()[0]) == float(silent.flatten()[0])
    # "auto" picks this kernel by itself where the DIF kernel does not apply
    if hop < 128:
        before = kernel.launches
        assert torch.equal(spectrogram_features_tm(x, cfg), got)
        assert kernel.launches == before + 1


@pytest.mark.cuda
def test_basis_kernel_takes_another_n_fft(cuda_device):
    cfg = FrontendConfig(n_fft=256, hop_length=32, sample_rate=8000, implementation="pallas")
    x = torch.from_numpy(_audio(rows=5, seconds=0.2)).to(cuda_device)
    got = stft_features_basis(x, cfg)
    assert got.shape == (5, 1 + x.shape[-1] // 32, 129)
    d = (got - stft_features_basis_plain(x, cfg)).abs()
    assert float(d.max()) < 1e-4


@pytest.mark.cuda
def test_frontend_kernels_reject_what_they_cannot_take(cuda_device):
    x = torch.zeros(8192, device=cuda_device)
    for kernel in (stft_features_basis, stft_features_ct):
        with pytest.raises(TypeError):
            kernel(x.double(), FrontendConfig(hop_length=512))
    with pytest.raises(ValueError, match="n_fft=2048"):
        stft_features_ct(x, FrontendConfig(n_fft=4096, hop_length=512))
    with pytest.raises(ValueError, match="n_fft % 16"):
        stft_features_basis(x, FrontendConfig(n_fft=40, hop_length=8))


@pytest.mark.cuda
@pytest.mark.parametrize("hybrid,kernel", [
    (stft_features_dif_tm_hybrid, stft_features_dif),
    (stft_features_ct_tm_hybrid, stft_features_ct),
    (stft_features_tm_hybrid, stft_features_basis),
])
def test_hybrid_is_kernel_forward_and_fft_backward(cuda_device, hybrid, kernel):
    cfg = FrontendConfig(hop_length=512)
    x0 = torch.from_numpy(_audio(rows=2, tone=0.1)).to(cuda_device)
    x0[-1] = x0[0].flip(-1)  # no silent row: its gradient is the clamp's zero
    weights = torch.randn((2, 173, 1025), device=cuda_device,
                          generator=torch.Generator(device=cuda_device).manual_seed(5))
    x = x0.clone().requires_grad_(True)
    before = kernel.launches
    y = hybrid(x, cfg)
    (y * weights).sum().backward()
    assert kernel.launches == before + 1  # none in the backward
    assert torch.equal(y.detach(), kernel(x0, cfg))
    xf = x0.clone().requires_grad_(True)
    fft_cfg = dataclasses.replace(cfg, implementation="fft")
    (spectrogram_features_tm(xf, fft_cfg) * weights).sum().backward()
    assert float((x.grad - xf.grad).abs().max()) <= 1e-6 * float(xf.grad.abs().max())


@pytest.mark.cuda
def test_dif_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros(8192, device=cuda_device)
    with pytest.raises(TypeError):
        stft_features_dif(x.double(), FrontendConfig(hop_length=512))
    with pytest.raises(ValueError):
        stft_features_dif(x, FrontendConfig(n_fft=4096, hop_length=512))


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ws", [
    ((2, 40, 30, 16), (5, 5, 16, 32)),
    ((1, 45, 25, 32), (5, 5, 32, 48)),
    ((1, 40, 22, 48), (7, 7, 48, 64)),
    ((1, 33, 21, 64), (9, 9, 64, 128)),
    ((3, 19, 9, 4), (3, 3, 4, 24)),
])
def test_conv_kernel_matches_plain(cuda_device, xs, ws):
    x, w, s, t = (v.to(cuda_device) for v in _block(xs, ws))
    before = conv_block_fused.launches
    got = conv_block_fused(x, w, s, t)
    torch.cuda.synchronize()
    assert conv_block_fused.launches == before + 1
    ref = conv_block_fused_plain(x, w, s, t)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=5e-5)
    # a channels_last NCHW tensor's NHWC view is taken as is
    cl = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(conv_block_fused(cl.permute(0, 2, 3, 1), w, s, t), got,
                               rtol=0, atol=0)


@pytest.mark.cuda
def test_conv_kernel_rejects_what_it_cannot_take(cuda_device):
    x = torch.zeros((1, 8, 8, 6), device=cuda_device)
    w = torch.zeros((3, 3, 6, 8), device=cuda_device)
    s = torch.ones(8, device=cuda_device)
    with pytest.raises(ValueError, match="divisible by 4"):
        conv_block_fused(x, w, s, s)
    with pytest.raises(TypeError):
        conv_block_fused(x.double(), w.double(), s.double(), s.double())
    with pytest.raises(ValueError, match="contiguous"):
        conv_block_fused(torch.zeros((1, 8, 8, 8), device=cuda_device).transpose(1, 2),
                         torch.zeros((3, 3, 8, 8), device=cuda_device), s, s)


# --- on any host -------------------------------------------------------------


def test_wrappers_take_the_plain_version_on_cpu():
    x = torch.from_numpy(_audio(rows=2, seconds=0.5))
    cfg = FrontendConfig(hop_length=512)
    before = stft_features_dif.launches
    torch.testing.assert_close(stft_features_dif(x, cfg), stft_features_dif_plain(x, cfg))
    xb, w, s, t = _block((1, 12, 11, 8), (3, 3, 8, 16))
    cbefore = conv_block_fused.launches
    torch.testing.assert_close(conv_block_fused(xb, w, s, t), conv_block_fused_plain(xb, w, s, t))
    assert stft_features_dif.launches == before and conv_block_fused.launches == cbefore
    for kernel, plain in ((stft_features_basis, stft_features_basis_plain),
                          (stft_features_ct, stft_features_ct_plain)):
        kbefore = kernel.launches
        torch.testing.assert_close(kernel(x, cfg), plain(x, cfg))
        assert kernel.launches == kbefore


def test_other_devices_raise():
    meta = torch.zeros((1, 12, 11, 8), device="meta")
    with pytest.raises(ValueError, match="CPU or CUDA"):
        conv_block_fused(meta, meta, meta, meta)
    for kernel in (stft_features_dif, stft_features_basis, stft_features_ct):
        with pytest.raises(ValueError, match="CPU or CUDA"):
            kernel(torch.zeros(4096, device="meta"), FrontendConfig(hop_length=512))


def test_kernel_tables_are_the_float64_tables_in_flat_order():
    flat = _kernel_tables("cpu")
    assert flat.dtype == torch.float64 and flat.shape == (2048 + 2 * 16 * 128 + 2 * 128,)
    w, twc, tws, c128, s128 = (torch.from_numpy(a) for a in _dif_tables_f64(2048)[:5])
    n = torch.arange(2048, dtype=torch.float64)
    torch.testing.assert_close(w, 0.5 - 0.5 * torch.cos(2 * np.pi * n / 2048), rtol=0, atol=1e-15)
    assert twc.shape == tws.shape == (16, 128)
    torch.testing.assert_close(flat, torch.cat([a.reshape(-1) for a in (w, twc, tws, c128, s128)]),
                               rtol=0, atol=0)
    # W_2048^(k1*n2) and W_128^m: rows k1 = 1 and the m = 32 quarter turn
    torch.testing.assert_close(twc[1, 64], torch.tensor(np.cos(np.pi / 16), dtype=torch.float64))
    assert float(s128[32]) == 1.0 and abs(float(c128[32])) < 1e-15


def test_stage_a_factors_elide_exact_zeros():
    *_, c16, s16 = _dif_tables_f64(2048)
    assert c16.shape == s16.shape == (16, 9)
    assert s16[:, 0].tolist() == [0.0] * 16 and s16[:, 8].tolist() == [0.0] * 16
    assert c16[1, 4] == 0.0 and c16[3, 4] == 0.0


def test_build_is_keyed_on_source_and_flags(tmp_path, monkeypatch):
    assert {"-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared"} <= set(_build.NVCC_FLAGS)
    a = _build.library_path("stft_dif")
    assert a != _build.library_path("conv_block")
    assert set(_build.SIGNATURES) == {"stft_dif", "conv_block", "stft_basis", "stft_ct"}
    (tmp_path / "stft_dif.cu").write_text("// changed source\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    b = _build.library_path("stft_dif")
    assert b != a
    (tmp_path / "dft_common.cuh").write_text("// a shared header is part of the key\n")
    assert _build.library_path("stft_dif") != b


def test_ctypes_signatures_pass_pointers_as_void_p():
    for name, (fn, argtypes) in _build.SIGNATURES.items():
        assert fn.endswith("_launch")
        assert argtypes[-1] is ctypes.c_void_p  # the stream
        assert argtypes[:2] == (ctypes.c_void_p, ctypes.c_void_p)  # first two tensors
