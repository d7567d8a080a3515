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
import dataclasses

import torch.nn.functional as F

from tpumix_torch.ops import _build

from tpumix_torch.models.blocks import ConvBlock2d
from tpumix_torch.ops import stft_basis
from tpumix_torch.ops import stft_dif as stft_dif_module
from tpumix_torch.ops.conv_block import (
    K_CHUNK,
    conv_block_fused,
    conv_block_fused_packed,
    conv_block_fused_plain,
    conv_block_fused_tf32_emulated,
    conv_block_fused_undrained,
    conv_block_route,
    fold_batchnorm,
    pack_conv_weights,
    tf32_split,
)
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
    _output_map,
    _reflect_index,
    stft_features_dif,
    stft_features_dif_plain,
    stft_features_dif_tm_hybrid,
)
from tpumix_torch.ops.stft_dif import launch_kernel as dif_launch_kernel


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


EDGE_LENGTHS = (1025, 1536, 2047, 4133)  # reflect padding reaches every frame, or most


@pytest.mark.cuda
@pytest.mark.parametrize("S", EDGE_LENGTHS)
@pytest.mark.parametrize("entry,hop", [("dif", 128), ("dif", 512), ("dif", 1024), ("ct", 16),
                                       ("ct", 32), ("ct", 64)])
def test_frontend_kernel_at_edge_lengths(cuda_device, entry, hop, S):
    """Both entries launch the one DIF kernel, which reflects the index
    itself: held to each entry's own float64 plain version (the DIT entry to
    the DIT factorization) where the padding reaches most frames."""
    kernel, plain = {"dif": (stft_features_dif, stft_features_dif_plain),
                     "ct": (stft_features_ct, stft_features_ct_plain)}[entry]
    cfg = FrontendConfig(hop_length=hop)
    x = torch.from_numpy(_audio(rows=4, tone=0.3)[:, :S].copy()).to(cuda_device)
    counts = stft_features_dif.launches, stft_features_ct.launches
    got = kernel(x, cfg)
    torch.cuda.synchronize()
    assert (stft_features_dif.launches - counts[0], stft_features_ct.launches - counts[1]) == (
        (1, 0) if entry == "dif" else (0, 1))
    assert got.shape == (4, 1 + S // hop, 1025)
    d = (got - plain(x, cfg)).abs().cpu().numpy()
    assert d.max() <= 1e-5 and d.mean() < 1e-4 and np.quantile(d, 0.999) < 5e-3
    assert bool((got[-1] == -(100.0 - 2.0 ** -17)).all())  # the silent row's amin value


@pytest.mark.cuda
@pytest.mark.parametrize("hop", [64, 512])
def test_dif_kernel_stage_stops_launch(cuda_device, hop):
    """The measurement-only launches that stop after stage A or after C1
    run and write one finite value per block of 4 frames; the whole launch
    is the entry's; any other stop is refused."""
    cfg = FrontendConfig(hop_length=hop)
    x = torch.from_numpy(_audio(rows=3, seconds=0.5, tone=0.1)).to(cuda_device)
    ref = stft_features_dif_plain(x, cfg) if hop == 512 else stft_features_ct_plain(x, cfg)
    got = dif_launch_kernel(x, cfg, "stft_dif")
    assert float((got - ref).abs().max()) <= 1e-5
    blocks = 3 * -(-got.shape[1] // 4)
    for stages in (1, 2):
        part = dif_launch_kernel(x, cfg, "stft_dif", stages)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(part.reshape(-1)[:blocks]).all())
    for stages in (0, 4):
        with pytest.raises(RuntimeError, match="launch failed"):
            dif_launch_kernel(x, cfg, "stft_dif", stages)


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
    for kernel in (stft_features_dif, stft_features_ct):  # where F.pad(mode="reflect") refuses
        with pytest.raises(ValueError, match="more than 1024"):
            kernel(x[:1024], FrontendConfig(hop_length=512))
        with pytest.raises(ValueError, match="reflection"):
            kernel(x, FrontendConfig(hop_length=512, pad_mode="constant"))


@pytest.mark.cuda
@pytest.mark.parametrize("xs,ws", [
    ((2, 40, 30, 16), (5, 5, 16, 32)),
    ((1, 45, 25, 32), (5, 5, 32, 48)),
    ((1, 40, 22, 48), (7, 7, 48, 64)),
    ((1, 33, 21, 64), (9, 9, 64, 128)),
    ((3, 19, 9, 4), (3, 3, 4, 24)),
    ((2, 12, 11, 8), (1, 1, 8, 32)),  # one weight chunk per kernel row
    ((2, 30, 40, 8), (3, 3, 8, 64)),  # kernel rows of 24 values, padded to the chunk of 32
    ((1, 150, 140, 16), (3, 5, 16, 128)),  # tiles that wrap over several output rows
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


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(1200, 300), (4096, 1024), (256, 8), (8192, 2048),
                                       (16384, 4096)])  # the last: the dense route
@pytest.mark.parametrize("tone", [0.03, 0.3])
def test_basis_kernel_takes_other_frame_lengths(cuda_device, n_fft, hop, tone):
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, implementation="pallas")
    x = torch.from_numpy(_audio(seconds=0.1 if hop == 8 else 2.0, tone=tone)).to(cuda_device)
    before = stft_features_basis.launches
    got = stft_features_basis(x, cfg)
    torch.cuda.synchronize()
    assert stft_features_basis.launches == before + 1
    assert got.shape == (3, 1 + x.shape[-1] // hop, n_fft // 2 + 1)
    d = (got - stft_features_basis_plain(x, cfg)).abs().cpu().numpy()
    assert d.max() < 0.2 and d.mean() < 1e-4 and np.quantile(d, 0.999) < 5e-3
    assert bool((got[-1] == got[-1].flatten()[0]).all())
    assert torch.equal(got, stft_features_basis(x, cfg))  # one writer per bin: deterministic
    route = _build.load("stft_basis").stft_basis_route(n_fft)
    assert route == (0 if n_fft == 16384 else 1)


@pytest.mark.cuda
def test_conv_route_is_chosen_by_shape(cuda_device):
    for xs, ws in [((64, 511, 85, 16), (5, 5, 16, 32)), ((64, 507, 81, 32), (5, 5, 32, 48)),
                   ((64, 503, 77, 48), (7, 7, 48, 64)), ((64, 497, 71, 64), (9, 9, 64, 128)),
                   ((2, 40, 30, 16), (5, 5, 16, 32))]:
        assert conv_block_route(xs, ws) == "wgmma"
    assert conv_block_route((3, 19, 9, 4), (3, 3, 4, 24)) == "simt"  # Cin % 8
    assert conv_block_route((1, 20, 20, 16), (3, 3, 16, 40)) == "simt"  # Cout not a wgmma width
    assert conv_block_route((1, 8, 8, 6), (3, 3, 6, 8)) == "none"
    # the measurement-only entry runs the wgmma route alone
    x, w, s, t = (v.to(cuda_device) for v in _block((3, 19, 9, 4), (3, 3, 4, 24)))
    with pytest.raises(RuntimeError, match="launch failed"):
        conv_block_fused_undrained(x, pack_conv_weights(w, s, t))


@pytest.mark.cuda
def test_conv_kernel_drains_the_tensor_core_accumulators(cuda_device):
    """K = 5184: the drained kernel is inside the tolerance; left to
    accumulate by truncation over all of K it is several times further off."""
    x, w, s, t = (v.to(cuda_device) for v in _block((2, 140, 71, 64), (9, 9, 64, 128)))
    assert conv_block_route(tuple(x.shape), tuple(w.shape)) == "wgmma"
    ref = conv_block_fused_plain(x, w, s, t)
    packed = pack_conv_weights(w, s, t)
    got = conv_block_fused_packed(x, packed)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=1e-4, atol=5e-5)
    emulated = conv_block_fused_tf32_emulated(x, w, s, t)
    np.testing.assert_allclose(got.cpu().numpy(), emulated.cpu().numpy(), rtol=1e-4, atol=5e-5)
    drained = float((got - ref).abs().max())
    undrained = float((conv_block_fused_undrained(x, packed) - ref).abs().max())
    assert undrained > 3 * drained


# --- on any host -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", [64, 1])  # a mixer's segment; StreamingMixer's
def test_auto_trunk_is_k2_and_matches_xla(cuda_device, chunks):
    """``conv_impl="auto"`` on the card: blocks 2-5 of ``scalar2s`` launch
    K2, block 1 and the ``"xla"`` model none, and the gains agree with
    ``"xla"``'s at K2's tolerance.  Seeded weights: on random features the
    shipped checkpoints' heads give their biases alone."""
    from tpumix_torch.config import preset
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.utils.device import disable_tf32

    disable_tf32()
    cfg = preset("scalar2s")
    assert cfg.conv_impl == "auto"
    g = torch.Generator().manual_seed(chunks)
    x = (20.0 * torch.randn((chunks, 4, 1025, cfg.num_frames), generator=g) - 40.0).to(
        cuda_device).contiguous(memory_format=torch.channels_last)
    gains, launches = {}, {}
    for impl in ("auto", "xla"):
        model = build_model(dataclasses.replace(cfg, conv_impl=impl),
                            generator=torch.Generator().manual_seed(1))
        model = model.to(cuda_device, memory_format=torch.channels_last).eval()
        before = conv_block_fused.launches
        with torch.inference_mode():
            gains[impl] = model.gains(x).cpu()
        launches[impl] = conv_block_fused.launches - before
    assert launches == {"auto": 4, "xla": 0}
    assert gains["auto"].shape == (chunks, 4) and bool(gains["xla"].abs().max() > 0.1)
    np.testing.assert_allclose(gains["auto"].numpy(), gains["xla"].numpy(), rtol=1e-4, atol=5e-5)


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


@pytest.mark.parametrize("S", EDGE_LENGTHS)
@pytest.mark.parametrize("hop", [16, 64, 128, 512, 1024])
def test_reflect_index_map_is_centre_reflect_padding(S, hop):
    """The map the DIF kernel applies per load (and its plain version
    gathers with) reads the frames ``F.pad(mode="reflect")`` + unfold read."""
    x = torch.arange(S, dtype=torch.float64)[None]
    T = 1 + S // hop
    padded = F.pad(x[None], (1024, 1024), mode="reflect")[0]
    frames = padded.unfold(-1, 2048, hop)[:, :T]
    idx = _reflect_index(S, T, hop, 2048)
    assert idx.shape == (T, 2048) and int(idx.min()) >= 0 and int(idx.max()) <= S - 1
    assert torch.equal(x[:, idx], frames)


def _dif_kernel_writes():
    """``(bin, k1, k2)`` of every feature store of the DIF kernel's C2 stage,
    in the order csrc/stft_dif.cu issues them: unit (u, k1) holds X_k1[u +
    16v] for v = 0..7."""
    writes = []
    for u in range(16):
        for k1 in range(9):
            writes += [(16 * u + k1 + 256 * v, k1, u + 16 * v) for v in range(4)]
            if 1 <= k1 < 8:
                writes += [(1024 - 16 * u - k1 - 256 * v, k1, u + 16 * (v + 4)) for v in range(4)]
            elif k1 == 0 and u == 0:
                writes.append((1024, 0, 64))
    return writes


def test_dif_output_map_writes_every_bin_once():
    """9 series of 128 cover the 1025 onesided bins: each bin once, those
    with k1 = 9..15 from their conjugate mirror, and the kernel's stores
    are the plain version's map."""
    src = _output_map(2048)
    assert src.shape == (1025,) and len(set(src.tolist())) == 1025
    k1, k2 = src // 128, src % 128
    assert int(k1.max()) == 8
    assert int(k2[k1 == 0].max()) == 64 and int(k2[k1 == 8].max()) == 63
    k = torch.arange(1025)
    mirror = (k % 16) > 8
    assert torch.equal(k1[mirror], 16 - k[mirror] % 16)
    assert torch.equal(k2[mirror], 127 - k[mirror] // 16)
    writes = _dif_kernel_writes()
    assert sorted(b for b, _, _ in writes) == list(range(1025))
    assert all(int(src[b]) == 128 * s + t for b, s, t in writes)


@pytest.mark.parametrize("hop", [16, 32, 64])
def test_dif_factorization_matches_the_dit_plain_version_at_k4_hops(hop):
    """What the DIT entry launches on the card — the DIF factorization at a
    hop that is a multiple of 16 — is the DIT float64 plain version's
    function: the two float64 sums agree far inside the float32 rounding of
    the features, also where the padding reaches the frames."""
    cfg = FrontendConfig(hop_length=hop)
    x = torch.from_numpy(_audio(rows=3, seconds=0.1, tone=0.3))  # 4410 samples
    for S in (1025, 4410):
        dif = stft_dif_module._dif_db(x[:, :S], cfg).to(torch.float32)
        dit = stft_features_ct_plain(x[:, :S], cfg)
        assert dif.shape == dit.shape == (3, 1 + S // hop, 1025)
        assert float((dif - dit).abs().max()) <= 1e-5
        assert bool((dif[-1] == -100.0).all()) and torch.equal(dif[-1], dit[-1])  # the silent row


def test_dif_plain_refuses_what_reflect_padding_refuses():
    cfg = FrontendConfig(hop_length=512)
    with pytest.raises(ValueError, match="more than 1024"):
        stft_features_dif_plain(torch.zeros(1024), cfg)
    assert stft_features_dif_plain(torch.zeros(1025), cfg).shape == (3, 1025)
    with pytest.raises(ValueError, match="reflection"):
        stft_features_dif(torch.zeros(4096), FrontendConfig(hop_length=512, pad_mode="constant"))


def test_build_is_keyed_on_source_and_flags(tmp_path, monkeypatch):
    assert {"-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-shared"} <= set(_build.NVCC_FLAGS)
    a = _build.library_path("stft_dif")
    assert a != _build.library_path("conv_block")
    assert set(_build.SIGNATURES) == {"stft_dif", "conv_block", "stft_basis"}
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
    # conv_block_launch: x, w, packed w, scale, shift, out, 7 ints, stream
    assert _build.SIGNATURES["conv_block"][1] == (ctypes.c_void_p,) * 6 + (ctypes.c_int,) * 7 + (
        ctypes.c_void_p,)
    # stft_basis_launch: xp, out, table, cos basis, sin basis, then the geometry
    assert _build.SIGNATURES["stft_basis"][1][:5] == (ctypes.c_void_p,) * 5
    # stft_dif_launch: unpadded rows, out, table, B, T, S (64-bit), hop, scale, amin^2, stream
    dif = (ctypes.c_void_p,) * 3 + (ctypes.c_int,) * 2 + (ctypes.c_longlong, ctypes.c_int,
                                                          ctypes.c_float, ctypes.c_double)
    assert _build.SIGNATURES["stft_dif"][1] == dif + (ctypes.c_void_p,)
    assert set(_build.EXTRA_ENTRIES) <= set(_build.SIGNATURES)
    extra = {fn: argtypes for entries in _build.EXTRA_ENTRIES.values() for fn, argtypes in entries}
    assert set(extra) == {"conv_block_route", "conv_block_undrained_launch", "stft_basis_route",
                          "stft_dif_stages_launch"}
    # the same launch with the stage to stop after before the stream
    assert extra["stft_dif_stages_launch"] == dif + (ctypes.c_int, ctypes.c_void_p)
    assert extra["conv_block_route"] == (ctypes.c_int,) * 7  # N, H, W, Cin, kh, kw, Cout
    assert extra["stft_basis_route"] == (ctypes.c_int,)
    assert extra["conv_block_undrained_launch"] == _build.SIGNATURES["conv_block"][1]


# --- K2: weight packing, the 3xTF32 scheme, the module's cache ----------------


@pytest.mark.parametrize("ws", [(5, 5, 16, 32), (9, 9, 64, 128), (7, 7, 48, 64), (3, 3, 4, 24)])
def test_weight_packing_is_k_major_tf32_hi_and_lo(ws):
    _, w, s, t = _block((1, 12, 12, ws[2]), ws)
    packed = pack_conv_weights(w, s, t)
    kh, kw, cin, cout = ws
    row_k = kw * cin
    padded = -(-row_k // K_CHUNK) * K_CHUNK
    assert packed.hilo.shape == (2, cout, kh * padded) and packed.hilo.dtype == torch.float32
    assert packed.hilo.is_contiguous() and packed.w.is_contiguous()
    hilo = packed.hilo.reshape(2, cout, kh, padded)
    if padded > row_k:
        assert float(hilo[..., row_k:].abs().max()) == 0.0  # the padding multiplies by zero
    hi, lo = hilo[0, :, :, :row_k], hilo[1, :, :, :row_k]
    # [Cout, K] with k = (i, j, c): element (co, i, j*cin + c) is w[i, j, c, co]
    want = w.permute(3, 0, 1, 2).reshape(cout, kh, row_k)
    assert torch.equal(hi + lo, want)  # exact in float32
    assert bool((lo.abs() <= 2.0 ** -11 * want.abs()).all())
    assert int((hi.contiguous().view(torch.int32) & 0x1FFF).abs().max()) == 0  # TF32: 13 zero bits
    assert float(hi[5, 1, 2 * cin + 3]) == float(tf32_split(w[1, 2, 3, 5])[0])
    assert torch.equal(packed.scale, s) and torch.equal(packed.shift, t)


def test_tf32_split_rounds_to_nearest_ties_away():
    one = torch.tensor([1.0]).view(torch.int32)
    v = torch.cat([one + 0x0FFF, one + 0x1000, one + 0x1001]).view(torch.float32)
    v = torch.cat([v, -v[1:2]])  # the tie, negative: away from zero too
    hi, lo = tf32_split(v)
    want = torch.cat([one, one + 0x2000, one + 0x2000]).view(torch.float32)
    assert torch.equal(hi[:3], want) and float(hi[3]) == -float(want[1])
    assert torch.equal(hi + lo, v)
    inf = torch.tensor([float("inf"), -float("inf")])
    assert torch.equal(tf32_split(inf)[0], inf)


EMULATION_SHAPES = [
    ((2, 40, 30, 16), (5, 5, 16, 32)),
    ((1, 45, 25, 32), (5, 5, 32, 48)),
    ((1, 40, 22, 48), (7, 7, 48, 64)),
    ((1, 33, 21, 64), (9, 9, 64, 128)),
    ((3, 19, 9, 4), (3, 3, 4, 24)),
    ((1, 12, 12, 64), (9, 9, 64, 128)),  # K = 5184, block 5's
]


@pytest.mark.parametrize("xs,ws", EMULATION_SHAPES)
def test_three_tf32_passes_hold_the_kernel_tolerance(xs, ws):
    x, w, s, t = _block(xs, ws)
    ref = conv_block_fused_plain(x, w, s, t)
    got = conv_block_fused_tf32_emulated(x, w, s, t)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4, atol=5e-5)


def test_one_tf32_pass_misses_the_kernel_tolerance():
    x, w, s, t = _block((1, 12, 12, 64), (9, 9, 64, 128))
    ref = conv_block_fused_plain(x, w, s, t)
    one = conv_block_fused_tf32_emulated(x, w, s, t, passes=1)
    off = (one - ref).abs() > 5e-5 + 1e-4 * ref.abs()
    assert float(off.float().mean()) > 0.1  # not a stray element: plain TF32 is ~1e-3 off
    with pytest.raises(ValueError):
        conv_block_fused_tf32_emulated(x, w, s, t, passes=2)


def _fused_block(seed=0):
    torch.manual_seed(seed)
    blk = ConvBlock2d(8, 16, 3, conv_impl="pallas").eval()
    with torch.no_grad():
        blk.bn.running_mean.normal_(0, 0.1)
        blk.bn.running_var.uniform_(0.5, 2.0)
    return blk


def test_conv_block_keeps_its_packed_operands_until_something_changes():
    blk = _fused_block()
    x = torch.randn(2, 8, 10, 9).contiguous(memory_format=torch.channels_last)
    y0 = blk(x)
    packed = blk._packed
    assert packed is not None and torch.equal(blk(x), y0) and blk._packed is packed
    unfused = torch.relu(blk.bn(blk.conv(x)))
    torch.testing.assert_close(y0, unfused, rtol=1e-4, atol=5e-5)

    other = _fused_block(seed=1)
    blk.load_state_dict(other.state_dict())  # copies in place: the versions move
    y1 = blk(x)
    assert blk._packed is not packed and not torch.equal(y1, y0)
    torch.testing.assert_close(y1, other(x), rtol=0, atol=0)

    packed = blk._packed
    with torch.no_grad():
        blk.conv.weight.mul_(2.0)  # what an optimizer step does
    y2 = blk(x)
    assert blk._packed is not packed
    torch.testing.assert_close(y2, torch.relu(blk.bn(blk.conv(x))), rtol=1e-4, atol=5e-5)

    packed = blk._packed
    with torch.no_grad():
        blk.bn.running_var.add_(0.5)  # a buffer, not a parameter
    assert not torch.equal(blk(x), y2) and blk._packed is not packed
    packed = blk._packed
    blk.conv.weight.data = blk.conv.weight.data.clone()  # new storage (as a move to a device is)
    assert blk._fused_operands() is not packed


# --- K3: the factorization against the dense product ---------------------------


@pytest.mark.parametrize("n_fft,hop,a,r", [(256, 8, 2, 1), (1200, 300, 1, 75), (2048, 512, 2, 8),
                                           (4096, 1024, 3, 1)])
def test_factorized_plain_matches_dense_plain(n_fft, hop, a, r):
    assert stft_basis.factorization(n_fft) == (a, r)
    cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, sample_rate=8000)
    x = torch.from_numpy(_audio(rows=3, seconds=0.03 if hop == 8 else 0.25, tone=0.3))
    dense, _, T = stft_basis._dense_db(x, cfg, torch.float64)
    fact, _, _ = stft_basis._factorized_db(x, cfg)
    assert fact.dtype == torch.float64 and fact.shape == dense.shape == (3, T, n_fft // 2 + 1)
    # dB, before the rounding to float32.  Two float64 sums in different orders:
    # they agree to ~1e-14 dB in a typical bin, and to 1e-8 dB in the few bins
    # 90 dB under their frame's energy (reflect-padded edge frames), where the
    # 1e-16 rounding of the frame-sized terms is 1e-9 of what is left
    d = (fact - dense).abs()
    assert float(d.median()) < 1e-12 and float(d.max()) < 1e-7
    got = stft_basis.stft_features_basis_factorized_plain(x, cfg)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, stft_features_basis_plain(x, cfg), rtol=0, atol=1e-5)
    assert bool((got[-1] == got[-1].flatten()[0]).all())  # the silent row clamps to amin


@pytest.mark.parametrize("n_fft", [16, 48, 256, 1200, 2048, 4096, 8192])
def test_factorized_output_map_writes_every_bin_once(n_fft):
    a, r = stft_basis.factorization(n_fft)
    bins, keep = stft_basis._output_map(n_fft)
    assert bins.shape == keep.shape == (n_fft // r, r)
    assert sorted(bins[keep].tolist()) == list(range(n_fft // 2 + 1))
    top = np.arange(n_fft // r) // 16 ** (a - 1)
    assert not keep[top > 8].any()  # the real input's other half is never computed
    # subsequence idx holds the bins congruent to its reversed digits mod 16^a
    assert bins[1, 0] == 16 ** (a - 1) and (a < 2 or bins[16, 0] == 16 ** (a - 2))


def test_basis_kernel_tables_are_the_float64_tables_in_flat_order():
    n = 1200
    flat = stft_basis._kernel_tables(n, "cpu")
    assert flat.dtype == torch.float64 and flat.shape == (3 * n,)
    e = torch.arange(n, dtype=torch.float64)
    torch.testing.assert_close(flat[:n], 0.5 - 0.5 * torch.cos(2 * np.pi * e / n), rtol=0, atol=1e-15)
    tw = flat[n:].reshape(n, 2)  # interleaved (cos, sin): one 16-byte load per twiddle
    torch.testing.assert_close(tw[:, 0], torch.cos(2 * np.pi * e / n), rtol=0, atol=1e-15)
    torch.testing.assert_close(tw[:, 1], torch.sin(2 * np.pi * e / n), rtol=0, atol=1e-15)
    assert float(tw[0, 0]) == 1.0 and float(tw[0, 1]) == 0.0
    assert abs(float(tw[n // 4, 0])) < 1e-15 and float(tw[n // 4, 1]) == 1.0
    # the tail's W_r^j is every (n / r)-th entry: r = 75 -> W_75^1 = tw[16]
    np.testing.assert_allclose(tw[16].numpy(), [np.cos(2 * np.pi / 75), np.sin(2 * np.pi / 75)],
                               atol=1e-15)
