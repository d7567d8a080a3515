"""The Differentiable Mixing Console (``preset("dmc_vggish")``) on the CPU at
its published widths, few tracks and chunks, against the plain reference
``tests/plain_dmc.py`` on seeded weights; and the routing of every conv
block of the port's models to the fused kernel K2.

Tolerances.  The program computes its frontend in float32 (a product over
792 resampler taps, a 512-point FFT, the mel product), the reference in
float64: the log-mel features differ by ~7e-6 on values of O(1), which the
encoder carries to ~1e-5 of each curve's scale in ``(a_L, a_R)``
(measured: 1.0e-5 amplitudes, 9.0e-6 smoothed curves, 1.3e-5 mix).  The
bound 1e-4 leaves ten times that; a segment boundary seen in the features
or a chunk or track out of place moves a curve by O(1) of its scale.
"""

import numpy as np
import plain_dmc
import pytest
import torch
import torch.nn as nn

from tpumix_torch.config import MixConfig, preset
from tpumix_torch.infer.mixer import SongMixer
from tpumix_torch.models.blocks import (
    K2_SIMT_FASTER,
    ConvBlock2d,
    ConvReLU2d,
    takes_fused_kernel,
)
from tpumix_torch.models.registry import build_model
from tpumix_torch.ops import vggish

TOL = 1e-4
C = vggish.CHUNK


def rel_err(got, ref) -> float:
    """Largest gap over each row's scale (the last axis), worst row."""
    got = np.asarray(got, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    assert got.shape == ref.shape
    got, ref = got.reshape(-1, got.shape[-1]), ref.reshape(-1, ref.shape[-1])
    return float((np.abs(got - ref).max(-1) / np.abs(ref).max(-1)).max())


@pytest.fixture(scope="module")
def dmc():
    """Seeded weights with the last layer calibrated on the song's first
    chunks (so the curves move with the audio), the model holding them, its
    mixer on the CPU with two-chunk segments, and a 5-track song of 5.3
    chunks (4 chunks with parameters)."""
    cfg = preset("dmc_vggish")
    model = build_model(cfg, generator=torch.Generator().manual_seed(17))
    rng = np.random.default_rng(3)
    levels = np.array([0.3, 0.05, 0.1, 0.2, 0.01])[:, None]
    x = (rng.standard_normal((5, int(5.3 * C))) * levels).astype(np.float32)
    x[1] *= np.linspace(0.2, 1.5, x.shape[1], dtype=np.float32)  # a fade: the curves move
    w = {k: v.clone() for k, v in model.state_dict().items()}
    examples = plain_dmc.examples(x)
    plain_dmc.calibrate(w, examples[:2])
    model.load_state_dict(w)
    mixer = SongMixer(model, cfg, mix_cfg=MixConfig(chunk_length_s=cfg.chunk_length_s,
                                                    max_chunks=2), device="cpu")
    return cfg, mixer, w, x, examples


def features(mixer, x, lo, n, seg):
    """The program's examples of chunks ``[lo, lo + n)`` of ``x`` in a
    ``seg``-chunk segment."""
    return vggish.segment_examples(mixer.segment_input(torch.from_numpy(x), lo, n, seg), seg)


@pytest.mark.parametrize("tracks", [1, 3, 5])
def test_model_matches_plain(dmc, tracks):
    """The first two chunks of the first ``tracks`` tracks: the program's
    frontend and model against the reference's (whose frontend is per
    track, so the 5-track song's examples serve every subset)."""
    _, mixer, w, x, examples = dmc
    ref = plain_dmc.amplitudes(w, examples[:2, :tracks])
    with torch.no_grad():
        got = mixer.model.gains(features(mixer, x[:tracks], 0, 2, 2))
    assert got.shape == (2, tracks, 2)
    # curves over chunks: rows (track, channel), the chunk axis last
    assert rel_err(got.permute(1, 2, 0), ref.permute(1, 2, 0)) < TOL


def test_permuting_tracks_permutes_outputs(dmc):
    """The context is a mean over the tracks: a permutation of the tracks
    permutes the outputs (up to the order of the mean's float32 sum)."""
    _, mixer, _, x, _ = dmc
    ex = features(mixer, x, 0, 2, 2)
    perm = torch.tensor([3, 0, 4, 1, 2])
    with torch.no_grad():
        a, b = mixer.model.gains(ex), mixer.model.gains(ex[:, perm])
    torch.testing.assert_close(b, a[:, perm], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("first,n", [(0, 2), (1, 2), (2, 2), (3, 1)])
def test_segment_with_halo_equals_whole_song(dmc, first, n):
    """Two-chunk segments (the last one padded), each from its slice of the
    song with the halo: their frames equal those of the whole song as one
    segment at and across the boundaries (the last frame of a chunk reads
    240 samples of the next), and the reference's.  The reference's
    frontend is float64: where a band's energy sits near the 0.01 floor of
    ``log(mel + 0.01)``, the program's float32 resampler (~2e-7 of the
    signal) moves a feature by up to ~4e-5."""
    _, mixer, _, x, examples = dmc
    whole = features(mixer, x, 0, 4, 4)
    part = mixer.segment_input(torch.from_numpy(x), first, n, 2)
    assert part.shape == (5, vggish.HALO_LEFT + 2 * C + vggish.HALO_RIGHT)
    seg = vggish.segment_examples(part, 2)[:n]
    torch.testing.assert_close(seg, whole[first:first + n], rtol=0, atol=1e-5)
    torch.testing.assert_close(seg, examples[first:first + n], rtol=0, atol=2e-4)


def test_mix_song_smooth_device_matches_plain(dmc):
    """Two-chunk segments through the mixer's entry, the second padded: the
    smoothed ``(a_L, a_R)`` and the peak-normalised stereo mix of 2 tracks
    of 4.3 chunks (3 with parameters)."""
    _, mixer, w, x, _ = dmc
    x = x[:2, :int(4.3 * C)]
    mixed_tracks, mixed, curves = mixer.mix_song_smooth_device(x)
    S = x.shape[-1]
    assert mixed_tracks.shape == (2, 2, S) and mixed.shape == (2, S)
    assert curves.shape == (2, 2, 3)
    ref_curves, ref_mix = plain_dmc.song(w, x)
    assert rel_err(curves, ref_curves) < TOL
    assert rel_err(mixed, ref_mix) < TOL
    assert rel_err(mixed_tracks.sum(0) / mixed_tracks.sum(0).abs().max(), ref_mix) < TOL
    # any track names, in their order
    named = mixer.mix_song_smooth_device({"kick": x[0], "bass": x[1]})
    torch.testing.assert_close(named[2], curves, rtol=0, atol=0)
    with pytest.raises(ValueError, match="mix_song_smooth_device"):
        mixer.song_gains(x)


def test_conv_relu_fused_path_is_same_conv():
    """K2's route for a VGGish block (its float64 plain version on the
    CPU): the 1-padded input with scale 1 and shift = bias is the SAME
    convolution + bias + ReLU."""
    torch.manual_seed(0)
    plain, fused = ConvReLU2d(8, 16, "xla"), ConvReLU2d(8, 16, "pallas")
    fused.load_state_dict(plain.state_dict())
    x = torch.randn(2, 8, 12, 10)
    with torch.no_grad():
        torch.testing.assert_close(fused(x), plain(x), rtol=1e-5, atol=1e-5)


def _decisions(model: nn.Module, conv_impl: str, route=None):
    """``takes_fused_kernel``'s choice for each conv block of ``model`` for an
    eval-mode float32 input on the card."""
    out = {}
    for name, m in model.named_modules():
        if isinstance(m, ConvBlock2d):
            conv = m.conv
        elif isinstance(m, ConvReLU2d):
            conv = m
        else:
            continue
        r = route(conv) if route else None
        out[name] = takes_fused_kernel(conv_impl, "cuda", False, False, conv.stride,
                                       conv.dilation, torch.float32, torch.float32,
                                       conv.in_channels, conv.out_channels, route=r)
    return out


def test_routing_of_every_block_is_pinned(dmc):
    """scalar2s: blocks 2-5 on K2 under "auto" and "pallas", block 1 (stride
    2, dilation 2) never; resnet18 has no block that asks (F.conv2d
    throughout); VGGish's conv1 (one input channel) never takes K2, conv2
    (the wgmma route) does, and its 256- and 512-channel blocks take the
    SIMT route only where it was timed faster than cuDNN."""
    scalar = build_model(preset("scalar2s"))
    want = {"conv_b1": False, "conv_b2": True, "conv_b3": True, "conv_b4": True,
            "conv_b5": True}
    assert _decisions(scalar, "auto") == want
    assert _decisions(scalar, "pallas") == want
    assert not any(_decisions(scalar, "xla").values())

    resnet = build_model(preset("resnet18"))
    assert _decisions(resnet, "auto") == {}
    assert {type(m) for m in resnet.modules() if isinstance(m, nn.Conv2d)} == {nn.Conv2d}

    dmc = dmc[1].model
    routes = {"conv1": "none", "conv2": "wgmma"}  # the launcher's, by shape

    def route(conv):
        name = next(n for n, m in dmc.encoder.named_children() if m is conv)
        return routes.get(name, "simt")

    got = _decisions(dmc, "auto", route)
    assert got == {f"encoder.{n}": n == "conv2" or (n != "conv1" and (
        getattr(dmc.encoder, n).in_channels, getattr(dmc.encoder, n).out_channels)
        in K2_SIMT_FASTER) for n in ("conv1", "conv2", "conv3_1", "conv3_2", "conv4_1",
                                     "conv4_2")}
    conv1 = [takes_fused_kernel("auto", "cuda", False, False, (1, 1), (1, 1), torch.float32,
                                torch.float32, 1, 64, route=r)
             for r in ("wgmma", "simt", "none", None)]
    conv1.append(takes_fused_kernel("pallas", "cuda", False, False, (1, 1), (1, 1),
                                    torch.float32, torch.float32, 1, 64, route="none"))
    assert not any(conv1)
