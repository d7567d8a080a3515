"""On-card smoke run of the PyTorch port (``tpumix_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpumix_torch/csrc``, holds each kernel against
its plain PyTorch version at the shapes of the main path, drives the main
path (``SongMixer`` on ``scalar2s`` + ``scalar2s_synth.npz``, then
``python -m tpumix_torch mix``) and checks what comes out.  It needs one
CUDA device and exits non-zero, printing no result, without one or outside a
checkout of the repository.  The last two lines are the ``{"kernels": ...}``
record and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SR = 44100


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_rates(name: str):
    """(FP32 FLOP/s, bytes/s, source) — NVIDIA data-sheet peaks of the part."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12, "H100 PCIe data sheet"
    if "NVL" in name:
        return 60.0e12, 3.9e12, "H100 NVL data sheet"
    return 67.0e12, 3.35e12, "H100 SXM data sheet"


def time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup``."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def bound_ms(flops: float, nbytes: float, rates) -> tuple:
    t_ops, t_bytes = flops / rates[0] * 1e3, nbytes / rates[1] * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def make_song(seconds: float, seed: int) -> np.ndarray:
    """``[4, S]`` seeded mono stems at the levels the shipped checkpoints were
    trained on: a bass tone with tremolo, decaying noise hits, a vibrato
    voice and band-limited noise, each at unit RMS over a -30 dB noise bed,
    presented at -26..-14 dB.  The last stem is silent over its final eighth
    (the frontend's amin clamp); one shared scale keeps the peak below 1."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n) / SR
    tau = 2 * np.pi

    def smooth(x, k):
        return np.convolve(x, np.ones(k) / k, mode="same")

    hits = np.exp(-np.mod(t / rng.uniform(0.3, 0.7), 1.0) * rng.uniform(8, 20))
    band = rng.standard_normal(n)
    raw = (
        np.sin(tau * rng.uniform(50, 120) * t) * (1 + 0.3 * np.sin(tau * 0.3 * t)),
        rng.standard_normal(n) * hits,
        np.sin(tau * rng.uniform(200, 500) * t + 3 * np.sin(tau * 5.5 * t))
        * (0.55 + 0.45 * np.sin(tau * 0.4 * t)),
        smooth(band, 8) - smooth(band, 64),
    )
    levels = rng.uniform(-26.0, -14.0, size=4)
    stems = np.empty((4, n), np.float32)
    for i, x in enumerate(raw):
        x = x / np.sqrt(np.mean(x * x)) + 10 ** (-30 / 20) * rng.standard_normal(n)
        stems[i] = x / np.sqrt(np.mean(x * x)) * 10 ** (levels[i] / 20)
    stems[3, n - n // 8:] = 0.0
    peak = float(np.abs(stems).max())
    return stems * (0.99 / peak) if peak > 0.99 else stems  # PCM16 headroom


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    name = torch.cuda.get_device_name(0)
    log(f"[device] {name} x{torch.cuda.device_count()}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  python {sys.version.split()[0]}")
    return name, smi


def phase_build():
    from tpumix_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {sorted(paths)} in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, path in sorted(paths.items()):
        with open(path[:-3] + ".log") as f:
            for line in f:
                if "registers" in line or "spill" in line:
                    log(f"[build] {name}: {line.strip()}")


def _k1_audio(tone: float, noise: float) -> np.ndarray:
    """``[64, 4, 88200]``: a tone per row over white noise; stem 3 silent."""
    rng = np.random.default_rng(1)
    t = np.arange(88200) / SR
    freqs = rng.uniform(40, 8000, size=(64, 4, 1))
    audio = tone * np.sin(2 * np.pi * freqs * t) + noise * rng.standard_normal((64, 4, t.size))
    audio[:, 3] = 0.0  # one silent stem: every bin clamps to amin
    return audio.astype(np.float32)


def _db_errors(got, ref):
    """max, mean and p99.9 |got - ref| over ``[..., T, F]`` features, and
    where the max sits: its reference value and its frame."""
    d = (got - ref).abs().flatten().cpu().numpy()
    i = int(d.argmax())
    where = (float(ref.flatten()[i]), i // ref.shape[-1] % ref.shape[-2])
    return float(d.max()), float(d.mean()), float(np.quantile(d, 0.999)), where


K1_LEVELS = (  # (label, tone amplitude, noise std) of the K1 checks
    ("tones 10 dB under noise", 0.03, 0.1),
    ("tones at noise", 0.1, 0.1),
    ("tones 10 dB over noise", 0.3, 0.1),
)


def phase_k1(rates):
    """K1 against its plain version, which computes the same function in
    float64: the difference is the kernel's own error.  For a float32 FFT
    its max sits in the deepest noise minima among the segment's 45M bins,
    where float32 rounding is a large share of the bin, and grows with the
    tone-to-noise ratio, so the bounds are held at every level of
    ``K1_LEVELS``.  float32 ``torch.stft`` against the same float64 version
    is printed beside it as the floor of a float32 FFT."""
    import torch

    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops.stft import amplitude_to_db, hann_window
    from tpumix_torch.ops.stft_dif import stft_features_dif, stft_features_dif_plain

    cfg = FrontendConfig(hop_length=512)
    B, S, T = 256, 88200, 173

    def library(x):
        spec = torch.stft(x.reshape(B, S), 2048, 512, window=hann_window(2048, device=x.device),
                          center=True, pad_mode="reflect", return_complex=True)
        return amplitude_to_db(spec.abs(), cfg.amin, cfg.db_multiplier).transpose(-1, -2)

    failed, held = [], 0.0
    for label, tone, noise in K1_LEVELS:
        x = torch.from_numpy(_k1_audio(tone, noise)).cuda()
        got = stft_features_dif(x, cfg)
        torch.cuda.synchronize()
        plain = stft_features_dif_plain(x, cfg)
        mx, mean, p999, at = _db_errors(got, plain)
        fmx, fmean, fp999, fat = _db_errors(library(x).reshape(plain.shape), plain)
        log(f"[k1] {label}: |kernel - plain (f64)| dB max {mx:.4e} (in a {at[0]:.1f} dB bin, "
            f"frame {at[1]}) mean {mean:.3e} p99.9 {p999:.3e}; |torch.stft (f32) - plain| dB max "
            f"{fmx:.4e} (in a {fat[0]:.1f} dB bin, frame {fat[1]}) mean {fmean:.3e} "
            f"p99.9 {fp999:.3e}")
        if not (mx < 0.1 and mean < 1e-4 and p999 < 5e-3):
            failed.append(label)
        if not bool(torch.isfinite(got).all()) or got.shape != (64, 4, T, 1025):
            raise AssertionError(f"K1 output bad: shape {tuple(got.shape)}")
        silent = got[:, 3]
        if not bool((silent == silent.flatten()[0]).all()):
            raise AssertionError("silent stem did not clamp to one amin value")
        held = max(held, mx)
        del got, plain
    if failed:
        raise AssertionError(f"K1 disagrees with its plain version: {failed}")
    x = torch.from_numpy(_k1_audio(0.1, 0.1)).cuda()
    # what the function needs, not what the kernel's design does: a real
    # 2048-point FFT (2.5 N log2 N), the window and |X|^2 per bin, against
    # the audio read once and the features written once; the flops at the
    # FP32 rate of the float32 function (the kernel's FP64 is its own choice)
    flops = B * T * (2.5 * 2048 * 11 + 2048 + 3 * 1025)
    nbytes = 4 * (B * S + B * T * 1025)
    b_ms, b_by = bound_ms(flops, nbytes, rates)
    ms = time_ms(lambda: stft_features_dif(x, cfg))
    plain_ms = time_ms(lambda: stft_features_dif_plain(x, cfg))
    lib_ms = time_ms(lambda: library(x))
    log(f"[k1] [64,4,88200] -> [64,4,173,1025]: kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  "
        f"torch.stft {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB)  {nbytes / ms / 1e6:.0f} GB/s, {ms / b_ms:.1f}x the bound")
    return {"name": "stft_features_dif", "route": "cuda",
            "source": "tpumix_torch/csrc/stft_dif.cu",
            "replaces": "tpumix/ops/stft_dif_pallas.py:318",
            "max_abs_err": held, "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": lib_ms}


# (x shape NHWC, w shape HWIO) of trunk blocks 2-5 for one 64-chunk scalar2s segment
TRUNK_SHAPES = (
    ((64, 511, 85, 16), (5, 5, 16, 32)),
    ((64, 507, 81, 32), (5, 5, 32, 48)),
    ((64, 503, 77, 48), (7, 7, 48, 64)),
    ((64, 497, 71, 64), (9, 9, 64, 128)),
)


def phase_k2(rates):
    import torch
    import torch.nn.functional as F

    from tpumix_torch.ops.conv_block import conv_block_fused, conv_block_fused_plain

    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    max_abs, bound_by = 0.0, set()
    g = torch.Generator(device="cuda").manual_seed(2)
    for xs, ws in TRUNK_SHAPES:
        cout = ws[-1]
        # activations O(1) and lecun-scaled weights, as in the trained trunk
        x = torch.randn(xs, device="cuda", generator=g)
        w = torch.randn(ws, device="cuda", generator=g) / float(np.sqrt(np.prod(ws[:3])))
        s = 0.5 + torch.rand(cout, device="cuda", generator=g)
        t = 0.1 * torch.randn(cout, device="cuda", generator=g)
        got = conv_block_fused(x, w, s, t)
        torch.cuda.synchronize()
        ref = conv_block_fused_plain(x, w, s, t)
        diff = (got - ref).abs()
        err = float(diff.max())
        ok = bool((diff <= 5e-5 + 1e-4 * ref.abs()).all())
        rel = float((diff / ref.abs().clamp_min(1e-6)).max())
        max_abs = max(max_abs, err)
        x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def library():  # cuDNN in float32 (TF32 off) + the epilogue
            y = F.conv2d(x_cl, w_oihw)
            return torch.relu_(y.mul_(s.view(1, -1, 1, 1)).add_(t.view(1, -1, 1, 1)))

        lib_err = float((got - library().permute(0, 2, 3, 1)).abs().max())
        ho, wo = xs[1] - ws[0] + 1, xs[2] - ws[1] + 1
        M, K = xs[0] * ho * wo, ws[0] * ws[1] * ws[2]
        flops = 2.0 * M * cout * K
        nbytes = 4.0 * (np.prod(xs) + np.prod(ws) + 2 * cout + M * cout)
        b_ms, b_by = bound_ms(flops, nbytes, rates)
        ms = time_ms(lambda: conv_block_fused(x, w, s, t), reps=10, warmup=1)
        plain_ms = time_ms(lambda: conv_block_fused_plain(x, w, s, t), reps=10, warmup=1)
        lib_ms = time_ms(library, reps=10, warmup=1)
        log(f"[k2] {xs} * {ws}: max abs {err:.3e} max rel {rel:.3e} within(rtol 1e-4, atol 5e-5) "
            f"{ok} (vs cuDNN f32: max abs {lib_err:.3e}); kernel {ms:.3f} ms  plain (f64) "
            f"{plain_ms:.3f} ms  cuDNN {lib_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by}; "
            f"{flops / 1e12:.3f} TFLOP)  {flops / ms / 1e9:.1f} TFLOP/s")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {xs} x {ws}")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms)):
            totals[key] += val
        bound_by.add(b_by)
        del x, got, ref, diff
    log(f"[k2] blocks 2-5 per segment: kernel {totals['ms']:.3f} ms  plain "
        f"{totals['plain_ms']:.3f} ms  cuDNN {totals['library_ms']:.3f} ms  bound "
        f"{totals['bound_ms']:.3f} ms")
    return {"name": "conv_block_fused", "route": "cuda",
            "source": "tpumix_torch/csrc/conv_block.cu",
            "replaces": "tpumix/ops/conv_block_pallas.py:445",
            "max_abs_err": max_abs, **totals,
            "bound_by": "operations" if bound_by == {"operations"} else "bytes"}


def _build_mixer(cfg, device, mix_cfg=None, transfer_dtype="float32"):
    from tpumix_torch.assets import load_checkpoint
    from tpumix_torch.infer.mixer import SongMixer
    from tpumix_torch.models.convert import state_dict_from_jax
    from tpumix_torch.models.registry import build_model

    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(load_checkpoint("scalar2s_synth")))
    return SongMixer(model, cfg, mix_cfg, transfer_dtype=transfer_dtype, device=device)


def phase_main_path():
    import torch

    from tpumix_torch.config import MixConfig, preset
    from tpumix_torch.infer.mixer import STEMS
    from tpumix_torch.ops.conv_block import conv_block_fused
    from tpumix_torch.ops.stft_dif import stft_features_dif

    cfg = preset("scalar2s")
    mixer = _build_mixer(cfg, "cuda")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is enabled on the mixer path")
    log("[main] TF32 off: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False")
    seconds = 300.0
    stems = make_song(seconds, seed=3)
    tracks = {t: np.stack([stems[i], stems[i]]) for i, t in enumerate(STEMS)}  # mono == stems
    C = mixer.chunk_samples
    mixer.song_gains(stems[:, : 3 * C])  # warm-up: cuDNN algorithm choice, allocator
    torch.cuda.synchronize()

    stft_features_dif.launches = 0
    conv_block_fused.launches = 0
    t0 = time.perf_counter()
    gains = mixer.song_gains(stems)
    t_gains = time.perf_counter() - t0
    t0 = time.perf_counter()
    mixed, raw, smooth = mixer.mix_song_smooth(tracks)
    t_mix = time.perf_counter() - t0
    t0 = time.perf_counter()
    d_tracks, d_mix, d_smooth = mixer.mix_song_smooth_device(stems)
    torch.cuda.synchronize()
    t_dev = time.perf_counter() - t0
    k1_launches, k2_xla = stft_features_dif.launches, conv_block_fused.launches
    log(f"[main] xla trunk: launches stft_features_dif {k1_launches} conv_block_fused {k2_xla}")
    if k1_launches <= 0:
        raise AssertionError("the main path did not launch the DIF kernel")

    n_chunks = stems.shape[1] // C
    if gains.shape != (n_chunks - 1, 4) or not np.isfinite(gains).all():
        raise AssertionError(f"bad gains {gains.shape}")
    for t in STEMS:
        if mixed[t].shape != tracks[t].shape or not np.isfinite(mixed[t]).all():
            raise AssertionError(f"bad mixed track {t}")
    d_mix = d_mix.cpu().numpy()
    if d_mix.shape != (stems.shape[1],) or not np.isfinite(d_mix).all():
        raise AssertionError("bad device mix")
    host_smooth = np.array([smooth[t] for t in STEMS])
    dev_gap = float(np.abs(d_smooth.cpu().numpy() - host_smooth).max() / np.abs(host_smooth).max())
    log(f"[main] scalar2s {seconds:.0f} s song ({n_chunks} chunks, {gains.shape[0]} gains): "
        f"gains-only {seconds / t_gains:.1f} audio-s/s ({t_gains:.3f} s), host-epilogue mix "
        f"{seconds / t_mix:.1f} audio-s/s ({t_mix:.3f} s), device mix {seconds / t_dev:.1f} "
        f"audio-s/s ({t_dev:.3f} s); device vs host smoothed curves: max rel gap {dev_gap:.2e}")
    if dev_gap > 1e-3:
        raise AssertionError("device epilogue disagrees with the host epilogue")

    wire = _build_mixer(cfg, "cuda", transfer_dtype="int16")
    g16 = wire.song_gains(stems)
    log(f"[main] int16 wire vs float32: gain MAE {np.abs(g16 - gains).mean():.2e}")
    if np.abs(g16 - gains).mean() > 1e-2:
        raise AssertionError("int16 wire gains drift")

    n_cpu = 10
    t0 = time.perf_counter()
    cpu = _build_mixer(cfg, "cpu", MixConfig(max_chunks=4))
    g_cpu = cpu.song_gains(stems[:, : n_cpu * C])
    mae = float(np.abs(gains[: n_cpu - 1] - g_cpu).mean())
    log(f"[main] cuda vs cpu ({n_cpu} chunks): dB-scalar gain MAE {mae:.3e} "
        f"(cpu {time.perf_counter() - t0:.1f} s)")
    if mae > 1e-3:
        raise AssertionError("cuda gains disagree with the CPU path")

    pcfg = dataclasses.replace(cfg, conv_impl="pallas")
    fused = _build_mixer(pcfg, "cuda")
    fused.song_gains(stems[:, : 3 * C])
    torch.cuda.synchronize()
    stft_features_dif.launches = 0
    conv_block_fused.launches = 0
    t0 = time.perf_counter()
    g_p = fused.song_gains(stems)
    t_p = time.perf_counter() - t0
    k1_p, k2_launches = stft_features_dif.launches, conv_block_fused.launches
    mae_p = float(np.abs(g_p - gains).mean())
    log(f"[main] conv_impl=pallas: launches stft_features_dif {k1_p} conv_block_fused "
        f"{k2_launches}; gain MAE vs cuDNN trunk {mae_p:.3e}; gains-only "
        f"{seconds / t_p:.1f} audio-s/s ({t_p:.3f} s)")
    if k2_launches <= 0 or k1_p <= 0:
        raise AssertionError("conv_impl='pallas' did not launch both kernels")
    if mae_p > 1e-3:
        raise AssertionError("fused trunk gains disagree with the cuDNN trunk")
    return {"stft_features_dif": k1_launches, "conv_block_fused": k2_launches}


def phase_breakdown():
    """Device time of each stage of one 64-chunk scalar2s segment (CUDA
    events, median of 5): wire decode + chunking, K1, the layout change,
    block 1, blocks 2-5 on cuDNN and on K2, the heads."""
    import torch

    from tpumix_torch.config import preset
    from tpumix_torch.infer.mixer import _dequantize_on_device
    from tpumix_torch.ops.stft_dif import stft_features_dif

    mixer = _build_mixer(preset("scalar2s"), "cuda")
    model, C = mixer.model, mixer.chunk_samples
    wire = torch.from_numpy(
        np.clip(np.rint(make_song(64 * 2.0, seed=4) * 32768), -32768, 32767).astype(np.int16)
    ).cuda()
    stages = {}
    with torch.inference_mode():
        def decode():
            return _dequantize_on_device(wire).reshape(4, 64, C).transpose(0, 1)

        x = decode()
        feats_tm = stft_features_dif(x, mixer.frontend)

        def layout():
            return feats_tm.permute(0, 3, 2, 1).contiguous().permute(0, 3, 1, 2)

        h = layout()
        stages["decode+chunk (int16)"] = time_ms(decode, reps=5)
        stages["K1 frontend"] = time_ms(lambda: stft_features_dif(x, mixer.frontend), reps=5)
        stages["layout [N,S,T,F]->channels_last"] = time_ms(layout, reps=5)
        stages["block 1 (cuDNN, s2 d2)"] = time_ms(lambda: model.conv_b1(h), reps=5)
        h = model.conv_b1(h)
        h1 = h
        t_cudnn, t_k2 = 0.0, 0.0
        for i in range(2, 6):
            blk = getattr(model, f"conv_b{i}")
            t_cudnn += time_ms(lambda: blk(h), reps=5)
            blk.conv_impl = "pallas"
            t_k2 += time_ms(lambda: blk(h), reps=5)
            blk.conv_impl = "xla"
            h = blk(h)
        stages["blocks 2-5 (cuDNN)"] = t_cudnn
        stages["blocks 2-5 (K2)"] = t_k2
        stages["4 heads"] = time_ms(
            lambda: torch.cat([getattr(model, f"head{i}")(h) for i in range(1, 5)], dim=-1), reps=5)
        torch.backends.cudnn.benchmark = True
        h = h1
        t_bench = 0.0
        for i in range(2, 6):
            blk = getattr(model, f"conv_b{i}")
            t_bench += time_ms(lambda: blk(h), reps=5)
            h = blk(h)
        torch.backends.cudnn.benchmark = False
        stages["blocks 2-5 (cuDNN, benchmark=True)"] = t_bench
    log("[time] one 64-chunk segment, device ms: " + "; ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))


def phase_cli():
    from tpumix_torch.data import wavio

    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        songs = ["SongA", "SongB"]
        for k, song in enumerate(songs):
            stems = make_song(9.0 + 3 * k, seed=10 + k)
            d = os.path.join(data, song, f"{song}_STEMS_JOINED")
            os.makedirs(d)
            for i, name in enumerate(("bass", "drums", "vocals", "other")):
                wavio.write(os.path.join(d, f"{song}_STEM_{name.upper()}.wav"),
                            np.stack([stems[i], stems[i]]).T, SR, subtype="PCM_16")
        with open(os.path.join(tmp, "songs.txt"), "w") as f:
            f.write("\n".join(songs) + "\n")
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        for flags, channels in ((["--transfer-dtype", "int16"], 2), (["--device-mix"], 1)):
            cmd = [sys.executable, "-m", "tpumix_torch", "mix", "--data", data, "--songlist",
                   os.path.join(tmp, "songs.txt"), "--out", out, *flags]
            t0 = time.perf_counter()
            res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                                 timeout=600)
            if res.returncode != 0:
                raise AssertionError(f"CLI failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
            for song in songs:
                audio, sr = wavio.read(os.path.join(out, f"{song}_mixed.wav"), always_2d=True)
                if (sr != SR or audio.shape[1] != channels or audio.shape[0] == 0
                        or not np.isfinite(audio).all()):
                    raise AssertionError(f"bad CLI output for {song} with {flags}")
            log(f"[cli] python -m tpumix_torch mix {' '.join(flags)}: {len(songs)} songs written "
                f"({channels} ch, finite) in {time.perf_counter() - t0:.1f} s")


def main() -> int:
    t_start = time.perf_counter()
    sys.path.insert(0, ROOT)
    name, smi = phase_device()
    import torch

    import tpumix_torch  # noqa: F401 — fails outside a checkout of the repository
    from tpumix_torch.utils.device import disable_tf32

    disable_tf32()  # the yardsticks run in full f32, like the port
    rates = peak_rates(name)
    log(f"[device] bounds from {rates[2]}: {rates[0] / 1e12:.1f} TFLOP/s FP32, "
        f"{rates[1] / 1e12:.2f} TB/s")
    phase_build()
    kernels = [phase_k1(rates), phase_k2(rates)]
    launches = phase_main_path()
    for k in kernels:
        k["launches"] = launches[k["name"]]
    phase_breakdown()
    phase_cli()
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
