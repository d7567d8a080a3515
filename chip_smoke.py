"""On-card smoke run of the PyTorch port (``tpumix_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from ``tpumix_torch/csrc``, holds each kernel against
its plain PyTorch version at the shapes of the main paths, and drives those
paths at the full width of ``scalar2s``: mixing (``SongMixer`` with
``scalar2s_synth.npz``, then ``python -m tpumix_torch mix``), training
(``python -m tpumix_torch train`` / ``export-checkpoint`` on a seeded corpus,
from the host loader and from the device corpus, then ``Trainer`` with each
fused frontend), synthetic training at the width of ``scalar2sL`` (the
generator on the card against the CPU, ``synth-data``, ``train-synth`` with
the gain objective, its export mixing), the HTTP service (``scalar2s``
and ``resnet18``: ``/gains``, ``/mix``, ``/stream``; ``python -m tpumix_torch
serve``), evaluation (``evaluate`` with the device and the host loudness
meter), the study paths (the ``khgemm`` / ``khgemm_int8`` trunks beside cuDNN
and K2, the ``"matmul"`` / ``"ct"`` frontends, ``istft``, a ``torch.profiler``
trace) and the parallel train steps (``dp``, and ``dp x sp`` with the frame
axis split), and checks what comes out.  It
needs one CUDA device and exits non-zero, printing no result, without one or
outside a checkout of the repository.  The last two lines are the
``{"kernels": ...}`` record and ``{"ok": true, "device": ...}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import re
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
    """(FP32 FLOP/s, bytes/s, source, dense TF32 tensor FLOP/s, FP64 FLOP/s
    outside the tensor cores) — NVIDIA data-sheet peaks of the part."""
    if "PCIe" in name:
        return 51.2e12, 2.0e12, "H100 PCIe data sheet", 378e12, 25.6e12
    if "NVL" in name:
        return 60.0e12, 3.9e12, "H100 NVL data sheet", 417.5e12, 30.0e12
    return 67.0e12, 3.35e12, "H100 SXM data sheet", 495e12, 34.0e12


def time_ms(fn, reps: int = 10, warmup: int = 2, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn()`` after ``warmup``,
    each over ``inner`` calls back to back (per call): a call shorter than
    the host's work to issue it needs several, or the events time the host."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return float(np.median(times))


def clocks_under_load(fn, launches: int = 80) -> str:
    """Run ``fn`` ``launches`` times back to back while sampling the card's SM
    clock and power draw (``nvidia-smi``, every 0.2 s); returns the per-launch
    time and the samples' range.  A kernel that holds the card at its power
    limit runs at a lowered clock, under the data sheet's rates."""
    import threading

    import torch

    samples, done = [], threading.Event()

    def sample():
        query = ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,power.limit",
                 "--format=csv,noheader,nounits"]
        while not done.is_set():
            out = subprocess.run(query, capture_output=True, text=True, timeout=60).stdout
            samples.append([float(v) for v in out.strip().splitlines()[0].split(",")])
            done.wait(0.2)

    fn()
    torch.cuda.synchronize()
    thread = threading.Thread(target=sample)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    thread.start()
    try:
        a.record()
        for _ in range(launches):
            fn()
        b.record()
        b.synchronize()
    finally:
        done.set()
        thread.join()
    arr = np.array(samples[1:] or samples)  # the first sample may precede the load
    return (f"{a.elapsed_time(b) / launches:.3f} ms per launch over {launches} launches; SM clock "
            f"{arr[:, 0].min():.0f}-{arr[:, 0].max():.0f} MHz (median {np.median(arr[:, 0]):.0f}, "
            f"max {arr[0, 1]:.0f}); power {arr[:, 2].min():.0f}-{arr[:, 2].max():.0f} W of "
            f"{arr[0, 3]:.0f} W ({len(arr)} samples)")


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


def _kernel_name(mangled: str) -> str:
    """``dif_kernel<4,128,1,3>`` for a mangled kernel name with its template
    arguments."""
    m = re.search(r"([A-Za-z_]*kernel)((?:I(?:L[ib]\d+E)+E)?)", mangled)
    if m is None:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2))
    return f"{m.group(1)}<{','.join(args)}>" if args else m.group(1)


def ptxas_report(log_path: str) -> list:
    """``(kernel, registers, spill store bytes, spill load bytes)`` of each
    kernel function in an ``nvcc -Xptxas -v`` log."""
    rows, fn, spills = [], None, (0, 0)
    with open(log_path) as f:
        for line in f:
            m = re.search(r"Function properties for (\S+)", line)
            if m:
                fn = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                spills = (int(m.group(1)), int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn is not None:
                rows.append((_kernel_name(fn), int(m.group(1)), *spills))
                fn, spills = None, (0, 0)
    return rows


def phase_build():
    from tpumix_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build()
    log(f"[build] {sorted(paths)} in {time.perf_counter() - t0:.1f} s (parallel nvcc)")
    for name, path in sorted(paths.items()):
        for fn, regs, st, ld in ptxas_report(path[:-3] + ".log"):
            log(f"[build] {name}: {fn}: {regs} registers, spill stores {st} B, spill loads {ld} B")


@functools.lru_cache(maxsize=2)
def _k1_parts(samples: int):
    """The unit tones and the white noise of ``_k1_audio``, drawn once per
    length (float64, ``[64, 4, samples]`` each)."""
    rng = np.random.default_rng(1)
    t = np.arange(samples) / SR
    freqs = rng.uniform(40, 8000, size=(64, 4, 1))
    return np.sin(2 * np.pi * freqs * t), rng.standard_normal((64, 4, t.size))


def _k1_audio(tone: float, noise: float, samples: int = 88200) -> np.ndarray:
    """``[64, 4, samples]``: a tone per row over white noise; stem 3 silent."""
    sines, white = _k1_parts(samples)
    audio = tone * sines + noise * white
    audio[:, 3] = 0.0  # one silent stem: every bin clamps to amin
    return audio.astype(np.float32)


def _db_errors(got, ref):
    """max, mean and p99.9 |got - ref| over ``[..., T, F]`` features, and
    where the max sits: its reference value and its frame."""
    d = (got - ref).abs().flatten().cpu().numpy()
    i = int(d.argmax())
    where = (float(ref.flatten()[i]), i // ref.shape[-1] % ref.shape[-2])
    return float(d.max()), float(d.mean()), float(np.quantile(d, 0.999)), where


K1_LEVELS = (  # (label, tone amplitude, noise std) of the frontend-kernel checks
    ("tones 10 dB under noise", 0.03, 0.1),
    ("tones at noise", 0.1, 0.1),
    ("tones 10 dB over noise", 0.3, 0.1),
)


def _library_features(x, cfg):
    """``torch.stft`` + abs + dB: the one-call yardstick of every frontend."""
    import torch

    from tpumix_torch.ops.stft import amplitude_to_db, hann_window

    rows = x.reshape(-1, x.shape[-1])
    spec = torch.stft(rows, cfg.n_fft, cfg.hop_length,
                      window=hann_window(cfg.n_fft, device=x.device),
                      center=True, pad_mode="reflect", return_complex=True)
    return amplitude_to_db(spec.abs(), cfg.amin, cfg.db_multiplier).transpose(-1, -2)


def _frontend_bound(B, S, T, rates):
    """What the function needs, not what a kernel's design does: a real
    2048-point FFT (2.5 N log2 N), the window and |X|^2 per bin, against the
    audio read once and the features written once; the flops at the FP32
    rate of the float32 function (float64 inside is the kernels' own choice).
    The three frontend kernels compute this one function."""
    flops = B * T * (2.5 * 2048 * 11 + 2048 + 3 * 1025)
    nbytes = 4 * (B * S + B * T * 1025)
    return (*bound_ms(flops, nbytes, rates), flops, nbytes)


def _edge_audio(S: int, tone: float, noise: float) -> np.ndarray:
    """``[8, S]``: a tone per row over white noise; row 7 silent."""
    rng = np.random.default_rng(S)
    t = np.arange(S) / SR
    audio = (tone * np.sin(2 * np.pi * rng.uniform(40, 8000, size=(8, 1)) * t)
             + noise * rng.standard_normal((8, S)))
    audio[-1] = 0.0
    return audio.astype(np.float32)


# lengths at which the reflect padding reaches every frame (1025: the least
# that reflect padding of 1024 takes) or most of them
EDGE_LENGTHS = (1025, 1536, 2047, 4133)
# the dB value of a silent bin from every frontend kernel: float32(scale * ln(amin^2))
SILENT_DB = -(100.0 - 2.0 ** -17)
# float64 instructions per frame of csrc/stft_dif.cu's design (an FMA is one),
# counted from the source: stage A 128 x (16 window + 70 real 16-point FFT + 30
# twiddle), C1 72 x 164 (16-point complex FFT), C2 144 x 88 (7 twiddles by
# W_128, 8-point FFT), epilogue 1025 x 3 (|X|^2, clamp)
DIF_FP64_PER_FRAME = 128 * (16 + 70 + 30) + 72 * 164 + 144 * 88 + 1025 * 3


def phase_frontend_kernel(tag, rates, kernel, plain, record, max_db, f32_plain=None,
                          auto_hop=None, extra_timing=None, edge_hops=(), max_held=None,
                          fp64_per_frame=None):
    """One frontend kernel against its plain version, which computes the same
    function in float64: the difference is the kernel's own error.  For a
    float32 DFT its max sits in the deepest noise minima among the segment's
    45M bins, where float32 rounding is a large share of the bin, and grows
    with the tone-to-noise ratio, so the bounds are held at every level of
    ``K1_LEVELS``.  Beside it: float32 ``torch.stft`` and, where given, the
    plain version run in float32 (``f32_plain``), against the same float64
    version, as the floor of float32 arithmetic for this algorithm.

    ``auto_hop``: ``(hop, B, S)`` of a small input on which
    ``implementation="auto"`` must pick this kernel by itself.
    ``extra_timing``: ``(label, cfg, shape)`` of one more kernel timing.
    ``edge_hops``: hops at which the kernel is also held to the plain
    version at ``EDGE_LENGTHS``.  ``max_held``: a tighter bound on the
    largest error of all these checks.  ``fp64_per_frame``: the kernel
    design's float64 instructions per frame, printed as a time beside the
    bound."""
    import torch

    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops.stft import spectrogram_features_tm

    cfg = FrontendConfig(hop_length=512)
    B, S, T = 256, 88200, 173
    failed, held, silent_value = [], 0.0, None
    for label, tone, noise in K1_LEVELS:
        x = torch.from_numpy(_k1_audio(tone, noise)).cuda()
        got = kernel(x, cfg)
        torch.cuda.synchronize()
        ref = plain(x, cfg)
        mx, mean, p999, at = _db_errors(got, ref)
        fmx, fmean, fp999, fat = _db_errors(_library_features(x, cfg).reshape(ref.shape), ref)
        line = (f"[{tag}] {label}: |kernel - plain (f64)| dB max {mx:.4e} (in a {at[0]:.1f} dB "
                f"bin, frame {at[1]}) mean {mean:.3e} p99.9 {p999:.3e}; |torch.stft (f32) - "
                f"plain| dB max {fmx:.4e} (in a {fat[0]:.1f} dB bin, frame {fat[1]}) mean "
                f"{fmean:.3e} p99.9 {fp999:.3e}")
        if f32_plain is not None:
            pmx, pmean, pp999, pat = _db_errors(f32_plain(x, cfg), ref)
            line += (f"; |plain in f32 - plain| dB max {pmx:.4e} (in a {pat[0]:.1f} dB bin, "
                     f"frame {pat[1]}) mean {pmean:.3e} p99.9 {pp999:.3e}")
        log(line)
        if not (mx < max_db and mean < 1e-4 and p999 < 5e-3):
            failed.append(label)
        if not bool(torch.isfinite(got).all()) or got.shape != (64, 4, T, 1025):
            raise AssertionError(f"{tag} output bad: shape {tuple(got.shape)}")
        silent = got[:, 3]
        silent_value = float(silent.flatten()[0])
        if not bool((silent == silent.flatten()[0]).all()):
            raise AssertionError(f"{tag}: silent stem did not clamp to one amin value")
        held = max(held, mx)
        del got, ref
    if failed:
        raise AssertionError(f"{tag} disagrees with its plain version: {failed}")
    log(f"[{tag}] silent stem: every bin {silent_value!r} dB")
    if silent_value != SILENT_DB:
        raise AssertionError(f"{tag}: a silent bin is {silent_value!r} dB, not {SILENT_DB!r}")

    for hop in edge_hops:
        ecfg = FrontendConfig(hop_length=hop)
        worst = (0.0, 0.0, 0.0)
        for n in EDGE_LENGTHS:
            for label, tone, noise in K1_LEVELS:
                xe = torch.from_numpy(_edge_audio(n, tone, noise)).cuda()
                got = kernel(xe, ecfg)
                torch.cuda.synchronize()
                if got.shape != (8, 1 + n // hop, 1025) or not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"{tag} at S={n}, hop {hop}: bad output {tuple(got.shape)}")
                mx, mean, p999, _ = _db_errors(got, plain(xe, ecfg))
                if not (mx < max_db and mean < 1e-4 and p999 < 5e-3):
                    raise AssertionError(f"{tag} disagrees with its plain version at S={n}, hop "
                                         f"{hop}, {label}: max {mx:.3e} mean {mean:.3e}")
                if not bool((got[-1] == SILENT_DB).all()):
                    raise AssertionError(f"{tag} at S={n}, hop {hop}: silent row is not {SILENT_DB}")
                worst = tuple(max(a, b) for a, b in zip(worst, (mx, mean, p999)))
        held = max(held, worst[0])
        log(f"[{tag}] hop {hop} at S = {EDGE_LENGTHS}, three levels, [8, S] with a silent row: "
            f"|kernel - plain| dB worst max {worst[0]:.4e} mean {worst[1]:.3e} p99.9 "
            f"{worst[2]:.3e}; silent row {SILENT_DB!r} dB")
    if max_held is not None and held > max_held:
        raise AssertionError(f"{tag}: largest error {held:.3e} dB exceeds {max_held:.0e}")

    if auto_hop is not None:
        hop, b, s = auto_hop
        acfg = FrontendConfig(hop_length=hop)  # implementation="auto"
        xa = torch.from_numpy(_k1_audio(0.1, 0.1)[:b, 0, :s].copy()).cuda()
        before = kernel.launches
        got = spectrogram_features_tm(xa, acfg)
        torch.cuda.synchronize()
        if kernel.launches != before + 1:
            raise AssertionError(f"{tag}: 'auto' at hop {hop} did not launch the kernel")
        mx, mean, p999, _ = _db_errors(got, plain(xa, acfg))
        log(f"[{tag}] auto at hop {hop} ({acfg.resolved_implementation()}), {tuple(xa.shape)} -> "
            f"{tuple(got.shape)}: |kernel - plain| dB max {mx:.3e} mean {mean:.3e}")
        if not (mx < max_db and mean < 1e-4 and p999 < 5e-3):
            raise AssertionError(f"{tag} disagrees with its plain version at hop {hop}")

    x = torch.from_numpy(_k1_audio(0.1, 0.1)).cuda()
    b_ms, b_by, flops, nbytes = _frontend_bound(B, S, T, rates)
    ms = time_ms(lambda: kernel(x, cfg), inner=10)
    plain_ms = time_ms(lambda: plain(x, cfg), reps=5, warmup=1)
    lib_ms = time_ms(lambda: _library_features(x, cfg), inner=10)
    log(f"[{tag}] [64,4,88200] -> [64,4,173,1025]: kernel {ms:.4f} ms  plain {plain_ms:.3f} ms  "
        f"torch.stft {lib_ms:.4f} ms  bound {b_ms:.4f} ms ({b_by}; {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB)  {nbytes / ms / 1e6:.0f} GB/s, {ms / b_ms:.1f}x the bound")
    if fp64_per_frame is not None:
        f64_ms = B * T * fp64_per_frame / (rates[4] / 2) * 1e3
        log(f"[{tag}] FP64 figure of the kernel's design: {fp64_per_frame} float64 instructions "
            f"per frame, {B * T * fp64_per_frame / 1e9:.2f} G for the call, {f64_ms:.4f} ms at "
            f"{rates[4] / 2e12:.1f} T instructions/s ({rates[4] / 1e12:.1f} TFLOP/s FP64, an FMA "
            f"counted twice); {ms / f64_ms:.1f}x that figure")
    if extra_timing is not None:
        label, ecfg, shape = extra_timing
        xe = torch.from_numpy(_k1_audio(0.1, 0.1)).cuda().repeat(1, 1, 3)[..., : shape[-1]]
        xe = xe.contiguous()
        e_ms = time_ms(lambda: kernel(xe, ecfg), inner=10)
        te = 1 + shape[-1] // ecfg.hop_length
        eb_ms, eb_by, _, eb = _frontend_bound(shape[0] * shape[1], shape[-1], te, rates)
        log(f"[{tag}] {label} {list(xe.shape)} -> [..., {te}, 1025]: kernel {e_ms:.4f} ms  "
            f"bound {eb_ms:.4f} ms ({eb_by}, {eb / 1e6:.1f} MB)  {e_ms / eb_ms:.1f}x the bound")
    return {**record, "route": "cuda", "max_abs_err": held, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def entry_times(reps: int = 10) -> dict:
    """Device ms per call (CUDA events over 10 calls, median of ``reps``) of
    the DIF and DIT entries of the ``tpumix_torch`` on ``sys.path`` at the
    serving and training shapes, and of ``padded_rows`` (the reflect-pad pass
    that K3 makes before its kernel, as K1 and K4 did before they read the
    unpadded rows); with the registers and spills (ptxas) of each library
    those calls built."""
    import torch

    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops import _build
    from tpumix_torch.ops.stft import padded_rows
    from tpumix_torch.ops.stft_ct import stft_features_ct
    from tpumix_torch.ops.stft_dif import stft_features_dif

    x = torch.from_numpy(_k1_audio(0.1, 0.1)).cuda()
    x_long = x.repeat(1, 1, 3)[..., :220500].contiguous()
    c64, c512, c1024 = (FrontendConfig(hop_length=h) for h in (64, 512, 1024))
    res = {
        "K1 entry, hop 512": time_ms(lambda: stft_features_dif(x, c512), reps, inner=10),
        "K1 entry, hop 1024 [64,4,220500]":
            time_ms(lambda: stft_features_dif(x_long, c1024), reps, inner=10),
        "K4 entry, hop 512": time_ms(lambda: stft_features_ct(x, c512), reps, inner=10),
        "K4 entry, hop 64": time_ms(lambda: stft_features_ct(x, c64), reps, inner=10),
        "padded_rows, hop 512": time_ms(lambda: padded_rows(x, c512), reps, inner=10),
    }
    logs = {n: _build.library_path(n)[:-3] + ".log" for n in _build.SIGNATURES}
    res["ptxas"] = {n: ptxas_report(p) for n, p in logs.items() if os.path.exists(p)}
    return res


def dif_stage_times(smi: str, reps: int = 10) -> None:
    """What each stage of the DIF kernel costs at ``[64,4,88200]``, hop 512:
    the differences of launches stopped after stage A and after C1
    (``stft_dif_stages_launch``) and the whole launch."""
    import torch

    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops.stft_dif import launch_kernel

    x = torch.from_numpy(_k1_audio(0.1, 0.1)).cuda()
    cfg = FrontendConfig(hop_length=512)
    a, c1, whole = (time_ms(lambda: launch_kernel(x, cfg, "stft_dif", n), reps, inner=10)
                    for n in (1, 2, 3))
    log(f"[k1] kernel hop 512 stopped after stage A {a:.4f} ms, after C1 {c1:.4f} ms, whole "
        f"{whole:.4f} ms; by stage: stage A + twiddle {a:.4f} ms, C1 {c1 - a:.4f} ms, C2 + "
        f"epilogue {whole - c1:.4f} ms ({smi})")


def phase_compare(parent: str, smi: str) -> None:
    """``entry_times`` of another checkout's package (``parent``, e.g. a
    ``git archive`` of the parent commit) and of this one, in turns on this
    card (parent, change, change, parent), each in a process of its own."""
    runs, failed = [], []
    for label, root in (("parent", parent), ("change", ROOT), ("change", ROOT), ("parent", parent)):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--entry-times", root],
                             capture_output=True, text=True, timeout=900, cwd=root)
        if res.returncode != 0:  # go on: the other side's numbers still come out
            log(f"[ab] {label} ({root}) failed:\n{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
            failed.append(label)
            continue
        runs.append((label, json.loads(res.stdout.strip().splitlines()[-1])))
    for i, (label, res) in enumerate(runs):
        rows_by_lib = res.pop("ptxas")
        if i == 0 and label == "parent":  # this checkout's: [build]
            for lib, rows in rows_by_lib.items():
                for fn, regs, st, ld in rows:
                    log(f"[ab] parent {lib}: {fn}: {regs} registers, spill stores {st} B, "
                        f"spill loads {ld} B")
    keys = list(dict.fromkeys(k for _, res in runs for k in res))
    log(f"[ab] frontend device ms per call at [64,4,88200] unless stated (10 calls per timing, "
        f"median of 10), in turns parent, change, change, parent ({smi}):")
    for k in keys:
        cells = {lab: [f"{r[k]:.4f}" for l2, r in runs if l2 == lab and k in r]
                 for lab in ("parent", "change")}
        log(f"[ab]   {k}: parent {' '.join(cells['parent']) or '-'}  change "
            f"{' '.join(cells['change']) or '-'}")
    if failed:
        raise AssertionError(f"entry times failed for {failed}")


def phase_hybrids():
    """Each differentiable frontend on the card: its forward is its kernel's,
    bit for bit, and its gradient with respect to the waveform is autograd's
    through the ``"fft"`` path."""
    import torch

    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops.stft import spectrogram_features_tm
    from tpumix_torch.ops.stft_basis import stft_features_basis, stft_features_tm_hybrid
    from tpumix_torch.ops.stft_ct import stft_features_ct, stft_features_ct_tm_hybrid
    from tpumix_torch.ops.stft_dif import stft_features_dif, stft_features_dif_tm_hybrid

    cfg = FrontendConfig(hop_length=512)
    fft_cfg = dataclasses.replace(cfg, implementation="fft")
    x0 = torch.from_numpy(_k1_audio(0.1, 0.1)[:2, :3]).cuda()  # no silent stem
    weights = torch.randn((2, 3, 173, 1025), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(5))
    xf = x0.clone().requires_grad_(True)
    (spectrogram_features_tm(xf, fft_cfg) * weights).sum().backward()
    for name, hybrid, kernel in (
            ("stft_features_dif_tm_hybrid", stft_features_dif_tm_hybrid, stft_features_dif),
            ("stft_features_ct_tm_hybrid", stft_features_ct_tm_hybrid, stft_features_ct),
            ("stft_features_tm_hybrid", stft_features_tm_hybrid, stft_features_basis)):
        x = x0.clone().requires_grad_(True)
        before = kernel.launches
        y = hybrid(x, cfg)
        if kernel.launches != before + 1:
            raise AssertionError(f"{name} did not launch its kernel")
        same = bool(torch.equal(y.detach(), kernel(x0, cfg)))
        (y * weights).sum().backward()
        after = kernel.launches
        gap = float((x.grad - xf.grad).abs().max())
        scale = float(xf.grad.abs().max())
        log(f"[hyb] {name}: forward == kernel bit for bit: {same}; waveform gradient vs autograd "
            f"through 'fft': max |diff| {gap:.3e} at max |grad| {scale:.3e}; backward launched "
            f"{after - before - 2} kernels")
        if not same or not bool(torch.isfinite(x.grad).all()) or gap > 1e-6 * scale:
            raise AssertionError(f"{name} is not its kernel forward with the 'fft' backward")
        if after - before != 2:  # the hybrid's forward and the comparison's, none in backward
            raise AssertionError(f"{name}'s backward re-entered the kernel")


# (x shape NHWC, w shape HWIO) of trunk blocks 2-5 for one 64-chunk scalar2s segment
TRUNK_SHAPES = (
    ((64, 511, 85, 16), (5, 5, 16, 32)),
    ((64, 507, 81, 32), (5, 5, 32, 48)),
    ((64, 503, 77, 48), (7, 7, 48, 64)),
    ((64, 497, 71, 64), (9, 9, 64, 128)),
)


def phase_k2(rates, smi):
    """K2 at the four trunk shapes of one 64-chunk segment: the route the
    launcher takes (all four must be the wgmma kernel), the error against the
    float64 plain version and against cuDNN in float32, with and without the
    accumulator drain, and the times of the kernel, cuDNN and the plain
    version.  TFLOP/s count each product once (2*M*Cout*K).  The bound of a
    3xTF32 tensor-core kernel is the larger of three TF32 passes at the
    tensor peak and the bytes; the FP32 pipes' figure is printed beside it
    under its own name, for comparison with the FP32 SIMT kernel's records."""
    import torch
    import torch.nn.functional as F

    from tpumix_torch.ops.conv_block import (
        conv_block_fused,
        conv_block_fused_packed,
        conv_block_fused_plain,
        conv_block_fused_undrained,
        conv_block_route,
        pack_conv_weights,
    )

    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    simt_total, pack_total = 0.0, 0.0
    max_abs, bound_by = 0.0, set()
    g = torch.Generator(device="cuda").manual_seed(2)
    for xs, ws in TRUNK_SHAPES:
        cout = ws[-1]
        route = conv_block_route(xs, ws)
        if route != "wgmma":
            raise AssertionError(f"K2 takes the {route} route at trunk shape {xs} x {ws}")
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
        packed = pack_conv_weights(w, s, t)
        if not torch.equal(conv_block_fused_packed(x, packed), got):
            raise AssertionError("the packed entry disagrees with conv_block_fused")
        undrained = float((conv_block_fused_undrained(x, packed) - ref).abs().max())
        x_cl = x.permute(0, 3, 1, 2)  # channels_last NCHW view
        w_oihw = w.permute(3, 2, 0, 1).contiguous()

        def library():  # cuDNN in float32 (TF32 off) + the epilogue
            y = F.conv2d(x_cl, w_oihw)
            return torch.relu_(y.mul_(s.view(1, -1, 1, 1)).add_(t.view(1, -1, 1, 1)))

        lib_out = library().permute(0, 2, 3, 1)
        lib_err = float((got - lib_out).abs().max())
        lib_ref = float((lib_out - ref).abs().max())
        del lib_out
        ho, wo = xs[1] - ws[0] + 1, xs[2] - ws[1] + 1
        M, K = xs[0] * ho * wo, ws[0] * ws[1] * ws[2]
        flops = 2.0 * M * cout * K
        nbytes = 4.0 * (np.prod(xs) + np.prod(ws) + 2 * cout + M * cout)
        t_tensor, t_bytes = 3.0 * flops / rates[3] * 1e3, nbytes / rates[1] * 1e3
        b_ms, b_by = (t_tensor, "operations") if t_tensor >= t_bytes else (t_bytes, "bytes")
        simt_ms = flops / rates[0] * 1e3
        # in turns on one card: kernel, cuDNN, cuDNN, kernel
        ms_a = time_ms(lambda: conv_block_fused_packed(x, packed), reps=10, warmup=1)
        lib_a = time_ms(library, reps=10, warmup=1)
        lib_b = time_ms(library, reps=10, warmup=1)
        ms_b = time_ms(lambda: conv_block_fused_packed(x, packed), reps=10, warmup=1)
        ms, lib_ms = 0.5 * (ms_a + ms_b), 0.5 * (lib_a + lib_b)
        onfly_ms = time_ms(lambda: conv_block_fused(x, w, s, t), reps=10, warmup=1)
        pack_ms = time_ms(lambda: pack_conv_weights(w, s, t), reps=10, warmup=1)
        plain_ms = time_ms(lambda: conv_block_fused_plain(x, w, s, t), reps=5, warmup=1)
        log(f"[k2] {xs} * {ws}: route {route}; vs plain (f64): max abs {err:.3e} max rel "
            f"{rel:.3e} within(rtol 1e-4, atol 5e-5) {ok}; without the accumulator drain: max abs "
            f"{undrained:.3e}; vs cuDNN f32: max abs {lib_err:.3e} (cuDNN vs plain {lib_ref:.3e}); "
            f"kernel {ms:.3f} ms ({ms_a:.3f}, {ms_b:.3f}; packing on the fly {onfly_ms:.3f})  "
            f"weight packing {pack_ms:.3f} ms  plain (f64) {plain_ms:.3f} ms  cuDNN {lib_ms:.3f} "
            f"ms ({lib_a:.3f}, {lib_b:.3f})  bound {b_ms:.3f} ms ({b_by}: 3 TF32 passes at "
            f"{rates[3] / 1e12:.0f} TFLOP/s; bytes {t_bytes:.3f} ms; {flops / 1e12:.3f} TFLOP)  "
            f"FP32-SIMT figure {simt_ms:.3f} ms  {flops / ms / 1e9:.1f} TFLOP/s  "
            f"{ms / b_ms:.2f}x the bound  {lib_ms / ms:.2f}x cuDNN's speed  ({smi})")
        if not ok:
            raise AssertionError(f"K2 disagrees with its plain version at {xs} x {ws}")
        if ms < b_ms:
            raise AssertionError(f"K2 reads faster than its bound at {xs} x {ws}")
        for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                         ("bound_ms", b_ms)):
            totals[key] += val
        simt_total += simt_ms
        pack_total += pack_ms
        bound_by.add(b_by)
        if ws == TRUNK_SHAPES[-1][1]:  # block 5, most of the work: what the card does under it
            log(f"[k2] block 5 under sustained load: kernel "
                f"{clocks_under_load(lambda: conv_block_fused_packed(x, packed))}")
            log(f"[k2] block 5 under sustained load: cuDNN f32 {clocks_under_load(library, 30)}")
        del x, got, ref, diff
    log(f"[k2] blocks 2-5 per segment: kernel {totals['ms']:.3f} ms  plain "
        f"{totals['plain_ms']:.3f} ms  cuDNN {totals['library_ms']:.3f} ms  bound "
        f"{totals['bound_ms']:.3f} ms  FP32-SIMT figure {simt_total:.3f} ms  weight packing "
        f"(once per checkpoint) {pack_total:.3f} ms  ({smi})")
    return {"name": "conv_block_fused", "route": "cuda",
            "source": "tpumix_torch/csrc/conv_block.cu",
            "replaces": "tpumix/ops/conv_block_pallas.py:445",
            "max_abs_err": max_abs, **totals,
            "bound_by": "operations" if bound_by == {"operations"} else "bytes"}


def phase_k3_sizes(rates, smi):
    """K3 at frame lengths the other frontend kernels do not take: one with a
    dense tail (1200 = 16 * 75) and one longer (4096 = 16^3), each against
    the dense float64 plain version at the three levels of ``K1_LEVELS``."""
    import torch

    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops.stft_basis import stft_features_basis, stft_features_basis_plain

    for n_fft, hop in ((1200, 300), (4096, 1024)):
        cfg = FrontendConfig(n_fft=n_fft, hop_length=hop, implementation="pallas")
        bins, T = n_fft // 2 + 1, 1 + 88200 // hop
        for label, tone, noise in K1_LEVELS:
            x = torch.from_numpy(_k1_audio(tone, noise)).cuda()
            got = stft_features_basis(x, cfg)
            torch.cuda.synchronize()
            if got.shape != (64, 4, T, bins) or not bool(torch.isfinite(got).all()):
                raise AssertionError(f"k3 n_fft {n_fft}: bad output {tuple(got.shape)}")
            mx, mean, p999, at = _db_errors(got, stft_features_basis_plain(x, cfg))
            log(f"[k3] n_fft {n_fft} hop {hop}, {label}: |kernel - plain (f64)| dB max {mx:.4e} "
                f"(in a {at[0]:.1f} dB bin, frame {at[1]}) mean {mean:.3e} p99.9 {p999:.3e}")
            if not (mx < 0.2 and mean < 1e-4 and p999 < 5e-3):
                raise AssertionError(f"k3 disagrees with its plain version at n_fft {n_fft}")
            if not bool((got[:, 3] == got[0, 3, 0, 0]).all()):
                raise AssertionError(f"k3 n_fft {n_fft}: silent stem did not clamp to one value")
            del got
        B, S = 256, 88200
        flops = B * T * (2.5 * n_fft * np.log2(n_fft) + n_fft + 3 * bins)
        nbytes = 4 * (B * S + B * T * bins)
        b_ms, b_by = bound_ms(flops, nbytes, rates)
        ms = time_ms(lambda: stft_features_basis(x, cfg), inner=10)
        plain_ms = time_ms(lambda: stft_features_basis_plain(x, cfg), reps=3, warmup=1)
        log(f"[k3] n_fft {n_fft} hop {hop} [64,4,88200] -> [64,4,{T},{bins}]: kernel {ms:.4f} ms  "
            f"plain (dense f64) {plain_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB)  {ms / b_ms:.1f}x the bound  ({smi})")


#: VGGish's conv blocks at one 64-chunk segment of 16 tracks (1024 examples):
#: (name, NCHW input, output channels)
VGGISH_SHAPES = (("conv1", (1024, 1, 96, 64), 64), ("conv2", (1024, 64, 48, 32), 128),
                 ("conv3_1", (1024, 128, 24, 16), 256), ("conv3_2", (1024, 256, 24, 16), 256),
                 ("conv4_1", (1024, 256, 12, 8), 512), ("conv4_2", (1024, 512, 12, 8), 512))


def phase_dmc(smi):
    """The Differentiable Mixing Console's trunk and entry on the card.  Per
    VGGish conv block at one segment's shape: the launcher's route, K2 on the
    1-padded input (scale 1, shift = bias, the pad included in its time)
    against the float64 plain version on 64 examples, and the times of K2
    and of cuDNN's SAME convolution + ReLU in float32 (TF32 off), in turns:
    the readings ``models/blocks.py::K2_SIMT_FASTER`` rests on.  Then a 16-track
    8 s session through ``SongMixer(preset("dmc_vggish"))`` on the card
    against the same mixer's CPU path."""
    import torch
    import torch.nn.functional as F

    from tpumix_torch.config import MixConfig, preset
    from tpumix_torch.infer.mixer import SongMixer
    from tpumix_torch.models.blocks import takes_fused_kernel
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.ops.conv_block import (
        conv_block_fused_packed,
        conv_block_fused_plain,
        conv_block_route,
        pack_conv_weights,
    )

    t_phase = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, xs, cout in VGGISH_SHAPES:
        n, cin, h, w = xs
        x = torch.relu(torch.randn(xs, device="cuda", generator=g)).contiguous(
            memory_format=torch.channels_last)
        wt = (torch.randn((cout, cin, 3, 3), device="cuda", generator=g)
              * float(np.sqrt(2.0 / (9 * cin)))).contiguous(memory_format=torch.channels_last)
        bias = 0.05 * torch.randn(cout, device="cuda", generator=g)
        hwio = wt.permute(2, 3, 1, 0)
        route = conv_block_route((n, h + 2, w + 2, cin), (3, 3, cin, cout))
        auto = takes_fused_kernel("auto", "cuda", False, False, (1, 1), (1, 1), torch.float32,
                                  torch.float32, cin, cout, route=route)

        def cudnn():
            return torch.relu(F.conv2d(x, wt, bias, padding=1))

        line = f"[dmc] {name} {xs} -> {cout}: route {route}, auto takes K2 {auto}"
        if route != "none":
            packed = pack_conv_weights(hwio.contiguous(), torch.ones_like(bias), bias)

            def k2():
                nhwc = F.pad(x.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))
                return conv_block_fused_packed(nhwc, packed)

            few = x[:64].permute(0, 2, 3, 1)
            ref = conv_block_fused_plain(F.pad(few, (0, 0, 1, 1, 1, 1)), hwio,
                                         torch.ones_like(bias), bias)
            err = float((k2()[:64] - ref).abs().max() / ref.abs().max())
            lib_err = float((cudnn()[:64].permute(0, 2, 3, 1) - ref).abs().max()
                            / ref.abs().max())
            ka = time_ms(k2, reps=10, warmup=2)
            la = time_ms(cudnn, reps=10, warmup=2)
            lb = time_ms(cudnn, reps=10, warmup=2)
            kb = time_ms(k2, reps=10, warmup=2)
            flops = 2.0 * n * h * w * 9 * cin * cout
            ms, lib_ms = 0.5 * (ka + kb), 0.5 * (la + lb)
            line += (f"; vs plain (f64), of the output's peak: K2 {err:.2e}, cuDNN {lib_err:.2e}; "
                     f"K2 {ms:.3f} ms ({ka:.3f}, {kb:.3f}; {flops / ms / 1e9:.1f} TFLOP/s)  "
                     f"cuDNN {lib_ms:.3f} ms ({la:.3f}, {lb:.3f}; {flops / lib_ms / 1e9:.1f} "
                     f"TFLOP/s)  K2 at {lib_ms / ms:.2f}x cuDNN's speed")
            if err > 1e-5:
                raise AssertionError(f"K2 disagrees with its plain version at VGGish {name}")
        else:
            line += f"; cuDNN {time_ms(cudnn, reps=10, warmup=2):.3f} ms"
        log(f"{line}  ({smi})")
        del x
    torch.cuda.empty_cache()

    cfg = preset("dmc_vggish")
    model = build_model(cfg, generator=torch.Generator().manual_seed(3))
    song = np.stack([make_song(8.0, seed)[0] for seed in range(16)]).astype(np.float32)
    outs = {}
    for device in ("cuda", "cpu"):
        mixer = SongMixer(model, cfg, mix_cfg=MixConfig(chunk_length_s=cfg.chunk_length_s),
                          device=device)
        t0 = time.perf_counter()
        tracks, mix, curves = mixer.mix_song_smooth_device(song)
        outs[device] = (mix.cpu().numpy(), curves.cpu().numpy())
        log(f"[dmc] SongMixer({cfg.name}) on {device}: 16 tracks x 8 s -> mixed tracks "
            f"{tuple(tracks.shape)}, mix {tuple(mix.shape)}, curves {tuple(curves.shape)} in "
            f"{time.perf_counter() - t0:.2f} s")
    gaps = [float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(outs["cuda"], outs["cpu"])]
    log(f"[dmc] card vs CPU, of the peak: mix {gaps[0]:.2e}, curves {gaps[1]:.2e}  "
        f"(phase {time.perf_counter() - t_phase:.1f} s; {smi})")
    if not all(np.isfinite(v).all() for v in outs["cuda"]) or max(gaps) > 1e-4:
        raise AssertionError("SongMixer(dmc_vggish) on the card disagrees with its CPU path")


def _build_mixer(cfg, device, mix_cfg=None, transfer_dtype="float32", **kw):
    from tpumix_torch.assets import load_checkpoint
    from tpumix_torch.infer.mixer import SongMixer
    from tpumix_torch.models.convert import state_dict_from_jax
    from tpumix_torch.models.registry import build_model

    model = build_model(cfg)
    model.load_state_dict(state_dict_from_jax(load_checkpoint("scalar2s_synth")))
    return SongMixer(model, cfg, mix_cfg, transfer_dtype=transfer_dtype, device=device, **kw)


def phase_main_path():
    import torch

    from tpumix_torch.config import MixConfig, preset
    from tpumix_torch.infer.mixer import STEMS
    from tpumix_torch.ops.conv_block import conv_block_fused
    from tpumix_torch.ops.stft_dif import stft_features_dif

    cfg = dataclasses.replace(preset("scalar2s"), conv_impl="xla")  # the cuDNN trunk
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

    fused = _build_mixer(preset("scalar2s"), "cuda")  # conv_impl="auto": K2 on the card
    fused.song_gains(stems[:, : 3 * C])
    torch.cuda.synchronize()
    stft_features_dif.launches = 0
    conv_block_fused.launches = 0
    t0 = time.perf_counter()
    g_p = fused.song_gains(stems)
    t_p = time.perf_counter() - t0
    k1_p, k2_launches = stft_features_dif.launches, conv_block_fused.launches
    mae_p = float(np.abs(g_p - gains).mean())
    log(f"[main] conv_impl=auto: launches stft_features_dif {k1_p} conv_block_fused "
        f"{k2_launches}; gain MAE vs cuDNN trunk {mae_p:.3e}; gains-only "
        f"{seconds / t_p:.1f} audio-s/s ({t_p:.3f} s)")
    if k2_launches <= 0 or k1_p <= 0:
        raise AssertionError("conv_impl='auto' did not launch both kernels")
    if mae_p > 1e-5:
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

    mixer = _build_mixer(dataclasses.replace(preset("scalar2s"), conv_impl="xla"), "cuda")
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

STUDY_IMPLS = ("xla", "pallas", "khgemm", "khgemm_int8")
STUDY_TRAIN_IMPLS = ("xla", "khgemm", "khgemm_hybrid")
INT8_PEAK = 1979e12  # dense s8 tensor-core TOP/s, H100 SXM data sheet


def _set_conv_impl(model, impl: str) -> None:
    for i in range(1, 6):
        getattr(model, f"conv_b{i}").conv_impl = impl


def _segment(song: np.ndarray, C: int, first: int, n: int):
    """Chunks ``first .. first + n`` of ``song [4, S]`` as ``[n, 4, C]`` on the card."""
    import torch

    x = song[:, first * C: (first + n) * C].reshape(4, n, C).transpose(1, 0, 2)
    return torch.from_numpy(np.ascontiguousarray(x)).cuda()


def _study_trunks(model, h0, flops, rates, smi) -> dict:
    """Per ``conv_impl``: device ms of blocks 1-5 and the heads (CUDA events,
    median of 3), the segment's gains and the peak memory of one ``gains``."""
    import torch

    out = {}
    peaks = {"xla": ("FP32", rates[0]), "pallas": ("3xTF32", rates[3] / 3),
             "khgemm": ("FP32", rates[0]), "khgemm_int8": ("INT8", INT8_PEAK)}
    for impl in STUDY_IMPLS:
        _set_conv_impl(model, impl)
        h, ms = h0, []
        for i in range(1, 6):
            blk = getattr(model, f"conv_b{i}")
            ms.append(time_ms(lambda: blk(h), reps=3, warmup=1))
            h = blk(h)
        ms.append(time_ms(lambda: torch.cat([getattr(model, f"head{i}")(h)
                                             for i in range(1, 5)], dim=-1), reps=3, warmup=1))
        del h
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        gains = model.gains(h0)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        out[impl] = {"ms": ms, "gains": gains.float().cpu().numpy(), "peak": peak,
                     "above": peak - base}
        name, peak_rate = peaks[impl]
        cells = []
        for i, (f, t) in enumerate(zip(flops, ms[:5]), start=1):
            rate = f / (t * 1e-3)
            label = "FP32" if i == 1 else name  # block 1 is F.conv2d under every impl
            share = rate / (rates[0] if i == 1 else peak_rate)
            cells.append(f"b{i} {t:.3f} ms {rate / 1e12:.2f} T/s ({100 * share:.1f}% of {label})")
        trunk = sum(ms)
        log(f"[study] {impl}: " + "; ".join(cells) + f"; heads {ms[5]:.3f} ms; trunk "
            f"{trunk:.3f} ms, {sum(flops) / (trunk * 1e-3) / 1e12:.2f} TFLOP/s; peak memory "
            f"{peak / 2**30:.2f} GiB ({(peak - base) / 2**30:.2f} above the inputs) ({smi})")
    return out


def _study_int8_codes(model, h0, smi) -> None:
    """The s8 codes of block 5's input windows and weights on the card
    against the CPU (2 chunks), and the lowering's output on one chunk."""
    import torch

    from tpumix_torch.ops import conv_int8

    _set_conv_impl(model, "xla")
    h = h0[:2]
    for i in range(1, 5):
        h = getattr(model, f"conv_b{i}")(h)
    x = h.permute(0, 2, 3, 1).contiguous()  # NHWC
    w = model.conv_b5.conv.weight.permute(2, 3, 1, 0).contiguous()  # HWIO
    q_gpu, s_gpu = conv_int8.quantize_windows(x, 9)
    q_cpu, s_cpu = conv_int8.quantize_windows(x.cpu(), 9)
    diff = (q_gpu.cpu().to(torch.int16) - q_cpu.to(torch.int16)).abs()
    wq_gpu, cs_gpu = conv_int8.quantize_weights(w)
    wq_cpu, cs_cpu = conv_int8.quantize_weights(w.cpu())
    wdiff = int((wq_gpu.cpu() != wq_cpu).sum())
    out_gpu = conv_int8.conv2d_valid_khgemm_int8(x[:1], w).cpu()
    out_cpu = conv_int8.conv2d_valid_khgemm_int8(x[:1].cpu(), w.cpu())
    rms = float(out_cpu.square().mean().sqrt())
    log(f"[study] khgemm_int8 codes, block 5 input of 2 chunks on cuda vs cpu: "
        f"{int((diff > 0).sum())} of {diff.numel()} window codes differ (max {int(diff.max())} "
        f"step), row scales max |diff| {float((s_gpu.cpu() - s_cpu).abs().max()):.3e}; "
        f"{wdiff} of {wq_cpu.numel()} weight codes differ; output of one chunk max |diff| "
        f"{float((out_gpu - out_cpu).abs().max()):.3e} (output RMS {rms:.3e}) ({smi})")
    if int(diff.max()) > 1 or wdiff:
        raise AssertionError("[study] the card's int8 codes are more than one step from the CPU's")


def _study_train(cfg, song, C, smi, rows: int = 48) -> int:
    """One ``reference`` step at ``[rows,4,88200]`` from one initialisation
    (dropout off) under each trainable trunk: the loss against the ``xla``
    step's, finite gradients, then a second step timed; K1 launches."""
    import torch

    from tpumix_torch.models.registry import build_model
    from tpumix_torch.ops.stft_dif import stft_features_dif
    from tpumix_torch.train.state import create_train_state, make_train_step

    stems = _segment(song, C, 64, rows)
    mix = stems.sum(dim=1)
    losses, launches = {}, 0
    for impl in STUDY_TRAIN_IMPLS:
        model = build_model(dataclasses.replace(cfg, use_dropout=False, conv_impl=impl),
                            for_training=True, generator=torch.Generator().manual_seed(7))
        state = create_train_state(model.to("cuda", memory_format=torch.channels_last), 1e-3,
                                   1e-5)
        step = make_train_step(state, cfg.frontend())
        stft_features_dif.launches = 0
        losses[impl] = float(step(stems, mix, None)["loss"])
        finite = all(bool(torch.isfinite(p.grad).all()) for p in model.parameters())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        loss2 = float(step(stems, mix, None)["loss"])
        ev[1].record()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
        launches += stft_features_dif.launches
        rel = abs(losses[impl] - losses["xla"]) / abs(losses["xla"])
        log(f"[study] train step {impl} at [{rows},4,88200]: loss {losses[impl]:.6f} (relative gap to "
            f"xla {rel:.2e}), gradients finite {finite}; second step {ev[0].elapsed_time(ev[1]):.1f}"
            f" ms device, {wall:.1f} ms wall, loss {loss2:.6f}, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({smi})")
        # step 1 from equal parameters: [dp]'s bound between two orders of sums
        if not finite or rel > 1e-4 or not np.isfinite(loss2):
            raise AssertionError(f"[study] the {impl} train step disagrees with xla's")
        del model, state, step
        torch.cuda.empty_cache()
    return launches


def _study_frontends(fe, seg, smi) -> None:
    """``"matmul"`` and ``"ct"`` at ``[64,4,88200]`` against K1's float64
    plain version; each held to tests/test_stft.py's mean and p99.9."""
    import torch

    from tpumix_torch.ops.stft import spectrogram_features_tm
    from tpumix_torch.ops.stft_dif import stft_features_dif_plain

    ref = stft_features_dif_plain(seg, fe)
    for impl, max_db in (("matmul", 0.2), ("ct", 0.1)):
        cfg = dataclasses.replace(fe, implementation=impl)
        got = spectrogram_features_tm(seg, cfg)
        torch.cuda.synchronize()
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"[study] {impl} frontend: bad output {tuple(got.shape)}")
        mx, mean, p999, at = _db_errors(got, ref)
        ms = time_ms(lambda: spectrogram_features_tm(seg, cfg), reps=5)
        log(f"[study] frontend {impl!r} {list(seg.shape)} -> {list(got.shape)}: {ms:.3f} ms; |{impl} - "
            f"K1 plain (f64)| dB mean {mean:.3e} p99.9 {p999:.3e} max {mx:.4e} (in a {at[0]:.1f} dB "
            f"bin, frame {at[1]}; tests/test_stft.py's max {max_db} {'held' if mx < max_db else 'not held'}) "
            f"({smi})")
        # the bulk is held; the max of a float32 DFT over a segment's 45M bins
        # lands in near-clamp bins (ROADMAP.md section 3), so it is reported
        if not (mean < 1e-4 and p999 < 5e-3):
            raise AssertionError(f"[study] the {impl} frontend disagrees with K1's plain version")
        del got


def _study_istft(fe, seg, smi) -> None:
    import torch

    from tpumix_torch.ops.istft import istft, mix_in_spectrogram_domain, stft_complex

    x = seg[:4, :, :].reshape(16, -1)  # 16 signals of 2 s
    spec = stft_complex(x, fe)
    y = istft(spec, fe, length=x.shape[-1])
    cover = (spec.shape[-2] - 1) * fe.hop_length - fe.n_fft // 2
    err = float((y[:, :cover] - x[:, :cover]).abs().max())
    mixed = mix_in_spectrogram_domain(spec.view(4, 4, *spec.shape[1:]), torch.ones(4, 4).cuda(),
                                      fe, length=x.shape[-1])
    err_mix = float((mixed[:, :cover] - x.view(4, 4, -1).sum(1)[:, :cover]).abs().max())
    log(f"[study] istft round trip on the card, 16 x 2 s: max |y - x| {err:.3e} over the "
        f"{cover} covered samples (atol 1e-4); spectral mixdown of 4 stems {err_mix:.3e} (1e-3) "
        f"({smi})")
    if err > 1e-4 or err_mix > 1e-3:
        raise AssertionError("[study] istft does not invert stft_complex on the card")


def _study_trace(model, h0, smi) -> None:
    """One ``trace_to`` of a segment's gains on the cuDNN trunk: the top five
    device operations by self time."""
    import torch

    from tpumix_torch.utils.profiling import span, trace_to

    _set_conv_impl(model, "xla")
    region = "segment gains"
    t0 = time.perf_counter()
    with trace_to(os.path.join(ROOT, "chiprun_out", "study_trace")) as prof:
        with span(region):
            model.gains(h0)
        torch.cuda.synchronize()
    wall = 1e3 * (time.perf_counter() - t0)
    events = list(prof.key_averages())
    key = ("self_device_time_total" if hasattr(events[0], "self_device_time_total")
           else "self_cuda_time_total")
    # the device's own entries (kernels, copies); the operators above them
    # carry the same time again.  The program's span is kept by the program
    # and written into the Chrome trace, not into the profile.
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    total = sum(getattr(e, key) for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: getattr(e, key), reverse=True)[:5]
    log(f"[study] torch.profiler, one segment's gains (cuDNN trunk): {len(kernels)} device "
        f"operations, {total:.3f} ms of device time ({wall:.1f} ms wall with the profiler "
        f"starting and stopping); top five: "
        + "; ".join(f"{e.key[:70]} {getattr(e, key) / 1e3:.3f} ms x{e.count}" for e in top)
        + f" ({smi})")
    if total <= 0:
        log("[study] torch.profiler recorded no device time on this card")


def phase_study(rates, smi):
    """The study paths at the full width of ``scalar2s`` with the shipped
    checkpoint, TF32 off: the trunk of one 64-chunk segment under ``xla``
    (cuDNN), ``pallas`` (K2), ``khgemm`` and ``khgemm_int8`` (per-block ms,
    TFLOP/s, gains against ``xla``, peak memory), the 300 s song's gains
    under the khgemm lowerings against the 1e-3 budget, the card's int8
    codes against the CPU's, one ``khgemm`` and one ``khgemm_hybrid`` train
    step, the ``"matmul"`` and ``"ct"`` frontends, an ``istft`` round trip
    and one ``torch.profiler`` trace.  No gate is a speed."""
    import torch

    from tpumix_torch.config import preset
    from tpumix_torch.models.flops import trunk_layer_flops
    from tpumix_torch.ops.conv_block import conv_block_fused
    from tpumix_torch.ops.stft_dif import stft_features_dif

    t_phase = time.perf_counter()
    cfg = preset("scalar2s")
    mixer = _build_mixer(cfg, "cuda")
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is enabled on the study path")
    log("[study] TF32 off: cudnn.allow_tf32=False cuda.matmul.allow_tf32=False; peaks "
        f"{rates[0] / 1e12:.0f} TFLOP/s FP32, {rates[3] / 1e12:.0f} TF32 (K2 runs 3 passes: "
        f"{rates[3] / 3e12:.0f}), {INT8_PEAK / 1e12:.0f} TOP/s INT8 ({rates[2]})")
    model, C, fe = mixer.model, mixer.chunk_samples, mixer.frontend
    song = make_song(300.0, seed=3)
    seg = _segment(song, C, 0, 64)
    flops = [64 * f for _, f in trunk_layer_flops(2, 173)]
    stft_features_dif.launches = conv_block_fused.launches = 0
    with torch.inference_mode():
        feats_tm = stft_features_dif(seg, fe)
        h0 = feats_tm.permute(0, 3, 2, 1).contiguous().permute(0, 3, 1, 2)
        del feats_tm
        trunks = _study_trunks(model, h0, flops, rates, smi)
        k2 = conv_block_fused.launches
        ref = trunks["xla"]["gains"]
        for impl in STUDY_IMPLS[1:]:
            g = trunks[impl]["gains"]
            log(f"[study] segment gains {impl} vs xla: MAE {np.abs(g - ref).mean():.3e}, max "
                f"{np.abs(g - ref).max():.3e}")
        for impl in ("pallas", "khgemm"):
            if not np.allclose(trunks[impl]["gains"], ref, rtol=2e-4, atol=2e-4):
                raise AssertionError(f"[study] the {impl} trunk's gains disagree with xla's")
        if not np.isfinite(trunks["khgemm_int8"]["gains"]).all():
            raise AssertionError("[study] khgemm_int8 gains are not finite")

        song_gains = {}
        for impl in ("xla", "khgemm", "khgemm_int8"):
            _set_conv_impl(model, impl)
            t0 = time.perf_counter()
            song_gains[impl] = mixer.song_gains(song)
            song_gains[impl + "_s"] = time.perf_counter() - t0
        for impl in ("khgemm", "khgemm_int8"):
            d = np.abs(song_gains[impl] - song_gains["xla"])
            log(f"[study] 300 s song, gains {impl} vs xla: MAE {d.mean():.3e} (budget 1e-3: "
                f"{'within' if d.mean() <= 1e-3 else 'OVER'}), max {d.max():.3e}; gains-only "
                f"{300.0 / song_gains[impl + '_s']:.1f} audio-s/s (xla "
                f"{300.0 / song_gains['xla_s']:.1f}) ({smi})")
        # khgemm is held to the contract; int8's deviation is the study's finding
        if np.abs(song_gains["khgemm"] - song_gains["xla"]).mean() > 1e-3:
            raise AssertionError("[study] khgemm song gains are over the 1e-3 budget")
        if not np.isfinite(song_gains["khgemm_int8"]).all():
            raise AssertionError("[study] khgemm_int8 song gains are not finite")
        _study_int8_codes(model, h0, smi)
        _study_trace(model, h0, smi)
        _study_frontends(fe, seg, smi)
        _study_istft(fe, seg, smi)
        _set_conv_impl(model, "xla")
        k1 = stft_features_dif.launches
        del h0
    torch.cuda.empty_cache()
    k1 += _study_train(cfg, song, C, smi)
    log(f"[study] launches: K1 {k1}, K2 {k2} (the pallas trunk); phase "
        f"{time.perf_counter() - t_phase:.1f} s")
    if k1 <= 0 or k2 <= 0:
        raise AssertionError("[study] K1 or K2 never launched")
    return {"stft_features_dif": k1, "conv_block_fused": k2}


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


def _write_corpus(root: str, songs: int, seconds: float) -> None:
    """A seeded MedleyDB-layout corpus of mono PCM16 songs: four stems each
    (``make_song``) and the engineer's mix, a fixed-gain sum of them."""
    from tpumix_torch.data import wavio

    mix_gains = np.array([0.9, 1.1, 0.8, 1.2], np.float32)
    for k in range(songs):
        song = f"Song{k:02d}"
        stems = make_song(seconds, seed=20 + k) * 0.5  # headroom for the mix
        d = os.path.join(root, song, f"{song}_STEMS_JOINED")
        os.makedirs(d)
        for i, name in enumerate(("bass", "drums", "vocals", "other")):
            wavio.write(os.path.join(d, f"{song}_STEM_{name.upper()}.wav"), stems[i][:, None], SR,
                        subtype="PCM_16")
        mix = (mix_gains[:, None] * stems).sum(axis=0)
        wavio.write(os.path.join(root, song, f"{song}_MIX.wav"), mix[:, None], SR,
                    subtype="PCM_16")


@contextlib.contextmanager
def _wav_reader(native: bool):
    """Within the block, WAV chunks are read through the port's C++ reader
    (which must be built) or, as under ``TPUMIX_NO_NATIVE=1``, through numpy.
    Yields ``[n]``: the reads the reader served, counted as they happen; the
    block fails if the C++ reader served none, or numpy's run any."""
    from tpumix_torch.data import _native

    lib = _native.get_lib()
    if lib is None:
        raise AssertionError("[train] the C++ WAV reader (tpumix_torch/csrc/tpumixio.cpp) "
                             "was not built")
    real, taken = _native.read_mono_f32, [0]

    def counted(*a):
        out = real(*a)
        taken[0] += out is not None
        return out

    _native.read_mono_f32 = counted
    if not native:
        os.environ["TPUMIX_NO_NATIVE"] = "1"
        _native._lib, _native._tried = None, False  # get_lib() reads the variable again
    try:
        yield taken
    finally:
        _native.read_mono_f32 = real
        os.environ.pop("TPUMIX_NO_NATIVE", None)
        _native._lib, _native._tried = lib, True
    if (taken[0] > 0) != native:
        raise AssertionError(f"[train] the file loader took the wrong reader ({taken[0]} "
                             "reads through the C++ reader)")


class _Take:
    """The first ``n`` batches of a loader, each epoch."""

    def __init__(self, loader, n):
        self.loader, self.n = loader, n

    def __len__(self):
        return min(self.n, len(self.loader))

    def __iter__(self):
        for i, batch in enumerate(self.loader):
            if i >= self.n:
                return
            yield batch


def _run_cli(args, timeout=900):
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "tpumix_torch", *args]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    if res.returncode != 0:
        raise AssertionError(f"CLI {' '.join(args[:1])} failed ({res.returncode}):\n"
                             f"{res.stdout}\n{res.stderr}")
    return res.stdout, time.perf_counter() - t0


def _epoch_lines(out: str) -> list:
    return [line for line in out.splitlines() if line.startswith("Epoch ")]


def phase_train(smi):
    """The training path at the full width of ``scalar2s`` (2 s chunks,
    ``[48,4,88200]`` waveforms in, ``[48,4,1025,173]`` features): the CLI
    (train, resume, export, mix with the export), then ``Trainer`` with each
    of the three fused frontends, a CUDA-vs-CPU step, and the step's device
    time by stage."""
    import warnings

    import torch

    from tpumix_torch.config import FrontendConfig, TrainConfig, preset
    from tpumix_torch.data import wavio
    from tpumix_torch.data.dataset import MultitrackAudioDataset
    from tpumix_torch.data.device_corpus import DeviceCorpus, DeviceCorpusIterator
    from tpumix_torch.data.prefetch import BatchIterator
    from tpumix_torch.infer.mixer import _dequantize_on_device
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.ops.stft_basis import stft_features_basis
    from tpumix_torch.ops.stft_ct import stft_features_ct
    from tpumix_torch.ops.stft_dif import stft_features_dif
    from tpumix_torch.train.state import _apply_update, make_frontend_fn
    from tpumix_torch.train.trainer import Trainer

    warnings.filterwarnings("ignore", message="model bn_momentum")
    B = 48
    cfg = preset("scalar2s")
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt = os.path.join(tmp, "data"), os.path.join(tmp, "ckpt")
        t0 = time.perf_counter()
        _write_corpus(data, songs=6, seconds=100.0)
        log(f"[train] corpus: 6 songs x 100 s, MedleyDB layout, mono PCM16, written in "
            f"{time.perf_counter() - t0:.1f} s")

        # --- the CLI: train 2 epochs, resume for a third, export, mix ---
        base = ["train", "--data", data, "--model", "scalar2s", "--batch-size", str(B),
                "--checkpoint-dir", ckpt, "--run-name", "smoke", "--transfer-dtype", "int16",
                "--checkpoint-score", "val"]
        out, dt = _run_cli([*base, "--epochs", "2"])
        file_epochs = _epoch_lines(out)
        for line in file_epochs:
            log(f"[train] cli: {line}")
        result = json.loads(out.strip().splitlines()[-1])
        if len(file_epochs) != 2 or not np.isfinite(result["best_val_loss"]):
            raise AssertionError(f"train CLI: expected 2 finite epochs, got\n{out}")
        log(f"[train] python -m tpumix_torch train --model scalar2s --batch-size {B} --epochs 2 "
            f"--transfer-dtype int16: {dt:.1f} s, best epoch {result['best_epoch']}")
        out, dt = _run_cli([*base, "--epochs", "3", "--resume"])
        epochs = _epoch_lines(out)
        if len(epochs) != 1 or not epochs[0].startswith("Epoch 2:") or "restored epoch 1" not in out:
            raise AssertionError(f"train --resume did not continue at epoch 2:\n{out}")
        log(f"[train] cli --resume --epochs 3: {epochs[0]} ({dt:.1f} s)")
        run_dir = json.loads(out.strip().splitlines()[-1])["checkpoint_dir"]
        npz = os.path.join(tmp, "smoke.npz")
        out, dt = _run_cli(["export-checkpoint", "--checkpoint", run_dir, "--out", npz])
        log(f"[train] cli export-checkpoint: {out.strip().splitlines()[-1]} ({dt:.1f} s)")
        mixed = os.path.join(tmp, "mixed")
        out, dt = _run_cli(["mix", "--data", data, "--song", "Song00", "--checkpoint", npz,
                            "--out", mixed])
        audio, sr = wavio.read(os.path.join(mixed, "Song00_mixed.wav"), always_2d=True)
        if sr != SR or audio.shape[0] != int(100.0 * SR) or not np.isfinite(audio).all():
            raise AssertionError("mix with the exported checkpoint wrote a bad file")
        log(f"[train] cli mix --checkpoint smoke.npz: {audio.shape[0] / SR:.0f} s written, finite "
            f"({dt:.1f} s)")

        # --- the same corpus and batch from the device: one upload, gathers ---
        out_dc, dt = _run_cli(["train", "--data", data, "--model", "scalar2s", "--batch-size",
                               str(B), "--checkpoint-dir", ckpt, "--run-name", "smoke_dc",
                               "--checkpoint-score", "val", "--device-corpus", "--epochs", "2"])
        dc_epochs = _epoch_lines(out_dc)
        if len(dc_epochs) != 2 or not np.isfinite(
                json.loads(out_dc.strip().splitlines()[-1])["best_val_loss"]):
            raise AssertionError(f"train --device-corpus: expected 2 finite epochs, got\n{out_dc}")
        for line in dc_epochs:
            log(f"[train] cli --device-corpus: {line}")
        log(f"[train] python -m tpumix_torch train --device-corpus --epochs 2: {dt:.1f} s")
        for what, line in (("file loader (int16 wire)", file_epochs[-1]),
                           ("device corpus", dc_epochs[-1])):
            m = re.search(r"(\d+) train steps in ([\d.]+)s, ([\d.]+)s of it waiting", line)
            steps, wall, wait = int(m.group(1)), float(m.group(2)), float(m.group(3))
            log(f"[train] cli epoch 1, {what}: wall {1e3 * wall / steps:.1f} ms/step, host wait "
                f"{1e3 * wait / steps:.1f} ms/step ({steps} steps, {smi})")

        # --- Trainer with each fused frontend, same seeds, same batches ---
        songs = sorted(os.listdir(data))
        d_train = MultitrackAudioDataset(data, songlist=songs[:5], chunk_length=2.0, seed=0,
                                         hop_length=512)
        d_val = MultitrackAudioDataset(data, songlist=songs[5:], chunk_length=2.0, seed=0,
                                       hop_length=512)
        counts, first_loss, trainers = {}, {}, {}
        for impl, kernel in (("dif_pallas", stft_features_dif), ("ct_pallas", stft_features_ct),
                             ("pallas", stft_features_basis)):
            torch.manual_seed(0)  # dropout masks: the same in the three runs
            tcfg = TrainConfig(batch_size=B, checkpoint_dir=ckpt, seed=0, transfer_dtype="int16",
                               log_every_steps=1000)
            frontend = dataclasses.replace(cfg.frontend(), implementation=impl)
            trainer = Trainer(build_model(cfg, for_training=True), frontend, tcfg,
                              run_name=f"smoke_{impl}")
            if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
                raise AssertionError("TF32 is enabled on the train path")
            loaders = (_Take(BatchIterator(d_train, B, seed=0), 1),
                       _Take(BatchIterator(d_val, B, shuffle=False, seed=0), 1))
            for k in (stft_features_dif, stft_features_ct, stft_features_basis):
                k.launches = 0
            t0 = time.perf_counter()
            res = trainer.fit(*loaders, 0, 2)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts[kernel.__name__] = kernel.launches
            others = sum(k.launches for k in (stft_features_dif, stft_features_ct,
                                              stft_features_basis)) - kernel.launches
            first_loss[impl] = res.train_loss[0]
            trainers[impl] = trainer
            log(f"[train] Trainer, frontend {impl}: 2 epochs x (1 train step + 1 val batch) in "
                f"{dt:.2f} s; train loss {res.train_loss}, val loss {res.val_loss}; launches "
                f"{kernel.__name__} {kernel.launches} (2 per step: stems and mix), other frontend "
                f"kernels {others}")
            if kernel.launches != 8 or others != 0 or not np.isfinite(res.train_loss).all():
                raise AssertionError(f"train path with {impl}: wrong launches or loss")
        log("[train] TF32 off on the train path: cudnn.allow_tf32=False "
            "cuda.matmul.allow_tf32=False")
        for impl in ("ct_pallas", "pallas"):
            rel = abs(first_loss[impl] - first_loss["dif_pallas"]) / first_loss["dif_pallas"]
            log(f"[train] first-step loss, {impl} vs dif_pallas: relative gap {rel:.3e}")
            if rel > 1e-3:
                raise AssertionError(f"first-step loss with {impl} is off the K1 run's")

        # --- steady epochs of the file loader, the same batches read through
        # the C++ reader and through numpy in turns: wall per step, host wait ---
        trainer = trainers["dif_pallas"]
        torch.cuda.reset_peak_memory_stats()
        readers = ("C++ reader", "numpy (TPUMIX_NO_NATIVE=1)")
        for epoch, reader in enumerate(readers + readers[::-1], start=2):
            with _wav_reader(reader.startswith("C++")) as taken:
                loader = _Take(BatchIterator(d_train, B, seed=1), 4)
                trainer.fit(loader, _Take(BatchIterator(d_val, B, shuffle=False), 1), epoch,
                            epoch + 1)
            st = trainer.last_epoch_stats
            log(f"[train] steady epoch from the file loader, {reader} ({taken[0]} reads "
                f"through it), {st['steps']} steps of [48,4,88200] int16: wall "
                f"{1e3 * st['wall_s'] / st['steps']:.1f} ms/step, host wait "
                f"{1e3 * st['host_wait_s'] / st['steps']:.1f} ms/step ({smi})")
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[train] peak device memory over those epochs {peak:.2f} GiB")
        t0 = time.perf_counter()
        corpus = DeviceCorpus(data, songs[:5], 88200, layout="medleydb")
        torch.cuda.synchronize()
        upload = time.perf_counter() - t0
        loader = _Take(DeviceCorpusIterator(corpus, B, seed=1), 4)
        trainer.fit(loader, _Take(DeviceCorpusIterator(corpus, B, shuffle=False), 1), 6, 7)
        st = trainer.last_epoch_stats
        log(f"[train] steady epoch from the device corpus ({corpus.corpus.numel() * 2 / 1e6:.0f} "
            f"MB int16, read and uploaded in {upload:.1f} s), {st['steps']} steps: wall "
            f"{1e3 * st['wall_s'] / st['steps']:.1f} ms/step, host wait "
            f"{1e3 * st['host_wait_s'] / st['steps']:.1f} ms/step ({smi})")
        del corpus

        # --- device ms by stage of one step (CUDA events, median of 5) ---
        stems_np, mix_np = next(iter(BatchIterator(d_train, B, seed=2)))
        wire = [torch.from_numpy(np.clip(np.rint(a * 32768.0), -32768, 32767).astype(np.int16))
                .cuda() for a in (stems_np, mix_np)]
        state = trainer.state
        _features = make_frontend_fn(trainer.frontend)
        names = ("wire decode", "frontend (K1 x2)", "forward", "backward", "optimizer")
        rows = []
        for _ in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            with torch.no_grad():
                stems, mix = _dequantize_on_device(wire[0]), _dequantize_on_device(wire[1])
                ev[1].record()
                feats, gt = _features(stems), _features(mix)
                ev[2].record()
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            masked, _ = state.model(feats)
            loss = torch.mean(torch.square(masked - gt))
            ev[3].record()
            loss.backward()
            ev[4].record()
            _apply_update(state)
            ev[5].record()
            torch.cuda.synchronize()
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
        med = np.median(np.array(rows[1:]), axis=0)
        log(f"[train] one step at [48,4,88200], device ms by stage (median of 5, {smi}): "
            + "; ".join(f"{n} {v:.3f}" for n, v in zip(names, med))
            + f"; sum {med.sum():.3f}")
        del trainers, trainer, state

        # --- one step on CUDA vs the same step on the CPU ---
        nb = 4
        small = dataclasses.replace(cfg, use_dropout=False)
        scfg = TrainConfig(batch_size=nb, checkpoint_dir=ckpt, seed=0)
        stems_np, mix_np = stems_np[:nb], mix_np[:nb]
        outs = {}
        for dev in ("cuda", "cpu"):
            tr = Trainer(build_model(small, for_training=True,
                                     generator=torch.Generator().manual_seed(7)),
                         small.frontend(), scfg, run_name=f"smoke_{dev}", device=dev)
            t0 = time.perf_counter()
            losses = [float(tr._train_step(torch.from_numpy(stems_np).to(dev),
                                           torch.from_numpy(mix_np).to(dev))["loss"])
                      for _ in range(2)]
            outs[dev] = (losses, [p.detach().cpu() for p in tr.model.parameters()],
                         time.perf_counter() - t0)
        rel = [abs(a - b) / abs(b) for a, b in zip(outs["cuda"][0], outs["cpu"][0])]
        diffs = torch.cat([(a - b).abs().flatten() for a, b in zip(outs["cuda"][1], outs["cpu"][1])])
        frac = float((diffs > 1e-4).float().mean())
        log(f"[train] cuda vs cpu, 2 steps at [{nb},4,88200] from the same parameters, dropout "
            f"off: loss relative gap {rel[0]:.3e}, {rel[1]:.3e}; updated parameters max |diff| "
            f"{float(diffs.max()):.3e}, {100 * frac:.3f}% differ by more than 1e-4 "
            f"(cpu {outs['cpu'][2]:.1f} s)")
        # an early Adam step moves each parameter by about lr along the sign of
        # its gradient: a gradient near zero (every conv bias in front of a
        # BatchNorm has none but rounding noise) may take either sign on the two
        # devices, so some parameters sit up to 2 lr per step apart and the
        # second step starts from slightly different points.  Held: the losses
        # to 1e-3, no parameter further than 2 lr per step, nine in ten within
        # a tenth of lr
        if max(rel) > 1e-3 or float(diffs.max()) > 4.1e-3 or frac > 0.10:
            raise AssertionError("a train step on cuda disagrees with the same step on the cpu")
    return counts


DP_RANKS = 2  # gloo ranks on the one card: NCCL refuses two ranks on one card
DP_BATCH = 16  # the global batch: 8 rows per rank
DP_STEPS = 3
DP_LOSSES = ("reference", "coherent")
DP_SONG_S = 300.0


def _dp_train(loss: str, batches, mesh, steps: int = DP_STEPS, sp_axis=None):
    """``steps`` steps of ``scalar2s`` (dropout off) on the global int16
    batches, through ``data_parallel`` with ``mesh`` (one process without;
    ``sp_axis``: frame-sharded over that axis): per-step loss, wall and
    device ms, and the BN running statistics after the first and the last
    step."""
    import torch

    from tpumix_torch.config import preset
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.parallel.mesh import data_parallel
    from tpumix_torch.train.state import create_train_state, make_train_step
    from tpumix_torch.utils.device import disable_tf32

    disable_tf32()
    cfg = dataclasses.replace(preset("scalar2s"), use_dropout=False)
    model = build_model(cfg, for_training=True, generator=torch.Generator().manual_seed(7))
    state = create_train_state(model.to("cuda", memory_format=torch.channels_last), 1e-3, 1e-5)
    step = make_train_step(state, cfg.frontend(), loss=loss, mesh=mesh, sp_axis=sp_axis)
    if mesh is not None:
        step = data_parallel(step, mesh)
    out = {"loss": [], "wall_ms": [], "device_ms": []}
    for k in range(steps):
        stems = torch.from_numpy(batches[f"stems{k}"]).cuda()
        mix = torch.from_numpy(batches[f"mix{k}"]).cuda()
        torch.cuda.synchronize()
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        t0 = time.perf_counter()
        ev[0].record()
        metrics = step(stems, mix, None)
        ev[1].record()
        torch.cuda.synchronize()
        out["wall_ms"].append(1e3 * (time.perf_counter() - t0))
        out["device_ms"].append(ev[0].elapsed_time(ev[1]))
        out["loss"].append(float(metrics["loss"]))
        if k in (0, steps - 1):
            out[f"stats{k + 1}"] = {n: b.detach().cpu().numpy()
                                    for n, b in state.model.named_buffers() if "running_" in n}
    return out


def _dp_mixer(mesh):
    """``scalar2s`` + ``scalar2s_synth.npz`` on the K2 trunk, its chunk axis
    split over ``mesh`` (none: the plain mixer): gains of the 300 s song."""
    from tpumix_torch.config import preset

    cfg = dataclasses.replace(preset("scalar2s"), conv_impl="pallas")
    kw = {} if mesh is None else {"mesh": mesh, "chunk_axis": "dp"}
    return _build_mixer(cfg, "cuda", **kw)


def _dp_rank(rank: int, init: str, work: str) -> int:
    """One gloo rank of [dp] on ``cuda:0`` (``chip_smoke.py --dp-rank``):
    the data-parallel steps, then the chunk-sharded mixer; the counts of its
    launches of K1 and K2 on these paths go back to the parent."""
    import torch

    from tpumix_torch.ops.conv_block import conv_block_fused
    from tpumix_torch.ops.stft_dif import stft_features_dif
    from tpumix_torch.parallel import distributed
    from tpumix_torch.parallel.mesh import make_mesh

    distributed.initialize(init, DP_RANKS, rank, backend="gloo", device="cuda:0")
    try:
        mesh = make_mesh((DP_RANKS,), ("dp",))
        with np.load(os.path.join(work, "batches.npz")) as z:
            batches = dict(z)
        out = {}
        stft_features_dif.launches = conv_block_fused.launches = 0
        for loss in DP_LOSSES:
            out[loss] = _dp_train(loss, batches, mesh)
        out["k1_train"] = stft_features_dif.launches
        mixer = _dp_mixer(mesh)
        stems = make_song(DP_SONG_S, seed=3)
        mixer.song_gains(stems[:, : 3 * mixer.chunk_samples])  # warm-up
        torch.cuda.synchronize()
        stft_features_dif.launches = conv_block_fused.launches = 0
        t0 = time.perf_counter()
        out["gains"] = mixer.song_gains(stems)
        out["mix_s"] = time.perf_counter() - t0
        out["k1_mix"], out["k2_mix"] = stft_features_dif.launches, conv_block_fused.launches
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


SP_LOSSES = (("reference", 3), ("coherent", 1))  # (objective, steps)


def _sp_rank(rank: int, init: str, work: str) -> int:
    """One gloo rank of [sp] on ``cuda:0`` (``chip_smoke.py --dp-rank R
    --dp-mode sp``): the frame-sharded steps on a ``(1, 2)`` ``dp x sp``
    mesh, the feature frames this rank computes and its K1 launches."""
    import torch

    from tpumix_torch.models.registry import build_model
    from tpumix_torch.config import preset
    from tpumix_torch.ops.stft_dif import stft_features_dif
    from tpumix_torch.parallel import distributed
    from tpumix_torch.parallel.mesh import make_mesh

    distributed.initialize(init, DP_RANKS, rank, backend="gloo", device="cuda:0")
    try:
        mesh = make_mesh((1, DP_RANKS), ("dp", "sp"))
        with np.load(os.path.join(work, "batches.npz")) as z:
            batches = dict(z)
        out = {}
        stft_features_dif.launches = 0
        for loss, steps in SP_LOSSES:
            out[loss] = _dp_train(loss, batches, mesh, steps, sp_axis="sp")
        out["k1"] = stft_features_dif.launches
        out["features"] = build_model(preset("scalar2s")).frame_shard(
            173, mesh.axis("sp"), 1).features
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


def _dp_batches(tmp: str) -> str:
    """``DP_STEPS`` int16 global batches ``[DP_BATCH, 4, 88200]`` of a 3-song
    x 40 s corpus from [train]'s writer, saved as ``tmp/batches.npz``."""
    from tpumix_torch.data.dataset import MultitrackAudioDataset
    from tpumix_torch.data.prefetch import BatchIterator

    data = os.path.join(tmp, "data")
    _write_corpus(data, songs=3, seconds=40.0)
    d = MultitrackAudioDataset(data, songlist=sorted(os.listdir(data)), chunk_length=2.0,
                               seed=0, hop_length=512)
    pcm = {}
    for k, (stems, mix) in zip(range(DP_STEPS), BatchIterator(d, DP_BATCH, shuffle=False)):
        pcm[f"stems{k}"] = np.clip(np.rint(stems * 32768.0), -32768, 32767).astype(np.int16)
        pcm[f"mix{k}"] = np.clip(np.rint(mix * 32768.0), -32768, 32767).astype(np.int16)
    path = os.path.join(tmp, "batches.npz")
    np.savez(path, **pcm)
    return path


def _run_ranks(tmp: str, mode: str, timeout: int = 300) -> tuple:
    """``DP_RANKS`` gloo ranks of this script on ``cuda:0`` (``--dp-rank``),
    met through a file under ``tmp``; their saved results and the seconds
    from start to exit.  A rank that hangs is stopped, and the phase fails."""
    import torch

    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    init = "file://" + os.path.join(tmp, f"rendezvous_{mode}")
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--dp-rank", str(r),
                               "--dp-init", init, "--dp-work", tmp, "--dp-mode", mode], cwd=ROOT,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_RANKS)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"[{mode}] rank {r} exited {p.returncode}:\n{out}")
    return ([torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
             for r in range(DP_RANKS)], time.perf_counter() - t0)


def _loss_gaps(a, b):
    return [abs(x - y) / abs(y) for x, y in zip(a["loss"], b["loss"])]


def _stats_gap(got, solo, k):
    return max(float(np.abs(got[f"stats{k}"][n] - ref).max()) / max(float(np.abs(ref).max()), 1.0)
               for n, ref in solo[f"stats{k}"].items())


def phase_sp(smi):
    """The frame-sharded train step on the one card: two gloo ranks on
    ``cuda:0`` on a ``(1, 2)`` ``dp x sp`` mesh train ``scalar2s`` at
    ``[16,4,88200]`` (every rank all 16 rows, its part of the frames), 3
    steps of ``reference`` and 1 of ``coherent``, against one process on the
    same global batches at [dp]'s bounds."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = _dp_batches(tmp)
        ranks, t_ranks = _run_ranks(tmp, "sp")
        batches = dict(np.load(path))
    reverse = {k: np.ascontiguousarray(v[::-1]) for k, v in batches.items()}
    spans = [r["features"] for r in ranks]
    overlap = spans[0][1] - spans[1][0]
    log(f"[sp] feature frames per rank {spans} of 173 (overlap {overlap} frames, each rank "
        f"{', '.join(f'{(b - a) / 173:.0%}' for a, b in spans)} of the frames)")
    for loss, steps in SP_LOSSES:
        solo = _dp_train(loss, batches, None, steps)
        got = ranks[0][loss]
        if got["loss"] != ranks[1][loss]["loss"]:
            raise AssertionError(f"[sp] {loss}: the ranks report different losses")
        rel = _loss_gaps(got, solo)
        control = _loss_gaps(_dp_train(loss, reverse, None, steps), solo)
        stats = {k: _stats_gap(got, solo, k) for k in {1, steps}}
        log(f"[sp] {loss}, {DP_RANKS} gloo ranks on cuda:0 ((1, 2) dp x sp) vs one process, "
            f"{steps} step(s) of [{DP_BATCH},4,88200] int16: loss relative gap "
            f"{', '.join(f'{v:.2e}' for v in rel)} (one process on the rows reversed: "
            f"{', '.join(f'{v:.2e}' for v in control)}); BN running statistics, max |diff| / "
            f"scale: {stats[1]:.2e} after step 1, {stats[steps]:.2e} after step {steps}; wall "
            f"per rank step {', '.join(f'{v:.1f}' for v in got['wall_ms'])} ms (device "
            f"{', '.join(f'{v:.1f}' for v in got['device_ms'])}), one process "
            f"{', '.join(f'{v:.1f}' for v in solo['wall_ms'])} ms ({smi})")
        later = [max(2e-2, 4 * c) for c in control[1:]]  # [dp]'s bounds
        if (rel[0] > 1e-4 or any(r > b for r, b in zip(rel[1:], later))
                or stats[1] > 1e-4 or stats[steps] > 1e-1):
            raise AssertionError(f"[sp] {loss}: the frame-sharded ranks disagree with one process")
    k1 = [r["k1"] for r in ranks]
    log(f"[sp] K1 launches per rank {k1}; the ranks took {t_ranks:.1f} s from start to exit; "
        f"phase {time.perf_counter() - t_phase:.1f} s")
    if min(k1) <= 0:
        raise AssertionError("[sp] a rank's frame-sharded step never launched K1")
    return {"stft_features_dif": sum(k1)}


def phase_dp(smi):
    """Data parallelism on the one card: two gloo ranks on ``cuda:0`` train
    ``scalar2s`` at full width (``[16,4,88200]`` int16 global batches of a
    corpus from [train]'s writer, 8 rows per rank) for ``DP_STEPS`` steps of
    ``reference`` and ``coherent`` and mix a 300 s song with the chunk axis
    split over them (K2 trunk), each held against one process on the same
    inputs; then ``train-synth --mesh 1``, one rank over NCCL."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        _dp_batches(tmp)
        ranks, t_ranks = _run_ranks(tmp, "dp")

        batches = dict(np.load(os.path.join(tmp, "batches.npz")))
        # the control: one process on the same global batches with their rows
        # in reverse order, which changes only the order of the float sums
        reverse = {k: np.ascontiguousarray(v[::-1]) for k, v in batches.items()}

        for loss in DP_LOSSES:
            solo = _dp_train(loss, batches, None)
            control = _loss_gaps(_dp_train(loss, reverse, None), solo)
            got = ranks[0][loss]
            if got["loss"] != ranks[1][loss]["loss"]:
                raise AssertionError(f"[dp] {loss}: the ranks report different losses")
            rel = _loss_gaps(got, solo)
            stats = {k: _stats_gap(got, solo, k) for k in (1, DP_STEPS)}
            log(f"[dp] {loss}, {DP_RANKS} gloo ranks on cuda:0 vs one process, {DP_STEPS} steps "
                f"of [{DP_BATCH},4,88200] int16: loss {['%.6f' % v for v in got['loss']]} vs "
                f"{['%.6f' % v for v in solo['loss']]}, relative gap "
                f"{', '.join(f'{v:.2e}' for v in rel)} (one process on the rows reversed: "
                f"{', '.join(f'{v:.2e}' for v in control)}); BN running statistics, max |diff| / "
                f"scale: {stats[1]:.2e} after step 1, {stats[DP_STEPS]:.2e} after step {DP_STEPS}")
            log(f"[dp] {loss} per step (steps 2-{DP_STEPS}): wall "
                f"{np.mean(got['wall_ms'][1:]):.1f} ms and device {np.mean(got['device_ms'][1:]):.1f}"
                f" ms per rank ([8,4,88200] each), one process {np.mean(solo['wall_ms'][1:]):.1f} "
                f"/ {np.mean(solo['device_ms'][1:]):.1f} ms ([16,4,88200]) ({smi})")
            # step 1 from equal parameters: the loss to the JAX test's bound
            # (tests/test_train.py:159, one step) and the statistics to 1e-4 of
            # their scale.  Later steps: Adam's first update moves every
            # parameter by +-lr along its gradient's sign, and a gradient of
            # rounding noise (a conv bias in front of a BatchNorm; a head weight
            # on the ReLU kink) takes either sign under another order of sums,
            # so the runs drift apart as far as the control does.  Held: the
            # later losses within tests/test_torch_train_step.py's 2e-2 or four
            # times the control's drift, the statistics within its 1e-1
            later = [max(2e-2, 4 * c) for c in control[1:]]
            if (rel[0] > 1e-4 or any(r > b for r, b in zip(rel[1:], later))
                    or stats[1] > 1e-4 or stats[DP_STEPS] > 1e-1):
                raise AssertionError(f"[dp] {loss}: {DP_RANKS} ranks disagree with one process")
        k1 = [r["k1_train"] for r in ranks]
        log(f"[dp] K1 launches per rank on the data-parallel steps: {k1} "
            f"({len(DP_LOSSES)} x {DP_STEPS} steps, one launch per step: stems; reference also "
            f"the mix)")
        if min(k1) <= 0:
            raise AssertionError("[dp] a rank's train step never launched K1")

        plain = _dp_mixer(None)
        stems = make_song(DP_SONG_S, seed=3)
        want = plain.song_gains(stems)
        gaps = [float(np.abs(r["gains"] - want).max()) for r in ranks]
        log(f"[dp] chunk-sharded SongMixer (scalar2s, K2 trunk, {DP_RANKS} gloo ranks on cuda:0) "
            f"on a {DP_SONG_S:.0f} s song: {want.shape[0]} gains, max |diff| vs the plain mixer "
            f"{max(gaps):.2e} (ranks {gaps}); per rank K1 "
            f"{[r['k1_mix'] for r in ranks]}, K2 {[r['k2_mix'] for r in ranks]} launches; "
            f"gains-only {[round(DP_SONG_S / r['mix_s'], 1) for r in ranks]} audio-s/s ({smi})")
        if max(gaps) > 1e-4 or min(min(r["k1_mix"], r["k2_mix"]) for r in ranks) <= 0:
            raise AssertionError("[dp] the chunk-sharded mixer disagrees with the plain mixer "
                                 "or did not launch K1 and K2")
        log(f"[dp] the {DP_RANKS} ranks took {t_ranks:.1f} s from start to exit")

        out, dt = _run_cli(["train-synth", "--model", "scalar2sL", "--mesh", "1", "--batch-size",
                            "48", "--steps-per-epoch", "2", "--epochs", "1", "--checkpoint-dir",
                            os.path.join(tmp, "ckpt"), "--run-name", "nccl"])
        epochs = _epoch_lines(out)
        result = json.loads(out.strip().splitlines()[-1])
        if ("backend nccl" not in out or len(epochs) != 1
                or not np.isfinite(result["best_val_loss"])):
            raise AssertionError(f"[dp] train-synth --mesh 1 over NCCL:\n{out}")
        log(f"[dp] python -m tpumix_torch train-synth --mesh 1 (NCCL, world size 1): {epochs[0]} "
            f"({dt:.1f} s)")
    log(f"[dp] phase {time.perf_counter() - t_phase:.1f} s")
    return {"stft_features_dif": sum(r["k1_train"] + r["k1_mix"] for r in ranks),
            "conv_block_fused": sum(r["k2_mix"] for r in ranks)}


def _epoch(out: str, k: int):
    """``(train loss, val loss, steps, wall s)`` of a CLI run's epoch ``k``."""
    line = _epoch_lines(out)[k]
    m = re.search(r"train ([\d.]+)\s+val ([\d.]+).*?(\d+) train steps in ([\d.]+)s", line)
    return float(m.group(1)), float(m.group(2)), int(m.group(3)), float(m.group(4))


def phase_dp4(smi, cards: int = 4, device: str = "cuda", model: str = "scalar2s",
              synth_model: str = "scalar2sL", batch: int = 16, synth_batch: int = 192):
    """``--phases dp4``, on a machine with ``cards`` cards (not in the default
    run, which needs one): the CLI's data parallelism over NCCL, one rank a
    card.  ``train --mesh 4`` on a written corpus (one epoch: one step of the
    global batch, one validation batch; its dropout masks are per rank, so it
    is not compared); ``train-synth --mesh 4`` (dropout off) for one step
    against ``--mesh 1``, the same global batch on one card, the loss to 1e-4
    relative; then both for two epochs of 4 steps at ``synth_batch`` (48 rows
    a rank): wall per steady step."""
    import torch

    from tpumix_torch.config import preset

    if device == "cuda" and torch.cuda.device_count() < cards:
        raise AssertionError(f"[dp4] needs {cards} cards, have {torch.cuda.device_count()}")
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt = os.path.join(tmp, "synth"), os.path.join(tmp, "ckpt")
        # four songs of batch / 2 chunks: two train songs give one step of the
        # global batch, two validation songs one batch
        seconds = preset(model).chunk_length_s * batch / 2
        _run_cli(["synth-data", "--out", data, "--n-train", "4", "--n-test", "1",
                  "--duration", str(seconds)])
        out, dt = _run_cli(["train", "--data", os.path.join(data, "train"), "--layout", "musdb18",
                            "--model", model, "--batch-size", str(batch), "--epochs", "1",
                            "--val-fraction", "0.5", "--device", device, "--checkpoint-dir",
                            ckpt, "--run-name", "train", "--mesh", str(cards)])
        loss, val, steps, _ = _epoch(out, 0)
        log(f"[dp4] train --mesh {cards} ({re.search(r'backend (\w+)', out).group(1)}), {model}, "
            f"global batch {batch}: {_epoch_lines(out)[0]} ({dt:.1f} s with start-up)")
        if steps != 1 or not np.isfinite([loss, val]).all() or val == 0.0:
            raise AssertionError(f"[dp4] train --mesh {cards}:\n{out}")
        synth = ["train-synth", "--model", synth_model, "--batch-size", str(synth_batch),
                 "--device", device, "--checkpoint-dir", ckpt]
        first = {}
        for mesh in (str(cards), "1"):
            _run_cli([*synth, "--steps-per-epoch", "1", "--epochs", "1", "--run-name",
                      f"one{mesh}", "--mesh", mesh])
            with open(os.path.join(ckpt, f"one{mesh}", "metrics.csv")) as f:
                first[mesh] = float(f.read().splitlines()[1].split(",")[1])  # 6 decimals
        rel = abs(first[str(cards)] - first["1"]) / abs(first["1"])
        log(f"[dp4] train-synth, one step of [{synth_batch},4,...] on {cards} ranks vs one: "
            f"loss {first[str(cards)]} vs {first['1']}, relative gap {rel:.2e}")
        if rel > 1e-4:
            raise AssertionError(f"[dp4] train-synth --mesh {cards} disagrees with one rank")
        for mesh in (str(cards), "1"):
            out, dt = _run_cli([*synth, "--steps-per-epoch", "4", "--epochs", "2", "--run-name",
                                f"synth{mesh}", "--mesh", mesh])
            _, _, steps, wall = _epoch(out, 1)
            log(f"[dp4] train-synth --mesh {mesh}, {synth_model}, global batch {synth_batch}: "
                f"steady epoch {1e3 * wall / steps:.1f} ms per step ({dt:.1f} s with start-up, "
                f"{smi})")
    log(f"[dp4] phase {time.perf_counter() - t_phase:.1f} s")


SYNTH_KINDS = (None, "reverb", "comp", "limiter", "full")
SYNTH_BATCH = 48  # train-synth's default batch


def _in_process_cli(args):
    """``python -m tpumix_torch <args>`` run in this process, so the kernels'
    launch counters see it: ``(stdout, seconds)``."""
    import contextlib
    import io

    from tpumix_torch.cli import main as cli_main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(args))
    if rc != 0:
        raise AssertionError(f"CLI {args[0]} returned {rc}:\n{buf.getvalue()}")
    return buf.getvalue(), time.perf_counter() - t0


def _synth_generator(smi):
    """The generator at full width (``[48, 4, 88200]`` windows of a 4-chunk
    context, level shift on): the same CPU draws rendered on the card and on
    the CPU, clean and under each bus; the card's own draws; one batch timed."""
    import torch

    from tpumix_torch.data.synthetic import synth_chunk_batch, synth_draws, synth_render

    B, n, cm, shift = SYNTH_BATCH, 88200, 4, (-14.0, 2.0)
    t0 = time.perf_counter()
    draws = synth_draws(torch.Generator().manual_seed(0), B, n, cm, shift)
    on_card = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in draws.items()}
    log(f"[synth] draws on the CPU at B={B}, n={n}, context x{cm}, shift {shift}: "
        f"{time.perf_counter() - t0:.1f} s")
    # Bound: both devices compute the time axis and every phase argument from
    # bit-equal float32 operands (true divisions, synth_render), but the
    # vocals' argument adds the vibrato, itself a sine that the two math
    # libraries round a few ulp apart; the sum can then round to the
    # neighbouring float32, one ulp of the largest argument, 2 pi 500 Hz x the
    # context + 3, and the vocal stem moves by up to that times its amplitude
    # (twice, for margin).  Every other difference (a sine's or exp's last
    # bits, the moving averages' float32 cumulative sums) is far below it.
    # The mix carries the vocal stem at its gain, and the reverb tail adds up
    # to 0.35 * sum(0.6**k) of it.  Labels take the same float32 operations.
    arg_ulp = float(np.spacing(np.float32(2 * np.pi * 500.0 * n * cm / SR + 3.0)))
    for kind in SYNTH_KINDS:
        got = [t.cpu() for t in synth_render(on_card, SR, return_gains=True, mix_bus_kind=kind)]
        ref = synth_render(draws, SR, return_gains=True, mix_bus_kind=kind)
        d = [float((a - b).abs().max()) for a, b in zip(got, ref)]
        vocals = ref[0][:, 2].abs().amax(dim=1)  # [B] peak of each item's vocal stem
        b_stems = 2.0 * arg_ulp * float(vocals.max())
        b_mix = 1.53 * 2.0 * arg_ulp * float((10.0 ** (0.5 * ref[2][:, 2]) * vocals).max())
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        per_stem = (got[0] - ref[0]).abs().amax(dim=(0, 2)).tolist()
        log(f"[synth] card vs cpu render, bus {kind or 'clean'}: max |d| stems {d[0]:.3e} "
            f"(bass/drums/vocals/other " + "/".join(f"{v:.2e}" for v in per_stem)
            + f"; bound {b_stems:.3e}), mix {d[1]:.3e} (bound {b_mix:.3e}), labels {d[2]:.3e} "
            f"(bound 1e-6); mean |d| stems {float((got[0] - ref[0]).abs().mean()):.3e}, mix "
            f"{float((got[1] - ref[1]).abs().mean()):.3e}; finite {finite}")
        if not finite or d[0] > b_stems or d[1] > b_mix or d[2] > 1e-6:
            raise AssertionError(f"the card's synthetic render disagrees with the CPU's ({kind})")
    del on_card, draws

    gen = torch.Generator(device="cuda")
    for kind in SYNTH_KINDS:
        stems, mix, g = synth_chunk_batch(gen.manual_seed(1), B, n, SR, return_gains=True,
                                          context_mult=cm, level_shift_db=shift,
                                          mix_bus_kind=kind)
        if (stems.shape != (B, 4, n) or mix.shape != (B, n) or g.shape != (B, 4)
                or stems.device.type != gen.device.type
                or not all(bool(torch.isfinite(t).all()) for t in (stems, mix, g))):
            raise AssertionError(f"bad synthetic batch on the card ({kind}): shapes "
                                 f"{[tuple(t.shape) for t in (stems, mix, g)]} on {stems.device}")
        if kind is None:
            # the labels are exact on the clean family (tests/test_train.py:452)
            recon = torch.einsum("bsn,bs->bn", stems, 10.0 ** (0.5 * g))
            excess = float(((recon - mix).abs() - (1e-5 + 1e-4 * mix.abs())).max())
            log(f"[synth] card draws: shapes and finiteness hold for every bus; clean family "
                f"sum_s 10**(0.5 g_s) stem_s - mix: max |d| {float((recon - mix).abs().max()):.3e}"
                f" (rtol 1e-4, atol 1e-5: excess {excess:.3e})")
            if excess > 0:
                raise AssertionError("the gain labels do not reconstruct the clean mix")
    ms = time_ms(lambda: synth_chunk_batch(gen, B, n, SR, return_gains=True, context_mult=cm,
                                           level_shift_db=shift), reps=5, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[synth] one batch [{B},4,{n}] from a {cm * n}-sample context: {ms:.3f} ms "
        f"(CUDA events, median of 5; {smi}); peak device memory so far {peak:.2f} GiB")


def phase_synth(smi):
    """The synthetic training path at the full width of ``scalar2sL``: the
    generator (``_synth_generator``), then the commands — ``synth-data``,
    ``train-synth --loss gain`` for 2 epochs and ``--resume`` for a third
    (in this process, so K1's launch counter sees them), ``export-checkpoint``
    and ``mix`` with the export, one ``--loss lstsq_tail --mix-bus full``
    step — then the step's device time by stage, its wall time, and one
    bfloat16 step.  Returns the K1 launches of the commands' training."""
    import torch

    from tpumix_torch.config import TrainConfig, preset
    from tpumix_torch.data import wavio
    from tpumix_torch.infer.mixer import _dequantize_on_device
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.ops.stft_dif import stft_features_dif
    from tpumix_torch.train.state import _apply_update, make_frontend_fn
    from tpumix_torch.train.trainer import SyntheticTrainer, _seeded_generator

    t_phase = time.perf_counter()
    _synth_generator(smi)
    B = SYNTH_BATCH
    with tempfile.TemporaryDirectory() as tmp:
        data, ckpt = os.path.join(tmp, "synth"), os.path.join(tmp, "ckpt")
        out, dt = _run_cli(["synth-data", "--out", data, "--n-train", "2", "--n-test", "1",
                            "--duration", "20"])
        with open(os.path.join(data, "test_songlist.txt")) as f:
            test_song = f.read().split()[0]
        log(f"[synth] cli synth-data: {out.strip().splitlines()[-1]} ({dt:.1f} s)")

        base = ["train-synth", "--model", "scalar2sL", "--batch-size", str(B),
                "--steps-per-epoch", "3", "--checkpoint-dir", ckpt, "--run-name", "synth"]
        stft_features_dif.launches = 0
        out, dt = _in_process_cli([*base, "--epochs", "2", "--loss", "gain"])
        for line in _epoch_lines(out):
            log(f"[synth] cli: {line}")
        result = json.loads(out.strip().splitlines()[-1])
        if len(_epoch_lines(out)) != 2 or not np.isfinite(result["best_val_loss"]):
            raise AssertionError(f"train-synth: expected 2 finite epochs, got\n{out}")
        log(f"[synth] python -m tpumix_torch train-synth --model scalar2sL --batch-size {B} "
            f"--steps-per-epoch 3 --epochs 2 --loss gain: {dt:.1f} s, {json.dumps(result)}")
        out, dt = _in_process_cli([*base, "--epochs", "3", "--loss", "gain", "--resume"])
        resumed = _epoch_lines(out)
        if (len(resumed) != 1 or not resumed[0].startswith("Epoch 2:")
                or "restored epoch 1" not in out):
            raise AssertionError(f"train-synth --resume did not continue at epoch 2:\n{out}")
        log(f"[synth] cli --resume --epochs 3: {resumed[0]} ({dt:.1f} s)")
        if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
            raise AssertionError("TF32 is enabled on the train-synth path")
        out, dt = _in_process_cli(["train-synth", "--model", "scalar2sL", "--batch-size", str(B),
                                   "--steps-per-epoch", "1", "--epochs", "1", "--loss",
                                   "lstsq_tail", "--mix-bus", "full", "--checkpoint-dir", ckpt,
                                   "--run-name", "synth_lstsq_tail"])
        line = _epoch_lines(out)
        result_l = json.loads(out.strip().splitlines()[-1])
        if len(line) != 1 or not np.isfinite(result_l["best_val_loss"]):
            raise AssertionError(f"train-synth --loss lstsq_tail --mix-bus full:\n{out}")
        launches = stft_features_dif.launches
        # per step one K1 launch (the stems; "gain" and the lstsq family never
        # take the mix's spectrogram), per validation batch one: 3 epochs x (3
        # + 4) + (1 + 4)
        log(f"[synth] cli --loss lstsq_tail --mix-bus full, 1 step: {line[0]} ({dt:.1f} s); "
            f"TF32 off; launches stft_features_dif over the three runs {launches}")
        if launches != 3 * (3 + 4) + (1 + 4):
            raise AssertionError("the train-synth path did not launch K1 once per batch")

        npz = os.path.join(tmp, "synth.npz")
        out, dt = _run_cli(["export-checkpoint", "--checkpoint", result["checkpoint_dir"],
                            "--out", npz])
        log(f"[synth] cli export-checkpoint: {out.strip().splitlines()[-1]} ({dt:.1f} s)")
        mixed = os.path.join(tmp, "mixed")
        out, dt = _run_cli(["mix", "--data", os.path.join(data, "test"), "--layout", "musdb18",
                            "--song", test_song, "--model", "scalar2sL", "--checkpoint", npz,
                            "--out", mixed])
        audio, sr = wavio.read(os.path.join(mixed, f"{test_song}_mixed.wav"), always_2d=True)
        if sr != SR or audio.shape[0] != int(20.0 * SR) or not np.isfinite(audio).all():
            raise AssertionError("mix with the train-synth export wrote a bad file")
        log(f"[synth] cli mix --model scalar2sL --checkpoint synth.npz on {test_song}: "
            f"{audio.shape[0] / SR:.0f} s written, finite ({dt:.1f} s)")

    # --- wall per step and the step's device time by stage ---
    cfg = dataclasses.replace(preset("scalar2sL"), bn_momentum=0.99, use_dropout=False)
    frontend = cfg.frontend()
    C = frontend.chunk_samples(cfg.chunk_length_s)
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = TrainConfig(batch_size=B, checkpoint_dir=tmp, seed=0, loss="gain",
                           log_every_steps=1000)
        trainer = SyntheticTrainer(build_model(cfg, for_training=True), frontend, tcfg,
                                   chunk_samples=C, run_name="steady", val_batches=1)
        torch.cuda.reset_peak_memory_stats()
        trainer.fit(5, 7, 0, 2)
        st = trainer.last_epoch_stats
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[synth] SyntheticTrainer scalar2sL, second epoch of {st['steps']} steps at "
            f"[{B},4,{C}]: wall {1e3 * st['wall_s'] / st['steps']:.1f} ms/step, host wait "
            f"{1e3 * st['host_wait_s'] / st['steps']:.1f} ms/step; peak device memory "
            f"{peak:.2f} GiB ({smi})")
        state = trainer.state
        _features = make_frontend_fn(frontend)
        names = ("generation", "frontend (K1 x1)", "forward", "backward", "optimizer")
        rows = []
        for k in range(6):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(6)]
            ev[0].record()
            with torch.no_grad():
                stems, g_true = trainer._generate(_seeded_generator(11, k, trainer.device))
                ev[1].record()
                feats = _features(_dequantize_on_device(stems))
                ev[2].record()
            state.model.train()
            state.optimizer.zero_grad(set_to_none=True)
            loss = torch.mean(torch.square(state.model.gains(feats) - g_true))
            ev[3].record()
            loss.backward()
            ev[4].record()
            _apply_update(state)
            ev[5].record()
            torch.cuda.synchronize()
            rows.append([ev[i].elapsed_time(ev[i + 1]) for i in range(5)])
        med = np.median(np.array(rows[1:]), axis=0)
        log(f"[synth] one train-synth step (gain) at [{B},4,{C}], device ms by stage (median "
            f"of 5, {smi}): " + "; ".join(f"{n} {v:.3f}" for n, v in zip(names, med))
            + f"; sum {med.sum():.3f}")
        del trainer, state

        # --- one bfloat16 step: finite, state float32 ---
        bcfg = dataclasses.replace(cfg, compute_dtype="bfloat16")
        trainer = SyntheticTrainer(build_model(bcfg, for_training=True), frontend, tcfg,
                                   chunk_samples=C, run_name="bf16", val_batches=1)
        res = trainer.fit(1, 7, 0, 1)
        dtypes = {t.dtype for t in trainer.model.parameters()}
        dtypes |= {t.dtype for t in trainer.model.buffers() if t.is_floating_point()}
        dtypes |= {m.dtype for s in trainer.state.optimizer.state.values() for m in s.values()
                   if torch.is_tensor(m) and m.is_floating_point()}
        log(f"[synth] --compute-dtype bfloat16 step: train loss {res.train_loss[0]:.4f}, val "
            f"{res.val_loss[0]:.4f}; parameter, buffer and optimizer dtypes {sorted(map(str, dtypes))}")
        if not np.isfinite(res.train_loss + res.val_loss).all() or dtypes != {torch.float32}:
            raise AssertionError("the bfloat16 train-synth step is not finite with float32 state")
    log(f"[synth] phase {time.perf_counter() - t_phase:.1f} s")
    return {"stft_features_dif": launches}


def _http(addr, method, path, body=None, timeout=900):
    """``(status, body bytes, wall s)`` of one request on its own connection."""
    import http.client

    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=timeout)
    t0 = time.perf_counter()
    try:
        headers = {} if body is None else {"Content-Length": str(len(body))}
        conn.request(method, path, body=body, headers=headers)
        r = conn.getresponse()
        return r.status, r.read(), time.perf_counter() - t0
    finally:
        conn.close()


def _ok(what, status, body):
    if status != 200:
        raise AssertionError(f"{what}: HTTP {status}: {body[:500]!r}")


def _wait_warm(addr, proc=None, timeout=600.0):
    """Poll ``/healthz`` until the server reports warm; seconds waited."""
    t0 = time.perf_counter()
    while True:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"the server exited with {proc.returncode} while warming")
        status, body, _ = _http(addr, "GET", "/healthz", timeout=60)
        _ok("/healthz", status, body)
        if json.loads(body)["warm"]:
            return time.perf_counter() - t0
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("the server did not report warm in time")
        time.sleep(0.2)


def _stereo(stems: np.ndarray) -> dict:
    """A stereo stem dict from ``[4, S]`` mono stems: the right channel is the
    left one 5 ms later at 0.8, so the mono downmix is neither channel."""
    from tpumix_torch.infer.mixer import STEMS

    return {t: np.stack([stems[i], 0.8 * np.roll(stems[i], 220)]) for i, t in enumerate(STEMS)}


def _served_kernel_checks():
    """K1 at the shapes the service gives it that no earlier phase holds to
    its plain version: one chunk at hop 512 (``[1, 4, 88200]``, what
    ``/stream`` launches) and resnet18's 64-chunk segment at hop 1024
    (``[64, 4, 220500]``, every resnet18 ``/gains`` and ``/mix``), each at
    every level of ``K1_LEVELS`` and the ``[k1]`` bounds; and K2 at the
    trunk's shapes of one chunk (rtol 1e-4 / atol 5e-5).  All against the
    float64 plain versions."""
    import torch

    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops.conv_block import (
        conv_block_fused,
        conv_block_fused_plain,
        conv_block_route,
    )
    from tpumix_torch.ops.stft_dif import stft_features_dif, stft_features_dif_plain

    for hop, rows, samples in ((512, 1, 88200), (1024, 64, 220500)):
        cfg = FrontendConfig(hop_length=hop)
        shape = (rows, 4, 1 + samples // hop, 1025)
        for label, tone, noise in K1_LEVELS:
            x = torch.from_numpy(_k1_audio(tone, noise, samples)[:rows].copy()).cuda()
            got = stft_features_dif(x, cfg)
            torch.cuda.synchronize()
            mx, mean, p999, at = _db_errors(got, stft_features_dif_plain(x, cfg))
            log(f"[serve] K1 at {list(x.shape)}, hop {hop}, {label}: |kernel - plain (f64)| dB "
                f"max {mx:.4e} (in a {at[0]:.1f} dB bin) mean {mean:.3e} p99.9 {p999:.3e}")
            if not (mx < 1e-5 and mean < 1e-4 and p999 < 5e-3) or got.shape != shape:
                raise AssertionError(f"K1 at {list(x.shape)}, hop {hop} disagrees with its plain "
                                     f"version ({label}) or is not {shape}")
            if not bool(torch.isfinite(got).all()) or not bool((got[:, 3] == SILENT_DB).all()):
                raise AssertionError(f"K1 at {list(x.shape)}, hop {hop}: not finite, or the "
                                     f"silent stem is not the amin value")
            del x, got
    g = torch.Generator(device="cuda").manual_seed(5)
    for xs, ws in TRUNK_SHAPES:
        xs = (1,) + xs[1:]
        x = torch.randn(xs, device="cuda", generator=g)
        w = torch.randn(ws, device="cuda", generator=g) / float(np.sqrt(np.prod(ws[:3])))
        s = 0.5 + torch.rand(ws[-1], device="cuda", generator=g)
        t = 0.1 * torch.randn(ws[-1], device="cuda", generator=g)
        got = conv_block_fused(x, w, s, t)
        torch.cuda.synchronize()
        ref = conv_block_fused_plain(x, w, s, t)
        diff = (got - ref).abs()
        ok = bool((diff <= 5e-5 + 1e-4 * ref.abs()).all())
        log(f"[serve] K2 at one chunk {xs} * {ws}: route {conv_block_route(xs, ws)}; vs plain "
            f"(f64) max abs {float(diff.max()):.3e}; within(rtol 1e-4, atol 5e-5) {ok}")
        if not ok:
            raise AssertionError(f"K2 at one chunk disagrees with its plain version at {xs}")


# (server, path, song seconds) of the requests [serve] sends and checks ("cli":
# the CLI's server, in a subprocess).  resnet18's /mix at 300 s is left out: it
# runs on the card what its /gains at 300 s runs, and the host epilogue that
# scalar2s's /mix at 300 s already holds.
SERVED = (("scalar2s K2 trunk", "/gains", 30), ("scalar2s K2 trunk", "/mix", 30),
          ("scalar2s K2 trunk", "/gains", 300), ("scalar2s K2 trunk", "/mix", 300),
          ("resnet18", "/gains", 30), ("resnet18", "/mix", 30), ("resnet18", "/gains", 300),
          ("cli", "/gains", 30), ("cli", "/mix", 30))


def phase_serve(smi):
    """The HTTP service on the card, as users drive it: in-process servers for
    ``scalar2s`` (``scalar2s_synth.npz``, K2 trunk) and ``resnet18``
    (``resnet18_synth.npz``), and ``python -m tpumix_torch serve --port 0``
    in a subprocess on the default trunk, each warmed; ``/gains`` and ``/mix``
    on seeded 30 s and 300 s stereo songs (``SERVED``) and a chunked
    ``/stream`` of 50 two-second chunks.  Every response must be 200 and equal
    what the same mixer computes in process; the 30 s gains also agree with
    the CPU path.
    Returns the kernels' launches on the served path (the in-process
    servers' requests).  The subprocess starts first, so that its start-up
    overlaps the rest."""
    t_phase = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-m", "tpumix_torch", "serve", "--port", "0"],
                            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        return _serve_checks(smi, proc, t_phase)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()


def _serve_checks(smi, proc, t_phase):
    import threading

    import torch

    from tpumix_torch.assets import load_checkpoint
    from tpumix_torch.config import MixConfig, preset
    from tpumix_torch.data import wavio
    from tpumix_torch.infer.mixer import STEMS, SongMixer
    from tpumix_torch.infer.streaming import StreamingMixer
    from tpumix_torch.models.convert import state_dict_from_jax
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.ops.conv_block import conv_block_fused
    from tpumix_torch.ops.stft_dif import stft_features_dif
    from tpumix_torch.serve import encode_stems_wav, serve

    _served_kernel_checks()

    def mixer_for(name, device, conv_impl="auto", mix_cfg=None):
        cfg = dataclasses.replace(preset(name), conv_impl=conv_impl)
        model = build_model(cfg)
        model.load_state_dict(state_dict_from_jax(load_checkpoint(f"{name}_synth")))
        return SongMixer(model, cfg, mix_cfg, device=device)

    servers, threads = {}, []
    for label, name, conv_impl in (("scalar2s K2 trunk", "scalar2s", "pallas"),
                                   ("resnet18", "resnet18", "auto")):
        httpd = serve(mixer_for(name, "cuda", conv_impl), host="127.0.0.1", port=0,
                      model_name=name)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        threads.append((httpd, thread))
        t0 = time.perf_counter()
        warming = threading.Thread(target=httpd.service.warm)
        warming.start()
        status, body, _ = _http(httpd.server_address, "GET", "/healthz")
        _ok("/healthz", status, body)
        during = json.loads(body)["warm"]
        warming.join()
        warm_s = time.perf_counter() - t0
        status, body, _ = _http(httpd.server_address, "GET", "/healthz")
        if status != 200 or not json.loads(body)["warm"]:
            raise AssertionError(f"{label}: not warm after warm() returned")
        log(f"[serve] {label} in process on port {httpd.server_address[1]}: warm() "
            f"{warm_s:.2f} s (kernels built by [build]); /healthz during warm-up said warm "
            f"{during}")
        servers[label] = httpd

    cli_addr, lines = None, []
    while cli_addr is None:
        line = proc.stdout.readline()
        if not line:
            raise AssertionError("serve exited before printing its address:\n"
                                 + "".join(lines))
        lines.append(line)
        m = re.match(r"\[serve\] scalar2s on http://([\d.]+):(\d+)", line)
        if m:
            cli_addr = (m.group(1), int(m.group(2)))
    up_s = time.perf_counter() - t_phase
    warm_s = _wait_warm(cli_addr, proc)
    log(f"[serve] python -m tpumix_torch serve --port 0: address read {up_s:.2f} s after "
        f"start (port {cli_addr[1]}), warm {warm_s:.2f} s later ({up_s + warm_s:.2f} s from "
        f"start, beside the checks above; kernels already built)")

    songs = {30: _stereo(make_song(30.0, seed=31)), 300: _stereo(make_song(300.0, seed=32))}
    bodies = {sec: encode_stems_wav(tr) for sec, tr in songs.items()}
    stream_stems = make_song(100.0, seed=33)

    # the served path: every request of the in-process servers, counted
    stft_features_dif.launches = 0
    conv_block_fused.launches = 0
    replies = {}
    for label, path, secs in SERVED:
        if label == "cli":
            continue
        status, body, wall = _http(servers[label].server_address, "POST", path, bodies[secs])
        _ok(f"{label} {path} {secs} s", status, body)
        replies[label, path, secs] = (body, wall)
    s2 = servers["scalar2s K2 trunk"]
    C = s2.service.mixer.chunk_samples
    blocks = [stream_stems[:, i * C:(i + 1) * C].astype("<f4") for i in range(50)]
    streamed, push_ms = _stream(s2.server_address, blocks, C)
    launches = {"stft_features_dif": stft_features_dif.launches,
                "conv_block_fused": conv_block_fused.launches}
    log(f"[serve] served path (in-process servers' requests): launches stft_features_dif "
        f"{launches['stft_features_dif']} conv_block_fused {launches['conv_block_fused']}")
    for label, path, secs in SERVED:
        if label != "cli":
            continue
        status, body, wall = _http(cli_addr, "POST", path, bodies[secs])
        _ok(f"{label} {path} {secs} s", status, body)
        replies[label, path, secs] = (body, wall)
    for httpd, thread in threads:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    # what the same mixers compute in process, and the CPU path on 30 s
    mixers = {label: httpd.service.mixer for label, httpd in servers.items()}
    mixers["cli"] = mixer_for("scalar2s", "cuda")
    cpu = {"scalar2s K2 trunk": mixer_for("scalar2s", "cpu", mix_cfg=MixConfig(max_chunks=16)),
           "resnet18": mixer_for("resnet18", "cpu", mix_cfg=MixConfig(max_chunks=8))}
    smoothed = {}  # mix_song_smooth of each served song, shared by its /gains and /mix
    for (label, path, secs), (body, wall) in replies.items():
        mixer, tracks = mixers[label], songs[secs]
        if (label, secs) not in smoothed:
            smoothed[label, secs] = mixer.mix_song_smooth(tracks)
        mixed_tracks, raw, smooth = smoothed[label, secs]
        if path == "/gains":
            payload = json.loads(body)
            mono = np.stack([tracks[t].mean(axis=0) for t in STEMS])
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            gains = mixer.song_gains(mono)
            b.record()
            b.synchronize()
            gap = max(float(np.abs(np.asarray(payload[k][t]) - np.asarray(ref[t])).max())
                      for k, ref in (("raw", raw), ("smooth", smooth)) for t in STEMS)
            line = (f"[serve] {label} /gains {secs} s: body {len(bodies[secs])} B in, "
                    f"{len(body)} B out; wall {wall * 1e3:.1f} ms; gains {a.elapsed_time(b):.2f} ms "
                    f"by CUDA events around song_gains of the same song in process ({gains.shape[0]} "
                    f"gains; host packing between launches included); |served - in process| max "
                    f"{gap:.2e}")
            if gap > 1e-6:
                raise AssertionError(f"{label} /gains {secs} s differs from mix_song_smooth")
            if secs == 30 and label in cpu:
                served = 2.0 * np.log10(np.array([payload["raw"][t] for t in STEMS]).T)
                mae = float(np.abs(served - cpu[label].song_gains(mono)).mean(axis=0).max())
                line += f"; dB-scalar MAE vs the CPU path {mae:.3e}"
                if mae > 1e-3:
                    raise AssertionError(f"{label}: served gains disagree with the CPU path")
            log(line)
        else:
            import io

            audio, sr = wavio.read(io.BytesIO(body), always_2d=True)
            ref = sum(mixed_tracks[t] for t in STEMS)  # mix_song: summed, peak-normalised
            ref = ref / np.max(np.abs(ref))
            gap = float(np.abs(audio.T - ref).max()) if audio.T.shape == ref.shape else np.inf
            log(f"[serve] {label} /mix {secs} s: body {len(bodies[secs])} B in, {len(body)} B "
                f"out; wall {wall * 1e3:.1f} ms; |served - mix_song| max {gap:.2e}")
            if sr != SR or gap > 1e-6 or not np.isfinite(audio).all():
                raise AssertionError(f"{label} /mix {secs} s differs from mix_song")

    seg_ms = {}
    g = torch.Generator(device="cuda").manual_seed(35)
    for label, mixer in mixers.items():
        wire = 0.1 * torch.randn(4, 64 * mixer.chunk_samples, device="cuda", generator=g)
        seg_ms[label] = time_ms(lambda: mixer._gains_fn(wire, 64), reps=5, warmup=1)
        del wire
    log("[serve] one 64-chunk segment from a float32 wire on the card (_gains_fn: decode, K1, "
        "trunk, heads), device ms, CUDA events, median of 5: " + "; ".join(
            f"{label} {ms:.3f}" for label, ms in seg_ms.items()) + f"  ({smi})")

    mixer = mixers["scalar2s K2 trunk"]
    sm = StreamingMixer(mixer.model, mixer.model_cfg, device="cuda")
    gap = max(float(np.abs(m - sm.push(b)).max()) for b, m in zip(blocks, streamed))
    p50, p99 = np.percentile(push_ms, 50), np.percentile(push_ms, 99)
    log(f"[serve] /stream scalar2s K2 trunk, {len(blocks)} chunks of 2 s: per push (send to "
        f"answer) p50 {p50:.2f} ms p99 {p99:.2f} ms max {max(push_ms):.2f} ms; real-time "
        f"factor {2000.0 / p50:.1f} at p50, {2000.0 / p99:.1f} at p99; |served - StreamingMixer| "
        f"max {gap:.2e}  ({smi})")
    if gap > 1e-6:
        raise AssertionError("/stream differs from a StreamingMixer fed the same chunks")
    log(f"[serve] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def _stream(addr, blocks, C):
    """Push ``blocks`` through ``POST /stream`` one at a time, each answered
    before the next is sent: ``(mixed chunks, ms per push)``."""
    import http.client

    conn = http.client.HTTPConnection(addr[0], addr[1], timeout=600)
    conn.putrequest("POST", "/stream")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.endheaders()

    def send(block):
        raw = block.tobytes()
        conn.send(f"{len(raw):x}\r\n".encode() + raw + b"\r\n")

    def read(fp):
        out = b""
        while len(out) < C * 4:
            size = int(fp.readline().strip(), 16)
            if size <= 0:
                raise AssertionError("/stream ended early")
            out += fp.read(size)
            fp.read(2)
        return np.frombuffer(out, dtype="<f4")

    try:
        t0 = time.perf_counter()
        send(blocks[0])
        resp = conn.response_class(conn.sock, method="POST")
        resp.begin()
        _ok("/stream", resp.status, b"")
        mixed, push_ms = [read(resp.fp)], [(time.perf_counter() - t0) * 1e3]
        for block in blocks[1:]:
            t0 = time.perf_counter()
            send(block)
            mixed.append(read(resp.fp))
            push_ms.append((time.perf_counter() - t0) * 1e3)
        conn.send(b"0\r\n\r\n")
        if int(resp.fp.readline().strip(), 16) != 0:
            raise AssertionError("/stream did not end with the last chunk")
    finally:
        conn.close()
    return mixed, push_ms


def _write_musdb_corpus(root: str, songs, seconds: float) -> None:
    """A seeded MUSDB18-layout corpus: ``test/<song>/{stems,mixture}.wav``
    (stereo float32) and ``manual_gain_mixes/<song>/{stems}.wav``, the same
    stems at per-stem gains an engineer might set."""
    from tpumix_torch.data import wavio
    from tpumix_torch.infer.mixer import STEMS

    manual = np.array([1.4, 0.8, 1.2, 0.6], np.float32)
    for k, song in enumerate(songs):
        tracks = _stereo(make_song(seconds, seed=40 + k))
        for sub in ("test", "manual_gain_mixes"):
            d = os.path.join(root, sub, song)
            os.makedirs(d)
            for i, t in enumerate(STEMS):
                gain = manual[i] if sub == "manual_gain_mixes" else 1.0
                wavio.write(os.path.join(d, f"{t}.wav"), (gain * tracks[t]).T, SR)
        wavio.write(os.path.join(root, "test", song, "mixture.wav"),
                    sum(tracks[t] for t in STEMS).T, SR)


def phase_eval(smi):
    """The evaluation path on the card, on a seeded two-song MUSDB18-layout
    corpus: ``mean-loudness`` (equal to ``compute_mean_loudness``) beside
    ``evaluate`` with the device meter and with the host meter (every stats
    cell within 0.1 LU of its host-meter counterpart); then the device meter
    on a seeded 300 s four-stem stereo song against the host meter (<= 0.1
    LU), with its time and peak memory."""
    import csv

    import torch

    from tpumix_torch.data.dataset import MultitrackAudioDataset
    from tpumix_torch.infer.mixer import STEMS
    from tpumix_torch.ops.loudness import integrated_loudness, integrated_loudness_torch

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        songs = ["EvalSongA", "EvalSongB"]
        _write_musdb_corpus(tmp, songs, 20.0)
        listing = os.path.join(tmp, "songs.txt")
        with open(listing, "w") as f:
            f.write("\n".join(songs) + "\n")
        # the evaluate runs read the in-process mean loudness, so that the
        # mean-loudness CLI runs beside them; its JSON must equal it
        ml = os.path.join(tmp, "ml.json")
        expected = MultitrackAudioDataset(os.path.join(tmp, "test"),
                                          layout="musdb18").compute_mean_loudness()
        with open(ml, "w") as f:
            json.dump(expected, f)
        stats, runs = {}, {}
        env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
        evaluate = ["evaluate", "--data", tmp, "--layout", "musdb18", "--songlist", listing,
                    "--mean-loudness", ml, "--out"]
        t0 = time.perf_counter()
        for run, args in (  # side by side
                ("mean-loudness", ["mean-loudness", "--data", os.path.join(tmp, "test"),
                                   "--layout", "musdb18", "--out", os.path.join(tmp, "cli.json")]),
                ("device", evaluate + [os.path.join(tmp, "device"), "--device-meter"]),
                ("host", evaluate + [os.path.join(tmp, "host")])):
            runs[run] = subprocess.Popen([sys.executable, "-m", "tpumix_torch", *args], cwd=ROOT,
                                         env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True)
        try:
            for run, proc in runs.items():
                out, _ = proc.communicate(timeout=600)
                if proc.returncode != 0:
                    raise AssertionError(f"{run} failed ({proc.returncode}):\n{out}")
        finally:
            for proc in runs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        wall = time.perf_counter() - t0
        with open(os.path.join(tmp, "cli.json")) as f:
            mean_loudness = json.load(f)
        log(f"[eval] mean-loudness (three runs side by side, {wall:.1f} s): " + ", ".join(
            f"{k} {v:.3f}" for k, v in mean_loudness.items()) + "; equal to compute_mean_loudness "
            f"in process: {mean_loudness == expected}")
        if mean_loudness != expected:
            raise AssertionError(f"mean-loudness wrote {mean_loudness}, not {expected}")
        for meter in ("device", "host"):
            with open(os.path.join(tmp, meter, "stats.csv")) as f:
                stats[meter] = list(csv.reader(f))
            log(f"[eval] evaluate, {meter} meter: {stats[meter][1:]}")
        worst = 0.0
        for rd, rh in zip(stats["device"][1:], stats["host"][1:]):
            vals = [(float(a), float(b)) for a, b in zip(rd[1:], rh[1:])]
            if rd[0] != rh[0] or not all(np.isfinite(v).all() for v in vals):
                raise AssertionError(f"bad stats rows {rd} / {rh}")
            worst = max(worst, max(abs(a - b) for a, b in vals))
        log(f"[eval] evaluate: every stats cell, device meter vs host meter: max |d| {worst:.4f} LU")
        if worst > 0.1:
            raise AssertionError("the device meter's stats disagree with the host meter's")

    tracks = _stereo(make_song(300.0, seed=34))
    batch = np.stack([tracks[t] for t in STEMS])  # [4, 2, S]
    n = batch.shape[-1]
    bucket = 1 << int(np.ceil(np.log2(n)))  # what the evaluator pads to
    padded = torch.from_numpy(np.pad(batch, ((0, 0), (0, 0), (0, bucket - n)))).cuda()
    exact = torch.from_numpy(batch).cuda()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    dev = integrated_loudness_torch(padded, SR).cpu().numpy()
    peak = torch.cuda.max_memory_allocated() - base
    dev_exact = integrated_loudness_torch(exact, SR).cpu().numpy()
    ms = time_ms(lambda: integrated_loudness_torch(padded, SR), reps=5, warmup=1)
    t0 = time.perf_counter()
    host = np.array([integrated_loudness(tracks[t].T, SR) for t in STEMS])
    host_s = time.perf_counter() - t0
    d_pad, d_exact = float(np.abs(dev - host).max()), float(np.abs(dev_exact - host).max())
    log(f"[eval] device meter, 300 s four-stem stereo song [4, 2, {n}] padded to {bucket}: "
        f"{ms:.2f} ms (CUDA events, median of 5), peak {peak / 2**30:.3f} GiB above the "
        f"{padded.numel() * 4 / 2**30:.3f} GiB input; host meter (scipy lfilter, float64) "
        f"{host_s:.3f} s, {host_s * 1e3 / ms:.0f}x the device meter; LUFS host "
        f"{np.round(host, 4).tolist()} device {np.round(dev, 4).tolist()}: max |d| {d_pad:.4f} "
        f"LU padded, {d_exact:.4f} LU unpadded  ({smi})")
    if not np.isfinite(dev).all() or max(d_pad, d_exact) > 0.1:
        raise AssertionError("the device meter disagrees with the host meter on 300 s")
    log(f"[eval] phase {time.perf_counter() - t_phase:.1f} s")


PHASES = ("k1", "k2", "k3", "k4", "hyb", "main", "time", "study", "cli", "train", "synth",
          "dp", "sp", "serve", "eval", "dmc")
MULTI_CARD_PHASES = ("dp4",)  # asked for by name only: they need four cards


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run (default: all but dp4, "
                         "which needs four cards and runs only when named; the kernel record "
                         "and the ok line are printed only by a full run)")
    ap.add_argument("--compare-with", metavar="DIR",
                    help="also time the frontend entries of the tpumix_torch in DIR (e.g. a git "
                         "archive of another commit) against this checkout's, in turns")
    ap.add_argument("--entry-times", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--dp-rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--dp-init", help=argparse.SUPPRESS)
    ap.add_argument("--dp-work", help=argparse.SUPPRESS)
    ap.add_argument("--dp-mode", default="dp", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES) - set(MULTI_CARD_PHASES))
    if unknown:
        ap.error(f"unknown phases {unknown}; have {PHASES + MULTI_CARD_PHASES}")

    t_start = time.perf_counter()
    sys.path.insert(0, os.path.abspath(args.entry_times or ROOT))
    if args.entry_times:  # one side of phase_compare: a JSON line, nothing else
        import torch

        if not torch.cuda.is_available():
            return 2
        import tpumix_torch  # noqa: F401

        print(json.dumps(entry_times()))
        return 0
    if args.dp_rank is not None:  # one rank of phase_dp or phase_sp
        rank_fn = _sp_rank if args.dp_mode == "sp" else _dp_rank
        return rank_fn(args.dp_rank, args.dp_init, args.dp_work)
    name, smi = phase_device()
    import torch

    import tpumix_torch  # noqa: F401 — fails outside a checkout of the repository
    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.ops.stft_basis import stft_features_basis, stft_features_basis_plain
    from tpumix_torch.ops.stft_ct import stft_features_ct, stft_features_ct_plain
    from tpumix_torch.ops.stft_dif import stft_features_dif, stft_features_dif_plain
    from tpumix_torch.utils.device import disable_tf32

    disable_tf32()  # the yardsticks run in full f32, like the port
    rates = peak_rates(name)
    log(f"[device] bounds from {rates[2]}: {rates[0] / 1e12:.1f} TFLOP/s FP32, "
        f"{rates[3] / 1e12:.0f} TFLOP/s TF32 (tensor cores, dense), {rates[1] / 1e12:.2f} TB/s")
    if args.compare_with:
        phase_compare(os.path.abspath(args.compare_with), smi)
    phase_build()

    def f32(plain):
        return lambda x, cfg: plain(x, cfg, dtype=torch.float32)

    kernels = {}
    if "k1" in phases:
        kernels["stft_features_dif"] = phase_frontend_kernel(
            "k1", rates, stft_features_dif, stft_features_dif_plain,
            {"name": "stft_features_dif", "source": "tpumix_torch/csrc/stft_dif.cu",
             "replaces": "tpumix/ops/stft_dif_pallas.py:318"}, max_db=0.1,
            extra_timing=("hop 1024 (the resnet18 frontend)", FrontendConfig(hop_length=1024),
                          (64, 4, 220500)), edge_hops=(128, 512, 1024), max_held=1e-5,
            fp64_per_frame=DIF_FP64_PER_FRAME)
        dif_stage_times(smi)
    if "k2" in phases:
        kernels["conv_block_fused"] = phase_k2(rates, smi)
    if "k3" in phases:
        kernels["stft_features_basis"] = phase_frontend_kernel(
            "k3", rates, stft_features_basis, stft_features_basis_plain,
            {"name": "stft_features_basis", "source": "tpumix_torch/csrc/stft_basis.cu",
             "replaces": "tpumix/ops/stft_pallas.py:165"}, max_db=0.2,
            f32_plain=f32(stft_features_basis_plain), auto_hop=(8, 2, 4096))
        phase_k3_sizes(rates, smi)
    if "k4" in phases:
        # the DIT entry launches the DIF kernel; held to the DIT float64 plain version
        kernels["stft_features_ct"] = phase_frontend_kernel(
            "k4", rates, stft_features_ct, stft_features_ct_plain,
            {"name": "stft_features_ct", "source": "tpumix_torch/csrc/stft_dif.cu",
             "replaces": "tpumix/ops/stft_ct_pallas.py:186"}, max_db=0.1,
            f32_plain=f32(stft_features_ct_plain), auto_hop=(64, 3, 22050),
            extra_timing=("hop 64 (what 'auto' gives this entry)", FrontendConfig(hop_length=64),
                          (64, 4, 88200)), edge_hops=(16, 64), max_held=1e-5,
            fp64_per_frame=DIF_FP64_PER_FRAME)
    if "hyb" in phases:
        phase_hybrids()
    launches = {}  # per kernel, summed over the serving and the training path
    if "main" in phases:
        launches.update(phase_main_path())
    if "time" in phases:
        phase_breakdown()
    if "study" in phases:
        for kname, n in phase_study(rates, smi).items():
            launches[kname] = launches.get(kname, 0) + n
    if "cli" in phases:
        phase_cli()
    if "train" in phases:
        for kname, n in phase_train(smi).items():
            launches[kname] = launches.get(kname, 0) + n
    if "synth" in phases:
        for kname, n in phase_synth(smi).items():
            launches[kname] = launches.get(kname, 0) + n
    if "dp" in phases:
        for kname, n in phase_dp(smi).items():
            launches[kname] = launches.get(kname, 0) + n
    if "sp" in phases:
        for kname, n in phase_sp(smi).items():
            launches[kname] = launches.get(kname, 0) + n
    if "serve" in phases:
        for kname, n in phase_serve(smi).items():
            launches[kname] = launches.get(kname, 0) + n
    if "eval" in phases:
        phase_eval(smi)
    if "dmc" in phases:
        phase_dmc(smi)
    if "dp4" in phases:
        phase_dp4(smi)
    log(f"[done] {time.perf_counter() - t_start:.1f} s on {smi}")
    if set(phases) != set(PHASES):
        log(f"[done] partial run ({','.join(phases)}): no kernel record, no ok line")
        return 0
    for kname, kern in kernels.items():
        kern["launches"] = launches[kname]
        if kern["launches"] <= 0:
            raise AssertionError(f"the main path never launched {kname}")
        if kern["ms"] < kern["bound_ms"]:
            raise AssertionError(f"{kname} reads faster than its bound")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: kern[k] for k in keys} for kern in kernels.values()]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
