"""HTTP mixing service (tpumix/serve.py): one process owns a ``SongMixer`` on the
card and serves mixing requests over HTTP with the standard library only.

Protocol
--------
``POST /mix``    body: the 4 stems as one float32 WAV with 4*channels
    interleaved channels (channels 0..c-1 = bass, c..2c-1 = drums, then
    vocals, other) and an int32 channels-per-stem trailer
    (:func:`encode_stems_wav`).  Response: the mixed song as a float32 WAV.
``POST /gains``  same body; response: JSON ``{"raw": {...}, "smooth": {...}}``
    per-stem gain curves.
``POST /stream`` live mixing, chunked transfer encoding both ways.  The
    client streams raw little-endian float32 blocks of exactly
    ``4 * chunk_samples`` samples (bass, drums, vocals, other mono chunks
    concatenated); the server answers each block with the causally mixed
    ``chunk_samples`` float32 samples before the next block arrives
    (``infer/streaming.py``: one chunk of algorithmic latency).
``GET  /streaminfo`` -> {"chunk_samples": N, "sample_rate": 44100}
``GET  /healthz`` -> {"status": "ok", "model": ..., "requests": N, "warm": bool}

Threads: ``ThreadingHTTPServer`` runs each request on its own thread.
``/mix`` and ``/gains`` are serialised by the service lock; ``/stream``
pushes run outside it, so several connections run the shared segment-1
mixer at once.  That is safe because the model is in eval mode under
``inference_mode`` and nothing on the path writes to it, and each thread
launches on its own current stream (the legacy default stream unless a
caller set another).

Start:  ``python -m tpumix_torch serve --model scalar2s [--checkpoint ...] --port 8080``
"""

from __future__ import annotations

import io
import json
import struct
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Tuple

import numpy as np

from tpumix_torch.config import MixConfig
from tpumix_torch.data import wavio
from tpumix_torch.infer.mixer import SongMixer
from tpumix_torch.infer.streaming import StreamingMixer
from tpumix_torch.utils.profiling import span

STEMS: Tuple[str, ...] = ("bass", "drums", "vocals", "other")

# Upper bound on a single client-declared HTTP request chunk (the wire
# protocol's natural unit is one 4-stem float32 audio block, well under 2 MB
# even for the 2 s model — 8 MB leaves headroom without letting one
# connection buffer gigabytes).
MAX_REQUEST_CHUNK_BYTES = 8 * 1024 * 1024


def encode_stems_wav(tracks: dict, sr: int = 44100) -> bytes:
    """Pack a stem dict (each ``[channels, S]`` or ``[S]``) into one WAV with
    stems stacked on the channel axis (the service wire format)."""
    arrs = []
    for t in STEMS:
        a = np.asarray(tracks[t], dtype=np.float32)
        if a.ndim == 1:
            a = a[None, :]
        arrs.append(a)
    ch = arrs[0].shape[0]
    if any(a.shape != arrs[0].shape for a in arrs):
        raise ValueError("all stems must share shape")
    stacked = np.concatenate(arrs, axis=0)  # [4*ch, S]
    buf = io.BytesIO()
    _write_wav_bytes(buf, stacked.T, sr)
    return buf.getvalue() + np.int32(ch).tobytes()  # trailer: channels/stem


def _write_wav_bytes(buf, data_sc, sr):
    data = np.asarray(data_sc, dtype="<f4")
    frames, channels = data.shape
    payload = data.tobytes()
    block_align = channels * 4
    buf.write(b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE")
    buf.write(b"fmt " + struct.pack("<IHHIIHH", 16, 3, channels, sr, sr * block_align,
                                    block_align, 32))
    buf.write(b"data" + struct.pack("<I", len(payload)) + payload)


def decode_stems_wav(body: bytes) -> Tuple[dict, int]:
    """Inverse of :func:`encode_stems_wav` -> (tracks dict, sample rate)."""
    ch = int(np.frombuffer(body[-4:], dtype=np.int32)[0])
    audio, sr = wavio.read(io.BytesIO(body[:-4]), always_2d=True)  # [S, 4*ch]
    stacked = audio.T  # [4*ch, S]
    tracks = {t: stacked[i * ch : (i + 1) * ch] for i, t in enumerate(STEMS)}
    return tracks, sr


class MixingService:
    """Owns the mixer; ``/mix`` and ``/gains`` are serialised through a lock
    (one device, one in-flight song keeps tail latency predictable)."""

    def __init__(self, mixer: SongMixer):
        self.mixer = mixer
        self.lock = threading.Lock()
        self.requests = 0
        self.warmed = False
        self._stream_inner = None  # shared segment-1 SongMixer, built lazily

    def warm(self, stream: bool = True) -> None:
        """Run every device path the service launches once before the first
        request: a 64-chunk segment (``/mix``, ``/gains``) and, with
        ``stream``, a one-chunk segment (``/stream``).  On the card that
        builds the kernels (nvcc at first use), lets cuDNN choose its
        algorithms for both shapes and makes the allocator's first blocks.
        ``/healthz`` answers throughout and reports ``"warm"``."""
        rng = np.random.default_rng(0)
        C = self.mixer.chunk_samples
        song = {t: (0.01 * rng.standard_normal((1, 2 * C))).astype(np.float32)
                for t in STEMS}
        with self.lock:
            self.mixer.mix_song(song)
        if stream:
            sm = self.make_streaming()
            with self.lock:
                self.requests -= 1  # warm-up is not a served request
            sm.push((0.01 * rng.standard_normal((4, C))).astype(np.float32))
        self.warmed = True

    def mix(self, tracks) -> np.ndarray:
        with self.lock:
            self.requests += 1
            return self.mixer.mix_song(tracks)

    def gains(self, tracks):
        with span("service.gains"), self.lock:
            self.requests += 1
            _, raw, smooth = self.mixer.mix_song_smooth(tracks)
            return raw, smooth

    def make_streaming(self) -> StreamingMixer:
        """Per-connection causal mixer.  The segment-size-1 ``SongMixer`` is
        built once, on the service mixer's device, and shared by every
        connection; only the smoothing state is per connection."""
        with self.lock:
            self.requests += 1
            if self._stream_inner is None:
                self._stream_inner = SongMixer(
                    self.mixer.model, self.mixer.model_cfg,
                    mix_cfg=MixConfig(chunk_length_s=self.mixer.model_cfg.chunk_length_s,
                                      max_chunks=1),
                    device=self.mixer.device,
                )
            return StreamingMixer(self.mixer.model, self.mixer.model_cfg,
                                  inner_mixer=self._stream_inner)


def make_handler(service: MixingService, model_name: str):
    class Handler(BaseHTTPRequestHandler):
        # chunked Transfer-Encoding (the /stream endpoint, both directions)
        # only exists in HTTP/1.1
        protocol_version = "HTTP/1.1"

        def log_message(self, *args):  # quiet
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"status": "ok", "model": model_name,
                                 "requests": service.requests,
                                 "warm": service.warmed})
            elif self.path == "/streaminfo":
                self._json(200, {"chunk_samples": service.mixer.chunk_samples,
                                 "sample_rate": 44100})
            else:
                self._json(404, {"error": "unknown path"})

        # ---- live streaming ---------------------------------------------

        def _iter_request_chunks(self):
            """Yield the raw bytes of each HTTP request chunk
            (Transfer-Encoding: chunked wire format)."""
            while True:
                # RFC allows chunk extensions after ';' — bound generously
                size_line = self.rfile.readline(1024).strip()
                if not size_line:
                    return
                size = int(size_line.split(b";")[0], 16)
                if size == 0:
                    self.rfile.readline()  # trailing CRLF after last-chunk
                    return
                if size > MAX_REQUEST_CHUNK_BYTES:
                    # a declared size like 'ffffffff' would otherwise buffer
                    # ~4 GB per connection on this threaded server
                    raise ValueError(
                        f"request chunk of {size} bytes exceeds the "
                        f"{MAX_REQUEST_CHUNK_BYTES}-byte cap"
                    )
                data = self.rfile.read(size)
                self.rfile.read(2)  # CRLF
                yield data

        def _do_stream(self):
            if "chunked" not in (self.headers.get("Transfer-Encoding") or "").lower():
                self._json(400, {"error": "POST /stream requires chunked transfer"})
                return
            sm = service.make_streaming()
            block_bytes = sm.chunk_samples * len(STEMS) * 4
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            pending = b""
            for frag in self._iter_request_chunks():
                pending += frag
                while len(pending) >= block_bytes:
                    block, pending = pending[:block_bytes], pending[block_bytes:]
                    stems = np.frombuffer(block, dtype="<f4").reshape(
                        len(STEMS), sm.chunk_samples
                    )
                    mixed = np.ascontiguousarray(sm.push(stems), dtype="<f4").tobytes()
                    self.wfile.write(f"{len(mixed):x}\r\n".encode() + mixed + b"\r\n")
                    self.wfile.flush()
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

        def send_response(self, *a, **k):
            self._response_started = True
            super().send_response(*a, **k)

        def do_POST(self):
            self._response_started = False
            try:
                if self.path == "/stream":
                    self._do_stream()
                    return
                length = int(self.headers.get("Content-Length", "0"))
                body = self.rfile.read(length)
                tracks, sr = decode_stems_wav(body)
                if self.path == "/mix":
                    mixed = service.mix(tracks)
                    buf = io.BytesIO()
                    _write_wav_bytes(buf, np.atleast_2d(mixed).T
                                     if mixed.ndim == 1 else mixed.T, sr)
                    data = buf.getvalue()
                    self.send_response(200)
                    self.send_header("Content-Type", "audio/wav")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/gains":
                    raw, smooth = service.gains(tracks)
                    self._json(200, {"raw": raw, "smooth": smooth})
                else:
                    self._json(404, {"error": "unknown path"})
            except Exception as e:  # noqa: BLE001 — service boundary
                if self._response_started:
                    # headers or body already on the wire: a second status
                    # line would corrupt the HTTP/1.1 keep-alive stream, so
                    # drop the connection instead
                    self.close_connection = True
                    return
                self._json(400, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def serve(mixer: SongMixer, host: str = "127.0.0.1", port: int = 8080,
          model_name: str = "scalar2s", warmup: bool = False) -> ThreadingHTTPServer:
    """Build the server (call ``serve_forever()`` on the result, or run it on
    a thread in tests); ``httpd.server_address`` is the bound address.

    ``warmup=True`` warms the device paths before returning (see
    :meth:`MixingService.warm`), before the socket accepts.  A serving
    process instead starts ``serve_forever()`` on a thread first and then
    calls ``httpd.service.warm()``, so ``/healthz`` answers (``warm: false``)
    throughout — that is what ``python -m tpumix_torch serve`` does."""
    service = MixingService(mixer)
    httpd = ThreadingHTTPServer((host, port), make_handler(service, model_name))
    httpd.service = service  # expose for warm-up, tests, introspection
    if warmup:
        service.warm()
    return httpd
