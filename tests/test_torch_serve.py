"""The port's HTTP mixing service on the CPU (``device="cpu"``, port 0): the
wire format byte for byte against the JAX package's, ``/healthz`` and
``/streaminfo``, ``/gains`` against the same mixer in process (1e-6) and the
JAX ``SongMixer`` (dB-scalar MAE <= 1e-3, tests/test_infer.py:82), ``/mix``
against ``mix_song`` (1e-6), a chunked ``/stream`` against a
``StreamingMixer`` fed the same chunks, the shared segment-1 inner mixer on
the service's device, the oversized-chunk refusal, ``/healthz`` during
warm-up, concurrent ``/gains`` with a live stream, and ``python -m
tpumix_torch serve`` in a subprocess.  The model is the shipped one-second
``scalar1sL_synth`` in segments of 4 chunks, so every trunk run is small."""

import http.client
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from tpumix.assets import load_checkpoint as jax_load_checkpoint
from tpumix.config import MixConfig as JaxMixConfig
from tpumix.config import preset as jax_preset
from tpumix.infer.mixer import SongMixer as JaxSongMixer
from tpumix.models.registry import build_model as jax_build_model
from tpumix.serve import decode_stems_wav as jax_decode_stems_wav
from tpumix.serve import encode_stems_wav as jax_encode_stems_wav
from tpumix_torch import serve as serve_mod
from tpumix_torch.assets import load_checkpoint
from tpumix_torch.config import MixConfig, preset
from tpumix_torch.data import wavio
from tpumix_torch.infer.mixer import SongMixer
from tpumix_torch.infer.streaming import StreamingMixer
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.serve import MixingService, decode_stems_wav, encode_stems_wav, serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
MODEL = "scalar1sL"
STEMS = ("bass", "drums", "vocals", "other")


def _mixer():
    model = build_model(preset(MODEL))
    model.load_state_dict(state_dict_from_jax(load_checkpoint(f"{MODEL}_synth")))
    return SongMixer(model, preset(MODEL), MixConfig(chunk_length_s=1.0, max_chunks=4),
                     device="cpu")


@pytest.fixture(scope="module")
def server():
    httpd = serve(_mixer(), host="127.0.0.1", port=0, model_name=MODEL, warmup=True)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd
    httpd.shutdown()
    t.join(timeout=30)


@pytest.fixture(scope="module")
def tracks():
    rng = np.random.default_rng(0)
    n = 5 * SR
    level = np.repeat(rng.uniform(0.05, 0.4, size=(4, 1, 5)), SR, axis=2)
    return {t: (level[i] * rng.standard_normal((2, n))).astype(np.float32)
            for i, t in enumerate(STEMS)}


def _post(httpd, path, body, timeout=300):
    host, port = httpd.server_address
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=body, headers={"Content-Length": str(len(body))})
        r = conn.getresponse()
        return r.status, r.read()
    finally:
        conn.close()


def _get(httpd, path):
    host, port = httpd.server_address
    conn = http.client.HTTPConnection(host, port, timeout=60)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        return r.status, json.loads(r.read())
    finally:
        conn.close()


def test_wire_format_is_the_jax_packages(tracks):
    body = encode_stems_wav(tracks)
    assert body == jax_encode_stems_wav(tracks)
    mono = {t: tracks[t][0] for t in STEMS}
    assert encode_stems_wav(mono) == jax_encode_stems_wav(mono)
    for decode in (decode_stems_wav, jax_decode_stems_wav):
        decoded, sr = decode(body)
        assert sr == SR
        for t in STEMS:
            np.testing.assert_array_equal(decoded[t], tracks[t])


def test_healthz_and_streaminfo(server):
    status, payload = _get(server, "/healthz")
    assert status == 200
    assert payload["status"] == "ok" and payload["model"] == MODEL
    assert payload["warm"] is True  # warm-up ran and is not a counted request
    assert _get(server, "/streaminfo") == (200, {"chunk_samples": SR, "sample_rate": SR})
    assert _get(server, "/nope")[0] == 404


def test_gains_request(server, tracks):
    status, body = _post(server, "/gains", encode_stems_wav(tracks))
    assert status == 200, body
    payload = json.loads(body)
    _, raw, smooth = server.service.mixer.mix_song_smooth(tracks)
    for t in STEMS:
        assert len(payload["raw"][t]) == 4  # 5 chunks -> 4 gains
        np.testing.assert_allclose(payload["raw"][t], raw[t], rtol=0, atol=1e-6)
        np.testing.assert_allclose(payload["smooth"][t], smooth[t], rtol=0, atol=1e-6)
    cfg = jax_preset(MODEL)
    jax_mixer = JaxSongMixer(jax_build_model(cfg), jax_load_checkpoint(f"{MODEL}_synth"), cfg,
                             JaxMixConfig(chunk_length_s=1.0, max_chunks=4))
    ref = jax_mixer.song_gains(np.stack([tracks[t].mean(axis=0) for t in STEMS]))
    served = 2.0 * np.log10(np.array([payload["raw"][t] for t in STEMS]).T)  # dB scalars
    assert np.ptp(ref, axis=0).max() > 1e-3  # the heads respond to the levels
    for i, t in enumerate(STEMS):
        assert np.mean(np.abs(served[:, i] - ref[:, i])) <= 1e-3, t


def test_mix_request(server, tracks):
    status, wav = _post(server, "/mix", encode_stems_wav(tracks))
    assert status == 200
    assert wav[:4] == b"RIFF"
    import io

    audio, sr = wavio.read(io.BytesIO(wav), always_2d=True)
    expect = server.service.mixer.mix_song(tracks)  # [2, S]
    assert sr == SR and audio.shape == (5 * SR, 2)
    np.testing.assert_allclose(audio.T, expect, rtol=0, atol=1e-6)


def test_bad_requests(server):
    status, body = _post(server, "/mix", b"garbage")
    assert status == 400 and b"error" in body
    host, port = server.server_address
    conn = http.client.HTTPConnection(host, port, timeout=60)
    conn.request("POST", "/stream", body=b"x", headers={"Content-Length": "1"})
    r = conn.getresponse()
    assert r.status == 400 and b"chunked" in r.read()
    conn.close()


def _open_stream(server):
    host, port = server.server_address
    conn = http.client.HTTPConnection(host, port, timeout=300)
    conn.putrequest("POST", "/stream")
    conn.putheader("Transfer-Encoding", "chunked")
    conn.endheaders()
    return conn


def _send_block(conn, block, split=False):
    raw = block.astype("<f4").tobytes()
    pieces = (raw[: len(raw) // 2], raw[len(raw) // 2:]) if split else (raw,)
    for piece in pieces:
        conn.send(f"{len(piece):x}\r\n".encode() + piece + b"\r\n")


def _read_block(fp, C=SR):
    out = b""
    while len(out) < C * 4:
        size = int(fp.readline().strip(), 16)
        assert size > 0
        got = b""
        while len(got) < size:
            got += fp.read(size - len(got))
        fp.read(2)
        out += got
    return np.frombuffer(out, dtype="<f4")


def test_live_stream_matches_streaming_mixer(server):
    """Each block's mix arrives before the next block is sent, and equals a
    ``StreamingMixer`` (alpha 0.35) fed the same chunks."""
    rng = np.random.default_rng(1)
    blocks = [(rng.uniform(0.05, 0.4, (4, 1)) * rng.standard_normal((4, SR))).astype("<f4")
              for _ in range(3)]
    conn = _open_stream(server)
    _send_block(conn, blocks[0], split=True)  # two HTTP chunks: reassembly
    resp = conn.response_class(conn.sock, method="POST")
    resp.begin()
    assert resp.status == 200 and resp.version == 11
    mixed = [_read_block(resp.fp)]  # block 0 answered before block 1 is sent
    for b in blocks[1:]:
        _send_block(conn, b, split=True)
        mixed.append(_read_block(resp.fp))
    conn.send(b"0\r\n\r\n")
    assert int(resp.fp.readline().strip(), 16) == 0
    conn.close()
    mixer = server.service.mixer
    sm = StreamingMixer(mixer.model, mixer.model_cfg, device="cpu")
    for b, m in zip(blocks, mixed):
        np.testing.assert_allclose(m, sm.push(b), rtol=0, atol=1e-6)


def test_stream_connections_share_one_inner_mixer_on_the_service_device():
    svc = MixingService(_mixer())
    a, b = svc.make_streaming(), svc.make_streaming()
    assert a._mixer is b._mixer and a is not b  # smoothing state is per connection
    assert a._mixer.mix_cfg.max_chunks == 1
    assert a._mixer.device == torch.device("cpu")  # not the default device
    assert svc.requests == 2


def test_oversized_request_chunk_rejected(server):
    import socket

    s = socket.create_connection(server.server_address, timeout=30)
    try:
        s.sendall(b"POST /stream HTTP/1.1\r\nHost: x\r\n"
                  b"Transfer-Encoding: chunked\r\n\r\nffffffff\r\n")
        total = 0
        while True:
            d = s.recv(65536)
            if not d:
                break
            total += len(d)
            assert total < 1 << 20  # only headers, never a huge buffer
    finally:
        s.close()


def test_cmd_serve_answers_healthz_during_warmup(monkeypatch, capsys):
    """``serve`` accepts connections before warming: ``/healthz`` answers
    ``warm: false`` during warm-up, then ``true``; the printed address
    carries the bound port, not ``--port 0``."""
    import tpumix_torch.cli as cli

    warm_entered, warm_release = threading.Event(), threading.Event()

    def slow_warm(self, stream=True):
        warm_entered.set()
        assert warm_release.wait(timeout=60), "test never released warm()"
        self.warmed = True

    monkeypatch.setattr(serve_mod.MixingService, "warm", slow_warm)
    monkeypatch.setattr(cli, "_load_mixer", lambda args: object())
    captured = {}
    real_serve = serve_mod.serve

    def capturing_serve(*a, **kw):
        captured["httpd"] = real_serve(*a, **kw)
        return captured["httpd"]

    monkeypatch.setattr(serve_mod, "serve", capturing_serve)
    args = cli.build_parser().parse_args(["serve", "--port", "0", "--model", MODEL])
    t = threading.Thread(target=cli.cmd_serve, args=(args,), daemon=True)
    t.start()
    try:
        assert warm_entered.wait(timeout=30)
        httpd = captured["httpd"]
        assert _get(httpd, "/healthz")[1]["warm"] is False
        warm_release.set()
        deadline = time.monotonic() + 30
        while not _get(httpd, "/healthz")[1]["warm"]:
            assert time.monotonic() < deadline, "server never reported warm"
            time.sleep(0.05)
        port = httpd.server_address[1]
        assert port != 0
        assert f"[serve] {MODEL} on http://127.0.0.1:{port}" in capsys.readouterr().out
    finally:
        warm_release.set()
        if "httpd" in captured:
            captured["httpd"].shutdown()
        t.join(timeout=30)
    assert not t.is_alive()


def test_concurrent_gains_with_live_stream(server, tracks):
    """Four parallel ``/gains`` requests serialise through the service lock
    while one live ``/stream`` keeps answering: its pushes run outside the
    lock, on the shared inner mixer, concurrently with the locked mixes."""
    body = encode_stems_wav(tracks)
    expect = json.loads(_post(server, "/gains", body)[1])
    results, errors = [], []

    def one_gains():
        try:
            status, payload = _post(server, "/gains", body, timeout=600)
            results.append((status, json.loads(payload)))
        except Exception as e:  # noqa: BLE001
            errors.append(repr(e))

    rng = np.random.default_rng(5)
    block = (0.2 * rng.standard_normal((4, SR))).astype("<f4")
    conn = _open_stream(server)
    _send_block(conn, block)
    resp = conn.response_class(conn.sock, method="POST")
    resp.begin()
    assert resp.status == 200
    _read_block(resp.fp)
    threads = [threading.Thread(target=one_gains) for _ in range(4)]
    for t in threads:
        t.start()
    pushed = []
    for i in range(4):
        b = np.roll(block, i + 1, axis=1)
        _send_block(conn, b)
        pushed.append((b, _read_block(resp.fp)))
    for t in threads:
        t.join(timeout=600)
        assert not t.is_alive()
    conn.send(b"0\r\n\r\n")
    assert int(resp.fp.readline().strip(), 16) == 0
    conn.close()
    assert not errors, errors[:2]
    assert len(results) == 4
    for status, payload in results:
        assert status == 200 and payload == expect
    mixer = server.service.mixer
    sm = StreamingMixer(mixer.model, mixer.model_cfg, device="cpu")
    sm.push(block)
    for b, m in pushed:
        np.testing.assert_allclose(m, sm.push(b), rtol=0, atol=1e-6)


def test_cli_serve_subprocess_answers_healthz():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "tpumix_torch", "serve", "--device", "cpu", "--port", "0",
         "--no-warmup", "--model", MODEL],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        url = None
        deadline = time.monotonic() + 120
        while url is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            assert line, "serve exited before printing its address"
            if line.startswith(f"[serve] {MODEL} on http://"):
                url = line.split("http://")[1].strip()
        host, port = url.rsplit(":", 1)
        conn = http.client.HTTPConnection(host, int(port), timeout=60)
        conn.request("GET", "/healthz")
        r = conn.getresponse()
        assert r.status == 200
        assert json.loads(r.read()) == {"status": "ok", "model": MODEL, "requests": 0,
                                        "warm": False}
        conn.close()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
