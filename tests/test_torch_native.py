"""The port's C++ WAV reader (``tpumix_torch/csrc/tpumixio.cpp`` through
``tpumix_torch/data/_native.py``, built with g++ at first use) against the
JAX package's (``tpumix.data._native``) and against the numpy reader, on
tests/test_native.py's fixtures: bit for bit wherever both decode the same
samples (the mono downmix too: both readers are one source), the numpy mean
within 1e-7 as tests/test_native.py holds it; plus the chunked read's
zero tail, the write round trip, the ``TPUMIX_NO_NATIVE`` fallback and
tests/test_wavio_property.py's mutated-bytes property ("rejects or
matches")."""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpumix.data import _native as jax_native
from tpumix_torch.data import _native, wavio
from tpumix_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 44100
SUBTYPES = ["FLOAT", "PCM_16", "PCM_24", "PCM_32"]


@pytest.fixture(scope="module")
def libs():
    """Both readers; the port's must build here (g++ is on the host)."""
    lib = _native.get_lib()
    assert lib is not None, "the port's reader did not build"
    if jax_native.get_lib() is None:
        pytest.skip("the JAX package's reader is unavailable")
    return lib


@pytest.fixture(scope="module")
def wav_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("nat")
    rng = np.random.default_rng(0)
    x = np.clip(0.3 * rng.standard_normal((SR, 2)), -1, 1).astype(np.float32)
    paths = {}
    for sub in SUBTYPES:
        p = str(base / f"t_{sub}.wav")
        wavio.write(p, x, SR, subtype=sub)
        paths[sub] = p
    return x, paths


def test_reader_is_built_from_the_ports_source(libs):
    path = _build.library_path("tpumixio")
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)
    assert libs._name == path
    with open(os.path.join(_build.CSRC, "tpumixio.cpp")) as f:
        assert "tpumixio_read_chunks_mono_f32" in f.read()


def test_ctypes_signatures_are_the_jax_packages(libs):
    theirs = jax_native.get_lib()
    for name, _, _ in _build.HOST_ENTRIES["tpumixio"]:
        ours, ref = getattr(libs, name), getattr(theirs, name)
        assert ours.restype == ref.restype, name
        assert [ctypes_name(t) for t in ours.argtypes] == [ctypes_name(t) for t in ref.argtypes]


def ctypes_name(t):
    return getattr(t, "__name__", repr(t))


@pytest.mark.parametrize("sub", SUBTYPES)
def test_info_matches_both_readers(libs, wav_files, sub):
    _, paths = wav_files
    meta = wavio.info(paths[sub])
    assert _native.info(paths[sub]) == jax_native.info(paths[sub]) == (
        meta.samplerate, meta.channels, meta.frames, meta.format)


@pytest.mark.parametrize("sub", SUBTYPES)
def test_read_is_bit_exact_against_both_readers(libs, wav_files, sub):
    _, paths = wav_files
    ours = _native.read_f32(paths[sub], 137, 5000, 2)
    ref, _ = wavio.read(paths[sub], start=137, stop=137 + 5000, always_2d=True)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, jax_native.read_f32(paths[sub], 137, 5000, 2))


@pytest.mark.parametrize("sub", SUBTYPES)
def test_mono_downmix(libs, wav_files, sub):
    _, paths = wav_files
    ours = _native.read_mono_f32(paths[sub], 100, 20000)
    np.testing.assert_array_equal(ours, jax_native.read_mono_f32(paths[sub], 100, 20000))
    ref, _ = wavio.read(paths[sub], start=100, stop=20100, always_2d=True)
    np.testing.assert_allclose(ours, ref.mean(axis=1), atol=1e-7)


def test_chunked_read_pads_the_tail(libs, wav_files):
    _, paths = wav_files
    chunks = _native.read_chunks_mono_f32(paths["FLOAT"], 10000, 5)
    assert chunks.shape == (5, 10000)
    assert np.all(chunks[4, 4100:] == 0)  # 44100 = 4*10000 + 4100
    np.testing.assert_array_equal(chunks, jax_native.read_chunks_mono_f32(paths["FLOAT"], 10000, 5))
    np.testing.assert_array_equal(chunks.reshape(-1)[:SR], _native.read_mono_f32(paths["FLOAT"],
                                                                                 0, SR))


@pytest.mark.parametrize("sub", ["FLOAT", "PCM_16"])
def test_write_round_trip(libs, wav_files, tmp_path, sub):
    x, _ = wav_files
    ours, theirs = str(tmp_path / "o.wav"), str(tmp_path / "t.wav")
    assert _native.write(ours, x, SR, sub) and jax_native.write(theirs, x, SR, sub)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    y, sr = wavio.read(ours)
    assert sr == SR
    if sub == "FLOAT":
        np.testing.assert_array_equal(y, x)
    else:
        np.testing.assert_allclose(y, x, atol=1.0 / 32768)
    assert not _native.write(str(tmp_path / "p.wav"), x, SR, "PCM_24")  # numpy's only


def test_read_mono_takes_the_reader(libs, wav_files, monkeypatch):
    _, paths = wav_files
    calls = []
    real = _native.read_mono_f32
    monkeypatch.setattr(_native, "read_mono_f32", lambda *a: calls.append(a) or real(*a))
    out = wavio.read_mono(paths["PCM_16"], start=100, count=1000)
    assert calls == [(paths["PCM_16"], 100, 1000)]
    np.testing.assert_array_equal(out, jax_native.read_mono_f32(paths["PCM_16"], 100, 1000))


def test_numpy_fallback_when_the_reader_is_absent(wav_files, monkeypatch):
    _, paths = wav_files
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", True)
    assert _native.read_mono_f32(paths["FLOAT"], 0, 10) is None
    out = wavio.read_mono(paths["FLOAT"], start=0, count=1000)
    ref, _ = wavio.read(paths["FLOAT"], start=0, stop=1000, always_2d=True)
    np.testing.assert_array_equal(out, ref.mean(axis=1).astype(np.float32))


def test_tpumix_no_native_selects_numpy(wav_files):
    """A fresh process with ``TPUMIX_NO_NATIVE=1`` never loads the library."""
    _, paths = wav_files
    code = ("import sys; from tpumix_torch.data import _native, wavio; "
            f"x = wavio.read_mono({paths['PCM_16']!r}, 0, 100); "
            "print(_native.get_lib() is None, x.shape)")
    env = dict(os.environ, PYTHONPATH=ROOT, TPUMIX_NO_NATIVE="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split() == ["True", "(100,)"]


def test_missing_compiler_leaves_the_numpy_path(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    monkeypatch.delenv("TPUMIX_NO_NATIVE", raising=False)
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setenv("CXX", "no-such-compiler")
    assert _native.get_lib() is None
    assert os.listdir(tmp_path) == []  # no temporary file left behind


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(blob=st.binary(min_size=0, max_size=256), seed=st.integers(0, 2**31 - 1))
def test_decoder_rejects_or_matches(libs, tmp_path, blob, seed):
    """tests/test_wavio_property.py's property for the port's reader: on a
    valid header prefix with random bytes grafted after it, the reader fails
    as safely as the numpy parser and agrees with it (and with the JAX
    package's reader, bit for bit) whenever it succeeds."""
    rng = np.random.default_rng(seed)
    path = str(tmp_path / "t.wav")
    wavio.write(path, rng.uniform(-1, 1, size=(64, 1)).astype(np.float32), 44100,
                subtype="PCM_16")
    base = open(path, "rb").read()
    cut = int(rng.integers(12, len(base)))
    mut = str(tmp_path / "mut.wav")
    with open(mut, "wb") as f:
        f.write(base[:cut] + blob)
    try:
        ref, _ = wavio.read(mut, always_2d=True)
        ref = ref.mean(axis=1).astype(np.float32)
        n = len(ref)
    except (ValueError, EOFError, OSError, struct.error):
        ref, n = None, 8
    out = _native.read_mono_f32(mut, 0, max(n, 1))
    theirs = jax_native.read_mono_f32(mut, 0, max(n, 1))
    assert (out is None) == (theirs is None)
    if out is not None:
        np.testing.assert_array_equal(out, theirs)
        if ref is not None and n:
            np.testing.assert_allclose(out[:n], ref, atol=1e-6)
