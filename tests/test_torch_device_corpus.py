"""The port's device-resident corpus (``tpumix_torch/data/device_corpus.py``)
on the CPU: tests/test_device_corpus.py's five cases on the port, the port's
batches and epoch order against the JAX package's ``DeviceCorpus`` for the
same indices and seed, and ``train --device-corpus --device cpu`` end to end
through the lstsq guard."""

import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.data.device_corpus import DeviceCorpus as JaxDeviceCorpus
from tpumix.data.device_corpus import DeviceCorpusIterator as JaxDeviceCorpusIterator
from tpumix_torch.config import FrontendConfig, TrainConfig, preset
from tpumix_torch.data import wavio
from tpumix_torch.data.dataset import STEMS, TRACKLIST, MultitrackAudioDataset
from tpumix_torch.data.device_corpus import DeviceCorpus, DeviceCorpusIterator
from tpumix_torch.data.loaders import track_path

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 8000
CHUNK = 6000  # 0.75 s -> 47 frames at hop 128


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    test processes side by side, and torch's default of a thread per core in
    each makes small CPU ops wait on one another many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_corpus(root, n_songs=3, dur_s=3.0, seed=0, sr=SR):
    """Tiny musdb18-layout corpus (tests/test_device_corpus.py): whole-second
    ragged lengths, the mix the plain stem sum inside [-1, 1]."""
    rng = np.random.default_rng(seed)
    songs = []
    for i in range(n_songs):
        name = f"song_{i}"
        d = os.path.join(root, name)
        os.makedirs(d, exist_ok=True)
        n = int(dur_s * sr) + sr * i
        stems = {s: (0.08 * rng.standard_normal(n)).astype(np.float32) for s in STEMS}
        for s, x in stems.items():
            wavio.write(os.path.join(d, f"{s}.wav"), x, sr)
        wavio.write(os.path.join(d, "mixture.wav"), sum(stems.values()).astype(np.float32), sr)
        songs.append(name)
    return songs


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("dcorpus")
    return str(root), _write_corpus(str(root))


def test_matches_host_dataset_chunks(corpus_dir):
    """Every device-gathered chunk equals the host dataset's read of the same
    (song, chunk) up to int16 quantisation."""
    root, songs = corpus_dir
    dc = DeviceCorpus(root, songs, CHUNK, layout="musdb18", device="cpu")
    ds = MultitrackAudioDataset(root, songlist=songs, chunk_length=CHUNK / SR, sr=SR,
                                layout="musdb18")
    table = dc.index_table()
    assert dc.num_chunks == len(ds) == len(table)
    ds_order = {s: i for i, s in enumerate(ds.songlist)}
    for gi in range(dc.num_chunks):
        s_i, c_i = table[gi]
        stems_d, mix_d = dc.batch(np.array([s_i]), np.array([c_i]))
        assert stems_d.is_contiguous() and mix_d.is_contiguous()
        host_gi = int(ds._cum_chunks[ds_order[dc.songlist[s_i]]]) + int(c_i)
        stems_h, mix_h = ds.load_audio_chunk(host_gi)
        np.testing.assert_allclose(stems_d[0].numpy() / 32768.0, stems_h, atol=1 / 32768.0)
        np.testing.assert_allclose(mix_d[0].numpy() / 32768.0, mix_h, atol=1 / 32768.0)


def test_iterator_covers_epoch_once(corpus_dir):
    root, songs = corpus_dir
    dc = DeviceCorpus(root, songs, CHUNK, layout="musdb18", device="cpu")
    it = DeviceCorpusIterator(dc, batch_size=2, shuffle=True, seed=3)
    batches = list(it)
    assert len(batches) == len(it) == dc.num_chunks // 2
    for stems, mix in batches:
        assert stems.shape == (2, 4, CHUNK) and stems.dtype == torch.int16
        assert mix.shape == (2, CHUNK) and mix.dtype == torch.int16
    # every chunk of the epoch once (drop_last leaves num_chunks % 2 out)
    seen = {bytes(m.numpy().tobytes()) for _, mb in batches for m in mb}
    assert len(seen) == len(batches) * 2
    # two epochs shuffle differently (the owned generator advances)
    flat1 = torch.cat([m.flatten() for _, m in batches])
    flat2 = torch.cat([m.flatten() for _, m in it])
    assert not torch.equal(flat1, flat2)


def test_flat_pack_footprint(corpus_dir):
    """The corpus stores exactly the sum of the (aligned) song lengths, no
    padding of every song to the longest one."""
    root, songs = corpus_dir
    dc = DeviceCorpus(root, songs, CHUNK, layout="musdb18", device="cpu")
    total = sum(min(wavio.read_mono(track_path(root, s, t, "musdb18")).shape[0]
                    for t in TRACKLIST) for s in songs)
    assert tuple(dc.corpus.shape) == (len(TRACKLIST), total)
    assert dc.corpus.dtype == torch.int16


def test_empty_songlist_and_short_songs_rejected(corpus_dir, monkeypatch):
    root, songs = corpus_dir
    with pytest.raises(ValueError, match="non-empty"):
        DeviceCorpus(root, [], CHUNK, layout="musdb18", device="cpu")
    with pytest.raises(ValueError, match="one chunk"):
        DeviceCorpus(root, songs, 10 * SR, layout="musdb18", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCorpus(root, songs, CHUNK, layout="musdb18")


def test_trainer_fit_runs_on_device_batches(corpus_dir, tmp_path, monkeypatch):
    """One tiny epoch of ``Trainer.fit`` straight off int16 device batches:
    no prefetcher and no host transform, and the step dequantises them."""
    import tpumix_torch.train.trainer as trainer_mod
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.train.trainer import Trainer

    root, songs = corpus_dir
    dc = DeviceCorpus(root, songs, CHUNK, layout="musdb18", device="cpu")
    model = build_model(dataclasses.replace(preset("scalar1s"), bn_momentum=0.99),
                        in_shape=(129, 47), for_training=True)
    cfg = TrainConfig(batch_size=2, num_epochs=1, checkpoint_dir=str(tmp_path), loss="lstsq",
                      augment=True, transfer_dtype="int16")
    tr = Trainer(model, FrontendConfig(n_fft=256, hop_length=128, sample_rate=SR), cfg,
                 run_name="dc", device="cpu")

    def no_prefetch(*a, **kw):
        raise AssertionError("device batches went through the host prefetcher")

    monkeypatch.setattr(trainer_mod, "prefetch_to_device", no_prefetch)
    seen = []
    real = tr._train_step
    tr._train_step = lambda s, m, g: (seen.append((s.dtype, m.dtype)), real(s, m, g))[1]
    result = tr.fit(DeviceCorpusIterator(dc, 2, seed=0),
                    DeviceCorpusIterator(dc, 2, shuffle=False, seed=0), 0, 1)
    assert np.isfinite(result.best_val_loss)
    assert seen == [(torch.int16, torch.int16)] * (dc.num_chunks // 2)
    assert tr.last_epoch_stats["steps"] == dc.num_chunks // 2


def test_batches_and_order_equal_the_jax_packages(corpus_dir):
    root, songs = corpus_dir
    dc = DeviceCorpus(root, songs, CHUNK, layout="musdb18", device="cpu")
    jdc = JaxDeviceCorpus(root, songs, CHUNK, layout="musdb18")
    np.testing.assert_array_equal(dc.corpus.numpy(), np.asarray(jdc.corpus))
    np.testing.assert_array_equal(dc.index_table(), jdc.index_table())
    rows = dc.index_table()[[5, 0, 11, 3]]
    got, want = dc.batch(rows[:, 0], rows[:, 1]), jdc.batch(rows[:, 0], rows[:, 1])
    for g, w in zip(got, want):
        assert g.dtype == torch.int16 and np.asarray(w).dtype == jnp.int16
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for shuffle in (True, False):
        ours = DeviceCorpusIterator(dc, 3, shuffle=shuffle, seed=4)
        theirs = JaxDeviceCorpusIterator(jdc, 3, shuffle=shuffle, seed=4)
        assert len(ours) == len(theirs)
        for _ in range(2):  # two epochs: the generators advance alike
            for (s, m), (js, jm) in zip(ours, theirs):
                np.testing.assert_array_equal(s.numpy(), np.asarray(js))
                np.testing.assert_array_equal(m.numpy(), np.asarray(jm))


def test_train_cli_with_device_corpus_and_the_lstsq_guard(tmp_path):
    """``train --device-corpus --device cpu`` at scalar1s's width: the lstsq
    guard dequantises the int16 device batch (this corpus's mix is the plain
    stem sum, so it warns), the --transfer-dtype warning, two epochs."""
    root = str(tmp_path / "data")
    _write_corpus(root, n_songs=3, dur_s=2.0, sr=44100)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "tpumix_torch", "train", "--data", root, "--layout", "musdb18",
           "--model", "scalar1s", "--batch-size", "2", "--epochs", "2", "--device", "cpu",
           "--device-corpus", "--loss", "lstsq", "--augment", "--bn-momentum", "0.99",
           "--transfer-dtype", "int16", "--val-fraction", "0.34",
           "--checkpoint-dir", str(tmp_path / "ckpt"), "--run-name", "dc"]
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "--transfer-dtype int16 is ignored with --device-corpus" in res.stdout
    assert "closed-form gain targets on a validation batch are ~zero" in res.stdout
    epochs = [l for l in res.stdout.splitlines() if l.startswith("Epoch ")]
    assert [l.split(":")[0] for l in epochs] == ["Epoch 0", "Epoch 1"]
    assert np.isfinite(json.loads(res.stdout.strip().splitlines()[-1])["best_val_loss"])
