"""The port's ``Trainer`` against the contracts tpumix's holds
(tests/test_train.py:223-274, 336-440, 549-609), on the CPU at that file's
small size: fit / checkpoint / restore, keep-best-k across a resume, a
half-written checkpoint swept, ``start >= end`` trains nothing, the wire
formats, ``augment_mix`` plumbing, per-loss patience, the cosine schedule and
the bn-momentum warning."""

import dataclasses
import json
import os
import warnings

import numpy as np
import pytest
import torch

from tpumix.train.trainer import resolve_patience as jax_resolve_patience
from tpumix_torch.config import FrontendConfig, TrainConfig, preset
from tpumix_torch.data.prefetch import BatchIterator, prefetch_to_device
from tpumix_torch.models.registry import build_model
from tpumix_torch.train.trainer import Trainer, TrainResult, resolve_patience

SR = 8000
CHUNK = 6000
FRONTEND = FrontendConfig(n_fft=256, hop_length=128, sample_rate=SR)


class SynthChunks:
    """Tiny in-memory dataset: 4 stems with fixed true mix gains
    (tests/test_train.py)."""

    def __init__(self, n_items=16, seed=0):
        rng = np.random.default_rng(seed)
        t = np.arange(CHUNK) / SR
        true_gains = np.array([0.9, 1.1, 0.8, 1.2], np.float32)
        self.items = []
        for _ in range(n_items):
            freqs = rng.uniform(50, 3000, size=4)
            stems = np.stack([(0.2 + 0.1 * rng.random()) * np.sin(
                2 * np.pi * f * t + rng.uniform(0, 6.28)) for f in freqs]).astype(np.float32)
            stems += 0.01 * rng.standard_normal(stems.shape).astype(np.float32)
            self.items.append((stems, (true_gains[:, None] * stems).sum(axis=0).astype(np.float32)))

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.fixture(scope="module")
def loader():
    return BatchIterator(SynthChunks(16), 8, shuffle=False)


def _trainer(tmp_path, run_name, bn_momentum=0.99, **cfg):
    cfg = TrainConfig(**{"batch_size": 8, "num_epochs": 1, "checkpoint_dir": str(tmp_path),
                         "seed": 0, **cfg})
    model_cfg = dataclasses.replace(preset("scalar1s"), bn_momentum=bn_momentum)
    model = build_model(model_cfg, in_shape=(129, 47), for_training=True,
                        generator=torch.Generator().manual_seed(0))
    return Trainer(model, FRONTEND, cfg, run_name=run_name, device="cpu")


def test_fit_checkpoints_and_restore(loader, tmp_path):
    torch.manual_seed(0)
    tr = _trainer(tmp_path, "loop", num_epochs=3, early_stopping_patience=10)
    res = tr.fit(loader, loader, 0, 3)
    assert isinstance(res, TrainResult) and len(res.train_loss) == len(res.val_loss) == 3
    assert res.train_loss[-1] < res.train_loss[0] and not res.stopped_early
    assert tr.state.step == 6 and tr.last_epoch_stats["steps"] == 2
    assert sorted(d for d in os.listdir(tr.ckpt_dir) if d.startswith("epoch_")) == [
        "epoch_0000", "epoch_0001", "epoch_0002"]
    with open(os.path.join(tr.ckpt_dir, "metrics.csv")) as f:
        rows = f.read().strip().splitlines()
    assert rows[0] == "epoch,train_loss,val_loss,seconds" and len(rows) == 4
    before = tr.model.conv_b1.conv.weight.detach().clone()
    tr.restore_checkpoint(0)
    assert tr.state.step == 2
    assert not torch.allclose(before, tr.model.conv_b1.conv.weight)


def test_early_stopping_uses_patience(loader, tmp_path, monkeypatch):
    tr = _trainer(tmp_path, "stop", num_epochs=6, early_stopping_patience=2)
    vals = iter([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    monkeypatch.setattr(tr, "_run_val_epoch", lambda loader: next(vals))
    monkeypatch.setattr(tr, "_run_train_epoch", lambda loader: 0.5)
    res = tr.fit(loader, loader, 0, 6)
    assert res.stopped_early and res.best_epoch == 0 and len(res.val_loss) == 3


@pytest.mark.parametrize("score,kept", [("train", "epoch_0002"), ("val", "epoch_0001")])
def test_keep_best_k_by_checkpoint_score(loader, tmp_path, monkeypatch, score, kept):
    tr = _trainer(tmp_path, f"keep_{score}", num_epochs=3, keep_checkpoints=1,
                  checkpoint_score=score)
    trains, vals = iter([3.0, 2.0, 1.0]), iter([2.0, 1.0, 3.0])
    monkeypatch.setattr(tr, "_run_train_epoch", lambda loader: next(trains))
    monkeypatch.setattr(tr, "_run_val_epoch", lambda loader: next(vals))
    tr.fit(loader, loader, 0, 3)
    assert [d for d in os.listdir(tr.ckpt_dir) if d.startswith("epoch_")] == [kept]
    with open(os.path.join(tr.ckpt_dir, "scores.json")) as f:
        assert len(json.load(f)) >= 1


def test_resume_restores_latest_and_keep_k_spans_the_resume(loader, tmp_path):
    tr = _trainer(tmp_path, "rk", num_epochs=2, keep_checkpoints=2)
    tr.fit(loader, loader, 0, 2)
    tr2 = _trainer(tmp_path, "rk", num_epochs=2, keep_checkpoints=2)
    assert tr2.resume() == 2 and tr2.state.step == 4 and len(tr2._scores) == 2
    for a, b in zip(tr.model.state_dict().values(), tr2.model.state_dict().values()):
        assert torch.equal(a, b)
    opt, opt2 = tr.state.optimizer.state_dict(), tr2.state.optimizer.state_dict()
    for i in opt["state"]:
        assert torch.equal(opt["state"][i]["exp_avg_sq"], opt2["state"][i]["exp_avg_sq"])
    tr2.fit(loader, loader, 2, 4)  # continue to a 4-epoch total
    kept = sorted(d for d in os.listdir(tr2.ckpt_dir) if d.startswith("epoch_"))
    assert len(kept) == 2  # quota enforced across the resume boundary
    assert _trainer(tmp_path, "fresh").resume() == 0


def test_half_written_checkpoint_is_ignored_and_swept(tmp_path):
    tr = _trainer(tmp_path, "sweep")
    os.makedirs(os.path.join(tr.ckpt_dir, "epoch_0003"))
    stale = os.path.join(tr.ckpt_dir, "epoch_0005.tmp-4242")
    os.makedirs(stale)
    assert tr.latest_epoch() == 3
    os.rmdir(os.path.join(tr.ckpt_dir, "epoch_0003"))
    assert tr.resume() == 0  # nothing restorable -> fresh start, no crash
    assert not os.path.exists(stale)


def test_a_kill_during_save_leaves_only_a_staging_dir(loader, tmp_path, monkeypatch):
    tr = _trainer(tmp_path, "killed")
    tr.save_checkpoint(0, score=-1.0)

    def die(*a, **kw):
        raise KeyboardInterrupt

    monkeypatch.setattr(torch, "save", die)
    with pytest.raises(KeyboardInterrupt):
        tr.save_checkpoint(1, score=-0.5)
    monkeypatch.undo()
    names = sorted(os.listdir(tr.ckpt_dir))
    assert "epoch_0001" not in names and any(n.startswith("epoch_0001.tmp-") for n in names)
    tr2 = _trainer(tmp_path, "killed")
    assert tr2.resume() == 1 and not any(".tmp-" in n for n in os.listdir(tr.ckpt_dir))


def test_start_at_end_trains_nothing(tmp_path):
    tr = _trainer(tmp_path, "done", num_epochs=100)

    class ExplodingLoader:
        def __iter__(self):
            raise AssertionError("a completed run must not train more epochs")

        def __len__(self):
            return 1

    res = tr.fit(ExplodingLoader(), ExplodingLoader(), 100, 100)
    assert res.train_loss == [] and res.best_epoch == -1


@pytest.mark.parametrize("wire", ["int16", "mulaw8"])
def test_quantised_wire_modes_train(loader, tmp_path, wire):
    tr = _trainer(tmp_path, wire, transfer_dtype=wire)
    seen = []
    real = tr._train_step
    tr._train_step = lambda s, m, g: (seen.append((s.dtype, m.dtype)), real(s, m, g))[1]
    res = tr.fit(loader, loader, 0, 1)
    assert np.isfinite(res.train_loss[0])
    want = torch.int16 if wire == "int16" else torch.int8
    assert seen == [(want, want)] * 2


def test_unknown_transfer_dtype_rejected(loader, tmp_path):
    tr = _trainer(tmp_path, "bad", transfer_dtype="int4")
    with pytest.raises(ValueError, match="transfer_dtype"):
        tr.fit(loader, loader, 0, 1)


def test_augment_flags_reach_the_train_step(monkeypatch, tmp_path):
    import tpumix_torch.train.trainer as tr_mod

    captured = {}
    real = tr_mod.make_train_step
    monkeypatch.setattr(tr_mod, "make_train_step",
                        lambda *a, **kw: (captured.update(kw), real(*a, **kw))[1])
    _trainer(tmp_path, "am", augment=True, augment_mix=False, loss="lstsq")
    assert captured["augment"] is True and captured["augment_mix"] is False
    assert captured["loss"] == "lstsq"


def test_gain_loss_and_bad_schedules_are_rejected(tmp_path):
    with pytest.raises(ValueError, match="gain"):
        _trainer(tmp_path, "g", loss="gain")
    with pytest.raises(ValueError, match="lr_total_steps"):
        _trainer(tmp_path, "c", lr_schedule="cosine")
    with pytest.raises(ValueError, match="unknown lr_schedule"):
        _trainer(tmp_path, "u", lr_schedule="linear")


def test_cosine_schedule_sets_the_rate_of_each_update(loader, tmp_path):
    tr = _trainer(tmp_path, "cos", lr_schedule="cosine", lr_total_steps=4, learning_rate=1e-2)
    rates = []
    real = tr.state.optimizer.step
    tr.state.optimizer.step = lambda *a, **kw: (
        rates.append(tr.state.optimizer.param_groups[0]["lr"]), real(*a, **kw))[1]
    tr.fit(loader, loader, 0, 1)
    np.testing.assert_allclose(rates, [1e-2, 1e-2 * (0.99 * 0.5 * (1 + np.cos(np.pi / 4)) + 0.01)],
                               rtol=1e-6)


@pytest.mark.parametrize("loss", ["reference", "coherent", "lstsq", "lstsq_tail", "lstsq_tail_cm"])
def test_patience_is_per_loss(loss):
    assert resolve_patience(None, loss) == jax_resolve_patience(None, loss)
    assert resolve_patience(7, loss) == 7


def test_bn_momentum_warning(tmp_path):
    with pytest.warns(UserWarning, match="bn_momentum=0.1"):
        _trainer(tmp_path, "parity", bn_momentum=0.10)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _trainer(tmp_path, "stable", bn_momentum=0.99)


def test_default_device_is_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TrainConfig(checkpoint_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(torch.nn.Identity(), FRONTEND, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(prefetch_to_device(iter([])))


def test_prefetch_and_batch_iterator(loader):
    ds = SynthChunks(10, seed=1)
    it = BatchIterator(ds, 4, seed=3)
    assert len(it) == 2 and len(BatchIterator(ds, 4, drop_last=False)) == 3
    batches = list(prefetch_to_device(iter(it), device="cpu",
                                      transform=lambda b: tuple(2 * a for a in b)))
    assert len(batches) == 2
    stems, mix = batches[0]
    assert isinstance(stems, torch.Tensor) and stems.shape == (4, 4, CHUNK) and mix.shape == (4, CHUNK)
    order = np.arange(10)
    np.random.default_rng(3).shuffle(order)
    np.testing.assert_array_equal(stems[0].numpy(), 2 * ds[int(order[0])][0])
    a = [b[1] for b in BatchIterator(ds, 2, seed=5, num_shards=2, shard_index=0)]
    b = [b[1] for b in BatchIterator(ds, 2, seed=5, num_shards=2, shard_index=1)]
    assert len(a) == len(b) == 2 and not np.array_equal(a[0], b[0])

    def failing():
        yield ds[0]
        raise OSError("disk gone")

    with pytest.raises(OSError, match="disk gone"):
        list(prefetch_to_device(failing(), device="cpu"))
    # a consumer that stops early does not leave the producer blocked
    gen = prefetch_to_device(iter(BatchIterator(ds, 1)), size=1, device="cpu")
    next(gen)
    gen.close()
