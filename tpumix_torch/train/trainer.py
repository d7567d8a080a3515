"""Training loop: epochs, validation, checkpointing, best-k scoring, early
stopping, CSV metrics (tpumix/train/trainer.py).

Parity targets:
* plain loop semantics — per-epoch train pass + full val pass, per-epoch
  checkpoint, returned loss histories (reference model_trainer.py:46-67);
* ignite-style handlers — checkpoints scored by ``-train_mse`` with keep-all
  or keep-best-k, EarlyStopping(patience) on the val evaluator, iteration
  logging cadence (reference training_ignite.ipynb cells 12-15);
* run naming ``{datetime}_training_{model}`` (cell 2).

One waveform-in train step (tpumix_torch/train/state.py) on the card, fed by a
background host->device prefetcher, or straight from a loader whose batches
are already on the card (``DeviceCorpusIterator``).  ``SyntheticTrainer``
generates each batch inside the step (tpumix_torch/data/synthetic.py) and
reads no file.  A checkpoint is the directory ``epoch_NNNN`` holding one
``torch.save`` file of model, optimizer and update count; it is written under
a temporary name and renamed into place, so a kill mid-save leaves only
something ``resume`` recognises and sweeps.

Data parallelism (tpumix/train/trainer.py:83-165): with a ``mesh`` (or a
process group and ``TrainConfig.mesh_shape``) every rank runs the trainer on
its own device with its rows of each global batch; the parameters start as
rank 0's, the steps reduce over the global batch
(tpumix_torch/train/state.py), the validation loss is the global mean, so
every rank decides early stopping alike, and only rank 0 prints and writes
checkpoints, ``scores.json``, ``metrics.csv`` and the plot.
"""

from __future__ import annotations

import contextlib
import csv
import dataclasses
import datetime
import itertools
import json
import os
import re
import shutil
import time
import warnings
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpumix_torch.config import FrontendConfig, TrainConfig
from tpumix_torch.data.prefetch import prefetch_to_device
from tpumix_torch.data.synthetic import synth_draws, synth_render
from tpumix_torch.infer.mixer import _mulaw_lut
from tpumix_torch.parallel.distributed import process_index
from tpumix_torch.parallel.mesh import broadcast_module, make_mesh
from tpumix_torch.train.state import (
    _check_loss,
    cosine_decay_schedule,
    create_train_state,
    make_eval_step,
    make_gain_eval_step,
    make_gain_train_step,
    make_train_step,
)
from tpumix_torch.utils.device import disable_tf32, resolve_device

_STATE_FILE = "state.pt"
_TMP_MARK = ".tmp-"  # epoch_NNNN.tmp-<pid>: a checkpoint still being written


def resolve_patience(patience: Optional[int], loss: str) -> int:
    """Per-loss early-stopping default.  The lstsq objectives have a measured
    mid-run val plateau deep enough that patience 10 stops there, so the
    family defaults to 30; everything else keeps the reference's ignite
    EarlyStopping(patience=10) parity.  An explicit value always wins."""
    if patience is not None:
        return patience
    return 30 if loss in ("lstsq", "lstsq_tail", "lstsq_tail_cm") else 10


@dataclasses.dataclass
class TrainResult:
    train_loss: List[float]
    val_loss: List[float]
    best_epoch: int
    best_val_loss: float
    stopped_early: bool


def _to_pcm16(a) -> np.ndarray:
    return np.clip(np.rint(np.asarray(a) * 32768.0), -32768, 32767)


class Trainer:
    """Orchestrates training of a gain-prediction model on waveform batches.

    :param model: a scalar gain model (``build_model(cfg, for_training=True)``);
        it is moved to ``device`` in ``channels_last``.
    :param device: ``None`` = ``cuda`` (raises without a card); ``"cpu"`` runs
        the frontends' plain versions.
    :param mesh: a ``tpumix_torch.parallel.Mesh`` whose ``dp`` axis splits
        each global batch over the ranks; the loaders then yield each rank's
        rows (``BatchIterator(num_shards=, shard_index=)``,
        ``DeviceCorpusIterator(num_shards=, shard_index=)``).  None: the mesh
        of ``config.mesh_shape`` when a process group is active or that shape
        has more than one rank, else none.
    """

    # label-supervised loss="gain" needs generator labels; only
    # SyntheticTrainer, which builds its own steps, supports it
    _supports_gain_loss = False

    def __init__(self, model: torch.nn.Module, frontend: FrontendConfig, config: TrainConfig,
                 run_name: Optional[str] = None, device=None, mesh=None):
        self.device = resolve_device(device)
        # full f32 on the card: cuDNN would otherwise run every convolution,
        # forward and backward, in TF32 (utils.device.disable_tf32)
        disable_tf32()
        self.model = model.to(self.device, memory_format=torch.channels_last)
        if mesh is None and (dist.is_initialized() or int(np.prod(config.mesh_shape)) > 1):
            mesh = make_mesh(config.mesh_shape, config.mesh_axis_names)
        self.mesh = mesh
        #: the rank that prints and writes (rank 0; the only one without a mesh)
        self.is_main = process_index() == 0
        if mesh is not None:
            broadcast_module(self.model)  # every rank starts from rank 0's
        self.frontend = frontend
        self.config = config
        self.patience = resolve_patience(config.early_stopping_patience, config.loss)
        lr = config.learning_rate
        if config.lr_schedule == "cosine":
            if not config.lr_total_steps:
                raise ValueError("lr_schedule='cosine' requires lr_total_steps")
            lr = cosine_decay_schedule(config.learning_rate, config.lr_total_steps, alpha=0.01)
        elif config.lr_schedule != "constant":
            raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")
        self.state = create_train_state(self.model, lr, config.weight_decay)

        # quality trap, armed by default in parity configs: retained fraction
        # 0.10 (= torch BatchNorm2d momentum 0.90) makes running stats track
        # essentially the LAST batch, so eval-mode outputs — and the val loss
        # early stopping judges — are noisy unless the run is long
        bn_m = getattr(model, "bn_momentum", None)
        if bn_m is not None and bn_m <= 0.5:
            warnings.warn(
                f"model bn_momentum={bn_m} (torch-parity): BatchNorm running "
                "stats will track the last batch almost exclusively, making "
                "eval-mode validation noisy on short runs — pass "
                "--bn-momentum 0.99 (ModelConfig.bn_momentum) unless strict "
                "reference parity is the goal",
                stacklevel=2,
            )

        if config.loss == "gain":
            if not self._supports_gain_loss:
                _check_loss(config.loss)  # raises with the guidance message
            # SyntheticTrainer installs the gain-supervised steps; the
            # waveform-pair steps have no labels to train on
            self._train_step = self._eval_step = None
        else:
            self._train_step = make_train_step(
                self.state, frontend, augment=config.augment,
                augment_mix=config.augment_mix, loss=config.loss, mesh=mesh,
            )
            self._eval_step = make_eval_step(self.state, frontend, loss=config.loss, mesh=mesh)
        # augmentation's random stream, on the device (tpumix: key(seed + 1))
        self._generator = torch.Generator(device=self.device).manual_seed(config.seed + 1)

        stamp = datetime.datetime.now().strftime("%d-%m-%Y-%H:%M")
        self.run_name = run_name or f"{stamp}_training_{type(model).__name__}"
        self.ckpt_dir = os.path.abspath(os.path.join(config.checkpoint_dir, self.run_name))
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self._scores: Dict[int, float] = {}
        self._metrics_path = os.path.join(self.ckpt_dir, "metrics.csv")
        #: of the last train epoch: steps, wall seconds, seconds spent waiting
        #: on the loader (host wait)
        self.last_epoch_stats: Dict[str, float] = {"steps": 0, "wall_s": 0.0, "host_wait_s": 0.0}

    # --- checkpointing -------------------------------------------------------

    def _ckpt_path(self, epoch: int) -> str:
        return os.path.join(self.ckpt_dir, f"epoch_{epoch:04d}")

    def save_checkpoint(self, epoch: int, score: float) -> None:
        """Save; score convention follows ignite's ``-train_mse`` (higher is
        better).  With keep_checkpoints=k, only the top-k scored survive.
        Only rank 0 writes (every rank holds the same state)."""
        if not self.is_main:
            return
        final = self._ckpt_path(epoch)
        tmp = f"{final}{_TMP_MARK}{os.getpid()}"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(
            {"model": self.model.state_dict(), "optimizer": self.state.optimizer.state_dict(),
             "step": self.state.step},
            os.path.join(tmp, _STATE_FILE),
        )
        shutil.rmtree(final, ignore_errors=True)  # a re-run of this epoch overwrites
        os.replace(tmp, final)
        self._scores[epoch] = score
        with open(os.path.join(self.ckpt_dir, "scores.json"), "w") as f:
            json.dump(self._scores, f)
        k = self.config.keep_checkpoints
        if k is not None and len(self._scores) > k:
            for ep in sorted(self._scores, key=self._scores.get)[: len(self._scores) - k]:
                shutil.rmtree(self._ckpt_path(ep), ignore_errors=True)
                del self._scores[ep]

    def latest_epoch(self) -> Optional[int]:
        """Newest epoch with a COMPLETE checkpoint in the run dir, or None.
        Only exact ``epoch_<N>`` directory names count: a kill mid-save leaves
        an ``epoch_<N>.tmp-<pid>`` staging dir behind, which is not restorable
        and must not crash the scan."""
        if not os.path.isdir(self.ckpt_dir):
            return None
        epochs = [
            int(m.group(1))
            for d in os.listdir(self.ckpt_dir)
            if (m := re.fullmatch(r"epoch_(\d+)", d))
            and os.path.isdir(os.path.join(self.ckpt_dir, d))
        ]
        return max(epochs) if epochs else None

    def resume(self) -> int:
        """Elastic recovery: restore the newest checkpoint of this run (if
        any) and return the epoch to continue from (0 when starting fresh)."""
        # sweep half-written checkpoint staging dirs (see latest_epoch): they
        # hold no restorable state
        if self.is_main and os.path.isdir(self.ckpt_dir):
            for d in os.listdir(self.ckpt_dir):
                if re.fullmatch(r"epoch_\d+" + re.escape(_TMP_MARK) + r".*", d):
                    print(f"[resume] sweeping half-written checkpoint {d}")
                    shutil.rmtree(os.path.join(self.ckpt_dir, d), ignore_errors=True)
        latest = self.latest_epoch()
        if latest is None:
            return 0
        self.restore_checkpoint(latest)
        # reload the score ledger so the keep-best-k quota spans the whole
        # run, not just post-resume epochs
        scores_path = os.path.join(self.ckpt_dir, "scores.json")
        if os.path.exists(scores_path):
            with open(scores_path) as f:
                self._scores = {int(k): float(v) for k, v in json.load(f).items()}
            # drop ledger entries whose checkpoint dirs no longer exist
            self._scores = {
                ep: s for ep, s in self._scores.items() if os.path.isdir(self._ckpt_path(ep))
            }
        self._print(f"[resume] restored epoch {latest} from {self.ckpt_dir}")
        return latest + 1

    def restore_checkpoint(self, epoch: int) -> None:
        saved = torch.load(os.path.join(self._ckpt_path(epoch), _STATE_FILE),
                           map_location=self.device, weights_only=True)
        self.model.load_state_dict(saved["model"])
        self.state.optimizer.load_state_dict(saved["optimizer"])
        self.state.step = int(saved["step"])

    # --- loops ---------------------------------------------------------------

    def _wire_transform(self):
        """Host-side encode of a batch into ``config.transfer_dtype``."""
        dtype = self.config.transfer_dtype
        if dtype == "float32":
            return None
        if dtype == "int16":
            return lambda batch: tuple(_to_pcm16(b).astype(np.int16) for b in batch)
        if dtype == "mulaw8":
            lut = _mulaw_lut()
            return lambda batch: tuple(lut[_to_pcm16(b).astype(np.int32) + 32768] for b in batch)
        raise ValueError(f"unknown transfer_dtype {dtype!r}")

    def _batches(self, loader):
        """The loader's batches as tensors on the trainer's device: a batch
        that is already there goes straight to the step (no host transform,
        no second copy; the step dequantises int16 by dtype); host batches go
        through the wire transform and the background prefetcher."""
        it = iter(loader)
        first = next(it, None)
        if first is None:
            return iter(())
        it = itertools.chain([first], it)
        if all(isinstance(t, torch.Tensor) and t.device == self.device for t in first):
            return it
        return prefetch_to_device(it, size=2, device=self.device,
                                  transform=self._wire_transform())

    def _run_train_epoch(self, loader) -> float:
        losses = []  # device scalars; forced once at epoch end so steps
        # pipeline (a per-step host sync would serialise transfers + compute)
        tic = time.perf_counter()
        it = self._batches(loader)
        waited = time.perf_counter() - tic  # the first batch, read to see where it lies
        i = 0
        while True:
            t0 = time.perf_counter()
            try:
                stems, mix = next(it)
            except StopIteration:
                break
            waited += time.perf_counter() - t0
            metrics = self._train_step(stems, mix, self._generator)
            losses.append(metrics["loss"])
            i += 1
            if i % self.config.log_every_steps == 0:
                self._print(f"  [{i}/{len(loader)}] loss: {float(metrics['loss']):.4f}")
        mean = float(torch.stack(losses).mean()) if losses else 0.0  # waits for the device
        self.last_epoch_stats = {"steps": i, "wall_s": time.perf_counter() - tic,
                                 "host_wait_s": waited}
        return mean

    def _print(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)

    def _run_val_epoch(self, loader) -> float:
        # device scalars accumulated and forced ONCE at epoch end; each is
        # the global batch's loss under a mesh (the eval step reduces it)
        losses = []
        for stems, mix in loader:
            losses.append(self._eval_step(torch.as_tensor(stems).to(self.device),
                                          torch.as_tensor(mix).to(self.device)))
        return float(torch.stack(losses).mean()) if losses else 0.0

    def fit(self, train_loader, val_loader, start_epoch: int = 0,
            end_epoch: Optional[int] = None) -> TrainResult:
        """Train epochs ``[start_epoch, end_epoch)``.

        ``end_epoch`` is the run's TOTAL length (exclusive bound), not a
        per-call increment: a resumed run (``start_epoch = resume()``)
        continues to the same ``--epochs`` target instead of extending by
        that many more.  ``start_epoch >= end_epoch`` trains nothing and
        reports the run as already complete."""
        end_epoch = end_epoch or self.config.num_epochs
        train_hist, val_hist = [], []
        best_val, best_epoch = float("inf"), -1
        bad_epochs = 0
        stopped = False

        # only rank 0 keeps the CSV ledger
        with (open(self._metrics_path, "a", newline="") if self.is_main
              else contextlib.nullcontext()) as f:
            writer = csv.writer(f) if f is not None else None
            if writer is not None and f.tell() == 0:
                writer.writerow(["epoch", "train_loss", "val_loss", "seconds"])

            for epoch in range(start_epoch, end_epoch):
                tic = time.time()
                train_loss = self._run_train_epoch(train_loader)
                val_loss = self._run_val_epoch(val_loader)
                dt = time.time() - tic
                train_hist.append(train_loss)
                val_hist.append(val_loss)
                stats = self.last_epoch_stats
                self._print(
                    f"Epoch {epoch}: train {train_loss:.4f}  val {val_loss:.4f}  ({dt:.1f}s; "
                    f"{stats['steps']} train steps in {stats['wall_s']:.2f}s, "
                    f"{stats['host_wait_s']:.2f}s of it waiting on the loader)"
                )
                if writer is not None:
                    writer.writerow([epoch, f"{train_loss:.6f}", f"{val_loss:.6f}",
                                     f"{dt:.2f}"])
                    f.flush()

                # ignite parity scores by -train_mse; "val" keeps the best
                # VALIDATION epochs instead (what an exported inference
                # artifact should be picked from)
                score = -val_loss if self.config.checkpoint_score == "val" else -train_loss
                self.save_checkpoint(epoch, score=score)

                if val_loss < best_val - 1e-12:
                    best_val, best_epoch = val_loss, epoch
                    bad_epochs = 0
                else:
                    bad_epochs += 1
                    if bad_epochs >= self.patience:
                        self._print(f"Early stopping at epoch {epoch} (patience exhausted)")
                        stopped = True
                        break

        self.plot_loss_curves(train_hist, val_hist)
        return TrainResult(train_hist, val_hist, best_epoch, best_val, stopped)

    def plot_loss_curves(self, train_hist: List[float], val_hist: List[float]) -> Optional[str]:
        """Loss-curve PNG in the run dir (parity: reference
        training_ignite.ipynb cell 16 / training.ipynb cell 17)."""
        if not train_hist or not self.is_main:
            return None
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # matplotlib optional
            return None
        fig = plt.figure(figsize=(7, 4))
        plt.plot(train_hist, label="train")
        plt.plot(val_hist, label="val")
        plt.xlabel("epoch")
        plt.ylabel("MSE loss")
        plt.legend()
        path = os.path.join(self.ckpt_dir, "loss_curves.png")
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        return path


_MASK64 = (1 << 64) - 1


def _seeded_generator(seed: int, index: int, device: torch.device) -> torch.Generator:
    """A generator on ``device`` whose stream is a function of ``(seed,
    index)`` alone (tpumix: ``fold_in(key(seed), index)``), so what a step
    draws does not depend on how many steps this process has run.  The pair
    goes through splitmix64's finaliser, a bijection of 64 bits that mixes
    both halves into the low 32 bits, the only ones the CPU's Mersenne
    Twister takes."""
    z = ((((seed & 0xFFFFFFFF) << 32) | (index & 0xFFFFFFFF)) + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return torch.Generator(device=device).manual_seed(z ^ (z >> 31))


class SyntheticTrainer(Trainer):
    """Trainer over the synthetic mixing task (tpumix_torch/data/synthetic.py,
    tpumix/train/trainer.py:426-552).

    Each batch is generated on the device inside the step, so the training
    loop reads no file and moves no batch from the host.  ``fit(steps_per_epoch,
    val_seed, start, end)``: the train "loader" is the number of steps per
    epoch, the val "loader" the seed of a fixed set of held-out batches
    re-evaluated each epoch.  Step ``k`` of the run (the update count) draws
    from a generator seeded by ``(config.seed + 1, k)`` and validation batch
    ``j`` from ``(val_seed, j)``, so a resumed run draws what an
    uninterrupted one does.  The step's augmentation draws from the step's
    generator after the batch; dropout masks (off unless the model enables
    them) from torch's global generator, as in :class:`Trainer`.
    Checkpointing, keep-best-k, patience, ``metrics.csv`` and the loss plot
    are inherited.

    ``loss="gain"`` supervises the generator's true gain labels
    (``make_gain_train_step``); the six self-supervised objectives train on
    the generated ``(stems, mix)`` pairs.
    """

    _supports_gain_loss = True

    def __init__(self, model: torch.nn.Module, frontend: FrontendConfig, config: TrainConfig,
                 chunk_samples: int, sr: int = 44100, run_name: Optional[str] = None,
                 device=None, val_batches: int = 4, context_mult: int = 4,
                 level_shift_db: Optional[Tuple[float, float]] = (-14.0, 2.0),
                 mix_bus_kind: Optional[str] = None, mesh=None):
        """``context_mult``: generator context in chunks (levels and labels
        are context-global, the model sees one random window; 1 = the
        per-chunk task).  ``level_shift_db``: range of the shared per-item
        level shift (labels shift-compensated); None disables it.
        ``mix_bus_kind``: ``synthetic.mix_bus`` on the generated reference mix
        (stresses the (stems, mix) objectives; gain labels stay clean).
        ``mesh``: as :class:`Trainer`; ``config.batch_size`` is then the
        global batch, whose draws every rank makes and whose rows it renders."""
        super().__init__(model, frontend, config, run_name=run_name, device=device, mesh=mesh)
        self.supervised = config.loss == "gain"
        if self.supervised:
            self._train_step = make_gain_train_step(self.state, frontend, mesh=self.mesh)
            self._eval_step = make_gain_eval_step(self.state, frontend, mesh=self.mesh)
        self.val_batches = val_batches
        self._draw_kw = dict(n=chunk_samples, context_mult=context_mult,
                             level_shift_db=level_shift_db)
        self._render_kw = dict(sr=sr, return_gains=self.supervised, mix_bus_kind=mix_bus_kind)
        self._rows = (slice(None) if self.mesh is None
                      else self.mesh.axis("dp").rows(config.batch_size))

    def _generate(self, generator: torch.Generator):
        """``(stems, supervision target)`` for the configured objective: the
        gain labels for ``"gain"``, the reference mix otherwise; this rank's
        rows of the global batch."""
        draws = synth_draws(generator, self.config.batch_size, **self._draw_kw)
        draws = {k: v[self._rows] if torch.is_tensor(v) else v for k, v in draws.items()}
        out = synth_render(draws, **self._render_kw)
        return (out[0], out[2]) if self.supervised else out

    def _run_train_epoch(self, steps) -> float:
        losses = []
        tic = time.perf_counter()
        steps = int(steps)
        for i in range(steps):
            generator = _seeded_generator(self.config.seed + 1, self.state.step, self.device)
            metrics = self._train_step(*self._generate(generator), generator)
            losses.append(metrics["loss"])
            if (i + 1) % self.config.log_every_steps == 0:
                self._print(f"  [{i + 1}/{steps}] loss: {float(metrics['loss']):.4f}")
        mean = float(torch.stack(losses).mean()) if losses else 0.0  # waits for the device
        self.last_epoch_stats = {"steps": steps, "wall_s": time.perf_counter() - tic,
                                 "host_wait_s": 0.0}
        return mean

    def _run_val_epoch(self, val_seed) -> float:
        losses = [self._eval_step(*self._generate(_seeded_generator(val_seed, j, self.device)))
                  for j in range(self.val_batches)]
        return float(torch.stack(losses).mean()) if losses else 0.0
