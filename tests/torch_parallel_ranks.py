"""One rank of the data-parallel checks in tests/test_torch_parallel.py.

    python tests/torch_parallel_ranks.py RANK WORLD INIT_METHOD OUT_DIR [MODE]

Joins a gloo group on the CPU, runs the port's parallel paths on the inputs
of tests/test_torch_parallel.py (the same seeds, built here: this process
imports torch and tpumix_torch only; the initial parameters come from
``OUT_DIR/init.pt`` and ``OUT_DIR/init_sp.pt``) and writes what it computed
to ``OUT_DIR/rank<RANK>.pt``.  MODE ``dp`` (the default, two ranks): every
data-parallel path on a ``(2,)`` mesh, then the frame-sharded train step on
a ``(1, 2)`` ``dp x sp`` mesh; MODE ``sp`` (four ranks): the frame-sharded
step on a ``(2, 2)`` mesh.  The test computes the one-process references
itself and compares.
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

SR = 8000
CHUNK = 6000  # 0.75 s -> 47 frames at hop 128 (tests/test_train.py's size)
FT = (129, 47)
LR, WD = 1e-3, 1e-5
GLOBAL_BATCH = 8
LOSSES = (("reference", False), ("coherent", True), ("lstsq_tail_cm", False))
# the frame-sharded step: 0.8 s chunks, 51 frames, so scalar1s keeps three
# conv5 frames to split over two sp ranks; every objective of the step
SP_CHUNK = 6400
SP_FT = (129, 51)
SP_LOSSES = (("reference", False), ("roundtrip", False), ("coherent", True), ("lstsq", False),
             ("lstsq_tail", False), ("lstsq_tail_cm", False))
SP_STEPS = 2


def frontend():
    from tpumix_torch.config import FrontendConfig

    return FrontendConfig(n_fft=256, hop_length=128, sample_rate=SR)


def batches(n_batches=2, bs=GLOBAL_BATCH, seed=0, chunk=CHUNK):
    """Seeded global (stems [bs, 4, chunk], mix [bs, chunk]) pairs: tones over
    noise, the mix a fixed-gain sum (tests/test_train.py SynthChunks)."""
    rng = np.random.default_rng(seed)
    t = np.arange(chunk) / SR
    true_gains = np.array([0.9, 1.1, 0.8, 1.2], np.float32)
    out = []
    for _ in range(n_batches):
        freqs = rng.uniform(50, 3000, size=(bs, 4, 1))
        stems = (0.2 + 0.1 * rng.random((bs, 4, 1))) * np.sin(
            2 * np.pi * freqs * t + rng.uniform(0, 6.28, (bs, 4, 1)))
        stems = (stems + 0.01 * rng.standard_normal(stems.shape)).astype(np.float32)
        out.append((stems, (true_gains[:, None] * stems).sum(axis=1).astype(np.float32)))
    return out


def model(init, in_shape=FT):
    """scalar1s at the small size, dropout off, BN retained fraction 0.99,
    holding the state dict ``init`` (the test's flax initialisation)."""
    from tpumix_torch.config import preset
    from tpumix_torch.models.registry import build_model

    cfg = dataclasses.replace(preset("scalar1s"), use_dropout=False, bn_momentum=0.99)
    m = build_model(cfg, in_shape=in_shape, for_training=True)
    m.load_state_dict(init)
    return m


def song(seconds=9.0, seed=3):
    """Four mono stems at 44.1 kHz for the mixer (1 s chunks: 8 gains)."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal((4, int(44100 * seconds)))).astype(np.float32)


def mixer(mesh=None):
    from tpumix_torch.config import MixConfig, preset
    from tpumix_torch.infer.mixer import SongMixer
    from tpumix_torch.models.registry import build_model

    cfg = preset("scalar1s")
    m = build_model(cfg, generator=torch.Generator().manual_seed(5))
    return SongMixer(m, cfg, MixConfig(chunk_length_s=1.0, max_chunks=4), device="cpu",
                     mesh=mesh, chunk_axis="dp" if mesh is not None else None)


def step_results(mesh, data, init):
    """Per objective, from ``init``: the eval loss on both global batches,
    then one train step on the first."""
    from tpumix_torch.parallel.mesh import data_parallel
    from tpumix_torch.train.state import create_train_state, make_eval_step, make_train_step

    out = {}
    for loss, augment in LOSSES:
        state = create_train_state(model(init), LR, WD)
        evaluate = make_eval_step(state, frontend(), loss=loss, mesh=mesh)
        step = make_train_step(state, frontend(), augment=augment, loss=loss, mesh=mesh)
        if mesh is not None:
            evaluate, step = data_parallel(evaluate, mesh), data_parallel(step, mesh)
        evals = [float(evaluate(torch.from_numpy(s), torch.from_numpy(m))) for s, m in data]
        stems, mix = data[0]
        metrics = step(torch.from_numpy(stems), torch.from_numpy(mix),
                       torch.Generator().manual_seed(11))
        out[loss] = {
            "eval": evals, "loss": float(metrics["loss"]),
            "mean_gain": float(metrics["mean_gain"]),
            "state": {k: v.clone() for k, v in state.model.state_dict().items()},
        }
    return out


def sp_step_results(mesh, init):
    """Per objective, from ``init``: ``SP_STEPS`` train steps on the
    ``SP_CHUNK`` global batches, frame-sharded over ``mesh``'s ``sp`` axis
    (one process without a mesh): each step's loss and mean gain, the state
    after the first step and the feature frames this rank computed."""
    from tpumix_torch.parallel.mesh import data_parallel
    from tpumix_torch.train.state import create_train_state, make_train_step

    data = batches(n_batches=SP_STEPS, chunk=SP_CHUNK, seed=1)
    out = {}
    for loss, augment in SP_LOSSES:
        state = create_train_state(model(init, SP_FT), LR, WD)
        kw = {} if mesh is None else {"mesh": mesh, "sp_axis": "sp"}
        step = make_train_step(state, frontend(), augment=augment, loss=loss, **kw)
        if mesh is not None:
            step = data_parallel(step, mesh)
        got = {"loss": [], "mean_gain": []}
        for k, (stems, mix) in enumerate(data):
            metrics = step(torch.from_numpy(stems), torch.from_numpy(mix),
                           torch.Generator().manual_seed(11 + k))
            got["loss"].append(float(metrics["loss"]))
            got["mean_gain"].append(float(metrics["mean_gain"]))
            if k == 0:
                got["state"] = {n: v.clone() for n, v in state.model.state_dict().items()}
        out[loss] = got
    if mesh is not None:
        out["features"] = state.model.frame_shard(frontend().num_frames(SP_CHUNK),
                                                  mesh.axis("sp"), mesh.axis("dp").size).features
    return out


def trainer_results(mesh, data, init, ckpt_dir):
    """The ``Trainer`` validation pass and a ``SyntheticTrainer`` gain epoch
    (one step, one validation batch)."""
    from tpumix_torch.config import TrainConfig
    from tpumix_torch.parallel.mesh import shard_batch
    from tpumix_torch.train.trainer import SyntheticTrainer, Trainer

    tag = "mesh" if mesh is not None else "solo"
    cfg = TrainConfig(batch_size=GLOBAL_BATCH, num_epochs=1, checkpoint_dir=ckpt_dir, seed=0)
    tr = Trainer(model(init), frontend(), cfg, run_name=f"val_{tag}", device="cpu", mesh=mesh)
    loader = [shard_batch(b, mesh) for b in data] if mesh is not None else data
    val = tr._run_val_epoch(loader)
    scfg = TrainConfig(batch_size=4, num_epochs=1, checkpoint_dir=ckpt_dir, seed=0, loss="gain")
    st = SyntheticTrainer(model(init), frontend(), scfg, chunk_samples=CHUNK, sr=SR,
                          run_name=f"gain_{tag}", device="cpu", val_batches=1, mesh=mesh)
    res = st.fit(1, 7, 0, 1)
    return {"val": val, "gain_train": res.train_loss[0], "gain_val": res.val_loss[0],
            "gain_state": {k: v.clone() for k, v in st.model.state_dict().items()}}


def mixer_results(mesh):
    m = mixer(mesh)
    stems = song()
    _, mixed, smooth = m.mix_song_smooth_device(stems)
    return {"gains": m.song_gains(stems), "mixed": mixed.numpy(), "smooth": smooth.numpy()}


def main(argv) -> int:
    rank, world, init, out_dir = int(argv[1]), int(argv[2]), argv[3], argv[4]
    mode = argv[5] if len(argv) > 5 else "dp"
    torch.set_num_threads(1)
    from tpumix_torch.parallel import distributed
    from tpumix_torch.parallel.mesh import make_mesh

    distributed.initialize(init, world, rank, backend="gloo", device="cpu", timeout_s=300)
    try:
        init_sp = torch.load(os.path.join(out_dir, "init_sp.pt"))
        if mode == "sp":
            out = {"sp": sp_step_results(make_mesh((2, world // 2), ("dp", "sp")), init_sp)}
        else:
            mesh = make_mesh((world,), ("dp",))
            data = batches()
            init = torch.load(os.path.join(out_dir, "init.pt"))
            out = {"steps": step_results(mesh, data, init),
                   "trainer": trainer_results(mesh, data, init, os.path.join(out_dir, "ckpt")),
                   "mixer": mixer_results(mesh),
                   "mesh": {"shape": dict(mesh.shape), "axis_names": mesh.axis_names},
                   "sp": sp_step_results(make_mesh((1, world), ("dp", "sp")), init_sp)}
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
