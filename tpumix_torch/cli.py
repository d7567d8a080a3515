"""tpumix_torch command-line interface.

    python -m tpumix_torch train              train a gain model
    python -m tpumix_torch train-synth        train on the synthetic task, generated on the device
    python -m tpumix_torch synth-data         write a synthetic corpus (MUSDB18 layout)
    python -m tpumix_torch export-checkpoint  run checkpoint -> compact inference .npz
    python -m tpumix_torch mix                mix one song (or a catalogue) with a checkpoint
    python -m tpumix_torch evaluate           LoudnessEvaluator sweep -> stats.xlsx/csv
    python -m tpumix_torch mean-loudness      per-class mean LUFS scan -> json
    python -m tpumix_torch precompute         feature cache for a songlist
    python -m tpumix_torch surgery            MedleyDB raw-stem -> category-stem grouping
    python -m tpumix_torch listening-prep     export MUSHRA listening-test wavs
    python -m tpumix_torch listening-parse    parse webMUSHRA scores -> boxplot
    python -m tpumix_torch serve              HTTP mixing service

The flags are those of the same ``python -m tpumix`` commands plus ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions).  ``train
--mesh N`` and ``train-synth --mesh N`` train data-parallel over N ranks of
``torch.distributed`` (one card each, NCCL; with ``--device cpu``, N gloo
processes): under torchrun with ``WORLD_SIZE == N`` the command joins that
group, otherwise it starts the N ranks itself.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys


def _songlist(args) -> list:
    """``--songlist``: a text file with one song per line, or a registry key
    (``tpumix_torch.data.songlists``)."""
    from tpumix_torch.data import songlists

    if args.songlist and os.path.isfile(args.songlist):
        with open(args.songlist) as f:
            return [line.strip() for line in f if line.strip()]
    if args.songlist:
        return songlists.get_songlist(args.songlist)
    return []


def _load_variables(checkpoint: str):
    """Inference variables (``{"params", "batch_stats"}`` numpy trees) from
    any checkpoint spelling: a shipped artifact name, an ``.npz`` file, a
    trainer run directory (its best-scored kept epoch) or one ``epoch_NNNN``
    directory of a run."""
    from tpumix_torch.assets import checkpoint_path
    from tpumix_torch.models.convert import load_npz, state_dict_to_jax

    if not os.path.exists(checkpoint) and "/" not in checkpoint:
        try:
            checkpoint = checkpoint_path(checkpoint.removesuffix(".npz"))
        except FileNotFoundError:
            pass  # fall through to the path-based error below
    if checkpoint.endswith(".npz"):
        return load_npz(checkpoint)
    state_file = os.path.join(_resolve_run_dir(checkpoint), "state.pt")
    if not os.path.exists(state_file):
        raise SystemExit(
            f"--checkpoint {checkpoint!r}: not a shipped artifact name, an .npz file or a "
            "run / epoch directory written by `python -m tpumix_torch train` (Orbax "
            "directories of the JAX package: python -m tpumix export-checkpoint)"
        )
    import torch

    saved = torch.load(state_file, map_location="cpu", weights_only=True)
    return state_dict_to_jax(saved["model"])


def _resolve_run_dir(checkpoint: str) -> str:
    """A trainer RUN directory resolves to its best-scored kept epoch (ledger
    written by Trainer.save_checkpoint; higher score = better, -val_loss or
    -train_mse by TrainConfig.checkpoint_score); anything else passes through
    untouched."""
    scores_path = os.path.join(checkpoint, "scores.json")
    if not os.path.exists(scores_path):
        return checkpoint
    with open(scores_path) as f:
        scores = {int(k): float(v) for k, v in json.load(f).items()}
    kept = {
        ep: s for ep, s in scores.items()
        if os.path.isdir(os.path.join(checkpoint, f"epoch_{ep:04d}"))
    }
    if not kept:
        return checkpoint
    best = max(kept, key=kept.get)
    print(f"[checkpoint] run dir given; using best-scored epoch {best}", flush=True)
    return os.path.join(checkpoint, f"epoch_{best:04d}")


def _load_mixer(args):
    import torch

    from tpumix_torch.assets import checkpoint_path
    from tpumix_torch.config import preset
    from tpumix_torch.infer.mixer import SongMixer
    from tpumix_torch.models.convert import state_dict_from_jax
    from tpumix_torch.models.registry import build_model

    cfg = dataclasses.replace(preset(args.model), compute_dtype=args.compute_dtype)
    model = build_model(cfg, generator=torch.Generator().manual_seed(args.seed))
    checkpoint = args.checkpoint
    if not checkpoint:
        try:
            checkpoint = checkpoint_path(f"{args.model}_synth")
            print(f"[{args.command}] no --checkpoint given; using shipped artifact "
                  f"{os.path.basename(checkpoint)}", flush=True)
        except FileNotFoundError:
            print(f"[{args.command}] WARNING: no --checkpoint and no shipped artifact "
                  f"for {args.model!r} — mixing with RANDOM-INIT weights", flush=True)
    if checkpoint:
        model.load_state_dict(state_dict_from_jax(_load_variables(checkpoint)))
    return SongMixer(model, cfg, transfer_dtype=args.transfer_dtype, device=args.device)


def _warn_if_lstsq_degenerate(val_loader) -> None:
    """Loud guard for a silent task killer: on corpora in the MUSDB18
    convention — ``mixture.wav`` is the PLAIN SUM of the stem files — the
    closed-form lstsq gain targets are identically zero (unity gains), so
    lstsq-family self-supervision learns the constant predictor.  Probes one
    UNAUGMENTED validation batch, host (float32) or device (int16 from a
    ``DeviceCorpus``), dequantised where it lies: engineer-scaled corpora
    measure mean |target| ~1e-3 scalar units; real mixing gains ~0.2+."""
    import torch

    from tpumix_torch.infer.mixer import _dequantize_on_device
    from tpumix_torch.train.state import _lstsq_gain_targets

    try:
        stems0, mix0 = next(iter(val_loader))
    except StopIteration:
        return
    g0 = _lstsq_gain_targets(_dequantize_on_device(torch.as_tensor(stems0)),
                             _dequantize_on_device(torch.as_tensor(mix0)))
    mean_abs = float(g0.abs().mean())
    if mean_abs < 0.02:
        print(
            "[train] WARNING: closed-form gain targets on a validation batch "
            f"are ~zero (mean |target| = {mean_abs:.4f} scalar "
            "units) — mixture.wav looks like the plain sum of the stem files, "
            "which makes lstsq-family self-supervision DEGENERATE (the model "
            "learns the constant unity-gain predictor).  Supervise raw "
            "session stems against the engineer's mix instead "
            "(synth-data --train-raw layout), or use --loss gain/reference.",
            flush=True,
        )


def _data_parallel(args, body) -> int:
    """Run ``body(args)`` on every rank of an ``--mesh N`` process group
    (tpumix/cli.py:279-284: N data-parallel devices, one command).

    A rank already in a group runs it; under torchrun (``WORLD_SIZE``) the
    process joins; else one rank runs here (N = 1) or N are spawned, their
    group met through a file in a temporary directory.  On CUDA every rank
    needs a card of its own (NCCL refuses two ranks on one card), so N above
    the cards present raises instead of running fewer."""
    import torch

    from tpumix_torch.parallel import distributed

    n = int(args.mesh)
    if n < 1:
        raise SystemExit(f"--mesh {args.mesh}: expected a positive rank count")
    if args.batch_size % n:
        raise SystemExit(f"--batch-size {args.batch_size} (the global batch) does not split "
                         f"over --mesh {n} ranks")
    if torch.distributed.is_initialized():
        return body(args)
    if args.device == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--mesh {n} on --device cuda needs {n} cards, this machine has "
                         f"{torch.cuda.device_count()} (NCCL refuses two ranks on one card)")
    if "WORLD_SIZE" in os.environ:
        if int(os.environ["WORLD_SIZE"]) != n:
            raise SystemExit(f"--mesh {n} under a launcher of WORLD_SIZE "
                             f"{os.environ['WORLD_SIZE']}")
        distributed.initialize(device=None if args.device == "cuda" else args.device)
        _say_joined(n)
        try:
            return body(args)
        finally:
            distributed.shutdown()
    import tempfile

    with tempfile.TemporaryDirectory(prefix="tpumix-mesh-") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        if n == 1:
            _rank_main(0, args, body, n, init)
        else:
            import torch.multiprocessing as mp

            mp.spawn(_rank_main, args=(args, body, n, init), nprocs=n, join=True)
    return 0


def _rank_main(rank: int, args, body, n: int, init: str) -> None:
    """One rank of :func:`_data_parallel`'s group: its device is
    ``cuda:<rank>`` (``cpu`` for ``--device cpu``)."""
    import torch

    from tpumix_torch.parallel import distributed

    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(n))
    if args.device == "cpu" and n > 1:  # the ranks share the host's cores
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    distributed.initialize(init, n, rank,
                           device=f"cuda:{rank}" if args.device == "cuda" else args.device)
    _say_joined(n)
    try:
        rc = body(args)
    finally:
        distributed.shutdown()
    if rc:
        raise SystemExit(rc)


def _say_joined(n: int) -> None:
    import torch

    _say(f"[mesh] {n} data-parallel ranks, backend {torch.distributed.get_backend()}")


def _mesh_config(args) -> dict:
    """``TrainConfig`` fields of ``--mesh``: one ``dp`` axis of N ranks."""
    return {"mesh_shape": (int(args.mesh),), "mesh_axis_names": ("dp",)} if args.mesh else {}


def _say(msg: str) -> None:
    """Print on rank 0 only (every rank of a data-parallel run computes the
    same result)."""
    from tpumix_torch.parallel.distributed import process_index

    if process_index() == 0:
        print(msg, flush=True)


def cmd_train(args) -> int:
    if args.mesh:
        return _data_parallel(args, _train)
    return _train(args)


def _train(args) -> int:
    import torch

    from tpumix_torch.config import TrainConfig, preset
    from tpumix_torch.data.dataset import MultitrackAudioDataset
    from tpumix_torch.data.loaders import discover_songs, split_songlist
    from tpumix_torch.data.prefetch import BatchIterator
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.train.trainer import Trainer, resolve_patience

    model_cfg = dataclasses.replace(preset(args.model), compute_dtype=args.compute_dtype,
                                    bn_momentum=args.bn_momentum)
    # no songlist -> discover songs exactly as the dataset would, so the
    # train/val split still happens
    songs = _songlist(args) or discover_songs(args.data)
    train_songs, val_songs, _ = split_songlist(
        songs, (1 - args.val_fraction, args.val_fraction, 0.0), seed=args.seed
    )
    if not train_songs:
        # an empty list would read as "discover everything" downstream
        raise SystemExit(
            f"--val-fraction {args.val_fraction} leaves no training songs "
            f"({len(songs)} total); lower it or provide more songs"
        )

    def make_ds(sl, augment):
        return MultitrackAudioDataset(
            args.data, songlist=sl, chunk_length=model_cfg.chunk_length_s,
            seed=args.seed, layout=args.layout, hop_length=model_cfg.hop_length,
            augment_data=augment,
        )

    # validation data is NEVER augmented (random val gains would bias the
    # early-stopping signal; the reference never augments validation)
    if not val_songs:
        _say("[train] WARNING: validation split is empty at this "
             "--val-fraction; validating on the training songs")
        val_songs = train_songs
    # with --mesh, --batch-size is the global batch and each rank loads its
    # rows of it (tpumix/cli.py:606)
    from tpumix_torch.parallel.distributed import process_count, process_index

    shards = dict(num_shards=process_count(), shard_index=process_index())
    local_batch = args.batch_size // shards["num_shards"]

    if args.device_corpus:
        # the corpus goes onto the device once as int16 and every batch is a
        # gather there (data/device_corpus.py).  Augmentation moves into the
        # step (random gains from the step's device generator, the same
        # all-five-tracks semantics); there is no wire to encode
        from tpumix_torch.data.device_corpus import DeviceCorpus, DeviceCorpusIterator

        if args.transfer_dtype != "float32":
            _say(f"[train] WARNING: --transfer-dtype {args.transfer_dtype} is "
                 "ignored with --device-corpus (the corpus is stored int16 on "
                 "device and the step dequantises by dtype; there is no wire)")
        chunk_samples = model_cfg.frontend().chunk_samples(model_cfg.chunk_length_s)
        c_train = DeviceCorpus(args.data, train_songs, chunk_samples, args.layout,
                               device=args.device)
        # the empty-split fallback above validates on the training songs:
        # upload that corpus once
        c_val = (c_train if val_songs == train_songs else
                 DeviceCorpus(args.data, val_songs, chunk_samples, args.layout,
                              device=args.device))
        train_loader = DeviceCorpusIterator(c_train, local_batch, seed=args.seed, **shards)
        val_loader = DeviceCorpusIterator(c_val, local_batch, shuffle=False, seed=args.seed,
                                          **shards)
        train_len = c_train.num_chunks
        step_augment, wire_dtype = args.augment, "float32"
    else:
        d_train = make_ds(train_songs, args.augment)
        train_loader = BatchIterator(d_train, local_batch, seed=args.seed, **shards)
        val_loader = BatchIterator(make_ds(val_songs, False), local_batch, shuffle=False,
                                   seed=args.seed, **shards)
        train_len = len(d_train)
        step_augment, wire_dtype = False, args.transfer_dtype

    # cosine needs the total step count up front; the loader's epoch length
    # is deterministic (drop_last static batches over the train chunk count)
    steps_per_epoch = max(1, train_len // args.batch_size)
    cfg = TrainConfig(
        batch_size=args.batch_size, learning_rate=args.lr, num_epochs=args.epochs,
        checkpoint_dir=args.checkpoint_dir, seed=args.seed, augment=step_augment,
        checkpoint_score=args.checkpoint_score,
        augment_mix=not args.augment_stems_only,
        early_stopping_patience=resolve_patience(args.patience, args.loss),
        keep_checkpoints=args.keep_checkpoints, loss=args.loss,
        transfer_dtype=wire_dtype,
        lr_schedule=args.lr_schedule,
        lr_total_steps=(args.epochs * steps_per_epoch
                        if args.lr_schedule == "cosine" else None),
        **_mesh_config(args),
    )
    # parameter init and dropout masks: both from --seed (dropout draws from
    # torch's global generator, train/state.py)
    torch.manual_seed(args.seed)
    model = build_model(model_cfg, generator=torch.Generator().manual_seed(args.seed),
                        for_training=True)
    trainer = Trainer(model, model_cfg.frontend(), cfg, run_name=args.run_name,
                      device=args.device)
    if args.loss.startswith("lstsq") and trainer.is_main:
        _warn_if_lstsq_degenerate(val_loader)
    start = trainer.resume() if args.resume else 0
    result = trainer.fit(train_loader, val_loader, start, args.epochs)
    _say(json.dumps({
        "best_epoch": result.best_epoch, "best_val_loss": result.best_val_loss,
        "stopped_early": result.stopped_early, "checkpoint_dir": trainer.ckpt_dir,
    }))
    return 0


def cmd_train_synth(args) -> int:
    if args.mesh:
        return _data_parallel(args, _train_synth)
    return _train_synth(args)


def _train_synth(args) -> int:
    """Train on the synthetic mixing task, each batch generated on the device
    inside the step (data/synthetic.py): the loop reads no file."""
    import torch

    from tpumix_torch.config import TrainConfig, preset
    from tpumix_torch.models.registry import build_model
    from tpumix_torch.train.trainer import SyntheticTrainer, resolve_patience

    model_cfg = dataclasses.replace(preset(args.model), compute_dtype=args.compute_dtype,
                                    bn_momentum=args.bn_momentum, use_dropout=args.dropout)
    cfg = TrainConfig(
        batch_size=args.batch_size, learning_rate=args.lr, num_epochs=args.epochs,
        checkpoint_dir=args.checkpoint_dir, seed=args.seed, augment=args.augment,
        checkpoint_score=args.checkpoint_score,
        augment_mix=not args.augment_stems_only,
        early_stopping_patience=resolve_patience(args.patience, args.loss),
        keep_checkpoints=args.keep_checkpoints, loss=args.loss,
        lr_schedule=args.lr_schedule,
        lr_total_steps=args.epochs * args.steps_per_epoch,
        **_mesh_config(args),
    )
    # parameter init and dropout masks from --seed, as in `train`
    torch.manual_seed(args.seed)
    model = build_model(model_cfg, generator=torch.Generator().manual_seed(args.seed),
                        for_training=True)
    frontend = model_cfg.frontend()
    trainer = SyntheticTrainer(
        model, frontend, cfg, chunk_samples=frontend.chunk_samples(model_cfg.chunk_length_s),
        run_name=args.run_name, device=args.device, context_mult=args.context_mult,
        level_shift_db=tuple(args.level_shift_db), mix_bus_kind=(args.mix_bus or None),
    )
    start = trainer.resume() if args.resume else 0
    # validation batches from seed + 7 (tpumix: key(seed + 7))
    result = trainer.fit(args.steps_per_epoch, args.seed + 7, start, args.epochs)
    _say(json.dumps({
        "best_epoch": result.best_epoch, "best_val_loss": result.best_val_loss,
        "stopped_early": result.stopped_early, "checkpoint_dir": trainer.ckpt_dir,
    }))
    return 0


def cmd_synth_data(args) -> int:
    """Write a synthetic evaluation corpus (MUSDB18 layout) and its songlist
    files."""
    from tpumix_torch.data.synthetic import write_synth_dataset

    os.makedirs(args.out, exist_ok=True)
    lists = write_synth_dataset(
        args.out, n_train=args.n_train, n_test=args.n_test, duration_s=args.duration,
        seed=args.seed, train_raw=args.train_raw, bus=(args.bus or None),
    )
    for split, songs in lists.items():
        with open(os.path.join(args.out, f"{split}_songlist.txt"), "w") as f:
            f.write("\n".join(songs) + "\n")
    print(json.dumps({"root": args.out, **{k: len(v) for k, v in lists.items()}}))
    return 0


def cmd_export_checkpoint(args) -> int:
    """Run checkpoint -> compact inference .npz (params + batch_stats only;
    drops optimiser state), in the tree the JAX package's ``load_npz`` reads."""
    from tpumix_torch.models.convert import save_npz

    variables = _load_variables(args.checkpoint)
    save_npz(args.out, variables["params"], variables["batch_stats"])
    print(json.dumps({"out": args.out, "bytes": os.path.getsize(args.out)}))
    return 0


def cmd_mix(args) -> int:
    from tpumix_torch.infer.catalog import mix_catalog

    mixer = _load_mixer(args)
    songs = _songlist(args) or [args.song]
    mix_catalog(mixer, args.data, songs, args.out, layout=args.layout,
                naive_sum=args.naive_sum, device_mix=args.device_mix,
                on_written=lambda p: print(f"[mix] {p}", flush=True))
    return 0


def cmd_evaluate(args) -> int:
    from tpumix_torch.eval.evaluator import LoudnessEvaluator

    mixer = _load_mixer(args)
    with open(args.mean_loudness) as f:
        mean_loudness = json.load(f)
    ev = LoudnessEvaluator(mixer, mean_loudness, seed=args.seed, results_dir=args.out,
                           device_meter=args.device_meter, device=args.device)
    ev.process_songlist(args.data, _songlist(args), write_to_disk=args.export_wavs,
                        out_path=os.path.join(args.out, "stats.xlsx"))
    return 0


def cmd_mean_loudness(args) -> int:
    from tpumix_torch.data.dataset import MultitrackAudioDataset

    d = MultitrackAudioDataset(args.data, songlist=_songlist(args) or None, layout=args.layout)
    ml = d.compute_mean_loudness()
    with open(args.out, "w") as f:
        json.dump(ml, f, indent=2)
    print(json.dumps(ml))
    return 0


def cmd_precompute(args) -> int:
    from tpumix_torch.config import preset
    from tpumix_torch.data.dataset import MultitrackAudioDataset

    model_cfg = preset(args.model)
    d = MultitrackAudioDataset(
        args.data, songlist=_songlist(args) or None, chunk_length=model_cfg.chunk_length_s,
        hop_length=model_cfg.hop_length, layout=args.layout, return_features=True,
        cache_dir=args.cache_dir,
    )
    d.precompute_features()
    print(f"[precompute] cache at {args.cache_dir}")
    return 0


def cmd_surgery(args) -> int:
    from tpumix_torch.data.surgery import process_root

    done = process_root(args.data, naive_sums=args.naive_sums)
    print(f"[surgery] processed {len(done)} songs")
    return 0


def cmd_listening_prep(args) -> int:
    import numpy as np

    from tpumix_torch.eval import listening
    from tpumix_torch.models.baselines import MeanLoudnessModel, RandomModel

    mixer = _load_mixer(args)
    with open(args.mean_loudness) as f:
        mean_loudness = json.load(f)
    models = {
        "random": RandomModel(rng=np.random.default_rng(args.seed)),
        "loudnorm": MeanLoudnessModel(mean_loudness),
        "mix": mixer,
    }
    listening.process_songlist(args.data, _songlist(args), models, save_dir=args.out)
    return 0


def cmd_listening_parse(args) -> int:
    from tpumix_torch.eval import listening

    by_model, _ = listening.parse_json(args.scores)
    g = listening.global_scores(by_model)
    keys = sorted(g)
    listening.produce_boxplot([g[k] for k in keys], keys, args.out)
    print(f"[listening] boxplot at {args.out}")
    return 0


def cmd_serve(args) -> int:
    import threading

    from tpumix_torch.serve import serve

    mixer = _load_mixer(args)
    httpd = serve(mixer, host=args.host, port=args.port, model_name=args.model)
    # accept connections before warming, so /healthz answers ("warm": false)
    # while the kernels build and the first shapes run
    server_thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    server_thread.start()
    host, port = httpd.server_address[:2]
    print(f"[serve] {args.model} on http://{host}:{port}", flush=True)
    if not args.no_warmup:
        print("[serve] warming the device paths (kernel builds, first shapes; /healthz "
              "reports \"warm\")...", flush=True)
        httpd.service.warm()
        print("[serve] warm", flush=True)
    try:
        while server_thread.is_alive():
            server_thread.join(timeout=1.0)
    except KeyboardInterrupt:
        httpd.shutdown()
    return 0


_MODELS = ["scalar1s", "scalar1sL", "scalar2s", "scalar2sL", "resnet18"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpumix_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp, checkpoint=True):
        sp.add_argument("--data", required=True, help="dataset root directory")
        sp.add_argument("--layout", default="medleydb", choices=["medleydb", "musdb18"])
        sp.add_argument("--songlist", default="",
                        help="registry key (tpumix_torch.data.songlists) or a text file, "
                             "one song per line")
        sp.add_argument("--model", default="scalar2s", choices=_MODELS)
        sp.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                        help="conv trunk dtype; float32 is the conformance dtype")
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--transfer-dtype", default="float32",
                        choices=["float32", "int16", "int12", "mulaw8"])
        sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
        if checkpoint:
            sp.add_argument("--checkpoint", default="",
                            help="shipped artifact name, .npz file, or a run / epoch "
                                 "directory of `train`")

    sp = sub.add_parser("train", help="train a gain model")
    common(sp, checkpoint=False)
    sp.add_argument("--epochs", type=int, default=20,
                    help="TOTAL epochs for the run; a --resume continues to this total, "
                         "it does not add this many more")
    sp.add_argument("--batch-size", type=int, default=48)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--val-fraction", type=float, default=0.2)
    sp.add_argument("--patience", type=int, default=None,
                    help="early-stopping patience; default is per-loss (lstsq family: 30 — "
                         "its val curve has a mid-run plateau that patience 10 stops at; "
                         "others: 10, ignite parity)")
    sp.add_argument("--keep-checkpoints", type=int, default=None)
    sp.add_argument("--checkpoint-score", default="train", choices=["train", "val"],
                    help="keep-best-k ranking: 'train' = ignite parity (-train_mse); 'val' "
                         "keeps the best VALIDATION epochs — use for runs whose best-val "
                         "checkpoint will be exported as an inference artifact")
    sp.add_argument("--checkpoint-dir", default="./checkpoints")
    sp.add_argument("--run-name", default=None)
    sp.add_argument("--augment", action="store_true")
    sp.add_argument("--augment-stems-only", action="store_true",
                    help="with --augment: re-gain only the stems, keep the supervision mix "
                         "clean (reference parity augments all five tracks; the independent "
                         "mix gain is unobservable from the stems, which makes lstsq-family "
                         "targets noisy)")
    sp.add_argument("--loss", default="reference",
                    choices=["reference", "roundtrip", "coherent", "lstsq", "lstsq_tail",
                             "lstsq_tail_cm"],
                    help="reference = dB-linear masked-sum MSE (parity); roundtrip = gains "
                         "supervised through the inference map")
    sp.add_argument("--bn-momentum", type=float, default=0.10,
                    help="BN retained fraction (flax convention); 0.10 (default) = the "
                         "reference's torch momentum 0.90 — running stats track the LAST "
                         "batch, which makes eval-mode val loss (and early stopping) noisy "
                         "on small corpora; raise towards 0.99 for stable statistics")
    sp.add_argument("--lr-schedule", default="constant", choices=["constant", "cosine"],
                    help="constant = reference parity; cosine decays lr -> 0.01x over "
                         "epochs x steps-per-epoch")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in the run dir (requires "
                         "--run-name)")
    sp.add_argument("--device-corpus", action="store_true",
                    help="upload the whole corpus to the device once (int16) and assemble "
                         "batches there: per-step host traffic is a [B] offset vector.  For "
                         "corpora that fit the card next to the model; augmentation runs in "
                         "the step (data/device_corpus.py)")
    sp.add_argument("--mesh", default="",
                    help="data-parallel rank count: --batch-size is the global batch, each "
                         "rank trains on its rows (one card per rank on cuda; gloo "
                         "processes with --device cpu)")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("train-synth", help="train on the synthetic task, generated on the "
                                            "device")
    sp.add_argument("--model", default="scalar2sL", choices=_MODELS)
    sp.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="trunk and heads dtype; parameters, optimizer state and BN "
                         "statistics stay float32")
    sp.add_argument("--bn-momentum", type=float, default=0.99,
                    help="BN retained fraction (0.10 = reference torch parity; 0.99 default "
                         "here for stable eval-mode running stats on short synthetic runs)")
    sp.add_argument("--dropout", action="store_true",
                    help="enable the reference's dropout (default OFF here: nothing to "
                         "regularise on an infinite synthetic stream, and it miscalibrates "
                         "BN running stats)")
    sp.add_argument("--context-mult", type=int, default=4,
                    help="generator context length in chunks; levels/labels are "
                         "context-global, the model sees one random window")
    sp.add_argument("--level-shift-db", type=float, nargs=2, default=(-14.0, 2.0),
                    metavar=("LO", "HI"),
                    help="shared global level shift range in dB with shift-compensated "
                         "labels (real corpora arrive at arbitrary absolute levels)")
    sp.add_argument("--mix-bus", default="", choices=["", "reverb", "comp", "limiter", "full"],
                    help="non-ideal mix-bus processing on the generator's reference mix "
                         "(reverb tail / soft-knee compressor / tanh limiter / all three); "
                         "gain labels stay clean")
    sp.add_argument("--lr-schedule", default="cosine", choices=["constant", "cosine"],
                    help="cosine decays to 0.01x over epochs*steps (default here; "
                         "'constant' = reference parity)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--epochs", type=int, default=20,
                    help="TOTAL epochs for the run; a --resume continues to this total, "
                         "it does not add this many more")
    sp.add_argument("--steps-per-epoch", type=int, default=50)
    sp.add_argument("--batch-size", type=int, default=48)
    sp.add_argument("--lr", type=float, default=1e-3)
    sp.add_argument("--patience", type=int, default=None,
                    help="early-stopping patience; default is per-loss (lstsq: 30, "
                         "others: 10)")
    sp.add_argument("--keep-checkpoints", type=int, default=None)
    sp.add_argument("--checkpoint-score", default="val", choices=["train", "val"],
                    help="keep-best-k ranking: 'train' = ignite parity (-train_mse); 'val' "
                         "keeps the best VALIDATION epochs (the artifact to export)")
    sp.add_argument("--checkpoint-dir", default="./checkpoints")
    sp.add_argument("--run-name", default=None)
    sp.add_argument("--augment", action="store_true")
    sp.add_argument("--augment-stems-only", action="store_true",
                    help="with --augment: re-gain only the stems, keep the supervision mix "
                         "clean")
    sp.add_argument("--loss", default="gain",
                    choices=["reference", "roundtrip", "coherent", "lstsq", "lstsq_tail",
                             "lstsq_tail_cm", "gain"],
                    help="gain (default): MSE against the generator's true gain labels, the "
                         "only per-stem-identifiable objective on this family; the others "
                         "are the label-free objectives of `train`")
    sp.add_argument("--resume", action="store_true",
                    help="continue from the newest checkpoint of this run")
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--mesh", default="",
                    help="data-parallel rank count: --batch-size is the global batch, each "
                         "rank generates and trains on its rows")
    sp.set_defaults(fn=cmd_train_synth)

    sp = sub.add_parser("synth-data", help="write a synthetic eval corpus")
    sp.add_argument("--out", required=True)
    sp.add_argument("--n-train", type=int, default=16)
    sp.add_argument("--n-test", type=int, default=8)
    sp.add_argument("--duration", type=float, default=30.0)
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--train-raw", action="store_true",
                    help="write the train split in the reference's supervision layout: raw "
                         "session stems + the engineer's mix as mixture.wav (what `train` "
                         "learns gains from)")
    sp.add_argument("--bus", default="", choices=["", "reverb", "comp", "limiter", "full"],
                    help="non-ideal mix-bus processing applied to every engineer mix "
                         "(data/synthetic.py mix_bus)")
    sp.set_defaults(fn=cmd_synth_data)

    sp = sub.add_parser("export-checkpoint",
                        help="run checkpoint -> compact inference .npz")
    sp.add_argument("--checkpoint", required=True, help="run or epoch directory of `train`")
    sp.add_argument("--out", required=True, help="output .npz path")
    sp.set_defaults(fn=cmd_export_checkpoint)

    sp = sub.add_parser("mix", help="mix songs with a trained model")
    common(sp)
    sp.add_argument("--song", default="", help="single song name")
    sp.add_argument("--out", default="./mixed")
    sp.add_argument("--naive-sum", action="store_true", help="also export raw stem sums")
    sp.add_argument("--device-mix", action="store_true",
                    help="run smoothing epilogue + mixdown on the device (writes the "
                         "mono downmix)")
    sp.set_defaults(fn=cmd_mix)

    sp = sub.add_parser("evaluate", help="loudness evaluation sweep")
    common(sp)
    sp.add_argument("--mean-loudness", required=True, help="json from mean-loudness")
    sp.add_argument("--out", default="./experiment")
    sp.add_argument("--export-wavs", action="store_true")
    sp.add_argument("--device-meter", action="store_true",
                    help="batched BS.1770 metering on --device (<=0.1 LU vs the host meter)")
    sp.set_defaults(fn=cmd_evaluate)

    sp = sub.add_parser("mean-loudness", help="per-class mean LUFS scan")
    common(sp, checkpoint=False)
    sp.add_argument("--out", default="./mean_loudness.json")
    sp.set_defaults(fn=cmd_mean_loudness)

    sp = sub.add_parser("precompute", help="write the feature cache")
    common(sp, checkpoint=False)
    sp.add_argument("--cache-dir", required=True)
    sp.set_defaults(fn=cmd_precompute)

    sp = sub.add_parser("surgery", help="MedleyDB stem grouping")
    sp.add_argument("--data", required=True)
    sp.add_argument("--naive-sums", action="store_true")
    sp.set_defaults(fn=cmd_surgery)

    sp = sub.add_parser("listening-prep", help="export listening-test wavs")
    common(sp)
    sp.add_argument("--mean-loudness", required=True)
    sp.add_argument("--out", default="./test_data")
    sp.set_defaults(fn=cmd_listening_prep)

    sp = sub.add_parser("listening-parse", help="parse webMUSHRA scores json")
    sp.add_argument("--scores", required=True)
    sp.add_argument("--out", default="./test_figures/global.png")
    sp.set_defaults(fn=cmd_listening_parse)

    sp = sub.add_parser("serve", help="HTTP mixing service")
    sp.add_argument("--model", default="scalar2s", choices=_MODELS)
    sp.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"])
    sp.add_argument("--checkpoint", default="")
    sp.add_argument("--transfer-dtype", default="float32",
                    choices=["float32", "int16", "int12", "mulaw8"])
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8080,
                    help="0 picks a free port; the bound one is printed")
    sp.add_argument("--no-warmup", action="store_true",
                    help="skip the start-up run of the device paths")
    # no --seed, as in the JAX CLI: a random init draws from 0
    sp.set_defaults(fn=cmd_serve, seed=0)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
