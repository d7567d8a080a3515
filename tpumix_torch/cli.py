"""tpumix_torch command-line interface.

    python -m tpumix_torch mix     mix one song (or a catalogue) with a checkpoint

The ``mix`` flags are those of ``python -m tpumix mix`` plus ``--device``
(``cuda`` by default; ``cpu`` runs the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys


def _songlist(args) -> list:
    if args.songlist and os.path.isfile(args.songlist):
        with open(args.songlist) as f:
            return [line.strip() for line in f if line.strip()]
    if args.songlist:
        raise SystemExit(
            f"--songlist {args.songlist!r} is not a file; the named songlist "
            "registry of the JAX package is not ported yet — pass a text file "
            "with one song per line"
        )
    return []


def _load_variables(checkpoint: str):
    """Inference variables from a shipped artifact name or an ``.npz`` file."""
    from tpumix_torch.assets import checkpoint_path
    from tpumix_torch.models.convert import load_npz

    if not os.path.exists(checkpoint) and "/" not in checkpoint:
        try:
            checkpoint = checkpoint_path(checkpoint.removesuffix(".npz"))
        except FileNotFoundError:
            pass
    if not checkpoint.endswith(".npz"):
        raise SystemExit(
            f"--checkpoint {checkpoint!r}: the port reads shipped artifact names "
            "and .npz files; Orbax run directories need the JAX package "
            "(python -m tpumix export-checkpoint writes an .npz)"
        )
    return load_npz(checkpoint)


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


def cmd_mix(args) -> int:
    from tpumix_torch.infer.catalog import mix_catalog

    mixer = _load_mixer(args)
    songs = _songlist(args) or [args.song]
    mix_catalog(mixer, args.data, songs, args.out, layout=args.layout,
                naive_sum=args.naive_sum, device_mix=args.device_mix,
                on_written=lambda p: print(f"[mix] {p}", flush=True))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpumix_torch", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("mix", help="mix songs with a trained model")
    sp.add_argument("--data", required=True, help="dataset root directory")
    sp.add_argument("--layout", default="medleydb", choices=["medleydb", "musdb18"])
    sp.add_argument("--songlist", default="", help="text file, one song per line")
    sp.add_argument("--model", default="scalar2s",
                    choices=["scalar1s", "scalar1sL", "scalar2s", "scalar2sL", "resnet18"])
    sp.add_argument("--compute-dtype", default="float32", choices=["float32", "bfloat16"],
                    help="conv trunk dtype; float32 is the conformance dtype")
    sp.add_argument("--seed", type=int, default=0, help="random-init seed (no checkpoint)")
    sp.add_argument("--transfer-dtype", default="float32",
                    choices=["float32", "int16", "int12", "mulaw8"])
    sp.add_argument("--checkpoint", default="", help="shipped artifact name or .npz file")
    sp.add_argument("--song", default="", help="single song name")
    sp.add_argument("--out", default="./mixed")
    sp.add_argument("--naive-sum", action="store_true", help="also export raw stem sums")
    sp.add_argument("--device-mix", action="store_true",
                    help="run smoothing epilogue + mixdown on the device (writes the "
                         "mono downmix)")
    sp.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    sp.set_defaults(fn=cmd_mix)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
