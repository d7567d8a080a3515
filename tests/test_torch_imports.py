"""The PyTorch port stands alone: no file of ``tpumix_torch/`` and not
``chip_smoke.py`` imports JAX, Flax or the JAX package, importing the port
loads none of them (nor the optional matplotlib and yaml, which the modules
that use them import where they use them), and the default device is the card
— never a silent CPU fall-back."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "tpumix")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "tpumix_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)  # one order for every test worker


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_forbidden_imports(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_import_loads_no_jax_module():
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import tpumix_torch, tpumix_torch.cli, tpumix_torch.infer.mixer, "
        "tpumix_torch.infer.catalog, tpumix_torch.ops.stft_dif, tpumix_torch.ops.conv_block, "
        "tpumix_torch.ops.stft_basis, tpumix_torch.ops.stft_ct, tpumix_torch.ops._build, "
        "tpumix_torch.assets, tpumix_torch.train, tpumix_torch.data.dataset, "
        "tpumix_torch.data.prefetch, tpumix_torch.serve, tpumix_torch.infer.streaming, "
        "tpumix_torch.eval.evaluator, tpumix_torch.models.resnet, tpumix_torch.ops.loudness, "
        "tpumix_torch.data.songlists, tpumix_torch.data.synthetic, "
        "tpumix_torch.data.device_corpus, tpumix_torch.parallel, "
        "tpumix_torch.parallel.distributed, tpumix_torch.parallel.mesh, "
        "tpumix_torch.data._native, tpumix_torch.data.surgery, tpumix_torch.eval.listening, "
        "tpumix_torch.ops.conv_khgemm, tpumix_torch.ops.conv_int8, tpumix_torch.ops.istft, "
        "tpumix_torch.models.flops, tpumix_torch.utils.profiling, tpumix_torch.parallel.frames\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'tpumix'))\n"
        "assert not bad, bad\n"
        "lazy = sorted(m for m in new if m.split('.')[0] in ('matplotlib', 'yaml'))\n"
        "assert not lazy, f'optional packages imported eagerly: {lazy}'\n"
        "print(len(new))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) > 0


def test_default_device_raises_without_cuda(monkeypatch):
    from tpumix_torch.utils.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_mixer_default_device_raises_without_cuda(monkeypatch):
    from tpumix_torch.config import preset
    from tpumix_torch.infer.mixer import SongMixer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SongMixer(torch.nn.Identity(), preset("scalar2s"))


def test_cli_device_flag_defaults_to_cuda():
    from tpumix_torch.cli import build_parser

    args = build_parser().parse_args(["mix", "--data", "x"])
    assert args.device == "cuda" and args.model == "scalar2s"
    assert args.transfer_dtype == "float32" and not args.device_mix
    train = build_parser().parse_args(["train", "--data", "x"])
    assert train.device == "cuda" and train.model == "scalar2s" and train.batch_size == 48
    serve = build_parser().parse_args(["serve"])
    assert serve.device == "cuda" and serve.model == "scalar2s" and serve.port == 8080
    evaluate = build_parser().parse_args(["evaluate", "--data", "x", "--mean-loudness", "m"])
    assert evaluate.device == "cuda" and not evaluate.device_meter


def test_training_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """``SyntheticTrainer``, ``DeviceCorpus``, ``train-synth`` and ``train
    --device-corpus`` take the card unless the CPU is asked for."""
    from tpumix_torch.cli import build_parser
    from tpumix_torch.config import FrontendConfig, TrainConfig
    from tpumix_torch.data.device_corpus import DeviceCorpus
    from tpumix_torch.train.trainer import SyntheticTrainer

    # "cuda" names the current card, the device its tensors report, so a
    # device batch compares equal to the trainer's device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    from tpumix_torch.utils.device import resolve_device

    assert resolve_device(None) == resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cuda:0") == torch.device("cuda", 0)
    synth = build_parser().parse_args(["train-synth"])
    assert synth.device == "cuda" and synth.model == "scalar2sL" and synth.loss == "gain"
    corpus = build_parser().parse_args(["train", "--data", "x", "--device-corpus"])
    assert corpus.device == "cuda" and corpus.device_corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SyntheticTrainer(torch.nn.Identity(), FrontendConfig(),
                         TrainConfig(checkpoint_dir=str(tmp_path)), chunk_samples=88200)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCorpus(str(tmp_path), ["song"], 88200)


def test_smoke_script_fails_outside_checkout(tmp_path):
    """``chip_smoke.py`` alone in a directory exits non-zero with no result
    line (here the CPU-only torch stops it first; on a card the missing
    package does)."""
    import shutil

    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
