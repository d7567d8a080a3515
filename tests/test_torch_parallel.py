"""The port's parallelism (``tpumix_torch/parallel``, the ``mesh`` arguments of
the train steps, ``Trainer``, ``SyntheticTrainer`` and ``SongMixer``, and
``train --mesh``) on the CPU, at the small size of tests/test_train.py
(``n_fft=256, hop=128, sr=8000``, 0.75 s chunks, ``MixingModelScalar1s`` on
``(129, 47)``).

Two gloo ranks (``tests/torch_parallel_ranks.py``, one launch for every
in-process path, met through a file under ``tmp_path``, one torch thread
each, joined with a timeout) against one process on the same global batches,
from one initialisation, which the JAX package's mesh step also starts from.

Tolerances, as tests/test_train.py:144-159, tests/test_infer.py:171 and
tests/test_infer_device.py:155 hold tpumix's sharded paths:
* loss: 1e-4 relative (float32 reductions in another order: the per-rank
  sums, then the sum over ranks); the JAX mesh step against the port's two
  ranks: 2e-4, tests/test_torch_train_step.py's bound between the packages;
* eval losses and the validation pass from equal parameters: 1e-5 relative;
* after one Adam step: >= 99% of parameters within 2e-5 and none further than
  2 ``lr`` (a gradient of rounding noise, a conv bias in front of a
  BatchNorm, may take either sign; tests/test_torch_train_step.py), BN
  running statistics within 1e-4 of their scale, flax's biased variance;
* the chunk-sharded mixer: gains within 1e-4, the device mix within rtol
  1e-4 / atol 1e-5.

The frame-sharded step (``sp_axis``, tpumix_torch/parallel/frames.py): a
``(1, 2)`` ``dp x sp`` mesh in the two-rank launch and a ``(2, 2)`` mesh in
one launch of four ranks, at 0.8 s chunks (51 frames, three conv5 frames),
every objective of the step, two steps against one process on the same
global batches.  Step 1: loss 1e-5 relative, mean gain 1e-5 absolute, BN
running statistics 1e-5 of their scale (one order of float32 sums against
another; measured 1e-6 / 7e-7 / 4.2e-6), the parameters as above; step 2
after Adam's first update: the loss within 2e-2 relative (chip_smoke.py
[dp]'s drift bound; measured at most 1.7e-4).  The ``(1, 2)`` step's loss
against the JAX step with ``sp_axis="sp"`` on a ``(1, 2)`` CPU mesh: 2e-4.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.config import FrontendConfig as JaxFrontendConfig
from tpumix.config import preset as jax_preset
from tpumix.models.registry import build_model as jax_build_model
from tpumix.parallel.distributed import shard_range as jax_shard_range
from tpumix.train import state as jax_state
from tpumix_torch.config import preset
from tpumix_torch.models.convert import state_dict_to_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.parallel import distributed, mesh as port_mesh

import torch_parallel_ranks as ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANKS = 2
SP_RANKS = 4  # the (2, 2) dp x sp mesh
TIMEOUT_S = 240


def _launch(argv_of_rank, tmp, timeout=TIMEOUT_S, ranks_=RANKS):
    """Start one process per rank and wait for all, killing every one that
    outlives ``timeout``: a hung rank fails the test."""
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.path.join(ROOT, "tests"))
    procs = [subprocess.Popen(argv_of_rank(r), cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(ranks_)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
    return outs


@pytest.fixture(scope="module")
def init_state():
    """One initialisation of tests/test_train.py's scalar1s (dropout off, BN
    retained fraction 0.99): the port's state dict, and the JAX model with a
    train state holding the same values."""
    model = build_model(dataclasses.replace(preset("scalar1s"), use_dropout=False,
                                            bn_momentum=0.99),
                        in_shape=ranks.FT, for_training=True,
                        generator=torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    jcfg = dataclasses.replace(jax_preset("scalar1s"), use_dropout=False, bn_momentum=0.99)
    jmodel = jax_build_model(jcfg, for_training=True)
    tx = jax_state.adam_with_l2(ranks.LR, ranks.WD)
    variables = jax.tree.map(jnp.asarray, state_dict_to_jax(init))
    jst = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]))
    return init, jmodel, tx, jst


@pytest.fixture(scope="module")
def init_sp():
    """The frame-sharded step's initialisation: scalar1s on ``SP_FT``."""
    model = build_model(dataclasses.replace(preset("scalar1s"), use_dropout=False,
                                            bn_momentum=0.99),
                        in_shape=ranks.SP_FT, for_training=True,
                        generator=torch.Generator().manual_seed(1))
    return {k: v.clone() for k, v in model.state_dict().items()}


def _one_thread(fn, *args):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn(*args)
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def sp_solo(init_sp):
    """The frame-sharded paths' one-process references."""
    return _one_thread(ranks.sp_step_results, None, init_sp)


@pytest.fixture(scope="module")
def sp22(init_sp, tmp_path_factory):
    """Four gloo ranks on a ``(2, 2)`` ``dp x sp`` mesh: their results."""
    tmp = tmp_path_factory.mktemp("sp")
    torch.save(init_sp, tmp / "init_sp.pt")
    rdv = "file://" + str(tmp / "rendezvous")
    _launch(lambda r: [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_ranks.py"),
                       str(r), str(SP_RANKS), rdv, str(tmp), "sp"], tmp, ranks_=SP_RANKS)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(SP_RANKS)]


@pytest.fixture(scope="module")
def results(init_state, init_sp, tmp_path_factory):
    """``(rank results, one-process results)``: one launch of two gloo ranks
    for every in-process path, and the same calls here with no mesh."""
    tmp = tmp_path_factory.mktemp("dp")
    init = init_state[0]
    torch.save(init, tmp / "init.pt")
    torch.save(init_sp, tmp / "init_sp.pt")
    rdv = "file://" + str(tmp / "rendezvous")
    _launch(lambda r: [sys.executable, os.path.join(ROOT, "tests", "torch_parallel_ranks.py"),
                       str(r), str(RANKS), rdv, str(tmp)], tmp)
    got = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(RANKS)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        data = ranks.batches()
        solo = {"steps": ranks.step_results(None, data, init),
                "trainer": ranks.trainer_results(None, data, init, str(tmp / "solo")),
                "mixer": ranks.mixer_results(None)}
    finally:
        torch.set_num_threads(threads)
    return got, solo


def _compare_after_one_step(got, want):
    diffs = []
    for key, ref in want.items():
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == int(ref) == 1, key
            continue
        if "running_" in key:
            scale = max(float(ref.abs().max()), 1.0)
            np.testing.assert_allclose(got[key].numpy(), ref.numpy(), rtol=0, atol=1e-4 * scale,
                                       err_msg=key)
        else:
            diffs.append((got[key] - ref).abs().flatten())
    diffs = torch.cat(diffs)
    assert float(diffs.max()) <= 2.0 * ranks.LR + 1e-6
    assert float((diffs <= 2e-5).float().mean()) >= 0.99


@pytest.mark.parametrize("n,count", [(10, 3), (8, 2), (2, 4), (0, 3), (7, 1)])
def test_shard_range_is_the_jax_packages(n, count):
    spans = [distributed.shard_range(n, i, count) for i in range(count)]
    assert spans == [jax_shard_range(n, i, count) for i in range(count)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    with pytest.raises(ValueError):
        distributed.shard_range(n, count, count)


def test_initialize_without_a_group_is_a_one_process_noop(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.initialize() is False
    assert distributed.initialize() is False  # safe twice
    assert distributed.process_count() == 1 and distributed.process_index() == 0
    assert distributed.shard_range(5) == (0, 5)
    one = port_mesh.make_mesh()
    assert dict(one.shape) == {"dp": 1} and one.axis_names == ("dp",)
    x = np.arange(12).reshape(6, 2)
    assert np.array_equal(port_mesh.shard_batch((x,), one)[0].numpy(), x)
    with pytest.raises(ValueError, match="needs 2 processes"):
        port_mesh.make_mesh((2,))
    with pytest.raises(ValueError, match="needs world_size and rank"):
        distributed.initialize("file:///nowhere")
    batch = distributed.global_batch({"stems": x}, device="cpu")
    assert batch["stems"].device.type == "cpu"


def test_backend_is_chosen_by_device_or_by_name():
    assert distributed.resolve_backend(None, "cpu") == "gloo"
    assert distributed.resolve_backend(None, "cuda:0") == "nccl"
    assert distributed.resolve_backend("gloo", "cuda:0") == "gloo"  # two ranks on one card
    with pytest.raises(ValueError, match="needs a CUDA device"):
        distributed.resolve_backend("nccl", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        distributed.resolve_backend("mpi", "cpu")


def test_rank_rows_and_global_augmentation_draws():
    """A rank's rows are its contiguous block of the global batch, and its
    augmentation gains are those rows of the global batch's draws."""
    from tpumix_torch.ops.gain import augment_audio

    axis = port_mesh.MeshAxis("dp", 2, 1)
    assert axis.rows(8) == slice(4, 8)
    with pytest.raises(ValueError, match="does not split"):
        axis.rows(7)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 4, 16)).astype(np.float32))
    whole = augment_audio(x, torch.Generator().manual_seed(3))
    mine = augment_audio(x[4:], torch.Generator().manual_seed(3), axis=axis)
    assert torch.equal(whole[4:], mine)


def test_sp_axis_builds_only_on_a_mesh_with_a_frame_sharded_trunk(init_state):
    """``sp_axis`` wants a mesh that has the axis and a scalar trunk; the
    shard of the full ``scalar2s`` input is the recompute the design
    accepts (two ranks: 111 and 109 of 173 feature frames)."""
    from tpumix_torch.models.resnet import GainResNet
    from tpumix_torch.train.state import create_train_state, make_train_step

    state = create_train_state(ranks.model(init_state[0]), ranks.LR, ranks.WD)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_train_step(state, ranks.frontend(), sp_axis="sp")
    with pytest.raises(ValueError, match="no axis 'sp'"):
        make_train_step(state, ranks.frontend(), mesh=port_mesh.make_mesh(), sp_axis="sp")
    resnet = create_train_state(GainResNet(in_shape=(129, 47)), ranks.LR, ranks.WD)
    with pytest.raises(ValueError, match="no frame-sharded trunk"):
        make_train_step(resnet, ranks.frontend(), mesh=port_mesh.make_mesh(), sp_axis="dp")
    model = build_model(preset("scalar2s"))
    spans = [model.frame_shard(173, port_mesh.MeshAxis("sp", 2, r)).features for r in range(2)]
    assert spans == [(0, 111), (64, 173)]
    assert [model.frame_shard(173, port_mesh.MeshAxis("sp", 1, 0)).features] == [(0, 173)]
    with pytest.raises(ValueError, match="fewer than"):
        build_model(preset("scalar1s")).frame_shard(47, port_mesh.MeshAxis("sp", 2, 0))


@pytest.mark.parametrize("size", [2, 3, 5])
@pytest.mark.parametrize("name,frames", [("scalar1s", 87), ("scalar2s", 173), ("scalar2s", 60)])
def test_frame_shards_partition_every_layer(name, frames, size):
    """At every layer the ranks' owned frames partition the layer, each
    inside what the rank computes, and a VALID convolution of the computed
    frames gives exactly the next layer's computed frames."""
    model = build_model(preset(name))
    layers = [(3, 2, model.block1_dilation)] + [(k, 1, 1) for k in (5, 5, 7, 9)]
    shards = [model.frame_shard(frames, port_mesh.MeshAxis("sp", size, r)) for r in range(size)]
    for i in range(6):
        ranges = [sh.ranges[i] for sh in shards]
        width = ranges[0][3]
        assert ranges[0][0] == 0 and ranges[-1][2] == width
        for (lo, hi, own, _), nxt in zip(ranges, ranges[1:] + [None]):
            assert lo < own <= hi <= width
            if nxt is not None:
                assert own == nxt[0]
    for sh in shards:
        for (k, s, d), (lo, hi, _, _), (lo2, hi2, _, _) in zip(layers, sh.ranges, sh.ranges[1:]):
            assert lo2 * s == lo and (hi - lo - d * (k - 1) - 1) // s + 1 == hi2 - lo2


def test_device_corpus_ranks_gather_their_rows_of_each_global_batch(tmp_path):
    from tpumix_torch.data import wavio
    from tpumix_torch.data.device_corpus import DeviceCorpus, DeviceCorpusIterator

    rng = np.random.default_rng(1)
    for song in ("A", "B"):
        d = tmp_path / song
        d.mkdir()
        for t in ("bass", "drums", "vocals", "other", "mixture"):
            wavio.write(str(d / f"{t}.wav"), 0.1 * rng.standard_normal(1000).astype(np.float32),
                        44100, subtype="PCM_16")
    corpus = DeviceCorpus(str(tmp_path), ["A", "B"], 90, layout="musdb18", device="cpu")
    whole = list(DeviceCorpusIterator(corpus, 4, seed=2))
    parts = [list(DeviceCorpusIterator(corpus, 2, seed=2, num_shards=2, shard_index=r))
             for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 22 // 4
    for k, (stems, mix) in enumerate(whole):
        assert torch.equal(stems, torch.cat([parts[0][k][0], parts[1][k][0]]))
        assert torch.equal(mix, torch.cat([parts[0][k][1], parts[1][k][1]]))
    with pytest.raises(ValueError):
        DeviceCorpusIterator(corpus, 2, num_shards=2, shard_index=2)


def test_ranks_hold_the_same_results(results):
    got, _ = results
    a, b = got
    assert a["mesh"] == {"shape": {"dp": RANKS}, "axis_names": ("dp",)} == b["mesh"]
    for loss in a["steps"]:
        assert a["steps"][loss]["loss"] == b["steps"][loss]["loss"]
        assert a["steps"][loss]["eval"] == b["steps"][loss]["eval"]
        for key, t in a["steps"][loss]["state"].items():
            assert torch.equal(t, b["steps"][loss]["state"][key]), key
    assert a["trainer"]["val"] == b["trainer"]["val"]
    np.testing.assert_array_equal(a["mixer"]["gains"], b["mixer"]["gains"])
    np.testing.assert_array_equal(a["mixer"]["mixed"], b["mixer"]["mixed"])


@pytest.mark.parametrize("loss", [name for name, _ in ranks.LOSSES])
def test_dp_step_equals_one_process_step(results, loss):
    """``reference``; ``coherent`` with augmentation (the global batch's
    draws and mix power); ``lstsq_tail_cm`` (the global common mode)."""
    got, solo = results
    have, want = got[0]["steps"][loss], solo["steps"][loss]
    np.testing.assert_allclose(have["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(have["mean_gain"], want["mean_gain"], rtol=0, atol=1e-5)
    _compare_after_one_step(have["state"], want["state"])


@pytest.mark.parametrize("loss", [name for name, _ in ranks.LOSSES])
def test_dp_eval_step_equals_one_process_step(results, loss):
    got, solo = results
    np.testing.assert_allclose(got[0]["steps"][loss]["eval"], solo["steps"][loss]["eval"],
                               rtol=1e-5)


def test_dp_step_matches_the_jax_mesh_step(results, init_state):
    """The port's two-rank ``reference`` step against tpumix's
    ``data_parallel_jit`` step on its 8-device CPU mesh, same parameters and
    global batch (tests/test_train.py:159)."""
    from tpumix.parallel.mesh import data_parallel_jit, make_mesh, shard_batch

    _, jmodel, tx, jst = init_state
    frontend = JaxFrontendConfig(n_fft=256, hop_length=128, sample_rate=ranks.SR)
    stems, mix = ranks.batches()[0]
    mesh = make_mesh((8,), ("dp",))
    step = data_parallel_jit(jax_state.make_train_step(jmodel, frontend, tx), mesh,
                             donate_state=False)
    _, metrics = step(jst, *shard_batch((stems, mix), mesh), jax.random.key(3))
    got, _ = results
    np.testing.assert_allclose(got[0]["steps"]["reference"]["loss"], float(metrics["loss"]),
                               rtol=2e-4)


def _sp_cases():
    return [(m, loss) for m in ("1x2", "2x2") for loss, _ in ranks.SP_LOSSES]


@pytest.mark.parametrize("mesh,loss", _sp_cases())
def test_sp_step_equals_one_process_step(results, sp22, sp_solo, mesh, loss):
    """The frame-sharded step on a ``dp x sp`` mesh against one process on
    the global batch, every objective: step 1 to float32 reordering, step 2
    within the drift of Adam's first update."""
    got = (results[0] if mesh == "1x2" else sp22)
    for rank in got[1:]:  # every rank reports the same metrics
        assert rank["sp"][loss]["loss"] == got[0]["sp"][loss]["loss"]
    have, want = got[0]["sp"][loss], sp_solo[loss]
    np.testing.assert_allclose(have["loss"][0], want["loss"][0], rtol=1e-5)
    np.testing.assert_allclose(have["mean_gain"][0], want["mean_gain"][0], rtol=0, atol=1e-5)
    for key, ref in want["state"].items():
        if "running_" in key:
            scale = max(float(ref.abs().max()), 1.0)
            np.testing.assert_allclose(have["state"][key].numpy(), ref.numpy(), rtol=0,
                                       atol=1e-5 * scale, err_msg=key)
    _compare_after_one_step(have["state"], want["state"])
    np.testing.assert_allclose(have["loss"][1], want["loss"][1], rtol=2e-2)


def test_sp_ranks_compute_overlapping_feature_frames(results, sp22):
    """Each ``sp`` rank computes the feature frames its conv5 columns need:
    on 51 frames of scalar1s, 49 of them on each rank."""
    assert [r["sp"]["features"] for r in results[0]] == [(0, 49), (4, 51)]
    assert [r["sp"]["features"] for r in sp22] == [(0, 49), (4, 51)] * 2


def test_sp_step_matches_the_jax_sp_step(results, init_sp):
    """The port's ``(1, 2)`` ``reference`` step against tpumix's step built
    with ``sp_axis="sp"`` on a ``(1, 2)`` CPU mesh (features annotated
    ``P(dp, None, None, sp)``), same parameters and global batch."""
    from tpumix.parallel.mesh import data_parallel_jit, make_mesh, shard_batch

    jcfg = dataclasses.replace(jax_preset("scalar1s"), use_dropout=False, bn_momentum=0.99)
    jmodel = jax_build_model(jcfg, for_training=True)
    tx = jax_state.adam_with_l2(ranks.LR, ranks.WD)
    variables = jax.tree.map(jnp.asarray, state_dict_to_jax(init_sp))
    jst = jax_state.TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                               batch_stats=variables["batch_stats"],
                               opt_state=tx.init(variables["params"]))
    frontend = JaxFrontendConfig(n_fft=256, hop_length=128, sample_rate=ranks.SR)
    stems, mix = ranks.batches(n_batches=1, chunk=ranks.SP_CHUNK, seed=1)[0]
    mesh = make_mesh((1, 2), ("dp", "sp"))
    step = data_parallel_jit(jax_state.make_train_step(jmodel, frontend, tx, mesh=mesh,
                                                       dp_axis="dp", sp_axis="sp"),
                             mesh, donate_state=False)
    _, metrics = step(jst, *shard_batch((stems, mix), mesh), jax.random.key(3))
    np.testing.assert_allclose(results[0][0]["sp"]["reference"]["loss"][0],
                               float(metrics["loss"]), rtol=2e-4)


def test_trainer_validation_pass_is_the_global_mean(results):
    got, solo = results
    np.testing.assert_allclose(got[0]["trainer"]["val"], solo["trainer"]["val"], rtol=1e-5)


def test_synthetic_trainer_gain_epoch_equals_one_process(results):
    """Each rank renders its rows of the global batch's draws: one ``gain``
    step and its validation batch as one process computes them."""
    got, solo = results
    have, want = got[0]["trainer"], solo["trainer"]
    np.testing.assert_allclose(have["gain_train"], want["gain_train"], rtol=1e-4)
    _compare_after_one_step(have["gain_state"], want["gain_state"])
    # validation runs after the update, in eval mode: a parameter at +-lr
    # from its one-process value moves the loss by a few 1e-5 relative
    np.testing.assert_allclose(have["gain_val"], want["gain_val"], rtol=1e-3)


def test_chunk_sharded_song_gains_match_the_plain_mixer(results):
    got, solo = results
    assert got[0]["mixer"]["gains"].shape == solo["mixer"]["gains"].shape == (8, 4)
    np.testing.assert_allclose(got[0]["mixer"]["gains"], solo["mixer"]["gains"], atol=1e-4)


def test_chunk_sharded_device_mix_matches_the_plain_mixer(results):
    got, solo = results
    np.testing.assert_allclose(got[0]["mixer"]["smooth"], solo["mixer"]["smooth"],
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got[0]["mixer"]["mixed"], solo["mixer"]["mixed"],
                               rtol=1e-4, atol=1e-5)


def test_sharded_segment_rounds_up_to_the_chunk_axis():
    """``_segment_len`` rounds up to a multiple of the axis
    (tpumix/infer/mixer.py:316-320)."""
    from tpumix_torch.config import MixConfig

    class Three:
        def axis(self, name):
            return port_mesh.MeshAxis(name, 3, 0)

    m = ranks.mixer()
    assert m._segment_len() == 4
    m = type(m)(m.model, m.model_cfg, MixConfig(chunk_length_s=1.0, max_chunks=4),
                device="cpu", mesh=Three(), chunk_axis="sp")
    assert m._segment_len() == 6


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """MedleyDB layout, PCM16, three 2 s songs of noise stems."""
    from tpumix_torch.data import wavio

    root = tmp_path_factory.mktemp("mesh_corpus")
    rng = np.random.default_rng(0)
    gains = dict(bass=0.9, drums=1.1, vocals=0.8, other=1.2)
    for song in ("SongA", "SongB", "SongC"):
        d = root / song / f"{song}_STEMS_JOINED"
        d.mkdir(parents=True)
        stems = {s: (0.1 * rng.standard_normal(2 * 44100)).astype(np.float32) for s in gains}
        for s, x in stems.items():
            wavio.write(str(d / f"{song}_STEM_{s.upper()}.wav"), x, 44100, subtype="PCM_16")
        wavio.write(str(root / song / f"{song}_MIX.wav"),
                    sum(gains[s] * x for s, x in stems.items()), 44100, subtype="PCM_16")
    return str(root)


def test_train_cli_mesh_2_on_the_cpu(corpus, tmp_path):
    """``train --mesh 2 --device cpu`` starts two gloo ranks itself; rank 0
    alone prints and writes (one epoch line, one ledger row, one checkpoint)."""
    ckpt = str(tmp_path / "ckpt")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    res = subprocess.run(
        [sys.executable, "-m", "tpumix_torch", "train", "--data", corpus, "--model", "scalar1s",
         "--batch-size", "2", "--device", "cpu", "--checkpoint-dir", ckpt, "--run-name", "m",
         "--val-fraction", "0.34", "--epochs", "1", "--bn-momentum", "0.99", "--mesh", "2"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stdout + res.stderr
    epochs = [line for line in res.stdout.splitlines() if line.startswith("Epoch ")]
    assert len(epochs) == 1 and "2 train steps" in epochs[0], res.stdout
    import json

    result = json.loads(res.stdout.strip().splitlines()[-1])
    assert np.isfinite(result["best_val_loss"])
    run = os.path.join(ckpt, "m")
    with open(os.path.join(run, "metrics.csv")) as f:
        assert len(f.read().strip().splitlines()) == 2
    assert sorted(d for d in os.listdir(run) if d.startswith("epoch_")) == ["epoch_0000"]


def test_mesh_on_cuda_needs_a_card_per_rank(monkeypatch, capsys):
    from tpumix_torch import cli

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for command in (["train", "--data", "x"], ["train-synth"]):
        with pytest.raises(SystemExit, match="needs 2 cards"):
            cli.main([*command, "--mesh", "2", "--batch-size", "4"])
    with pytest.raises(SystemExit, match="does not split"):
        cli.main(["train-synth", "--mesh", "2", "--batch-size", "5", "--device", "cpu"])
