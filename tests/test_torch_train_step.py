"""The port's train and eval steps against tpumix's, on the CPU at the small
size of tests/test_train.py (``n_fft=256, hop=128, sr=8000``, 0.75 s chunks,
``MixingModelScalar1s`` on ``(129, 47)``).

Same parameters (initialised by flax, carried across with
``state_dict_from_jax``), same batches (numpy, seeded), dropout and
augmentation off, because the two random streams cannot match.  After one and
after three steps the loss, the mean gain, the updated parameters and the
BatchNorm running statistics agree.

Tolerances.  Loss: 2e-4 relative on the first step (one forward from equal
parameters; the frontends differ by ~1e-5 dB) and 2e-2 on the later ones; mean
gain: 1e-5, then 5e-2, absolute (each head sums 10290 activations, so a per
cent of flipped ``+-lr`` weights moves a gain by a few 1e-2).  Parameters: an Adam update moves each parameter by about ``lr`` in the
direction of its gradient's sign, and at a flax init BatchNorm centres
activations on the ReLU kink, so a gradient near zero can take either sign in
the two frameworks (tests/test_train.py:185-189 says the same of tpumix
against itself); a conv bias in front of a BatchNorm has no gradient at all
but rounding noise, which Adam scales to a full ``+-lr`` step.  Hence, after
the first step: at least 99% of all parameters within 2e-5, and none further
apart than 2 ``lr``.  From the second step on Adam's update depends on the
gradients' sizes, and these now come from slightly different parameters, so
the two runs drift apart: after the third step at least 80% of all parameters
within 3e-4 (a tenth of the 3 ``lr`` each has travelled) and none further apart
than 6 ``lr``.  Running statistics: 1e-4 of their scale after the first step
(equal parameters went in); 1e-1 after the third, when the few flipped weights
of block 1 have met +-80 dB features and the difference has run through the
trunk (a wrong momentum or a skipped update would show at order 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.config import FrontendConfig as JaxFrontendConfig
from tpumix.config import preset as jax_preset
from tpumix.models.registry import build_model as jax_build_model
from tpumix.train import state as jax_state
from tpumix_torch.config import FrontendConfig, preset
from tpumix_torch.models.convert import state_dict_from_jax, state_dict_to_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.train import state as port_state

SR = 8000
CHUNK = 6000  # 0.75 s -> 47 frames at hop 128
FT = (129, 47)
KW = dict(n_fft=256, hop_length=128, sample_rate=SR)
LR, WD = 1e-3, 1e-5


def _batches(n_batches=2, bs=6, seed=0):
    """Seeded (stems [bs, 4, CHUNK], mix [bs, CHUNK]) pairs: tones over noise,
    the mix a fixed-gain sum (tests/test_train.py SynthChunks)."""
    rng = np.random.default_rng(seed)
    t = np.arange(CHUNK) / SR
    true_gains = np.array([0.9, 1.1, 0.8, 1.2], np.float32)
    out = []
    for _ in range(n_batches):
        freqs = rng.uniform(50, 3000, size=(bs, 4, 1))
        stems = (0.2 + 0.1 * rng.random((bs, 4, 1))) * np.sin(
            2 * np.pi * freqs * t + rng.uniform(0, 6.28, (bs, 4, 1)))
        stems = (stems + 0.01 * rng.standard_normal(stems.shape)).astype(np.float32)
        out.append((stems, (true_gains[:, None] * stems).sum(axis=1).astype(np.float32)))
    return out


@pytest.fixture(scope="module")
def data():
    return _batches()


@pytest.fixture
def one_torch_thread():
    """One intra-op thread for the test that asks for it: the suite runs
    several test processes side by side, and torch's default of a thread per
    core in each makes CPU ops wait on one another many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _pair(seed=0, name="scalar1s"):
    """A flax model with its initial variables and the port's model holding
    the same values, both in training mode without dropout."""
    jcfg = dataclasses.replace(jax_preset(name), use_dropout=False)
    jmodel = jax_build_model(jcfg, for_training=True)
    tx = jax_state.adam_with_l2(LR, WD)
    jst = jax_state.create_train_state(jmodel, jax.random.key(seed), (1, 4, *FT), tx)
    model = build_model(dataclasses.replace(preset(name), use_dropout=False),
                        in_shape=FT, for_training=True)
    variables = jax.tree.map(np.asarray, {"params": jst.params, "batch_stats": jst.batch_stats})
    model.load_state_dict(state_dict_from_jax(variables))
    return jmodel, tx, jst, port_state.create_train_state(model, LR, WD)


def _compare_states(jst, state, steps, within_after_three=0.80):
    ref = state_dict_from_jax(jax.tree.map(np.asarray, {"params": jst.params,
                                                        "batch_stats": jst.batch_stats}))
    got = state.model.state_dict()
    assert int(jst.step) == state.step == steps
    diffs = []
    for key, want in ref.items():
        if key.endswith("num_batches_tracked"):
            continue
        have = got[key]
        if "running_" in key:
            scale = max(float(want.abs().max()), 1.0)
            atol = (1e-4 if steps == 1 else 1e-1) * scale
            np.testing.assert_allclose(have.numpy(), want.numpy(), rtol=0, atol=atol, err_msg=key)
        else:
            diffs.append((have - want).abs().flatten())
    diffs = torch.cat(diffs)
    assert float(diffs.max()) <= 2.0 * LR * steps + 1e-6
    if steps == 1:
        assert float((diffs <= 2e-5).float().mean()) >= 0.99
    else:
        assert float((diffs <= 0.1 * LR * steps).float().mean()) >= within_after_three


LOSSES = list(port_state.SELF_SUPERVISED_LOSSES)


@pytest.mark.parametrize("loss", LOSSES)
def test_train_step_matches_tpumix_after_one_and_three_steps(data, loss):
    jmodel, tx, jst, state = _pair()
    jstep = jax.jit(jax_state.make_train_step(jmodel, JaxFrontendConfig(**KW), tx, loss=loss))
    step = port_state.make_train_step(state, FrontendConfig(**KW), loss=loss)
    for i, (stems, mix) in enumerate((data[0], data[1], data[0]), start=1):
        jst, jm = jstep(jst, jnp.asarray(stems), jnp.asarray(mix), jax.random.key(1))
        m = step(torch.from_numpy(stems), torch.from_numpy(mix))
        rtol = 2e-4 if i == 1 else 2e-2
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=rtol)
        # the mean gain is a small difference of O(1) gains: absolute, not relative
        np.testing.assert_allclose(float(m["mean_gain"]), float(jm["mean_gain"]), rtol=0,
                                   atol=1e-5 if i == 1 else 5e-2)
        if i in (1, 3):
            _compare_states(jst, state, steps=i)
    assert state.model.training


@pytest.mark.parametrize("loss", ["reference", "lstsq"])
def test_resnet18_train_step_matches_tpumix_after_one_and_three_steps(data, loss,
                                                                     one_torch_thread):
    """``GainResNet`` under the scalar test's setup.  After one step the
    scalar bounds hold, but for the mean gain, which gets
    tests/test_torch_resnet.py's bound on this model's gains from equal
    parameters, 1e-4 (thirteen residual blocks of float32 sums in another
    order: 1.3e-5 here at one thread).  Its later steps drift further, and the drift is the
    Adam sign drift, not a fault (tests/measure_port_parity.py, ``drift``):
    the JAX package run against itself from a start whose parameters are
    perturbed by 1e-5 relative (its first step then agrees with the
    unperturbed run as the port's does: 99.6-99.8% of parameters within
    2e-5, the port 99.9%) keeps only 61-71% of the parameters within 3e-4
    after three steps (two perturbation draws, both losses; 78-85% at 1e-6),
    its loss moves up to 4.0% and its mean gain up to 0.076.  The port sits
    inside that: 73.4% / 80.4%, 3.1% / 0.9%, 0.010 / 0.004 (``reference`` /
    ``lstsq``).  So from the second step on: 60% of the parameters within
    3e-4, the loss to 5e-2 relative and the mean gain to 0.1, the JAX
    package's own spread under that perturbation with its first digit kept."""
    jmodel, tx, jst, state = _pair(name="resnet18")
    jstep = jax.jit(jax_state.make_train_step(jmodel, JaxFrontendConfig(**KW), tx, loss=loss))
    step = port_state.make_train_step(state, FrontendConfig(**KW), loss=loss)
    for i, (stems, mix) in enumerate((data[0], data[1], data[0]), start=1):
        jst, jm = jstep(jst, jnp.asarray(stems), jnp.asarray(mix), jax.random.key(1))
        m = step(torch.from_numpy(stems), torch.from_numpy(mix))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=2e-4 if i == 1 else 5e-2)
        np.testing.assert_allclose(float(m["mean_gain"]), float(jm["mean_gain"]), rtol=0,
                                   atol=1e-4 if i == 1 else 0.1)
        if i in (1, 3):
            _compare_states(jst, state, steps=i, within_after_three=0.60)


def test_gain_step_matches_tpumix(data):
    jmodel, tx, jst, state = _pair()
    fe, jfe = FrontendConfig(**KW), JaxFrontendConfig(**KW)
    jstep = jax.jit(jax_state.make_gain_train_step(jmodel, jfe, tx, mesh=None, dp_axis=None))
    step = port_state.make_gain_train_step(state, fe)
    g_true = np.random.default_rng(2).uniform(-0.4, 0.4, (6, 4)).astype(np.float32)
    for i, (stems, _) in enumerate((data[0], data[1], data[0]), start=1):
        jst, jm = jstep(jst, jnp.asarray(stems), jnp.asarray(g_true), jax.random.key(1))
        m = step(torch.from_numpy(stems), torch.from_numpy(g_true))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-4 if i == 1 else 2e-2)
        np.testing.assert_allclose(float(m["gain_rmse_db"]), 10.0 * np.sqrt(float(m["loss"])),
                                   rtol=1e-5)
    _compare_states(jst, state, steps=3)
    jloss = jax.jit(jax_state.make_gain_eval_step(jmodel, jfe))(
        jst, jnp.asarray(data[1][0]), jnp.asarray(g_true))
    loss = port_state.make_gain_eval_step(state, fe)(torch.from_numpy(data[1][0]),
                                                     torch.from_numpy(g_true))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-2)


def test_feature_step_matches_tpumix(data):
    from tpumix.ops.stft import spectrogram_features as jax_features

    jmodel, tx, jst, state = _pair()
    jstep = jax.jit(jax_state.make_feature_train_step(jmodel, tx))
    step = port_state.make_feature_train_step(state)
    for i, (stems, mix) in enumerate((data[0], data[1], data[0]), start=1):
        feats = np.asarray(jax_features(jnp.asarray(stems), JaxFrontendConfig(**KW)))
        gt = np.asarray(jax_features(jnp.asarray(mix), JaxFrontendConfig(**KW)))
        jst, jm = jstep(jst, jnp.asarray(feats), jnp.asarray(gt), jax.random.key(1))
        m = step(torch.from_numpy(feats.copy()), torch.from_numpy(gt.copy()))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=2e-4 if i == 1 else 2e-2)
    _compare_states(jst, state, steps=3)


@pytest.mark.parametrize("loss", ["reference", "coherent", "lstsq_tail_cm"])
def test_eval_step_matches_tpumix_and_mutates_nothing(data, loss):
    jmodel, _, jst, state = _pair(seed=3)
    stems, mix = data[1]
    jloss = jax.jit(jax_state.make_eval_step(jmodel, JaxFrontendConfig(**KW), loss=loss))(
        jst, jnp.asarray(stems), jnp.asarray(mix))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    ev = port_state.make_eval_step(state, FrontendConfig(**KW), loss=loss)
    l1 = ev(torch.from_numpy(stems), torch.from_numpy(mix))
    l2 = ev(torch.from_numpy(stems), torch.from_numpy(mix))
    assert float(l1) == float(l2) and np.isfinite(float(l1)) and not l1.requires_grad
    np.testing.assert_allclose(float(l1), float(jloss), rtol=2e-4)
    assert state.step == 0 and not state.optimizer.state
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_quantised_wire_batches(data):
    """int16 batches on the PCM16 grid give the float32 loss exactly (the
    decode is the mixer's); mulaw8 batches decode as tpumix's do."""
    from tpumix.infer.mixer import _mulaw_lut as jax_mulaw_lut
    from tpumix_torch.infer.mixer import _mulaw_lut

    jmodel, _, jst, state = _pair()
    stems, mix = data[0]
    q = lambda a: np.clip(np.rint(a * 32768.0), -32768, 32767)  # noqa: E731
    ev = port_state.make_eval_step(state, FrontendConfig(**KW))
    on_grid = ev(torch.from_numpy((q(stems) / 32768.0).astype(np.float32)),
                 torch.from_numpy((q(mix) / 32768.0).astype(np.float32)))
    as_int16 = ev(torch.from_numpy(q(stems).astype(np.int16)),
                  torch.from_numpy(q(mix).astype(np.int16)))
    np.testing.assert_allclose(float(as_int16), float(on_grid), rtol=1e-6)

    np.testing.assert_array_equal(_mulaw_lut(), jax_mulaw_lut())
    lut = _mulaw_lut()
    mu = [lut[q(a).astype(np.int32) + 32768] for a in (stems, mix)]
    jev = jax.jit(jax_state.make_eval_step(jmodel, JaxFrontendConfig(**KW)))
    np.testing.assert_allclose(float(ev(torch.from_numpy(mu[0]), torch.from_numpy(mu[1]))),
                               float(jev(jst, jnp.asarray(mu[0]), jnp.asarray(mu[1]))), rtol=2e-4)
    # a train step takes the quantised batch too
    m = port_state.make_train_step(state, FrontendConfig(**KW))(
        torch.from_numpy(q(stems).astype(np.int16)), torch.from_numpy(q(mix).astype(np.int16)))
    assert np.isfinite(float(m["loss"])) and state.step == 1


@pytest.mark.parametrize("impl,hop", [("pallas", 128), ("ct_pallas", 32)])
def test_train_step_with_each_fused_frontend(impl, hop):
    """The step's loss with the naive-basis and the DIT frontend equals the
    ``"fft"`` frontend's to frontend-conformance noise (tests/test_train.py:
    290-293: 1e-3 relative), and tpumix's with the same frontend."""
    kw = dict(n_fft=256, hop_length=hop, sample_rate=SR)
    frames = 1 + CHUNK // hop
    stems, mix = _batches(1, bs=3, seed=4)[0]
    jcfg = dataclasses.replace(jax_preset("scalar1s"), use_dropout=False)
    jmodel = jax_build_model(jcfg, for_training=True)
    tx = jax_state.adam_with_l2(LR, WD)
    jst = jax_state.create_train_state(jmodel, jax.random.key(0), (1, 4, 129, frames), tx)
    variables = jax.tree.map(np.asarray, {"params": jst.params, "batch_stats": jst.batch_stats})
    losses = {}
    for name in (impl, "fft"):
        model = build_model(dataclasses.replace(preset("scalar1s"), use_dropout=False),
                            in_shape=(129, frames), for_training=True)
        model.load_state_dict(state_dict_from_jax(variables))
        state = port_state.create_train_state(model, LR, WD)
        step = port_state.make_train_step(state, FrontendConfig(**kw, implementation=name))
        losses[name] = float(step(torch.from_numpy(stems), torch.from_numpy(mix))["loss"])
    assert abs(losses[impl] - losses["fft"]) / losses["fft"] < 1e-3
    jstep = jax.jit(jax_state.make_train_step(
        jmodel, JaxFrontendConfig(**kw, implementation=impl), tx))
    _, jm = jstep(jst, jnp.asarray(stems), jnp.asarray(mix), jax.random.key(1))
    np.testing.assert_allclose(losses[impl], float(jm["loss"]), rtol=2e-4)


def test_exported_tree_round_trips(data):
    """``state_dict_to_jax`` is the inverse of ``state_dict_from_jax``: after
    a step, flax ``apply`` on the exported tree gives the port's gains."""
    jmodel, _, _, state = _pair()
    stems, mix = data[0]
    port_state.make_train_step(state, FrontendConfig(**KW))(torch.from_numpy(stems),
                                                            torch.from_numpy(mix))
    variables = state_dict_to_jax(state.model.state_dict())
    feats = (20.0 * np.random.default_rng(1).standard_normal((2, 4, *FT)) - 40.0).astype(np.float32)
    _, jgains = jmodel.apply(variables, feats, train=False)
    state.model.eval()
    with torch.no_grad():
        gains = state.model.gains(torch.from_numpy(feats))
    np.testing.assert_allclose(gains.numpy(), np.asarray(jgains), atol=1e-4)
