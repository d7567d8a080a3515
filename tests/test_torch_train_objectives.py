"""Pieces of the port's train step against tpumix's, on seeded numpy inputs:
the closed-form lstsq targets and their guards, the objectives' values,
``adam_with_l2`` and the cosine schedule against optax, the BatchNorm
running-variance convention, the gain ops, and — statistically, because the
random streams cannot match — augmentation and dropout.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpumix.models.blocks import ConvBlock2d as JaxConvBlock2d
from tpumix.ops import gain as jax_gain
from tpumix.train import state as jax_state
from tpumix_torch.config import FrontendConfig, TrainConfig
from tpumix_torch.models.blocks import BatchNorm2d, ConvBlock2d
from tpumix_torch.ops import gain as port_gain
from tpumix_torch.train import state as port_state


def _mix_case(seed=0, B=3, T=4000, noise=0.05):
    rng = np.random.default_rng(seed)
    stems = (0.2 * rng.standard_normal((B, 4, T))).astype(np.float32)
    amp = rng.uniform(0.5, 2.0, (B, 4)).astype(np.float32)
    mix = np.einsum("bst,bs->bt", stems, amp) + noise * rng.standard_normal((B, T))
    return stems, mix.astype(np.float32), amp


# --- closed-form targets -----------------------------------------------------


def test_lstsq_targets_match_tpumix():
    """A float32 4x4 solve with relative jitter 1e-6 on a well-conditioned
    Gram (independent noise stems): the two LAPACK paths agree to 1e-4 in
    the scalar-gain domain."""
    stems, mix, amp = _mix_case()
    ref = np.asarray(jax_state._lstsq_gain_targets(jnp.asarray(stems), jnp.asarray(mix)))
    got = port_state._lstsq_gain_targets(torch.from_numpy(stems), torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4)
    np.testing.assert_allclose(got, 2.0 * np.log10(amp), atol=2e-2)  # and they are the gains


def test_lstsq_targets_finite_for_silent_stems():
    """An all-silent batch item must not poison the targets: it clamps to the
    quiet floor 2*log10(1e-3) = -6 and leaves its neighbours alone
    (tests/test_train.py:835-854)."""
    stems, mix, _ = _mix_case(seed=7, noise=0.0)
    stems[1] = 0.0
    mix[1] = 0.0
    got = port_state._lstsq_gain_targets(torch.from_numpy(stems), torch.from_numpy(mix)).numpy()
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[1], -6.0, atol=1e-5)
    alone = port_state._lstsq_gain_targets(torch.from_numpy(stems[::2]),
                                           torch.from_numpy(mix[::2])).numpy()
    np.testing.assert_allclose(got[::2], alone, rtol=1e-5, atol=1e-5)
    tail = port_state._lstsq_tail_gain_targets(torch.from_numpy(stems), torch.from_numpy(mix))
    assert bool(torch.isfinite(tail).all())


def _comb_mix(seed=3, B=3, T=6000, d=300, taps=(0.5, 0.3, 0.15)):
    """A gain-weighted sum plus a comb tail of it at spacing ``d``."""
    stems, mix, amp = _mix_case(seed=seed, B=B, T=T, noise=0.0)
    dry = mix.copy()
    for k, a in enumerate(taps, start=1):
        mix[:, k * d:] += a * dry[:, : T - k * d]
    return stems, mix, amp


def test_lstsq_tail_targets_match_tpumix_and_absorb_the_tail():
    """On a mix with an unambiguous comb tail both packages pick the same tap
    spacing (the xcorr peak is far from a tie), so the 12x12 solves agree to
    1e-3; the tail-aware targets sit closer to the true gains than plain
    lstsq's."""
    stems, mix, amp = _comb_mix()
    ref = np.asarray(jax_state._lstsq_tail_gain_targets(jnp.asarray(stems), jnp.asarray(mix)))
    got = port_state._lstsq_tail_gain_targets(torch.from_numpy(stems),
                                              torch.from_numpy(mix)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-3)
    plain = port_state._lstsq_gain_targets(torch.from_numpy(stems), torch.from_numpy(mix)).numpy()
    true = 2.0 * np.log10(amp)
    assert np.abs(got - true).mean() < np.abs(plain - true).mean()


def test_lstsq_tail_without_a_positive_peak_is_plain_lstsq():
    """No positive xcorr peak in [dmin, dmax) means no comb evidence: such
    items fall back to the plain targets (tests/test_train.py, state.py
    :352-359).  A negated comb tail makes every probed lag non-positive."""
    stems, mix, _ = _comb_mix(taps=(-0.5,), d=80)
    st, mx = torch.from_numpy(stems), torch.from_numpy(mix)
    plain = port_state._lstsq_gain_targets(st, mx)
    # probe only the lag where the residual's correlation with the sum is negative
    got = port_state._lstsq_tail_gain_targets(st, mx, dmin=80, dmax=81)
    torch.testing.assert_close(got, plain, rtol=0, atol=0)
    ref = np.asarray(jax_state._lstsq_tail_gain_targets(jnp.asarray(stems), jnp.asarray(mix),
                                                        dmin=80, dmax=81))
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-4)


@pytest.mark.parametrize("name,kwargs", [
    ("coherent", {}), ("lstsq", {}), ("lstsq_tail", {"tail": True}),
    ("lstsq_tail_cm", {"tail": True, "recenter_cm": True}),
])
def test_waveform_objectives_match_tpumix(name, kwargs):
    stems, mix, _ = _comb_mix(seed=9)
    gains = np.random.default_rng(1).uniform(-0.5, 0.5, (3, 4)).astype(np.float32)
    j = (jnp.asarray(stems), jnp.asarray(mix), jnp.asarray(gains))
    t = (torch.from_numpy(stems), torch.from_numpy(mix), torch.from_numpy(gains))
    if name == "coherent":
        ref, got = jax_state._coherent_loss(*j), port_state._coherent_loss(*t)
    else:
        ref, got = jax_state._lstsq_loss(*j, **kwargs), port_state._lstsq_loss(*t, **kwargs)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-3)


def test_roundtrip_masked_db_matches_tpumix():
    rng = np.random.default_rng(2)
    feats = (20.0 * rng.standard_normal((2, 4, 33, 9)) - 40.0).astype(np.float32)
    gains = rng.uniform(-0.5, 0.5, (2, 4)).astype(np.float32)
    ref = np.asarray(jax_state._roundtrip_masked_db(jnp.asarray(feats), jnp.asarray(gains), 1e-5))
    got = port_state._roundtrip_masked_db(torch.from_numpy(feats), torch.from_numpy(gains), 1e-5)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_check_loss_messages():
    assert port_state.SELF_SUPERVISED_LOSSES == jax_state.SELF_SUPERVISED_LOSSES
    model = torch.nn.Linear(1, 1)
    state = port_state.create_train_state(model, 1e-3, 0.0)
    with pytest.raises(ValueError, match="gain.*label-supervised"):
        port_state.make_train_step(state, FrontendConfig(), loss="gain")
    with pytest.raises(ValueError, match="unknown loss 'nonsense'"):
        port_state.make_eval_step(state, FrontendConfig(), loss="nonsense")


# --- optimizer ---------------------------------------------------------------


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_adam_with_l2_matches_optax(schedule):
    """Five updates of a small tree from the same gradients: coupled L2 on
    every leaf, eps 1e-8, and the cosine schedule read at the update count
    from 0 (``optax.cosine_decay_schedule(lr, 4, alpha=0.01)``)."""
    rng = np.random.default_rng(0)
    shapes = {"w": (3, 4), "b": (4,), "scale": (2, 2, 2)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    lr, wd = 0.1, 0.5
    jlr = optax.cosine_decay_schedule(lr, 4, alpha=0.01) if schedule == "cosine" else lr
    tx = jax_state.adam_with_l2(jlr, wd)
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    opt = tx.init(jparams)

    class Tree(torch.nn.Module):
        def __init__(self):
            super().__init__()
            for k, v in init.items():
                setattr(self, k, torch.nn.Parameter(torch.from_numpy(v.copy())))

    tree = Tree()
    plr = port_state.cosine_decay_schedule(lr, 4, alpha=0.01) if schedule == "cosine" else lr
    state = port_state.create_train_state(tree, plr, wd)
    for g in grads:
        updates, opt = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, v in g.items():
            getattr(tree, k).grad = torch.from_numpy(v.copy())
        port_state._apply_update(state)
    assert state.step == 5
    for k in shapes:
        np.testing.assert_allclose(getattr(tree, k).detach().numpy(), np.asarray(jparams[k]),
                                   rtol=1e-4, atol=1e-5)  # float32, five steps of 0.1
    if schedule == "cosine":
        js = optax.cosine_decay_schedule(lr, 4, alpha=0.01)
        for count in (0, 1, 3, 4, 9):  # past decay_steps it stays at alpha * lr
            np.testing.assert_allclose(plr(count), float(js(count)), rtol=1e-6)


def test_adam_l2_first_step_is_torch_semantics():
    """grad' = grad + wd*param, then Adam: one step on a scalar is ~ -lr
    (tests/test_train.py:111-121)."""
    w = torch.nn.Parameter(torch.tensor(2.0))
    opt = port_state.adam_with_l2([w], 0.1, 0.5)
    w.grad = torch.tensor(1.0)
    opt.step()
    assert abs(float(w) - 2.0 + 0.1) < 1e-3
    assert opt.defaults["eps"] == 1e-8 and opt.defaults["weight_decay"] == 0.5


# --- BatchNorm ---------------------------------------------------------------


def test_batchnorm_running_variance_is_flax_biased_variance():
    """One training forward of a block on a small batch (n = 2*5*4 = 40 per
    channel): the port's running variance equals flax's ``batch_stats/var``
    to 1e-6, and sits the factor (n-1)/n under ``nn.BatchNorm2d``'s."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 7, 6)).astype(np.float32)  # NCHW
    jblock = JaxConvBlock2d(features=8, kernel_size=3, bn_momentum=0.10)
    variables = jblock.init(jax.random.key(0), jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    _, mutated = jblock.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=True,
                              mutable=["batch_stats"])
    jvar = np.asarray(mutated["batch_stats"]["bn"]["var"])
    jmean = np.asarray(mutated["batch_stats"]["bn"]["mean"])

    block = ConvBlock2d(3, 8, 3, bn_momentum=0.10).train()
    kernel = np.asarray(variables["params"]["conv"]["kernel"])
    with torch.no_grad():
        block.conv.weight.copy_(torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy()))
        block.conv.bias.zero_()
    stock = torch.nn.BatchNorm2d(8, eps=block.bn.eps, momentum=block.bn.momentum).train()
    with torch.no_grad():
        y = block(torch.from_numpy(x))
        stock(block.conv(torch.from_numpy(x)))
    assert isinstance(block.bn, BatchNorm2d) and int(block.bn.num_batches_tracked) == 1
    np.testing.assert_allclose(block.bn.running_var.numpy(), jvar, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(block.bn.running_mean.numpy(), jmean, rtol=1e-5, atol=1e-6)
    n = 2 * 5 * 4
    batch_part = (stock.running_var - 0.1) * ((n - 1) / n)  # retained fraction 0.10 of var 1
    np.testing.assert_allclose(block.bn.running_var.numpy(), (0.1 + batch_part).numpy(), rtol=1e-5)
    assert float((stock.running_var - block.bn.running_var).abs().max()) > 1e-3
    # eval mode is nn.BatchNorm2d's, and the block's output is flax's
    jy, _ = jblock.apply(variables, jnp.asarray(x.transpose(0, 2, 3, 1)), train=True,
                         mutable=["batch_stats"])
    np.testing.assert_allclose(y.numpy(), np.asarray(jy).transpose(0, 3, 1, 2), atol=1e-5)


def test_batchnorm_backward_runs_after_the_buffer_update():
    block = ConvBlock2d(3, 4, 3).train()
    x = torch.randn(2, 3, 6, 6, generator=torch.Generator().manual_seed(0))
    block(x).sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in block.parameters())


# --- gain ops and random streams ----------------------------------------------


def test_gain_ops_match_tpumix():
    rng = np.random.default_rng(4)
    feats = (20.0 * rng.standard_normal((2, 4, 9, 5)) - 40.0).astype(np.float32)
    amp = rng.uniform(0.1, 2.0, (3, 5)).astype(np.float32)
    np.testing.assert_allclose(port_gain.amplitude_to_db_scalar(torch.from_numpy(amp)).numpy(),
                               np.asarray(jax_gain.amplitude_to_db_scalar(jnp.asarray(amp))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(port_gain.dummy_mix_db(torch.from_numpy(feats)).numpy(),
                               np.asarray(jax_gain.dummy_mix_db(jnp.asarray(feats))),
                               rtol=1e-5, atol=1e-4)
    stereo = rng.standard_normal((2, 2, 100)).astype(np.float32)
    np.testing.assert_allclose(port_gain.stereo_to_mono(torch.from_numpy(stereo)).numpy(),
                               np.asarray(jax_gain.stereo_to_mono(jnp.asarray(stereo))), atol=1e-7)


def test_augmentation_statistics():
    """One gain per (batch, stem) from U[0.6, 1.4]: constant along time,
    different between rows, mean 1, reproducible from the generator — as
    ``jax.random.uniform`` draws them in tpumix, compared as distributions."""
    audio = torch.ones((64, 4, 50))
    out = port_gain.augment_audio(audio, torch.Generator().manual_seed(0))
    gains = out[..., 0]
    assert torch.equal(out, gains[..., None].expand_as(out))
    assert 0.6 <= float(gains.min()) < 0.65 and 1.35 < float(gains.max()) <= 1.4
    assert abs(float(gains.mean()) - 1.0) < 0.03 and abs(float(gains.std()) - 0.8 / 12**0.5) < 0.03
    jg = np.asarray(jax_gain.augment_audio(jnp.ones((64, 4, 50)), jax.random.key(0)))[..., 0]
    assert abs(jg.mean() - float(gains.mean())) < 0.05 and abs(jg.std() - float(gains.std())) < 0.03
    again = port_gain.augment_audio(audio, torch.Generator().manual_seed(0))
    assert torch.equal(again, out)
    feats = torch.zeros((8, 4, 3, 2))
    shifted = port_gain.augment_features_db(feats, torch.Generator().manual_seed(1))
    per_stem = shifted[..., 0, 0]
    assert torch.equal(shifted, per_stem[..., None, None].expand_as(shifted))
    lo, hi = 20 * np.log10(0.6), 20 * np.log10(1.4)
    assert lo <= float(per_stem.min()) and float(per_stem.max()) <= hi


@pytest.mark.parametrize("augment_mix", [True, False])
def test_train_step_augments_stems_and_optionally_the_mix(monkeypatch, augment_mix):
    """With ``augment`` the stems get one gain per (batch, stem) and, with
    ``augment_mix``, the mix an independent one per item
    (tpumix/train/state.py:474-482)."""
    calls = []
    real = port_state.augment_audio

    def spy(audio, generator=None, **kw):
        out = real(audio, generator, **kw)
        calls.append((tuple(audio.shape), (out / audio)[..., 0]))
        return out

    monkeypatch.setattr(port_state, "augment_audio", spy)
    from tpumix_torch.config import preset
    from tpumix_torch.models.registry import build_model

    model = build_model(dataclasses.replace(preset("scalar1s"), use_dropout=False),
                        in_shape=(129, 47), for_training=True)
    state = port_state.create_train_state(model, 1e-3, 1e-5)
    step = port_state.make_train_step(
        state, FrontendConfig(n_fft=256, hop_length=128, sample_rate=8000),
        augment=True, augment_mix=augment_mix)
    stems = torch.full((3, 4, 6000), 0.1)
    m = step(stems, stems.sum(dim=1), torch.Generator().manual_seed(5))
    assert np.isfinite(float(m["loss"]))
    assert [c[0] for c in calls] == [(3, 4, 6000)] + ([(3, 6000)] if augment_mix else [])
    stem_gains = calls[0][1]
    assert stem_gains.shape == (3, 4) and len(set(stem_gains.flatten().tolist())) == 12
    if augment_mix:  # drawn after the stems' gains: independent of them
        assert calls[1][1].shape == (3,)
        assert not torch.allclose(calls[1][1], stem_gains.mean(dim=1))


def test_dropout_rate_and_scale():
    """Blocks 1-4 drop 20% and block 5 30% of their activations in training
    mode (tpumix/models/scalar.py:80-95), survivors scaled by 1/(1-p) as
    flax's Dropout does; none in eval."""
    from tpumix_torch.config import preset
    from tpumix_torch.models.registry import build_model

    model = build_model(preset("scalar1s"), in_shape=(129, 47), for_training=True)
    assert model.training
    assert [getattr(model, f"conv_b{i}").dropout.p for i in range(1, 6)] == [0.2, 0.2, 0.2, 0.2, 0.3]
    torch.manual_seed(0)
    out = model.conv_b5.dropout(torch.ones(200_000))
    assert abs(float((out == 0).float().mean()) - 0.3) < 0.01
    np.testing.assert_allclose(float(out.max()), 1.0 / 0.7, rtol=1e-6)
    model.eval()
    assert torch.equal(model.conv_b5.dropout(torch.ones(10)), torch.ones(10))
    assert not build_model(preset("scalar1s"), in_shape=(129, 47)).training


def test_train_config_is_tpumix_train_config():
    from tpumix.config import DataConfig as JaxDataConfig
    from tpumix.config import TrainConfig as JaxTrainConfig
    from tpumix_torch.config import DataConfig

    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JaxTrainConfig())
    assert dataclasses.asdict(DataConfig()) == dataclasses.asdict(JaxDataConfig())
