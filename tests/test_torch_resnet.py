"""The port's ResNet family against flax: ``GainResNet`` and ``Bottleneck`` at a
narrow input (gains atol 1e-4), the shipped ``resnet18_synth.npz`` at the full
width ``[1, 4, 1025, 216]`` (gains within 1e-3), and one training-mode forward
whose BatchNorm running statistics follow flax's (biased variance, torch
momentum 0.1 == flax retained fraction 0.9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.assets import load_checkpoint as jax_load_checkpoint
from tpumix.models.blocks import Bottleneck as JaxBottleneck
from tpumix.models.resnet import GainResNet as JaxGainResNet
from tpumix_torch.assets import load_checkpoint
from tpumix_torch.config import preset
from tpumix_torch.models.blocks import Bottleneck
from tpumix_torch.models.convert import _named_from_jax, state_dict_from_jax, state_dict_to_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.models.resnet import GainResNet, resnet_output_hw

FT = (129, 40)


def _perturb_stats(variables, seed):
    """Numpy copy of flax variables with BN statistics away from identity."""
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)

    def walk(node):
        for key, val in node.items():
            if isinstance(val, dict) and "mean" in val:
                val["mean"] = (0.1 * rng.standard_normal(val["mean"].shape)).astype(np.float32)
                val["var"] = rng.uniform(0.5, 2.0, val["var"].shape).astype(np.float32)
            elif isinstance(val, dict):
                walk(val)

    walk(variables["batch_stats"])
    return variables


@pytest.fixture(scope="module")
def narrow():
    rng = np.random.default_rng(0)
    x = (20.0 * rng.standard_normal((2, 4, *FT)) - 40.0).astype(np.float32)
    flax_model = JaxGainResNet()
    variables = _perturb_stats(jax.jit(lambda k, a: flax_model.init(k, a, train=False))(
        jax.random.key(1), x), seed=1)
    return x, flax_model, variables


def test_gain_resnet_matches_flax(narrow):
    x, flax_model, variables = narrow
    j_masked, j_gains = flax_model.apply(variables, x, train=False)
    model = GainResNet(in_shape=FT)
    missing = model.load_state_dict(state_dict_from_jax(variables))
    assert not missing.missing_keys and not missing.unexpected_keys
    model.eval()
    with torch.no_grad():
        masked, gains = model(torch.from_numpy(x))
    assert gains.shape == (2, 4) and masked.shape == (2, *FT)
    np.testing.assert_allclose(gains.numpy(), np.asarray(j_gains), atol=1e-4, rtol=0)
    np.testing.assert_allclose(masked.numpy(), np.asarray(j_masked), rtol=1e-5, atol=1e-2)
    assert np.abs(np.asarray(j_gains)).max() > 0.1  # the heads are alive


def test_training_forward_updates_bn_like_flax(narrow):
    x, flax_model, variables = narrow
    (_, j_gains), updates = flax_model.apply(variables, x, train=True, mutable=["batch_stats"])
    model = GainResNet(in_shape=FT)
    model.load_state_dict(state_dict_from_jax(variables))
    model.train()
    with torch.no_grad():
        _, gains = model(torch.from_numpy(x))
    np.testing.assert_allclose(gains.numpy(), np.asarray(j_gains), atol=1e-4, rtol=0)
    ours = state_dict_to_jax(model.state_dict())["batch_stats"]
    theirs = jax.tree.map(np.asarray, updates["batch_stats"])
    flat_ours = dict(jax.tree_util.tree_leaves_with_path(ours))
    flat_theirs = jax.tree_util.tree_leaves_with_path(theirs)
    # mean and var of 30 BatchNorms: the stem, 2 per block x 12, 5 shortcuts
    assert len(flat_ours) == len(flat_theirs) == 2 * 30
    for path, val in flat_theirs:
        np.testing.assert_allclose(flat_ours[path], val, rtol=1e-4, atol=1e-5, err_msg=str(path))


@pytest.mark.parametrize("strides,cin", [(1, 16), (2, 8)])
def test_bottleneck_matches_flax(strides, cin):
    rng = np.random.default_rng(strides)
    x = rng.standard_normal((2, 17, 12, cin)).astype(np.float32)  # NHWC
    flax_block = JaxBottleneck(features=4, strides=strides)
    variables = _perturb_stats(flax_block.init(jax.random.key(strides), x, train=False), strides)
    ref = np.asarray(flax_block.apply(variables, x, train=False))
    block = Bottleneck(cin, 4, strides=strides)
    block.load_state_dict(_named_from_jax(variables))
    block.eval()
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    assert (block.shortcut_conv is None) == (strides == 1 and cin == 16)


def test_shipped_resnet18_full_width_matches_flax():
    cfg = preset("resnet18")
    model = build_model(cfg)
    assert isinstance(model, GainResNet)
    assert model.head1.fc.weight.shape == (1, 231)  # 33 * 7 at [1025, 216]
    assert resnet_output_hw(1025, 216, (1, 2, 2, 2, 2, 2)) == (33, 7)
    shipped = load_checkpoint("resnet18_synth")
    missing = model.load_state_dict(state_dict_from_jax(shipped))
    assert not missing.missing_keys and not missing.unexpected_keys
    back = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_jax(model.state_dict())))
    leaves = jax.tree_util.tree_leaves_with_path(shipped)
    assert len(back) == len(leaves) == 166  # the npz, both ways, bit for bit
    for path, val in leaves:
        np.testing.assert_array_equal(back[path], val, err_msg=str(path))
    rng = np.random.default_rng(3)
    x = (20.0 * rng.standard_normal((1, 4, 1025, 216)) - 50.0).astype(np.float32)
    _, j_gains = jax.jit(lambda v, a: JaxGainResNet().apply(v, a, train=False))(
        jax_load_checkpoint("resnet18_synth"), jnp.asarray(x))
    with torch.no_grad():
        gains = model.gains(torch.from_numpy(x))
    np.testing.assert_allclose(gains.numpy(), np.asarray(j_gains), atol=1e-3, rtol=0)
