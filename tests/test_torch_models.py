"""The port's scalar models against flax ``apply``: every preset, random
weights carried across by ``state_dict_from_jax``, at a narrow input.  Gains
agree within 1e-4 (f32 reassociation only), with both trunk lowerings; all
five shipped scalar checkpoints load into the port."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpumix.config import preset as jax_preset
from tpumix.models.convert import flax_scalar_to_torch as jax_flax_scalar_to_torch
from tpumix.models.registry import build_model as jax_build_model
from tpumix_torch.assets import checkpoint_path, load_checkpoint
from tpumix_torch.config import preset
from tpumix_torch.models.convert import flax_scalar_to_torch, state_dict_from_jax
from tpumix_torch.models.registry import build_model, example_feature_shape

FT = (72, 72)  # narrow input: every trunk keeps a positive output size
PRESETS = ["scalar1s", "scalar1sL", "scalar2s", "scalar2sL"]


def _jax_variables(name, x, seed):
    variables = jax_build_model(jax_preset(name)).init(jax.random.key(seed), x, train=False)
    variables = jax.tree.map(np.asarray, variables)
    rng = np.random.default_rng(seed)
    for blk in variables["batch_stats"].values():  # BN away from identity
        blk["bn"]["mean"] = (0.1 * rng.standard_normal(blk["bn"]["mean"].shape)).astype(np.float32)
        blk["bn"]["var"] = rng.uniform(0.5, 2.0, blk["bn"]["var"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def features():
    rng = np.random.default_rng(0)
    return (20.0 * rng.standard_normal((3, 4, *FT)) - 40.0).astype(np.float32)


@pytest.mark.parametrize("conv_impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", PRESETS)
def test_forward_matches_flax(features, name, conv_impl):
    variables = _jax_variables(name, features, seed=PRESETS.index(name) + 1)
    j_masked, j_gains = jax_build_model(jax_preset(name)).apply(variables, features, train=False)
    model = build_model(dataclasses.replace(preset(name), conv_impl=conv_impl), in_shape=FT)
    model.load_state_dict(state_dict_from_jax(variables))
    model.eval()
    with torch.no_grad():
        masked, gains = model(torch.from_numpy(features))
    assert gains.shape == (3, 4) and masked.shape == (3, *FT)
    np.testing.assert_allclose(gains.numpy(), np.asarray(j_gains), atol=1e-4, rtol=0)
    np.testing.assert_allclose(masked.numpy(), np.asarray(j_masked), rtol=1e-5, atol=1e-2)
    assert np.abs(np.asarray(j_gains)).max() > 0.1  # the heads are alive


def test_channels_last_input_gives_same_gains(features):
    variables = _jax_variables("scalar2s", features, seed=9)
    model = build_model(preset("scalar2s"), in_shape=FT)
    model.load_state_dict(state_dict_from_jax(variables))
    model.eval()
    x = torch.from_numpy(features)
    with torch.no_grad():
        a = model.gains(x)
        b = model.gains(x.contiguous(memory_format=torch.channels_last))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_name_and_layout_map_is_the_jax_packages(features):
    variables = _jax_variables("scalar2sL", features, seed=4)
    ours = flax_scalar_to_torch(variables["params"], variables["batch_stats"])
    theirs = jax_flax_scalar_to_torch(variables["params"], variables["batch_stats"])
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_array_equal(ours[k], theirs[k])


@pytest.mark.parametrize("name,arch", [
    ("scalar2sL_synth", "scalar2sL"),
    ("scalar1sL_synth", "scalar1sL"),
    ("scalar2s_synth", "scalar2s"),
    ("scalar2s_lstsq_selfsup", "scalar2s"),
    ("scalar2s_filecorpus", "scalar2s"),
])
def test_shipped_checkpoints_load(name, arch):
    assert checkpoint_path(name).endswith(f"tpumix/assets/checkpoints/{name}.npz")
    model = build_model(preset(arch))
    missing = model.load_state_dict(state_dict_from_jax(load_checkpoint(name)))
    assert not missing.missing_keys and not missing.unexpected_keys
    fc = model.head1.fc.weight
    assert fc.shape[1] == {"scalar2sL": 30811, "scalar2s": 30807, "scalar1sL": 10294}[arch]


def test_registry_contract():
    assert example_feature_shape(preset("scalar2s"), batch=2) == (2, 4, 1025, 173)
    resnet = build_model(preset("resnet18"))
    assert type(resnet).__name__ == "GainResNet"
    assert resnet.head1.fc.weight.shape == (1, 231)  # 33 * 7 at [1025, 216]
    a = build_model(preset("scalar1s"), generator=torch.Generator().manual_seed(3))
    b = build_model(preset("scalar1s"), generator=torch.Generator().manual_seed(3))
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
    assert a.conv_b5.conv_impl == "xla"  # "auto" -> F.conv2d
