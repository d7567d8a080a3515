"""The port's scalar models against flax ``apply``: every preset, random
weights carried across by ``state_dict_from_jax``, at a narrow input.  Gains
agree within 1e-4 (f32 reassociation only), with both trunk lowerings; all
five shipped scalar checkpoints load into the port.  ``conv_impl="auto"``
is ``"xla"`` on the CPU and in training, and K2 for blocks 2-5 on the card."""

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
from tpumix_torch.models.blocks import takes_fused_kernel
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
    # "auto" reaches the blocks, which decide at forward time (K2 on the card
    # in eval mode, F.conv2d elsewhere: the tests below)
    assert all(getattr(a, f"conv_b{i}").conv_impl == "auto" for i in range(1, 6))


def _auto_and_xla(name, features, seed):
    variables = _jax_variables(name, features, seed=seed)
    models = {}
    for impl in ("auto", "xla"):
        models[impl] = build_model(dataclasses.replace(preset(name), conv_impl=impl), in_shape=FT)
        models[impl].load_state_dict(state_dict_from_jax(variables))
    return models


@pytest.mark.parametrize("name", PRESETS)
def test_auto_on_the_cpu_is_xla_bit_for_bit(features, name):
    models = _auto_and_xla(name, features, seed=11)
    x = torch.from_numpy(features)
    with torch.no_grad():
        got = {impl: m.eval()(x) for impl, m in models.items()}
    for a, b in zip(got["auto"], got["xla"]):
        assert torch.equal(a, b)
    blocks = [getattr(models["auto"], f"conv_b{i}") for i in range(1, 6)]
    assert all(b._packed is None for b in blocks)  # K2's operands never made


def test_auto_in_training_mode_is_xla_bit_for_bit(features):
    models = _auto_and_xla("scalar2s", features, seed=12)
    x = torch.from_numpy(features)
    out = {}
    for impl, m in models.items():
        m.train()
        torch.manual_seed(5)  # the same dropout masks
        gains = m.gains(x)
        gains.sum().backward()
        out[impl] = (gains.detach(), m.conv_b5.conv.weight.grad, m.conv_b5.bn.running_mean)
    for a, b in zip(out["auto"], out["xla"]):
        assert torch.equal(a, b)
    assert models["auto"].conv_b5._packed is None


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("device,training,grad,stride,dilation,x_dtype,cin,cout,takes", [
    ("cuda", False, False, (1, 1), (1, 1), F32, 16, 32, True),  # block 2 on the card, eval
    ("cuda", False, False, (1, 1), (1, 1), F32, 64, 128, True),  # block 5
    ("cpu", False, False, (1, 1), (1, 1), F32, 16, 32, False),  # the CPU: F.conv2d
    ("cuda", True, True, (1, 1), (1, 1), F32, 16, 32, False),  # training
    ("cuda", False, True, (1, 1), (1, 1), F32, 16, 32, False),  # eval, gradient recorded
    ("cuda", False, False, (2, 2), (2, 2), F32, 4, 16, False),  # block 1 of the 2 s models
    ("cuda", False, False, (2, 2), (1, 1), F32, 16, 16, False),  # stride 2 alone
    ("cuda", False, False, (1, 1), (2, 2), F32, 16, 16, False),  # dilation 2 alone
    ("cuda", False, False, (1, 1), (1, 1), BF16, 16, 32, False),  # bfloat16 compute
    ("cuda", False, False, (1, 1), (1, 1), F32, 6, 32, False),  # the launcher's Cin % 4
    ("cuda", False, False, (1, 1), (1, 1), F32, 16, 30, False),  # and Cout % 4
])
def test_auto_takes_the_fused_kernel_only_where_it_applies(device, training, grad, stride,
                                                           dilation, x_dtype, cin, cout, takes):
    assert takes_fused_kernel("auto", device, training, grad, stride, dilation, x_dtype, F32,
                              cin, cout) is takes
    # "pallas" keeps the JAX package's conditions (any device, no channel or
    # gradient test); "xla" and the khgemm lowerings never fuse
    pallas = not training and stride == dilation == (1, 1) and x_dtype == F32
    assert takes_fused_kernel("pallas", device, training, grad, stride, dilation, x_dtype, F32,
                              cin, cout) is pallas
    for impl in ("xla", "khgemm", "khgemm_hybrid", "khgemm_int8"):
        assert not takes_fused_kernel(impl, device, training, grad, stride, dilation, x_dtype,
                                      F32, cin, cout)


@pytest.mark.parametrize("name", ["scalar1s", "scalar2s"])
def test_auto_routes_blocks_2_to_5_through_the_fused_kernel_on_the_card(features, name,
                                                                       monkeypatch):
    """The decision each block takes from its own input, with a CPU tensor
    standing in for a CUDA one: blocks 2-5 take K2's entry (its float64 plain
    version here), block 1 stays ``F.conv2d``, and the gains agree with
    ``"xla"`` within K2's tolerance."""
    from tpumix_torch.models import blocks

    real = blocks.takes_fused_kernel
    monkeypatch.setattr(blocks, "takes_fused_kernel",
                        lambda impl, device, *a: real(impl, "cuda" if device == "cpu" else device,
                                                      *a))
    models = _auto_and_xla(name, features, seed=13)
    x = torch.from_numpy(features)
    with torch.no_grad():
        got = {impl: m.eval().gains(x) for impl, m in models.items()}
    packed = [getattr(models["auto"], f"conv_b{i}")._packed is not None for i in range(1, 6)]
    assert packed == [False, True, True, True, True]
    np.testing.assert_allclose(got["auto"].numpy(), got["xla"].numpy(), rtol=1e-4, atol=5e-5)
    with torch.enable_grad():  # a recorded gradient keeps every block on F.conv2d
        grads = models["auto"].gains(x)
    assert grads.requires_grad
    np.testing.assert_array_equal(grads.detach().numpy(), got["xla"].numpy())
