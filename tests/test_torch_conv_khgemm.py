"""The port's kh-unrolled GEMM lowerings (tpumix_torch/ops/conv_khgemm.py) and
the khgemm blocks against the JAX package (tpumix/ops/conv_khgemm.py), on the
same numpy inputs, at the JAX tests' tolerances:

* the forward against ``conv2d_valid_khgemm`` and ``F.conv2d``: rtol / atol
  1e-5 (tests/test_conv_khgemm.py:31), but at conv5's K = 5184 terms atol
  2e-5: there the JAX lowering itself sits 1.8e-5 and the port's 1.2e-5 from
  float64 (measured on the CPU with one thread), each a float32 sum in its own
  order; the stride / dilation dispatch: rtol
  1e-5, atol 1e-6 (:39-44);
* the hand VJP's ``dx`` / ``dw`` against JAX's hand VJP and against
  ``F.conv2d`` autograd: rtol 2e-4, atol 2e-5 / 2e-4 (:143-144); the hybrid's
  forward against khgemm: atol 1e-6 (:154).
  ``F.conv2d`` as the yardstick runs in float64: torch's float32 CPU
  convolution sits 4e-5 to 8e-5 from float64 at the conv4 and conv5 shapes,
  four to seven times further than either khgemm (9e-6, 1.2e-5; measured
  on the CPU with one thread), so a float32 yardstick would test torch's CPU
  convolution, not the lowering;
* models: ``scalar1s`` gains under ``khgemm`` against the JAX ``khgemm``
  model, atol 1e-4 (tests/test_torch_models.py's bound between the
  packages); the ``xla`` and ``khgemm`` trunks on one state dict, 2e-4
  (tests/test_conv_khgemm.py:71-72);
* bfloat16: the products are exact in float32 and the kh partials add in
  float32 in both packages, so the two differ by float32 reassociation, then
  one rounding to bfloat16: at most one bfloat16 step (2**-7 relative);
  model gains within tests/test_torch_bf16.py's 2**-6 * max|g|.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpumix.config import preset as jax_preset
from tpumix.models.registry import build_model as jax_build_model
from tpumix.ops import conv_khgemm as jk
from tpumix_torch.config import preset
from tpumix_torch.models.blocks import ConvBlock2d
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.ops import conv_khgemm as tk

FT = (129, 47)  # tests/test_conv_khgemm.py's model input


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _xw(xs, ws, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(xs).astype(np.float32),
            (rng.standard_normal(ws) * 0.1).astype(np.float32))


def _torch_conv(x, w, strides=(1, 1), dilation=(1, 1)):
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), stride=strides,
                    dilation=dilation).permute(0, 2, 3, 1)


def _torch_conv64(x, w, **kw):
    """``F.conv2d`` in float64, its result (and gradients) float32."""
    return _torch_conv(x.double(), w.double(), **kw).float()


@pytest.mark.parametrize("xs,ws,atol", [
    ((2, 40, 30, 16), (5, 5, 16, 32), 1e-5),   # conv2 family
    ((2, 37, 25, 48), (7, 7, 48, 64), 1e-5),   # conv4
    ((1, 30, 22, 64), (9, 9, 64, 128), 2e-5),  # conv5
    ((3, 12, 11, 3), (1, 1, 3, 7), 1e-5),      # degenerate 1x1
])
def test_forward_matches_jax_khgemm_and_conv2d(xs, ws, atol):
    x, w = _xw(xs, ws, 0)
    got = tk.conv2d_valid_khgemm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.conv2d_valid_khgemm(x, w)), rtol=1e-5,
                               atol=atol)
    want = _torch_conv64(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize("kw", [dict(strides=(2, 2)), dict(dilation=(2, 2))])
def test_dispatch_takes_conv2d_for_stride_and_dilation(kw):
    x, w = _xw((2, 21, 19, 4), (3, 3, 4, 16), 1)
    got = tk.conv2d(torch.from_numpy(x), torch.from_numpy(w), **kw).numpy()
    np.testing.assert_allclose(got, np.asarray(jk.conv2d(x, w, **kw)), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, _torch_conv64(torch.from_numpy(x), torch.from_numpy(w),
                                                  **kw).numpy(), rtol=1e-5, atol=1e-6)


def _grads(conv, x, w, seed):
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    torch.sum(torch.sin(conv(xt, wt).double() * 0.1) * float(seed)).backward()
    return xt.grad.numpy(), wt.grad.numpy()


@pytest.mark.parametrize("xs,ws", [
    ((2, 20, 15, 8), (5, 5, 8, 16)),
    ((1, 17, 11, 4), (3, 7, 4, 12)),
    ((2, 25, 12, 6), (9, 9, 6, 10)),
])
def test_hand_vjp_matches_jax_hand_vjp_and_conv2d_autograd(xs, ws):
    x, w = _xw(xs, ws, 0)
    seed = float(np.random.default_rng(0).standard_normal())
    dx, dw = _grads(tk.conv2d_valid_khgemm, x, w, seed)
    jdx, jdw = jax.grad(lambda x_, w_: jnp.sum(jnp.sin(jk.conv2d_valid_khgemm(x_, w_) * 0.1)
                                               * seed), argnums=(0, 1))(x, w)
    np.testing.assert_allclose(dx, np.asarray(jdx), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dw, np.asarray(jdw), rtol=2e-4, atol=2e-4)
    tdx, tdw = _grads(_torch_conv64, x, w, seed)
    np.testing.assert_allclose(dx, tdx, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(dw, tdw, rtol=2e-4, atol=2e-4)


def test_hybrid_forward_is_khgemm_and_backward_is_conv2d():
    x, w = _xw((2, 20, 15, 8), (5, 5, 8, 16), 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    np.testing.assert_allclose(tk.conv2d_valid_khgemm_hybrid(xt, wt).numpy(),
                               tk.conv2d_valid_khgemm(xt, wt).numpy(), atol=1e-6)
    hdx, hdw = _grads(tk.conv2d_valid_khgemm_hybrid, x, w, 1.0)
    tdx, tdw = _grads(_torch_conv64, x, w, 1.0)
    np.testing.assert_allclose(hdx, tdx, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(hdw, tdw, rtol=2e-4, atol=2e-4)
    jdx, jdw = jax.grad(lambda x_, w_: jnp.sum(jnp.sin(jk.conv2d_valid_khgemm_hybrid(x_, w_)
                                                       * 0.1)), argnums=(0, 1))(x, w)
    np.testing.assert_allclose(hdx, np.asarray(jdx), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(hdw, np.asarray(jdw), rtol=2e-4, atol=2e-4)


def test_bf16_khgemm_adds_its_partials_in_float32():
    """bf16 inputs: the port under autocast against the JAX bf16 lowering
    (one bf16 step apart at most) and against float32 products of the bf16
    values added in float64, rounded once to bf16."""
    x, w = _xw((2, 24, 20, 16), (5, 5, 16, 32), 4)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = tk.conv2d_valid_khgemm(xb, wb)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(jk.conv2d_valid_khgemm(jnp.asarray(x, jnp.bfloat16),
                                             jnp.asarray(w, jnp.bfloat16)).astype(jnp.float32))
    exact = _torch_conv(xb.double(), wb.double()).bfloat16().float().numpy()
    step = 2.0 ** -7 * np.abs(exact) + 1e-30
    assert np.all(np.abs(got - want) <= step)
    assert np.all(np.abs(got - exact) <= step)


def _jax_variables(cfg, x, seed):
    variables = jax.tree.map(np.asarray, jax_build_model(cfg).init(jax.random.key(seed), x,
                                                                   train=False))
    rng = np.random.default_rng(seed)
    for blk in variables["batch_stats"].values():  # BN away from identity
        blk["bn"]["mean"] = (0.1 * rng.standard_normal(blk["bn"]["mean"].shape)).astype(np.float32)
        blk["bn"]["var"] = rng.uniform(0.5, 2.0, blk["bn"]["var"].shape).astype(np.float32)
    return variables


@pytest.fixture(scope="module")
def scalar1s():
    x = np.random.default_rng(5).standard_normal((2, 4, *FT)).astype(np.float32) * 20.0 - 40.0
    variables = _jax_variables(jax_preset("scalar1s"), x, 0)
    return x, variables, state_dict_from_jax(variables)


def _port(conv_impl, state, compute_dtype="float32"):
    model = build_model(dataclasses.replace(preset("scalar1s"), conv_impl=conv_impl,
                                            compute_dtype=compute_dtype), in_shape=FT)
    model.load_state_dict(state)
    return model.eval()


def test_scalar1s_khgemm_matches_the_jax_khgemm_model(scalar1s):
    x, variables, state = scalar1s
    jcfg = dataclasses.replace(jax_preset("scalar1s"), conv_impl="khgemm")
    j_masked, j_gains = jax_build_model(jcfg).apply(variables, x, train=False)
    with torch.no_grad():
        masked, gains = _port("khgemm", state)(torch.from_numpy(x))
    np.testing.assert_allclose(gains.numpy(), np.asarray(j_gains), atol=1e-4, rtol=0)
    np.testing.assert_allclose(masked.numpy(), np.asarray(j_masked), rtol=1e-5, atol=1e-2)
    assert np.abs(np.asarray(j_gains)).max() > 0.1  # the heads are alive


def test_every_conv_impl_takes_one_state_dict(scalar1s):
    x, _, state = scalar1s
    with torch.no_grad():
        gains = {impl: _port(impl, state).gains(torch.from_numpy(x)).numpy()
                 for impl in ("xla", "khgemm", "khgemm_hybrid", "khgemm_int8")}
    keys = {impl: set(_port(impl, state).state_dict()) for impl in gains}
    assert all(k == keys["xla"] for k in keys.values())
    np.testing.assert_allclose(gains["khgemm"], gains["xla"], rtol=2e-4, atol=2e-4)
    np.testing.assert_array_equal(gains["khgemm_hybrid"], gains["khgemm"])
    assert np.isfinite(gains["khgemm_int8"]).all()  # held to JAX in test_torch_conv_int8.py


def test_bf16_scalar1s_khgemm_matches_jax_bf16_khgemm(scalar1s):
    x, variables, state = scalar1s
    jcfg = dataclasses.replace(jax_preset("scalar1s"), conv_impl="khgemm",
                               compute_dtype="bfloat16")
    _, j_gains = jax_build_model(jcfg).apply(variables, x, train=False)
    with torch.no_grad():
        gains = _port("khgemm", state, "bfloat16").gains(torch.from_numpy(x)).numpy()
    j_gains = np.asarray(j_gains, np.float32)
    assert np.abs(gains - j_gains).max() <= 2.0 ** -6 * np.abs(j_gains).max()


def test_block_adds_the_bias_after_the_lowering():
    torch.manual_seed(0)
    a = ConvBlock2d(8, 16, 5, conv_impl="xla").eval()
    b = ConvBlock2d(8, 16, 5, conv_impl="khgemm").eval()
    b.load_state_dict(a.state_dict())
    with torch.no_grad():
        a.conv.bias.normal_()
        b.conv.bias.copy_(a.conv.bias)
        x = torch.randn(2, 8, 20, 15).contiguous(memory_format=torch.channels_last)
        np.testing.assert_allclose(b(x).numpy(), a(x).numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unknown conv_impl"):
        ConvBlock2d(8, 16, 5, conv_impl="cudnn")


@pytest.mark.parametrize("conv_impl", ["khgemm", "khgemm_hybrid"])
def test_khgemm_train_step_matches_the_xla_step(scalar1s, conv_impl):
    """One ``reference`` step of the small scalar1s (tests/test_train.py's
    frontend) under each trainable khgemm lowering against the ``xla`` step
    from one initialisation: the loss to 1e-5 relative (one forward), the
    parameters after Adam's first step as tests/test_torch_parallel.py holds
    two orders of float32 sums: >= 99% within 2e-5, none beyond 2 lr."""
    from tpumix_torch.config import FrontendConfig
    from tpumix_torch.train.state import create_train_state, make_train_step

    fe = FrontendConfig(n_fft=256, hop_length=128, sample_rate=8000)
    rng = np.random.default_rng(2)
    stems = torch.from_numpy((0.1 * rng.standard_normal((2, 4, 6000))).astype(np.float32))
    mix = stems.sum(dim=1)
    init = build_model(dataclasses.replace(preset("scalar1s"), use_dropout=False), in_shape=FT,
                       for_training=True).state_dict()
    out = {}
    for impl in ("xla", conv_impl):
        model = build_model(dataclasses.replace(preset("scalar1s"), use_dropout=False,
                                                conv_impl=impl), in_shape=FT, for_training=True)
        model.load_state_dict(init)
        state = create_train_state(model, 1e-3, 1e-5)
        metrics = make_train_step(state, fe)(stems, mix, None)
        out[impl] = float(metrics["loss"]), {k: v.clone() for k, v in model.state_dict().items()}
    np.testing.assert_allclose(out[conv_impl][0], out["xla"][0], rtol=1e-5)
    diffs = torch.cat([(out[conv_impl][1][k] - v).abs().flatten().float()
                       for k, v in out["xla"][1].items() if "running_" not in k
                       and not k.endswith("num_batches_tracked")])
    assert float(diffs.max()) <= 2e-3 + 1e-6
    assert float((diffs <= 2e-5).float().mean()) >= 0.99
