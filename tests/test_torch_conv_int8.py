"""The port's dynamic-W8A8 khgemm lowering (tpumix_torch/ops/conv_int8.py)
against the JAX package's (tpumix/ops/conv_int8.py) on the same inputs, and
held to the JAX tests' own contract (tests/test_conv_int8.py):

* the activation and weight codes equal the JAX package's (both divide in
  float32 by the same scales and round half to even): measured on the CPU, no
  code differs; the outputs then differ by float32 reassociation of the
  dequantised sums: rtol / atol 1e-5, the khgemm bound
  (tests/test_conv_khgemm.py:31);
* the quantisation envelope on random normals: mean < 1.5e-2, max < 8e-2 of
  the output RMS (tests/test_conv_int8.py:30-42);
* exact on ternary inputs, atol 1e-3 (:45-55);
* ``scalar1s`` gains under ``khgemm_int8`` within 0.1 of ``khgemm`` (:58-78),
  and within 1e-4 of the JAX int8 model (tests/test_torch_models.py's bound
  between the packages);
* ``inference-only`` raises in the block and in ``build_model``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.config import preset as jax_preset
from tpumix.models.registry import build_model as jax_build_model
from tpumix.ops import conv_int8 as jq
from tpumix.ops.conv_khgemm import conv2d_valid_khgemm as jax_khgemm
from tpumix_torch.config import preset
from tpumix_torch.models.blocks import ConvBlock2d
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.ops import conv_int8 as tq
from tpumix_torch.ops.conv_khgemm import conv2d_valid_khgemm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_codes(x, kw):
    """The JAX lowering's window codes, as tpumix/ops/conv_int8.py:105-114
    forms them."""
    Wo = x.shape[2] - kw + 1
    rowscale = jq._window_row_scales(jnp.asarray(x), kw, Wo)
    cols = jnp.concatenate([jnp.clip(jnp.round(x[:, :, j: j + Wo, :] / rowscale), -127, 127)
                            .astype(jnp.int8) for j in range(kw)], axis=-1)
    return np.asarray(cols), np.asarray(rowscale)


def _normals(shape, kern, seed=0):
    kx, kw_ = jax.random.split(jax.random.key(seed))
    return (np.array(jax.random.normal(kx, shape, jnp.float32)),
            np.array(jax.random.normal(kw_, kern, jnp.float32) * 0.1))


@pytest.mark.parametrize("shape,kern", [((2, 24, 20, 16), (5, 5, 16, 32)),
                                        ((1, 30, 17, 64), (9, 9, 64, 128))])
def test_codes_and_output_match_the_jax_lowering(shape, kern):
    x, w = _normals(shape, kern)
    cols_q, rowscale = tq.quantize_windows(torch.from_numpy(x), kern[1])
    j_cols, j_rowscale = _jax_codes(x, kern[1])
    np.testing.assert_array_equal(rowscale.numpy(), j_rowscale)
    assert int((cols_q.numpy() != j_cols).sum()) == 0
    w_q, colscale = tq.quantize_weights(torch.from_numpy(w))
    j_wq, j_colscale = jq.quantize_weights(jnp.asarray(w))
    np.testing.assert_array_equal(w_q.numpy(), np.asarray(j_wq))
    np.testing.assert_array_equal(colscale.numpy(), np.asarray(j_colscale))
    got = tq.conv2d_valid_khgemm_int8(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = np.asarray(jq.conv2d_valid_khgemm_int8(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shape,kern", [((2, 24, 20, 16), (5, 5, 16, 32)),
                                        ((1, 30, 17, 64), (9, 9, 64, 128))])
def test_int8_tracks_f32_within_quant_envelope(shape, kern):
    x, w = _normals(shape, kern)
    ref = conv2d_valid_khgemm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    q = tq.conv2d_valid_khgemm_int8(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert q.shape == ref.shape
    rel = np.abs(q - ref) / (np.sqrt(np.mean(ref ** 2)) + 1e-9)
    assert float(np.mean(rel)) < 1.5e-2
    assert float(np.max(rel)) < 8e-2


def test_int8_exact_on_ternary_inputs():
    rng = np.random.default_rng(1)
    x = rng.integers(-1, 2, (1, 12, 10, 8)).astype(np.float32)
    w = rng.integers(-1, 2, (3, 3, 8, 16)).astype(np.float32)
    ref = np.asarray(jax_khgemm(jnp.asarray(x), jnp.asarray(w)))
    q = tq.conv2d_valid_khgemm_int8(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(q, ref, rtol=0, atol=1e-3)


def test_model_forward_with_int8_trunk():
    """tests/test_conv_int8.py:58-78 on the port, the JAX model's weights
    carried over by the converter."""
    x = np.array(jax.random.normal(jax.random.key(2), (1, 4, 129, 87), jnp.float32))
    jcfg = dataclasses.replace(jax_preset("scalar1s"), conv_impl="khgemm_int8")
    variables = jax_build_model(jcfg).init(jax.random.key(0), x, train=False)
    _, j_gains = jax_build_model(jcfg).apply(variables, x, train=False)
    state = state_dict_from_jax(jax.tree.map(np.asarray, variables))
    gains = {}
    for impl in ("khgemm_int8", "khgemm"):
        model = build_model(dataclasses.replace(preset("scalar1s"), conv_impl=impl),
                            in_shape=(129, 87))
        model.load_state_dict(state)
        with torch.no_grad():
            gains[impl] = model.eval().gains(torch.from_numpy(x)).numpy()
    assert gains["khgemm_int8"].shape == (1, 4) and np.isfinite(gains["khgemm_int8"]).all()
    assert float(np.abs(gains["khgemm_int8"] - gains["khgemm"]).max()) < 0.1
    np.testing.assert_allclose(gains["khgemm_int8"], np.asarray(j_gains), rtol=0, atol=1e-4)


def test_int8_is_inference_only():
    cfg = dataclasses.replace(preset("scalar2s"), conv_impl="khgemm_int8")
    with pytest.raises(ValueError, match="inference-only"):
        build_model(cfg, for_training=True)
    block = ConvBlock2d(8, 16, 3, conv_impl="khgemm_int8")
    x = torch.randn(1, 8, 12, 10)
    with pytest.raises(ValueError, match="inference-only"):
        block.train()(x)
    assert block.eval()(x).shape == (1, 16, 10, 8)


def test_cuda_shape_rule_names_the_shape(monkeypatch):
    """On CUDA ``torch._int_mm`` needs M > 16 and K, N multiples of 8; the
    lowering raises naming the shape (checked here through the rule alone)."""
    a = torch.zeros(32, 12, dtype=torch.int8)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda self: True))
    with pytest.raises(ValueError, match="M, K, N = 32, 12, 16"):
        tq._s8_gemm(a, torch.zeros(12, 16, dtype=torch.int8))
