"""The port's fused conv block (tpumix_torch/ops/conv_block.py) against the
JAX Pallas kernels in interpret mode: ``conv_block_fused_plain`` — the CPU
path of the K2 wrapper — vs ``conv_block_fused_v2`` and
``conv_block_fused_khpack_v2`` at the small shapes of
tests/test_conv_block_pallas.py:36-41, with that file's rtol 1e-4 / atol
5e-5 (:48); plus ``fold_batchnorm`` parity.  The kernel itself is held to
the plain version on the card in tests/test_torch_kernels.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from tpumix.ops.conv_block_pallas import (
    conv_block_fused_khpack_v2,
    conv_block_fused_v2,
)
from tpumix.ops.conv_block_pallas import fold_batchnorm as jax_fold_batchnorm
from tpumix_torch.ops.conv_block import conv_block_fused, conv_block_fused_plain, fold_batchnorm

SHAPES = [
    ((2, 40, 30, 16), (5, 5, 16, 32)),
    ((1, 25, 20, 8), (3, 7, 8, 24)),
    ((1, 33, 21, 64), (9, 9, 64, 128)),
    ((1, 19, 9, 4), (7, 7, 4, 64)),
]
KHPACK_SHAPES = [
    ((2, 40, 30, 16), (5, 5, 16, 32)),
    ((1, 45, 25, 32), (5, 5, 32, 48)),
    ((1, 40, 22, 48), (7, 7, 48, 64)),
    ((1, 19, 9, 4), (3, 3, 4, 24)),
]


def _rand_block(xs, ws, seed=0):
    rng = np.random.default_rng(seed)
    cout = ws[-1]
    return dict(
        x=rng.standard_normal(xs).astype(np.float32),
        w=(rng.standard_normal(ws) * 0.1).astype(np.float32),
        bias=(rng.standard_normal(cout) * 0.1).astype(np.float32),
        gamma=rng.uniform(0.5, 1.5, cout).astype(np.float32),
        beta=(rng.standard_normal(cout) * 0.1).astype(np.float32),
        mean=(rng.standard_normal(cout) * 0.1).astype(np.float32),
        var=rng.uniform(0.5, 2.0, cout).astype(np.float32),
    )


def _fold(p):
    return fold_batchnorm(*(torch.from_numpy(p[k]) for k in ("bias", "gamma", "beta", "mean", "var")),
                          1e-3)


def _check(jax_fn, xs, ws, seed):
    p = _rand_block(xs, ws, seed)
    s, t = _fold(p)
    ref = np.asarray(jax_fn(jnp.asarray(p["x"]), jnp.asarray(p["w"]), jnp.asarray(s.numpy()),
                            jnp.asarray(t.numpy()), interpret=True))
    got = conv_block_fused(torch.from_numpy(p["x"]), torch.from_numpy(p["w"]), s, t)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=5e-5)


@pytest.mark.parametrize("xs,ws", SHAPES)
def test_plain_matches_jax_v2(xs, ws):
    _check(conv_block_fused_v2, xs, ws, seed=0)


@pytest.mark.parametrize("xs,ws", KHPACK_SHAPES)
def test_plain_matches_jax_khpack_v2(xs, ws):
    _check(conv_block_fused_khpack_v2, xs, ws, seed=2)


def test_fold_batchnorm_matches_jax():
    p = _rand_block((1, 4, 4, 4), (1, 1, 4, 16), seed=3)
    s, t = _fold(p)
    js, jt = jax_fold_batchnorm(*(jnp.asarray(p[k]) for k in ("bias", "gamma", "beta", "mean", "var")),
                                1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=1e-6, atol=1e-7)


def test_channels_last_view_equals_contiguous_nhwc():
    p = _rand_block((2, 12, 10, 8), (3, 3, 8, 16), seed=4)
    s, t = _fold(p)
    nchw_cl = torch.from_numpy(p["x"]).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    a = conv_block_fused(nchw_cl.permute(0, 2, 3, 1), torch.from_numpy(p["w"]), s, t)
    b = conv_block_fused_plain(torch.from_numpy(p["x"]), torch.from_numpy(p["w"]), s, t)
    np.testing.assert_array_equal(a.numpy(), b.numpy())

