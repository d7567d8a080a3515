"""The bfloat16 compute dtype of the port, held to tests/test_bf16.py's
contract for the JAX package (:41, :63, :76) and to the JAX package itself.

Contract: parameters, optimizer state and BN statistics stay float32 (bf16 is
a compute dtype, so checkpoints interchange with float32 runs), the train step
is finite, and bf16 gains sit within 0.5 of the float32 gains on the same
weights.

Across packages: the heads and the level features run in the compute dtype
in both (tpumix/models/scalar.py:93-103, resnet.py:52-55), so the gains come
out of a bf16 Dense and are bf16 values cast to float32 in both.  The two
frameworks round the trunk in different orders (flax normalises BN in bf16,
torch's autocast in float32), so the two packages' bf16 gains are not
bit-equal.  Measured at a 72 x 72 input over three seeds
(tests/measure_port_parity.py, ``bf16``), the largest gap
was 0.002-0.125 for the four scalar models (at most one bf16 ulp of the
largest gain: 0.125 at |g| = 18.4) and 0.19-0.23 for resnet18, against
each package's own bf16-vs-float32 deviation of 0.05-0.16 (scalar) and
0.25-0.46 (resnet18).  The bound below says that much: the two packages'
bf16 gains are no further apart than the larger of their deviations from
float32 on the same input, and for the scalar models within two bf16 ulps
of the largest gain, 2**-6 * max|g|, the rounding of the heads' output.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from tpumix.config import preset as jax_preset
from tpumix.models.registry import build_model as jax_build_model
from tpumix_torch.config import FrontendConfig, preset
from tpumix_torch.models.convert import state_dict_from_jax
from tpumix_torch.models.registry import build_model
from tpumix_torch.ops.stft import spectrogram_features
from tpumix_torch.train.state import create_train_state, make_train_step

TINY = FrontendConfig(n_fft=256, hop_length=128, sample_rate=8000)
CHUNK = 6400  # 0.8 s @ 8 kHz -> 51 frames, 129 bins
FT = (TINY.num_bins, TINY.num_frames(CHUNK))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    test processes side by side, and torch's default of a thread per core in
    each makes small CPU ops wait on one another many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny_model(dtype: str, for_training: bool = True):
    cfg = dataclasses.replace(preset("scalar2s"), compute_dtype=dtype, bn_momentum=0.99,
                              use_dropout=False)
    return build_model(cfg, in_shape=FT, for_training=for_training)


def _batch(b=2, seed=0):
    rng = np.random.default_rng(seed)
    stems = np.asarray(rng.standard_normal((b, 4, CHUNK)) * 0.1, np.float32)
    return torch.from_numpy(stems), torch.from_numpy(stems.sum(axis=1))


def test_state_dtypes_stay_f32_and_step_is_finite():
    model = _tiny_model("bfloat16")
    state = create_train_state(model, 1e-3, 1e-5)
    for t in list(model.parameters()) + list(model.buffers()):
        assert t.dtype in (torch.float32, torch.int64)
    before = [p.detach().clone() for p in model.parameters()]
    metrics = make_train_step(state, TINY, loss="lstsq")(*_batch())
    assert np.isfinite(float(metrics["loss"]))
    for t in list(model.parameters()) + list(model.buffers()):
        assert t.dtype in (torch.float32, torch.int64)
    for moments in state.optimizer.state.values():
        assert moments["exp_avg"].dtype == moments["exp_avg_sq"].dtype == torch.float32
    # gradients flowed: the parameters moved
    assert max(float((p.detach() - b).abs().max())
               for p, b in zip(model.parameters(), before)) > 0.0


def test_reference_loss_finite_too():
    state = create_train_state(_tiny_model("bfloat16"), 1e-3, 1e-5)
    metrics = make_train_step(state, TINY, loss="reference")(*_batch(seed=3))
    assert np.isfinite(float(metrics["loss"]))


def test_gains_close_to_f32_on_shared_weights():
    f32 = _tiny_model("float32", for_training=False)
    b16 = _tiny_model("bfloat16", for_training=False)
    b16.load_state_dict(f32.state_dict())
    feats = spectrogram_features(_batch(b=2, seed=7)[0], TINY)
    with torch.no_grad():
        g32, g16 = f32.gains(feats), b16.gains(feats)
    assert g16.dtype == torch.float32  # the heads' output is cast back
    # ~0.4 absolute is the bf16 floor on +-100 dB inputs (tests/test_bf16.py)
    np.testing.assert_allclose(g16.numpy(), g32.numpy(), atol=0.5)
    assert float((g16 - g32).abs().max()) > 0.0  # genuinely the bf16 path


@pytest.mark.parametrize("name", ["scalar2s", "scalar2sL", "resnet18"])
def test_bf16_gains_follow_jax(name):
    ft = (72, 72)
    x = (20.0 * np.random.default_rng(0).standard_normal((4, 4, *ft)) - 40.0).astype(np.float32)
    j32 = jax_build_model(dataclasses.replace(jax_preset(name), compute_dtype="float32"))
    j16 = jax_build_model(dataclasses.replace(jax_preset(name), compute_dtype="bfloat16"))
    variables = jax.jit(lambda k, a: j32.init(k, a, train=False))(jax.random.key(0), x)
    jg32 = np.asarray(j32.apply(variables, x, train=False)[1])
    jg16 = np.asarray(j16.apply(variables, x, train=False)[1])
    model = build_model(dataclasses.replace(preset(name), compute_dtype="bfloat16"), in_shape=ft)
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    with torch.no_grad():
        g16 = model.gains(torch.from_numpy(x))
    # the heads emit in bf16, as JAX's do: every gain is a bf16 value
    assert g16.dtype == torch.float32
    assert torch.equal(g16, g16.to(torch.bfloat16).to(torch.float32))
    np.testing.assert_array_equal(jg16, jg16.astype(jax.numpy.bfloat16).astype(np.float32))
    g16 = g16.numpy()
    gap = np.abs(g16 - jg16).max()
    assert gap <= max(np.abs(g16 - jg32).max(), np.abs(jg16 - jg32).max()), gap
    if name != "resnet18":
        assert gap <= 2.0**-6 * np.abs(jg32).max(), gap
