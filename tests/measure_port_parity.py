"""Measurements behind the parity tolerances of the port's tests, on the CPU.

    JAX_PLATFORMS=cpu python tests/measure_port_parity.py     # a few minutes

Not a test (pytest does not collect this file): it prints the numbers that
tests/test_torch_train_step.py (resnet18), tests/test_torch_bf16.py and
tests/test_torch_mixer.py state their bounds from.

1. ``drift``: resnet18's train step at test_torch_train_step.py's size.
   The JAX package against itself from a start whose parameters are scaled
   by ``1 + eps * N(0, 1)`` (eps 1e-6 and 1e-5, two draws), and the port
   against the JAX package from the same start: the share of parameters
   within 2e-5 after one step and within 3e-4 after three, the loss's
   relative gap and the mean gain's gap at step three.
2. ``bf16``: bf16 gains of both packages on the same weights at a 72 x 72
   input, three seeds: port against JAX, and each against its float32 gains.
3. ``direct``: the port's CPU ``mix_song_smooth`` against
   ``reference_mix_song_smooth`` on tests/test_infer.py's fixture: dB-scalar
   gain MAE and relative amplitude per stem.
4. ``division``: how many float32 samples of ``arange(352800) / 44100``
   change when the division is a product with the reciprocal (what CUDA
   does with a Python-scalar divisor).
"""

import dataclasses
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [_TESTS, os.path.dirname(_TESTS)]  # the tests' helpers, the repository

from test_torch_train_step import FT, KW, LR, WD, _batches  # noqa: E402
from tpumix.config import FrontendConfig as JaxFrontendConfig  # noqa: E402
from tpumix.config import preset as jax_preset  # noqa: E402
from tpumix.models.registry import build_model as jax_build_model  # noqa: E402
from tpumix.train import state as jax_state  # noqa: E402
from tpumix_torch.config import FrontendConfig, preset  # noqa: E402
from tpumix_torch.models.convert import state_dict_from_jax  # noqa: E402
from tpumix_torch.models.registry import build_model  # noqa: E402
from tpumix_torch.train import state as port_state  # noqa: E402


def _params(st):
    sd = state_dict_from_jax(jax.tree.map(np.asarray, {"params": st.params,
                                                       "batch_stats": st.batch_stats}))
    return {k: v for k, v in sd.items() if "running" not in k and "num_batches" not in k}


def _within(a, b, tol):
    d = torch.cat([(a[k] - b[k]).abs().flatten() for k in a])
    return float((d <= tol).float().mean())


def drift():
    data = _batches()
    for loss in ("reference", "lstsq"):
        jmodel = jax_build_model(dataclasses.replace(jax_preset("resnet18"), use_dropout=False),
                                 for_training=True)
        tx = jax_state.adam_with_l2(LR, WD)
        start = jax_state.create_train_state(jmodel, jax.random.key(0), (1, 4, *FT), tx)
        step = jax.jit(jax_state.make_train_step(jmodel, JaxFrontendConfig(**KW), tx, loss=loss))

        def run(st):
            out = []
            for stems, mix in (data[0], data[1], data[0]):
                st, m = step(st, jnp.asarray(stems), jnp.asarray(mix), jax.random.key(1))
                out.append((_params(st), float(m["loss"]), float(m["mean_gain"])))
            return out

        ref = run(start)
        model = build_model(dataclasses.replace(preset("resnet18"), use_dropout=False),
                            in_shape=FT, for_training=True)
        model.load_state_dict(state_dict_from_jax(jax.tree.map(
            np.asarray, {"params": start.params, "batch_stats": start.batch_stats})))
        state = port_state.create_train_state(model, LR, WD)
        pstep = port_state.make_train_step(state, FrontendConfig(**KW), loss=loss)
        port = []
        for stems, mix in (data[0], data[1], data[0]):
            m = pstep(torch.from_numpy(stems), torch.from_numpy(mix))
            port.append(({k: v.clone() for k, v in model.state_dict().items()
                          if k in ref[0][0]}, float(m["loss"]), float(m["mean_gain"])))
        rows = [("port", port)]
        for eps in (1e-6, 1e-5):
            for seed in (5, 6):
                rng = np.random.default_rng(seed)
                params = jax.tree.map(lambda p: p * (1 + eps * rng.standard_normal(p.shape)
                                                     .astype(np.float32)), start.params)
                rows.append((f"jax, eps {eps:g}, draw {seed}",
                             run(start.replace(params=params, opt_state=tx.init(params)))))
        for name, other in rows:
            print(f"[drift] resnet18 {loss}, {name}: step 1 within 2e-5 "
                  f"{_within(ref[0][0], other[0][0], 2e-5):.4f}; step 3 within 3e-4 "
                  f"{_within(ref[2][0], other[2][0], 3e-4):.4f}, loss gap "
                  f"{abs(other[2][1] - ref[2][1]) / abs(ref[2][1]):.4f}, mean gain gap "
                  f"{abs(other[2][2] - ref[2][2]):.4f}")


def bf16():
    for seed in (0, 1, 2):
        x = (20.0 * np.random.default_rng(seed).standard_normal((4, 4, 72, 72)) - 40.0
             ).astype(np.float32)
        for name in ("scalar1s", "scalar1sL", "scalar2s", "scalar2sL", "resnet18"):
            j32 = jax_build_model(dataclasses.replace(jax_preset(name), compute_dtype="float32"))
            j16 = jax_build_model(dataclasses.replace(jax_preset(name), compute_dtype="bfloat16"))
            variables = jax.jit(lambda k, a: j32.init(k, a, train=False))(jax.random.key(seed), x)
            g32 = np.asarray(j32.apply(variables, x, train=False)[1])
            jg16 = np.asarray(j16.apply(variables, x, train=False)[1])
            model = build_model(dataclasses.replace(preset(name), compute_dtype="bfloat16"),
                                in_shape=(72, 72))
            model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
            with torch.no_grad():
                g16 = model.gains(torch.from_numpy(x)).numpy()
            print(f"[bf16] seed {seed} {name}: port - jax {np.abs(g16 - jg16).max():.4f}; port - "
                  f"f32 {np.abs(g16 - g32).max():.4f}; jax - f32 {np.abs(jg16 - g32).max():.4f}; "
                  f"max |g| {np.abs(g32).max():.2f}")


def direct():
    from tpumix.models import MixingModelScalar1s as JaxScalar1s
    from tpumix.utils.reference_pipeline import build_torch_twin, reference_mix_song_smooth
    from tpumix_torch.infer.mixer import STEMS, SongMixer

    sr = 44100
    variables = JaxScalar1s().init(jax.random.key(0), np.zeros((1, 4, 1025, 87), np.float32),
                                   train=False)
    rng = np.random.default_rng(42)
    n = 14 * sr
    t = np.arange(n) / sr

    def shaped_noise(scale, smooth):
        return scale * np.convolve(rng.standard_normal(n), np.ones(smooth) / smooth, mode="same")

    song = {
        "bass": 0.4 * np.sin(2 * np.pi * 80 * t) + shaped_noise(0.1, 64),
        "drums": shaped_noise(0.3, 2) * (np.sin(2 * np.pi * 3 * t) > 0.3),
        "vocals": 0.3 * np.sin(2 * np.pi * 300 * t + np.sin(2 * np.pi * 2 * t))
        + shaped_noise(0.1, 16),
        "other": shaped_noise(0.2, 8),
    }
    song = {k: v.astype(np.float32) for k, v in song.items()}
    model = build_model(preset("scalar1s"))
    model.load_state_dict(state_dict_from_jax(jax.tree.map(np.asarray, variables)))
    _, raw, _ = SongMixer(model, preset("scalar1s"), device="cpu").mix_song_smooth(song)
    twin = build_torch_twin(variables["params"], variables["batch_stats"])
    _, ref, _ = reference_mix_song_smooth(twin, song, chunk_length=1.0, sr=sr, hop=512)
    for s in STEMS:
        a, b = np.asarray(raw[s]), np.asarray(ref[s])
        print(f"[direct] {s}: gain MAE {np.mean(np.abs(2 * np.log10(a) - 2 * np.log10(b))):.2e}, "
              f"relative amplitude {np.mean(np.abs(a - b) / np.abs(b)):.2e}")


def division():
    a = torch.arange(352800, dtype=torch.float32)
    true, product = a / torch.tensor(44100.0), a * (1.0 / 44100)
    print(f"[division] arange(352800) / 44100 in float32: {int((true != product).sum())} samples "
          "differ between the true division and the product with the reciprocal")


if __name__ == "__main__":
    torch.set_num_threads(1)  # as the tests that state these bounds run
    for name in sys.argv[1:] or ("drift", "bf16", "direct", "division"):
        globals()[name]()
