"""The port's synthetic data engine (``tpumix_torch/data/synthetic.py``)
against the JAX package's, on the CPU at small shapes (B <= 4, n <= 4096).

* The host twin is a copy: ``make_synth_song`` equal to JAX's on the same
  seeds (with and without a bus), ``write_synth_dataset`` byte-equal file by
  file, ``mix_bus``'s numpy branch equal to JAX's numpy branch.
* ``mix_bus`` on torch against ``jnp`` on the same float32 input, per kind.
* The device generator cannot share JAX's random stream, so it is split:
  ``synth_render`` fed the draws JAX makes from ``jax.random.split(key, 15)``
  (rebuilt here as tpumix/data/synthetic.py:244-314 draws them) is held to
  JAX's ``synth_chunk_batch`` on the same key.

Tolerances (float32 throughout in both).  Tones: ``sin`` of the same float32
argument agrees to an ulp or two; the stems then pass through two RMS
normalisations (sums in different orders) and the 'other' stem through two
moving averages formed as differences of float32 cumulative sums over the
whole context, whose rounding is ~1e-7 of the running sum.  Measured over
the 20 cases below: max |d| 3.6e-6 on stems and 4.8e-6 on the mix (peaks
0.55-2.7), so atol 1e-5.  The compressor's envelope is ``log10`` of such a
window sum: ``mix_bus`` alone sits 3.9e-7 from jnp.  The labels are a few
float32 operations on the same levels: bit-equal here, atol 1e-6.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpumix.data import synthetic as jsyn
from tpumix_torch.data import synthetic as syn

SR = 8000
BUS = (None, "reverb", "comp", "limiter", "full")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's tests: the suite runs several
    test processes side by side, and torch's default of a thread per core in
    each makes small CPU ops wait on one another many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def jax_draws(key, B, n, context_mult=1, level_shift_db=None):
    """The draws of JAX's ``synth_chunk_batch(key, B, n, ...)``, key by key,
    as the port's ``synth_draws`` names them."""
    k = jax.random.split(key, 15)
    n_ctx = n * max(int(context_mult), 1)
    two_pi = 2.0 * jnp.pi

    def u(key, lo, hi, shape=(B, 1)):
        return jax.random.uniform(key, shape, minval=lo, maxval=hi)

    d = {
        "n_win": n, "f0": u(k[0], 50.0, 120.0), "ph": u(k[1], 0.0, two_pi, (B, 3)),
        "fam": u(k[2], 0.1, 0.5), "period": u(k[3], 0.3, 0.7), "decay": u(k[4], 8.0, 20.0),
        "off": u(k[5], 0.0, 1.0), "dnoise": jax.random.normal(k[6], (B, n_ctx)),
        "fv": u(k[7], 200.0, 500.0), "fe": u(k[8], 0.2, 0.6),
        "onoise": jax.random.normal(k[9], (B, n_ctx)),
        "u_db": jax.random.uniform(k[10], (B, 4), minval=jsyn.PRESENT_DB[0],
                                   maxval=jsyn.PRESENT_DB[1]),
        "beds": jax.random.normal(k[11], (B, 4, n_ctx)),
        "shift": None if level_shift_db is None else u(k[13], *level_shift_db),
        "win_off": None if n_ctx == n else jax.random.randint(k[12], (B,), 0, n_ctx - n + 1),
    }
    return {name: v if v is None or isinstance(v, int) else torch.from_numpy(np.array(v))
            for name, v in d.items()}


CASES = [(cm, shift, bus) for cm in (1, 4) for shift in (None, (-14.0, 2.0)) for bus in BUS]


@pytest.mark.parametrize("cm,shift,bus", CASES,
                         ids=[f"ctx{c}-{'shift' if s else 'noshift'}-{b}" for c, s, b in CASES])
def test_render_on_jax_draws_matches_jax_generator(cm, shift, bus):
    key, B, n = jax.random.key(11), 3, 4096 // cm
    js, jm, jg = jsyn.synth_chunk_batch(key, B, n, sr=SR, return_gains=True, context_mult=cm,
                                        level_shift_db=shift, mix_bus_kind=bus)
    s, m, g = syn.synth_render(jax_draws(key, B, n, cm, shift), SR, return_gains=True,
                               mix_bus_kind=bus)
    assert s.shape == (B, 4, n) and m.shape == (B, n) and g.shape == (B, 4)
    assert s.dtype == m.dtype == g.dtype == torch.float32
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=0, atol=1e-5)
    np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=0, atol=1e-5)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0, atol=1e-6)
    # without labels the same two arrays
    s2, m2 = syn.synth_render(jax_draws(key, B, n, cm, shift), SR, mix_bus_kind=bus)
    assert torch.equal(s2, s) and torch.equal(m2, m)


def test_synth_chunk_batch_is_reproducible_and_labels_reconstruct_the_mix():
    def batch(seed, **kw):
        return syn.synth_chunk_batch(torch.Generator().manual_seed(seed), 4, 2048, sr=SR,
                                     return_gains=True, **kw)

    a, b, c = batch(3), batch(3), batch(4)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], c[1])
    # the labels are exact on the clean family: sum_s 10**(0.5 g_s) stem_s == mix
    # (tests/test_train.py:445-452's check of the JAX generator)
    for stems, mix, g in (a, batch(5, context_mult=4, level_shift_db=(-14.0, 2.0))):
        recon = torch.einsum("bsn,bs->bn", stems, 10.0 ** (0.5 * g))
        np.testing.assert_allclose(recon.numpy(), mix.numpy(), rtol=1e-4, atol=1e-5)
    # the draws: JAX's ranges and the window inside the context
    d = syn.synth_draws(torch.Generator().manual_seed(0), 64, 100, context_mult=4,
                        level_shift_db=(-14.0, 2.0))
    assert d["dnoise"].shape == (64, 400) and d["beds"].shape == (64, 4, 400)
    assert float(d["f0"].min()) >= 50.0 and float(d["f0"].max()) <= 120.0
    assert float(d["u_db"].min()) >= -26.0 and float(d["u_db"].max()) <= -14.0
    assert float(d["shift"].min()) >= -14.0 and float(d["shift"].max()) <= 2.0
    assert int(d["win_off"].min()) >= 0 and int(d["win_off"].max()) <= 300


@pytest.mark.parametrize("kind", jsyn.BUS_KINDS)
def test_mix_bus_matches_jax(kind):
    x = (0.3 * np.random.default_rng(1).standard_normal((2, 3000))).astype(np.float32)
    # numpy branch: the host twin's, exactly
    np.testing.assert_array_equal(syn.mix_bus(x, SR, kind), jsyn.mix_bus(x, SR, kind))
    # torch against jnp, float32 both (see the module docstring)
    got = syn.mix_bus(torch.from_numpy(x), SR, kind)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jsyn.mix_bus(jnp.asarray(x), SR, kind)),
                               rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="unknown mix_bus kind"):
        syn.mix_bus(x, SR, "tape")


def test_engineer_targets_match_jax():
    u = np.random.default_rng(2).uniform(-40, 0, (5, 4))
    np.testing.assert_array_equal(syn.engineer_targets_db(u), jsyn.engineer_targets_db(u))
    np.testing.assert_allclose(syn.engineer_targets_db(torch.from_numpy(u)).numpy(),
                               jsyn.engineer_targets_db(u), rtol=0, atol=1e-12)


@pytest.mark.parametrize("bus", [None, "full"])
def test_make_synth_song_equals_jax(bus):
    for seed in (0, 7):
        got = syn.make_synth_song(seed, duration_s=1.5, sr=SR, bus=bus)
        want = jsyn.make_synth_song(seed, duration_s=1.5, sr=SR, bus=bus)
        for g, w in zip(got[:2], want[:2]):
            assert g.keys() == w.keys()
            for k in g:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert got[2] == want[2]


@pytest.mark.parametrize("train_raw,bus", [(False, None), (True, "reverb")])
def test_write_synth_dataset_is_byte_equal(tmp_path, train_raw, bus):
    kw = dict(n_train=2, n_test=1, duration_s=1.0, sr=SR, seed=3, train_raw=train_raw, bus=bus)
    got = syn.write_synth_dataset(str(tmp_path / "port"), **kw)
    assert got == jsyn.write_synth_dataset(str(tmp_path / "jax"), **kw)
    assert syn.synth_songlist("synth_test_", 2) == ["synth_test_000", "synth_test_001"]
    files = []
    for dirpath, _, names in os.walk(tmp_path / "jax"):
        files += [os.path.relpath(os.path.join(dirpath, n), tmp_path / "jax") for n in names]
    assert len(files) == (2 + 2 * 1) * 5
    for rel in files:
        with open(tmp_path / "jax" / rel, "rb") as a, open(tmp_path / "port" / rel, "rb") as b:
            assert a.read() == b.read(), rel
