"""Train state and the waveform-in train / eval steps (tpumix/train/state.py).

Parity contract: the reference training semantics (reference
model_trainer.py:25-44 and training.ipynb cell 11) — per-batch
``MSE(masked, gt_spectrogram)`` with Adam(lr, weight_decay=1e-5) where weight
decay is torch-style *coupled* L2 on every parameter — plus dropout and
batch-norm running-stat updates, and tpumix's further objectives.

PyTorch idiom.  The state is the ``nn.Module``, a ``torch.optim.Adam`` and an
update count (:class:`TrainState`); a step is a plain function
``(stems, mix, generator) -> metrics`` that updates the state **in place**.
The step takes raw waveform batches ``(stems [B, 4, S], mix [B, S])``, float32
or a quantised wire format, and computes all 5*B spectrograms on the device
through the configured frontend.  The frontend sits outside the differentiated
part, as in tpumix (gradients are with respect to parameters only), so the
features are computed without a graph.

Random streams: augmentation draws from the ``torch.Generator`` a step is
given (tpumix: a PRNG key).  Dropout masks come from torch's global generator
of the model's device (``nn.Dropout`` takes none); seed it with
``torch.manual_seed`` for a reproducible run.  Neither stream can match JAX's
bit for bit.

Data parallelism.  A step built with ``mesh`` (tpumix_torch/parallel/mesh.py)
runs on each rank of the mesh's ``dp_axis`` with that rank's rows of the
global batch and reduces wherever the JAX step, under GSPMD, reduces over the
global batch: BatchNorm normalises over it, the gradients are averaged, the
``coherent`` denominator and ``lstsq_tail_cm``'s common mode are global
means, augmentation draws the global batch's gains, and ``loss`` and
``mean_gain`` are global means.  So an N-rank step is the one-process step on
the global batch, up to the order of float32 sums.  Dropout stays per rank.

Frame-axis ("sequence") sharding.  :func:`make_train_step` with ``sp_axis``
(a ``dp x sp`` mesh) also splits the trunk's frame axis over the ``sp``
ranks of each ``dp`` group (tpumix_torch/parallel/frames.py): each computes
the features and trunk over the frames its conv5 columns need, BatchNorm
normalises over the whole ``dp x sp`` group on a partition of each layer's
frames, the heads' partial dots and the frame-summed losses are summed over
``sp``, and the gradients are summed over ``sp`` and averaged over ``dp``:
still the one-process step on the global batch.  The scalar models only.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Union

import torch
import torch.nn as nn

from tpumix_torch.config import FrontendConfig
from tpumix_torch.infer.mixer import _dequantize_on_device
from tpumix_torch.models.blocks import use_global_batchnorm
from tpumix_torch.ops.gain import augment_audio
from tpumix_torch.ops.stft import spectrogram_features
from tpumix_torch.ops.gain import spectral_mix
from tpumix_torch.parallel.frames import FrameShard, frame_features
from tpumix_torch.parallel.mesh import MeshAxis, average_gradients

_LN10 = 2.302585092994046

Schedule = Callable[[int], float]


@dataclasses.dataclass
class TrainState:
    """What a step updates: the model (parameters and BN running statistics),
    the optimizer (Adam moments) and the count of updates taken.
    ``lr_schedule`` maps that count to the learning rate of the next update;
    None keeps the optimizer's own."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    lr_schedule: Optional[Schedule] = None


def cosine_decay_schedule(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """``optax.cosine_decay_schedule``: ``init * ((1 - alpha) * 0.5 * (1 +
    cos(pi * min(count, decay_steps) / decay_steps)) + alpha)``, evaluated at
    the update count starting from 0."""
    if decay_steps <= 0:
        raise ValueError("cosine_decay_schedule needs a positive decay_steps")

    def schedule(count: int) -> float:
        frac = min(count, decay_steps) / decay_steps
        return init_value * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * frac)) + alpha)

    return schedule


def adam_with_l2(params, learning_rate: Union[float, Schedule],
                 weight_decay: float) -> torch.optim.Adam:
    """tpumix's ``adam_with_l2``, which is ``torch.optim.Adam(weight_decay=wd)``:
    ``grad += wd * param`` BEFORE the Adam moment updates (coupled L2, not
    AdamW), on every parameter, BN scale and bias included.  With a schedule
    the rate is set per update by the step (:class:`TrainState.lr_schedule`);
    the optimizer starts at ``schedule(0)``."""
    lr = learning_rate(0) if callable(learning_rate) else learning_rate
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay)


def create_train_state(model: nn.Module, learning_rate: Union[float, Schedule],
                       weight_decay: float) -> TrainState:
    """State for ``model`` as it stands (move it to its device first: the
    optimizer keeps its moments beside the parameters)."""
    return TrainState(
        model=model,
        optimizer=adam_with_l2(model.parameters(), learning_rate, weight_decay),
        lr_schedule=learning_rate if callable(learning_rate) else None,
    )


def _apply_update(state: TrainState) -> None:
    """One optimizer update from the gradients in place, at the scheduled rate."""
    if state.lr_schedule is not None:
        lr = state.lr_schedule(state.step)
        for group in state.optimizer.param_groups:
            group["lr"] = lr
    state.optimizer.step()
    state.step += 1


def _roundtrip_masked_db(feats_db: torch.Tensor, gains: torch.Tensor, amin: float) -> torch.Tensor:
    """Amplitude-consistent predicted mix spectrogram: the predicted scalar
    gains pass through the REFERENCE INFERENCE MAP ``10**(0.5*g)``
    (inference_utils.py:129), scale the stems' *amplitude* spectrograms, sum,
    and return to dB, so training supervises exactly the quantity inference
    applies."""
    amp = torch.pow(10.0, 0.5 * gains)  # [B, 4]
    feats_amp = torch.exp(feats_db * (_LN10 / 20.0))  # true dB->amplitude inverse
    mix_amp = torch.einsum("bsft,bs->bft", feats_amp, amp)
    return (20.0 / _LN10) * torch.log(torch.clamp(mix_amp, min=amin))


def make_frontend_fn(frontend: FrontendConfig) -> Callable:
    """Differentiable frontend ``[..., S] -> [..., F, T]``: for a fused
    implementation its hybrid (kernel forward, ``"fft"``-path backward: the
    raw kernels have no autograd rule), the ``torch.stft`` path otherwise."""

    def _features(x: torch.Tensor) -> torch.Tensor:
        impl = frontend.resolved_implementation()
        if impl == "pallas":
            from tpumix_torch.ops.stft_basis import stft_features_tm_hybrid

            return stft_features_tm_hybrid(x, frontend).transpose(-1, -2)
        if impl == "ct_pallas":
            from tpumix_torch.ops.stft_ct import stft_features_ct_tm_hybrid

            return stft_features_ct_tm_hybrid(x, frontend).transpose(-1, -2)
        if impl == "dif_pallas":
            from tpumix_torch.ops.stft_dif import stft_features_dif_tm_hybrid

            return stft_features_dif_tm_hybrid(x, frontend).transpose(-1, -2)
        return spectrogram_features(x, frontend)

    return _features


def _dp(mesh, dp_axis: Optional[str], model: Optional[nn.Module] = None
        ) -> Optional[MeshAxis]:
    """The mesh's data-parallel axis (None without a mesh).  For a train step
    (``model`` given) its BatchNorm layers normalise over that axis's global
    batch from here on."""
    if mesh is None or dp_axis is None:
        return None
    axis = mesh.axis(dp_axis)
    if model is not None:
        use_global_batchnorm(model, axis)
    return axis


def _sp(mesh, dp_axis: Optional[str], sp_axis: str, model: nn.Module):
    """``(dp axis or None, sp axis, the dp x sp group)`` of a frame-sharded
    step; the model's BatchNorm layers normalise over the whole group."""
    if mesh is None:
        raise ValueError(f"sp_axis={sp_axis!r} needs a mesh")
    if not hasattr(model, "frame_shard"):
        raise ValueError(f"sp_axis: {type(model).__name__} has no frame-sharded trunk "
                         "(the scalar models have)")
    dp = mesh.axis(dp_axis) if dp_axis is not None else None
    group = mesh.axes(dp_axis, sp_axis)
    use_global_batchnorm(model, group)
    return dp, mesh.axis(sp_axis), group


def _global_mean(x: torch.Tensor, axis: Optional[MeshAxis]) -> torch.Tensor:
    """The mean over the global batch of a per-rank mean over equal shards,
    as data (no autograd)."""
    return x if axis is None else axis.mean(x)


def _gain_loss_backward_update(state: TrainState, feats: torch.Tensor, loss_of: Callable,
                               axis: Optional[MeshAxis] = None,
                               grad_axis: Optional[MeshAxis] = None) -> Dict[str, torch.Tensor]:
    """Shared tail of every train step: forward in training mode, the loss
    from ``loss_of(model, feats) -> (value, gains)``, backward, the gradients
    averaged over ``axis`` (with ``grad_axis``, a ``dp x sp`` group: summed
    over it and divided by the ``dp`` size), one update; metrics are global
    means over ``axis``."""
    state.model.train()
    state.optimizer.zero_grad(set_to_none=True)
    value, gains = loss_of(state.model, feats)
    value.backward()
    if grad_axis is not None:
        average_gradients(state.model.parameters(), grad_axis,
                          divisor=1 if axis is None else axis.size)
    elif axis is not None:
        average_gradients(state.model.parameters(), axis)
    _apply_update(state)
    return {"loss": _global_mean(value.detach(), axis),
            "mean_gain": _global_mean(gains.detach().mean(), axis)}


def make_gain_train_step(state: TrainState, frontend: FrontendConfig, mesh=None,
                         dp_axis: Optional[str] = "dp") -> Callable:
    """Label-supervised train step for generators that know the true gains:
    ``(stems [B,4,S], g_true [B,4], generator) -> metrics`` with ``loss =
    MSE(predicted_gains, g_true)`` in the model-scalar domain.  No reference
    analogue: the reference's corpora carry no gain labels.  ``mesh``: see
    the module docstring."""
    _features = make_frontend_fn(frontend)
    axis = _dp(mesh, dp_axis, state.model)

    def step(stems: torch.Tensor, g_true: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            feats = _features(_dequantize_on_device(stems))  # [B, 4, F, T]

        def loss_of(model, feats):
            gains = model.gains(feats)
            return torch.mean(torch.square(gains - g_true)), gains

        metrics = _gain_loss_backward_update(state, feats, loss_of, axis)
        # gain RMS error in true dB (scalar domain x10) is the interpretable metric
        metrics["gain_rmse_db"] = 10.0 * torch.sqrt(metrics["loss"])
        return metrics

    return step


def make_gain_eval_step(state: TrainState, frontend: FrontendConfig, mesh=None,
                        dp_axis: Optional[str] = "dp") -> Callable:
    """Eval twin of :func:`make_gain_train_step` (running BN stats, no
    dropout): ``(stems, g_true) -> loss``, with ``mesh`` the global batch's."""
    _features = make_frontend_fn(frontend)
    axis = _dp(mesh, dp_axis)

    @torch.no_grad()
    def step(stems: torch.Tensor, g_true: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        gains = state.model.gains(_features(_dequantize_on_device(stems)))
        return _global_mean(torch.mean(torch.square(gains - g_true)), axis)

    return step


#: losses make_train_step/make_eval_step understand.  "gain" is deliberately
#: NOT here: it needs generator labels (make_gain_train_step) — accepting it
#: silently would train the "reference" objective instead.  The magnitude
#: objectives ("reference", "roundtrip") cannot identify per-stem gains;
#: "coherent" supervises the same pairs in the waveform domain; the "lstsq"
#: family supervises closed-form per-item gain targets (tpumix/train/state.py
#: has the measured history of each).
SELF_SUPERVISED_LOSSES = (
    "reference", "roundtrip", "coherent", "lstsq", "lstsq_tail", "lstsq_tail_cm"
)


def _is_lstsq(loss: str) -> bool:
    """The closed-form-target objective family (shared dispatch)."""
    return loss in ("lstsq", "lstsq_tail", "lstsq_tail_cm")


def _solve_amp(regs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Batched regularised least squares: ``argmin_a ||a . regs - target||^2``.

    :param regs: ``[B, R, T]`` regressor waveforms; :param target: ``[B, T]``.
    :return: ``[B, R]`` coefficients (finite-guarded, NOT clamped/log-mapped).

    Tikhonov jitter scaled to the Gram diagonal keeps near-silent or
    collinear regressors solvable.  The relative term vanishes when ALL
    regressors in an item are silent (gram == 0, e.g. a song intro/outro
    window), which would make the solve singular and poison the batch loss —
    the absolute floor keeps the system nonsingular there, and the
    finite-guard catches any residual pathology.  ``solve_ex`` neither raises
    nor waits for the device on a singular item.
    """
    gram = torch.einsum("bst,but->bsu", regs, regs)  # [B, R, R]
    rhs = torch.einsum("bst,bt->bs", regs, target)  # [B, R]
    R = regs.shape[1]
    diag_mean = torch.diagonal(gram, dim1=1, dim2=2).mean(dim=1)[:, None, None]
    jitter = (1e-6 * diag_mean + 1e-12) * torch.eye(R, device=regs.device, dtype=regs.dtype)
    amp, _ = torch.linalg.solve_ex(gram + jitter, rhs[..., None])
    amp = amp[..., 0]
    return torch.where(torch.isfinite(amp), amp, torch.full_like(amp, 1e-3))


def _amp_to_gain(amp: torch.Tensor) -> torch.Tensor:
    """Amplitude -> model-scalar domain through the inverse of the reference
    inference map (``amp = 10**(0.5 g)``); negative / tiny solutions clamp to
    a quiet floor before the log map."""
    return 2.0 * torch.log10(torch.clamp(amp, min=1e-3))


def _lstsq_gain_targets(stems: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
    """Per-item closed-form mixing gains: ``argmin_a || sum_s a_s stem_s -
    mix ||^2`` via the 4x4 normal equations, mapped to the model-scalar
    domain.  ``[B, S, T]``, ``[B, T]`` -> ``[B, S]``."""
    return _amp_to_gain(_solve_amp(stems, mix))


def _lstsq_tail_gain_targets(stems: torch.Tensor, mix: torch.Tensor, n_taps: int = 8,
                             dmin: int = 60, dmax: int = 1200) -> torch.Tensor:
    """Tail-robust closed-form gains: the plain lstsq solve plus a data-driven
    comb-tail term that absorbs mix-bus reverb instead of biasing the gains.

    1. plain solve -> gain-weighted stem sum ``wsum`` and residual ``mix -
       wsum`` (on a clean gain-sum mix the residual is ~0 and this whole path
       degenerates to plain lstsq);
    2. estimate the tail's tap spacing ``d`` per item as the argmax of
       xcorr(residual, wsum) over [dmin, dmax) (FFT form), with a subharmonic
       correction (halve while the half-lag peak holds >= 40% of the picked
       peak);
    3. re-solve with regressors ``{stem_s} + {wsum delayed by k*d,
       k=1..n_taps}`` and take the DIRECT coefficients as the gain targets.

    When xcorr is non-positive over the whole band there is no comb evidence
    (argmax lands on the zeroed sub-dmin region, d = 0, and every "delayed"
    regressor would be a copy of wsum): such items fall back to the
    plain-lstsq targets.  ``[B, S, T]``, ``[B, T]`` -> ``[B, S]``."""
    B, S, T = stems.shape
    amp0 = _solve_amp(stems, mix)  # [B, S]
    wsum = torch.einsum("bst,bs->bt", stems, torch.clamp(amp0, min=1e-3))
    resid = mix - wsum

    # xcorr over positive lags via FFT; next power of two >= T + dmax keeps
    # the circular wrap out of the probed window
    n = 1 << int(math.ceil(math.log2(T + dmax)))
    xc = torch.fft.irfft(
        torch.fft.rfft(resid, n) * torch.conj(torch.fft.rfft(wsum, n)), n
    )[:, :dmax]
    lags = torch.arange(dmax, device=stems.device)
    xc = torch.where(lags[None, :] >= dmin, xc, torch.zeros_like(xc))
    d = torch.argmax(xc, dim=1)  # [B]
    peak = torch.gather(xc, 1, d[:, None])[:, 0]
    for _ in range(4):  # dmax/dmin < 2**5 — 4 halvings reach the floor
        half = d // 2
        half_peak = torch.gather(xc, 1, half[:, None])[:, 0]
        take = (half >= dmin) & (half_peak > 0.4 * peak)
        d = torch.where(take, half, d)
        peak = torch.where(take, half_peak, peak)
    no_comb = peak <= 0.0  # [B]

    t_idx = torch.arange(T, device=stems.device)[None, :]
    tails = []
    for k in range(1, n_taps + 1):
        idx = t_idx - k * d[:, None]  # [B, T]
        tails.append(torch.gather(wsum, 1, idx.clamp(0, T - 1)) * (idx >= 0))
    regs = torch.cat([stems, torch.stack(tails, dim=1)], dim=1)
    amp = torch.where(no_comb[:, None], amp0, _solve_amp(regs, mix)[:, :S])
    return _amp_to_gain(amp)


def _coherent_loss(stems: torch.Tensor, mix: torch.Tensor, gains: torch.Tensor,
                   axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """Waveform-domain self-supervision: predicted gains through the
    reference inference map scale the stem WAVEFORMS; the coherent sum must
    reproduce the mix.  Normalised by mix power, the global batch's with
    ``axis`` (it does not depend on the parameters).  ONE definition shared
    by train and eval steps so early stopping judges exactly the objective
    training optimised."""
    amp = torch.pow(10.0, 0.5 * gains)  # [B, S]
    mix_pred = torch.einsum("bst,bs->bt", stems, amp)
    power = _global_mean(torch.mean(torch.square(mix)), axis)
    return torch.mean(torch.square(mix_pred - mix)) / (power + 1e-8)


def _lstsq_loss(stems: torch.Tensor, mix: torch.Tensor, gains: torch.Tensor,
                tail: bool = False, recenter_cm: bool = False,
                axis: Optional[MeshAxis] = None) -> torch.Tensor:
    """MSE against the closed-form per-item gain targets (shared by train
    and eval; the targets are data, computed without a graph).  ``tail=True``
    selects the tail-robust solve; ``recenter_cm=True`` replaces each item's
    common mode (mean over stems) with the batch mean, the global batch's
    with ``axis``."""
    with torch.no_grad():
        targets = _lstsq_tail_gain_targets if tail else _lstsq_gain_targets
        g_star = targets(stems, mix)
        if recenter_cm:
            cm = torch.mean(g_star, dim=1, keepdim=True)  # [B, 1]
            g_star = g_star - cm + _global_mean(torch.mean(cm), axis)
    return torch.mean(torch.square(gains - g_star))


def _check_loss(loss: str) -> None:
    if loss not in SELF_SUPERVISED_LOSSES:
        hint = (
            " ('gain' is label-supervised — use make_gain_train_step)" if loss == "gain" else ""
        )
        raise ValueError(
            f"unknown loss {loss!r}; expected one of {SELF_SUPERVISED_LOSSES}{hint}"
        )


def _objective(loss: str, frontend: FrontendConfig, _features: Callable,
               axis: Optional[MeshAxis] = None) -> Callable:
    """``(model, feats, stems, mix, shard=None) -> (loss value, gains)`` for
    one of :data:`SELF_SUPERVISED_LOSSES`; one definition behind the train
    and the eval step.  The value is this rank's mean, its global statistics
    those of ``axis``'s global batch.  The waveform-domain objectives never
    compute the mix's spectrogram.  With a :class:`FrameShard` the features
    are this ``sp`` rank's frames, and the spectrogram objectives sum over
    its owned frames, then over ``sp``."""

    def objective(model, feats, stems, mix, shard: Optional[FrameShard] = None):
        if shard is not None:
            gains = model.gains(feats, shard=shard)
        if loss == "coherent":
            gains = gains if shard is not None else model.gains(feats)
            return _coherent_loss(stems, mix, gains, axis), gains
        if _is_lstsq(loss):
            gains = gains if shard is not None else model.gains(feats)
            return _lstsq_loss(stems, mix, gains, tail=loss != "lstsq",
                               recenter_cm=loss == "lstsq_tail_cm", axis=axis), gains
        if shard is not None:
            return _sharded_spectral_loss(loss, frontend, _features, feats, mix, gains, shard)
        with torch.no_grad():
            gt = _features(mix)
        if loss == "roundtrip":
            gains = model.gains(feats)
            masked = _roundtrip_masked_db(feats, gains, frontend.amin)
        else:
            masked, gains = model(feats)
        return torch.mean(torch.square(masked - gt)), gains

    return objective


def _sharded_spectral_loss(loss: str, frontend: FrontendConfig, _features: Callable,
                           feats: torch.Tensor, mix: torch.Tensor, gains: torch.Tensor,
                           shard: FrameShard):
    """``reference`` / ``roundtrip`` on a frame-sharded step: this rank's sum
    of squared errors over its owned feature frames, over the global count,
    summed over ``sp``.  Each rank's part reaches the gains through
    :meth:`MeshAxis.grad_sum`, so every rank's gains get the gradient of the
    whole sum."""
    lo, own_hi = shard.owned_features
    own, width = shard.owned(0)
    with torch.no_grad():
        gt = frame_features(_features, mix, frontend, lo, own_hi)
    feats = feats[..., :own]
    g = shard.axis.grad_sum(gains)
    if loss == "roundtrip":
        masked = _roundtrip_masked_db(feats, g, frontend.amin)
    else:
        masked = spectral_mix(feats, g)
    part = torch.sum(torch.square(masked - gt)) / (masked.shape[0] * masked.shape[1] * width)
    return shard.axis.sum_identity_grad(part), gains


def make_train_step(state: TrainState, frontend: FrontendConfig, augment: bool = False,
                    augment_mix: bool = True, loss: str = "reference", mesh=None,
                    dp_axis: Optional[str] = "dp", sp_axis: Optional[str] = None) -> Callable:
    """Build the waveform-in train step: ``(stems [B,4,S], mix [B,S],
    generator) -> metrics`` (``loss`` and ``mean_gain`` as device scalars);
    it updates ``state`` in place.

    ``augment_mix`` (default True = reference parity): when augmenting, the
    ground-truth mix also receives an independent random gain, exactly like
    the reference's per-track loop (data/dataset.py:185-199).  Set False to
    keep the supervision target clean.

    ``loss``: ``"reference"`` — MSE between the model's dB-linear masked sum
    and the mix spectrogram (reference model_trainer.py:25-44);
    ``"roundtrip"`` — the same through :func:`_roundtrip_masked_db`;
    ``"coherent"``, ``"lstsq"``, ``"lstsq_tail"``, ``"lstsq_tail_cm"`` — the
    waveform-domain objectives above.

    ``mesh``: the step runs on each rank of its ``dp_axis`` with that rank's
    rows of the global batch (module docstring); with ``sp_axis`` each rank
    of that axis also takes its part of the frame axis (the scalar models;
    the module docstring)."""
    _check_loss(loss)
    if sp_axis is not None:
        axis, sp, group = _sp(mesh, dp_axis, sp_axis, state.model)
    else:
        axis, sp, group = _dp(mesh, dp_axis, state.model), None, None
    _features = make_frontend_fn(frontend)
    objective = _objective(loss, frontend, _features, axis)

    def step(stems: torch.Tensor, mix: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            # quantised wire formats dequantise on the device (int16 PCM,
            # int8 mu-law — the mixer's decode)
            stems = _dequantize_on_device(stems)
            mix = _dequantize_on_device(mix)
            if augment:
                # independent random gains per (batch, stem) and, with
                # augment_mix, per batch item for the mix
                stems = augment_audio(stems, generator, axis=axis)
                if augment_mix:
                    mix = augment_audio(mix, generator, axis=axis)
            shard = None
            if sp is None:
                feats = _features(stems)  # [B, 4, F, T]
            else:
                shard = state.model.frame_shard(frontend.num_frames(stems.shape[-1]), sp,
                                                1 if axis is None else axis.size)
                feats = frame_features(_features, stems, frontend, *shard.features)
        return _gain_loss_backward_update(
            state, feats, lambda model, feats: objective(model, feats, stems, mix, shard), axis,
            group)

    return step


def make_eval_step(state: TrainState, frontend: FrontendConfig, loss: str = "reference",
                   mesh=None, dp_axis: Optional[str] = "dp") -> Callable:
    """Eval step: ``(stems, mix) -> loss`` with running BN stats and no
    dropout (reference _validate_epoch, model_trainer.py:14-23); it changes
    nothing in ``state``.  Features come from the SAME frontend factory as
    :func:`make_train_step`, so early stopping judges exactly the features
    training saw.  With ``mesh`` the loss is the global batch's."""
    _check_loss(loss)
    axis = _dp(mesh, dp_axis)
    _features = make_frontend_fn(frontend)
    objective = _objective(loss, frontend, _features, axis)

    @torch.no_grad()
    def step(stems: torch.Tensor, mix: torch.Tensor) -> torch.Tensor:
        state.model.eval()
        stems = _dequantize_on_device(stems)
        mix = _dequantize_on_device(mix)
        value, _ = objective(state.model, _features(stems), stems, mix)
        return _global_mean(value, axis)

    return step


def make_feature_train_step(state: TrainState) -> Callable:
    """Feature-input variant for precomputed-feature pipelines (reference
    ``compute_features=False`` path, data/dataset.py:253-268):
    ``(feats [B,4,F,T], gt [B,F,T], generator) -> metrics``."""

    def step(feats: torch.Tensor, gt: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        def loss_of(model, feats):
            masked, gains = model(feats)
            return torch.mean(torch.square(masked - gt)), gains

        return _gain_loss_backward_update(state, feats, loss_of)

    return step
