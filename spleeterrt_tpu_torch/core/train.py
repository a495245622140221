"""Training for the Spleeter U-Net (a capability the reference lacks).

The reference ships fixed pre-trained weights only (Executable/model.7z,
VST .dat blobs; no training code anywhere). This is the reference
package's training (spleeterrt_tpu/core/train.py) in PyTorch: per-stem L1
between `mask * |mix|` and the target stem magnitude, Adam after a clip to
global norm 1 (the reference package's `optax.chain(clip_by_global_norm,
adam)`), and a bias-corrected EMA of the params for deployment.

The loss runs the canonical route of core/model.py (each stem's
`unet_forward_nchw` in torch convolutions), whatever the routing switches
say: the hand kernels have no backward, and their wrappers raise on an
input that requires grad. Params stay float32 leaf tensors; the forward
casts them to the compute dtype, and only the final logits are float32.
Evaluation runs the real separation graph (core/separate.py), hand kernels
and all, under `torch.no_grad()` on detached params.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from spleeterrt_tpu_torch.config import STEM_MODE_4
from spleeterrt_tpu_torch.core import separate, transform
from spleeterrt_tpu_torch.core.model import Params, multi_stem_masks
from spleeterrt_tpu_torch.utils import metrics

ADAM_BETAS = (0.9, 0.999)  # optax.adam's defaults
ADAM_EPS = 1e-8
MAX_GRAD_NORM = 1.0  # the reference package's clip_by_global_norm(1.0)


@dataclass
class TrainState:
    params: Params  # stacked per-stem params: float32 leaves, requires_grad
    optimizer: torch.optim.Adam  # over `param_leaves(params)`
    step: int
    ema_params: Params | None = None  # EMA shadow (deployment weights)


def param_leaves(params: Params) -> list[torch.Tensor]:
    """The leaves of a params dict in one fixed order, (layer, field) by
    name: the optimizer's parameter order, so a checkpoint restores into
    any state whose dicts hold the same keys in another order."""
    return [params[ln][fn] for ln in sorted(params) for fn in sorted(params[ln])]


def separation_loss(
    stacked_params: Params,
    mix_mag: torch.Tensor,  # (B, T, F, 2)
    target_mags: torch.Tensor,  # (S, B, T, F, 2)
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.bfloat16,
    active: torch.Tensor | None = None,  # (S, B) 0/1 weights
) -> torch.Tensor:
    """L1(mask * |mix|, |stem|) averaged over stems.

    `active` (S, B) zeroes the crops of silent stems (all-zero targets, see
    data/dataset.py::stem_activity), so a corpus with sparse stems doesn't
    teach the masks to collapse to zero."""
    mix = mix_mag.permute(0, 3, 1, 2).contiguous()  # NCHW, as the nets take it
    masks = multi_stem_masks(
        stacked_params, mix, stem_mode, compute_dtype, "exact",
        pallas_head=False, pallas_encoder=False,
    )  # (S, B, 2, T, F) float32
    est = masks * mix[None].to(masks.dtype)
    err = (est - target_mags.permute(0, 1, 4, 2, 3).to(masks.dtype)).abs()
    if active is None:
        return err.mean()
    per = err.mean(dim=tuple(range(2, err.ndim)))  # (S, B)
    w = active.to(per.dtype)
    return (per * w).sum() / w.sum().clamp(min=1.0)


def trainable(params: Params) -> Params:
    """Float32 leaf copies of `params` that require grad."""
    return {
        ln: {fn: v.detach().float().clone().requires_grad_(True)
             for fn, v in ly.items()}
        for ln, ly in params.items()
    }


def _detached_copy(params: Params) -> Params:
    return {ln: {fn: v.detach().clone() for fn, v in ly.items()}
            for ln, ly in params.items()}


def init_train_state(
    stacked_params: Params, lr: float, ema: bool = False,
) -> TrainState:
    """A fresh state on the params' device: float32 leaf copies of the
    params, Adam(lr) over them, step 0, and an EMA shadow if `ema`."""
    params = trainable(stacked_params)
    return TrainState(
        params=params,
        optimizer=torch.optim.Adam(param_leaves(params), lr=lr,
                                   betas=ADAM_BETAS, eps=ADAM_EPS),
        step=0,
        ema_params=_detached_copy(params) if ema else None,
    )


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> None:
    """optax.clip_by_global_norm's rule, in place: g where ||g|| < max_norm,
    else g * max_norm / ||g||, ||g|| the norm of every leaf together. (Not
    torch.nn.utils.clip_grad_norm_, which divides by ||g|| + 1e-6.) No host
    sync: the choice is a device-side select."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
    torch._foreach_mul_(grads, scale)


def ema_decay_at(step: int, ema_decay: float) -> float:
    """The bias-corrected decay after `step` updates, in float32 as the
    reference package computes it: decay * (1 - 1 / (step + 1))."""
    one = np.float32(1.0)
    return float(np.float32(ema_decay) * (one - one / (np.float32(step) + one)))


def make_train_step(
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.bfloat16,
    ema_decay: float = 0.999,
):
    """Returns `train_step(state, mix_mag, target_mags, active=None)
    -> (state, loss)`: one Adam step on the gradient of
    :func:`separation_loss` clipped to global norm MAX_GRAD_NORM, updating
    `state` in place. If the state carries
    `ema_params`, they track the stepped params with bias-corrected decay
    `ema_decay`."""

    def train_step(state: TrainState, mix_mag, target_mags, active=None):
        leaves = param_leaves(state.params)
        state.optimizer.zero_grad(set_to_none=True)
        loss = separation_loss(state.params, mix_mag, target_mags, stem_mode,
                               compute_dtype, active)
        loss.backward()
        clip_by_global_norm_([p.grad for p in leaves], MAX_GRAD_NORM)
        state.optimizer.step()
        state.step += 1
        if state.ema_params is not None:
            d = ema_decay_at(state.step, ema_decay)
            ema = param_leaves(state.ema_params)
            with torch.no_grad():
                torch._foreach_mul_(ema, d)
                torch._foreach_add_(ema, leaves, alpha=1.0 - d)
        return state, loss.detach()

    return train_step


def deploy_params(stacked_params: Params, fft_size: int = 4096) -> Params:
    """Fold the training input scale into the first conv (detached copies).

    Training feeds |rfft|/fft_size (data/dataset.py::to_magnitudes) for O(1)
    activations; the inference graph (core/separate.py) feeds raw |rfft|.
    conv1 is linear in its input, so scaling its weights by 1/fft_size
    makes the trained nets drop into the inference graph and the
    reference's blob format unchanged (the reference's pre-trained weights
    absorb raw magnitudes the same way, Executable/spleeter.c:177).
    """
    out = {ln: {fn: v.detach() for fn, v in ly.items()}
           for ln, ly in stacked_params.items()}
    out["down1"]["w"] = out["down1"]["w"] / float(fft_size)
    return out


def evaluate_si_sdr(
    stacked_params: Params, dataset, cfg, seconds: float = 12.0,
) -> dict[str, float]:
    """Holdout evaluation: fold the training input scale into the nets
    (:func:`deploy_params`), run the REAL separation pipeline
    (separate.separate_nstem, bins from bin_limit up weighted 0: at hop
    1024 K1, the packed U-Net's K2-K6 and K7 on a card) on the params'
    device over a centered segment of every track in `dataset`, and report
    mean per-stem time-domain SI-SDR in dB (plus 'mean')."""
    names = tuple(dataset.stem_names)
    params = deploy_params(stacked_params, cfg.transform.fft_size)
    device = params["up7"]["w"].device
    ob = (0.0,) * len(names)
    sums = {s: 0.0 for s in names}
    sr = getattr(dataset, "sample_rate", 44100)
    with torch.no_grad():
        for tr in dataset.tracks:
            n = min(int(seconds * sr), tr.n_frames)
            start = (tr.n_frames - n) // 2
            mix, stems = tr.read_crop(start, n)
            preshift, _ = transform.offline_pad_sizes(n, cfg.transform)
            padded = transform.pad_offline(
                torch.from_numpy(np.ascontiguousarray(mix)).to(device),
                cfg.transform,
            ).contiguous()
            est = separate.separate_nstem(params, padded, cfg, ob).cpu().numpy()
            est = est[..., preshift : preshift + n]
            for i, s in enumerate(names):
                sums[s] += metrics.si_sdr_db(est[i], stems[i])
    report = {s: v / len(dataset.tracks) for s, v in sums.items()}
    report["mean"] = sum(report.values()) / len(names)
    return report
