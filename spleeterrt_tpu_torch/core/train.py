"""Training for the Spleeter U-Net (a capability the reference lacks).

The reference ships fixed pre-trained weights only (Executable/model.7z,
VST .dat blobs; no training code anywhere). This is the reference
package's training (spleeterrt_tpu/core/train.py) in PyTorch: per-stem L1
between `mask * |mix|` and the target stem magnitude, Adam after a clip to
global norm 1 (the reference package's `optax.chain(clip_by_global_norm,
adam)`), and a bias-corrected EMA of the params for deployment.

The loss runs the canonical route of core/model.py (every stem's layer
in one grouped torch convolution, core/grouped.py), whatever the routing
switches say: the hand kernels have no backward, and their wrappers raise on an
input that requires grad. Params stay float32 leaf tensors; the forward
casts them to the compute dtype, and only the final logits are float32.
Evaluation runs the real separation graph (core/separate.py), hand kernels
and all, under `torch.no_grad()` on detached params.

The sharded step (`shard_train_state`, `make_sharded_train_step`) runs the
same step over a (stem, data) mesh of ranks (parallel/mesh.py): each rank
holds its stem group's slice of the params, Adam moments and EMA, and
takes its share of the batch. Adam and the EMA are elementwise, so a stem
slice steps as the whole would; the loss, the gradient reduction and the
clip's norm are where ranks meet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from spleeterrt_tpu_torch.config import STEM_MODE_4, require_spleeter
from spleeterrt_tpu_torch.core import separate, transform
from spleeterrt_tpu_torch.core.model import Params, multi_stem_masks, num_stems
from spleeterrt_tpu_torch.parallel.distributed import all_gather_cat, all_reduce_
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
    # The (stem, data) mesh of a sharded state (shard_train_state): params,
    # moments and EMA then hold this rank's stem group's slice.
    mesh: object | None = None


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
    err = l1_errors(stacked_params, mix_mag, target_mags, stem_mode,
                    compute_dtype)
    if active is None:
        return err.mean()
    per = err.mean(dim=tuple(range(2, err.ndim)))  # (S, B)
    w = active.to(per.dtype)
    return (per * w).sum() / w.sum().clamp(min=1.0)


def l1_errors(
    stacked_params: Params,
    mix_mag: torch.Tensor,  # (B, T, F, 2)
    target_mags: torch.Tensor,  # (S, B, T, F, 2)
    stem_mode: int,
    compute_dtype,
) -> torch.Tensor:
    """|mask * |mix| - |stem|| -> (S, B, 2, T, F) float32, through the
    canonical route (the only one autograd differentiates)."""
    mix = mix_mag.permute(0, 3, 1, 2).contiguous()  # NCHW, as the nets take it
    masks = multi_stem_masks(
        stacked_params, mix, stem_mode, compute_dtype, "exact",
        pallas_head=False, pallas_encoder=False,
    )  # (S, B, 2, T, F) float32
    est = masks * mix[None].to(masks.dtype)
    return (est - target_mags.permute(0, 1, 4, 2, 3).to(masks.dtype)).abs()


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


def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         group=None) -> None:
    """optax.clip_by_global_norm's rule, in place: g where ||g|| < max_norm,
    else g * max_norm / ||g||, ||g|| the norm of every leaf together. (Not
    torch.nn.utils.clip_grad_norm_, which divides by ||g|| + 1e-6.) No host
    sync: the choice is a device-side select. With `group` (the stem
    groups of a sharded state) the leaves are every rank's of the group:
    each rank's leaf norms are gathered and the norm taken over all."""
    norms = torch.stack(torch._foreach_norm(grads))
    if group is not None:
        norms = all_gather_cat(norms, group)
    norm = torch.linalg.vector_norm(norms)
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
        state.optimizer.zero_grad(set_to_none=True)
        loss = separation_loss(state.params, mix_mag, target_mags, stem_mode,
                               compute_dtype, active)
        loss.backward()
        _update(state, ema_decay)
        return state, loss.detach()

    return train_step


def _update(state: TrainState, ema_decay: float, stem_group=None) -> None:
    """The rest of a step once the gradients are in the leaves: the clip
    (its norm over `stem_group`'s leaves too), Adam, the step count and the
    EMA, in place."""
    leaves = param_leaves(state.params)
    clip_by_global_norm_([p.grad for p in leaves], MAX_GRAD_NORM, stem_group)
    state.optimizer.step()
    state.step += 1
    if state.ema_params is not None:
        d = ema_decay_at(state.step, ema_decay)
        ema = param_leaves(state.ema_params)
        with torch.no_grad():
            torch._foreach_mul_(ema, d)
            torch._foreach_add_(ema, leaves, alpha=1.0 - d)


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
    stacked_params: Params,
    dataset,
    cfg,
    seconds: float = 12.0,
    out_band: tuple[float, ...] | None = None,
    trained_scale: bool = True,
) -> dict[str, float]:
    """Holdout evaluation: run the REAL separation pipeline
    (separate.separate_nstem: at hop 1024 K1, the packed U-Net's K2-K6 and
    K7 on a card) on the params' device over a centered segment of every
    track in `dataset`, and report mean per-stem time-domain SI-SDR in dB
    (plus 'mean'). `trained_scale` folds the training input scale into the
    nets first (:func:`deploy_params`); False evaluates them as given.
    `out_band` weights each stem's bins from bin_limit up (default 0)."""
    require_spleeter(cfg, "training's evaluation")
    names = tuple(dataset.stem_names)
    params = (
        deploy_params(stacked_params, cfg.transform.fft_size)
        if trained_scale
        else {ln: {fn: v.detach() for fn, v in ly.items()}
              for ln, ly in stacked_params.items()}
    )
    device = params["up7"]["w"].device
    ob = tuple(out_band) if out_band is not None else (0.0,) * len(names)
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


def _stem_rows(mesh) -> tuple[int, int]:
    """(this rank's index on "stem", the mesh's stem groups)."""
    return mesh.get_coordinate()[0], mesh.size(0)


def shard_train_state(state: TrainState, mesh, n_stems: int) -> TrainState:
    """This rank's share of `state` over the (stem, data) mesh: its stem
    group's slice of the params (new leaves), of the Adam moments (if the
    optimizer has stepped) and of the EMA; the step and Adam's settings are
    kept. The stems must divide the "stem" axis."""
    g, n_groups = _stem_rows(mesh)
    if n_stems % n_groups or num_stems(state.params) != n_stems:
        raise ValueError(f"{num_stems(state.params)} nets, {n_stems} stems "
                         f"over {n_groups} stem groups")
    per = n_stems // n_groups
    rows = slice(g * per, (g + 1) * per)
    take = lambda p: {ln: {fn: v.detach()[rows].clone() for fn, v in ly.items()}
                      for ln, ly in p.items()}
    params = trainable(take(state.params))
    settings = {k: v for k, v in state.optimizer.param_groups[0].items()
                if k != "params"}
    optimizer = torch.optim.Adam(param_leaves(params), **settings)
    for old, new in zip(param_leaves(state.params), param_leaves(params)):
        moments = state.optimizer.state.get(old)
        if moments:
            optimizer.state[new] = {
                "step": moments["step"].clone(),
                "exp_avg": moments["exp_avg"][rows].clone(),
                "exp_avg_sq": moments["exp_avg_sq"][rows].clone(),
            }
    return TrainState(
        params=params, optimizer=optimizer, step=state.step,
        ema_params=None if state.ema_params is None else take(state.ema_params),
        mesh=mesh,
    )


def make_sharded_train_step(
    mesh,
    stem_mode: int = STEM_MODE_4,
    compute_dtype=torch.bfloat16,
    ema_decay: float = 0.999,
):
    """Returns `train_step(state, mix_mag, target_mags, active=None) ->
    (state, loss)` over the (stem, data) mesh, for a state placed with
    :func:`shard_train_state`. Every rank passes the whole batch: mix_mag
    (B, T, F, 2) splits over "data" (B a multiple of its size), the
    targets (S, B, ...) and `active` (S, B) over "stem" and "data".

    The loss is a mean over (S, B, ...), so each rank's part is its local
    mean over (n_stem * n_data) ranks, or with `active` its weighted sum
    over the Σw of the whole batch and every stem. A stem's gradient is the
    sum over "data" of its ranks' gradients (one all-reduce); the clip's
    norm is taken over every stem group's leaves; the returned loss, summed
    over every rank, is the global loss on every rank. Collective."""
    g, n_groups = _stem_rows(mesh)
    d, n_data = mesh.get_coordinate()[1], mesh.size(1)
    stem_group, data_group = mesh.get_group("stem"), mesh.get_group("data")

    def train_step(state: TrainState, mix_mag, target_mags, active=None):
        if state.mesh is not mesh:
            raise ValueError("the state is not sharded over this mesh; place "
                             "it with shard_train_state")
        b = mix_mag.shape[0] // n_data
        s = num_stems(state.params)
        if b * n_data != mix_mag.shape[0] or target_mags.shape[0] != s * n_groups:
            raise ValueError(
                f"a batch of {mix_mag.shape[0]} and {target_mags.shape[0]} "
                f"target stems do not split over {n_data} data ranks and "
                f"{n_groups} stem groups of {s} stems")
        rows, stems = slice(d * b, (d + 1) * b), slice(g * s, (g + 1) * s)
        state.optimizer.zero_grad(set_to_none=True)
        err = l1_errors(state.params, mix_mag[rows], target_mags[stems, rows],
                        stem_mode, compute_dtype)
        if active is None:
            part = err.mean() / (n_groups * n_data)
        else:
            per = err.mean(dim=tuple(range(2, err.ndim)))  # (s, b)
            w = active.to(per.dtype)
            part = (per * w[stems, rows]).sum() / w.sum().clamp(min=1.0)
        part.backward()
        all_reduce_([p.grad for p in param_leaves(state.params)], data_group)
        _update(state, ema_decay, stem_group)
        loss = part.detach().clone()
        all_reduce_([loss], dist.group.WORLD)
        return state, loss

    return train_step
