"""Checkpoint / resume for training state.

The reference has no compute-side checkpointing (its only persisted state is
the weight blobs). The reference package saves its TrainState with orbax
(spleeterrt_tpu/core/checkpoint.py); here one `torch.save` file in a step
directory holds the params, the optimizer's `state_dict`, the step and the
EMA shadow, and `restore` copies them into a template state on the
template's device. `train_state_from_jax` carries a state over from the
reference package: its params and its Adam moments, which are elementwise
and so take the weights' layout change.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from spleeterrt_tpu_torch.core import weights
from spleeterrt_tpu_torch.core.model import Params
from spleeterrt_tpu_torch.core.train import (
    ADAM_BETAS,
    ADAM_EPS,
    TrainState,
    param_leaves,
    trainable,
)

STATE_FILE = "train_state.pt"


def _host(params: Params | None) -> Params | None:
    if params is None:
        return None
    return {ln: {fn: v.detach().cpu() for fn, v in ly.items()}
            for ln, ly in params.items()}


def save(path: str | os.PathLike, state: TrainState) -> None:
    """Write a checkpoint directory (overwrites)."""
    os.makedirs(path, exist_ok=True)
    target = os.path.join(path, STATE_FILE)
    tmp = target + ".tmp"
    torch.save({
        "params": _host(state.params),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "ema_params": _host(state.ema_params),
    }, tmp)
    os.replace(tmp, target)


def _copy_into(dst: Params, src: Params) -> None:
    with torch.no_grad():
        for ln, ly in dst.items():
            for fn, v in ly.items():
                v.copy_(src[ln][fn])


def restore(path: str | os.PathLike, template: TrainState) -> TrainState:
    """Restore into `template` (its params, optimizer and EMA tensors, on
    their devices) and return it. Both must hold an EMA, or neither."""
    data = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    if (data["ema_params"] is None) != (template.ema_params is None):
        raise ValueError(f"{path}: the checkpoint and the template disagree "
                         f"on holding an EMA")
    _copy_into(template.params, data["params"])
    template.optimizer.load_state_dict(data["optimizer"])
    template.step = int(data["step"])
    if template.ema_params is not None:
        _copy_into(template.ema_params, data["ema_params"])
    return template


def latest_step_dir(root: str | os.PathLike) -> str | None:
    """Resolve the newest step_N subdirectory under a checkpoint root."""
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("step_") and name[5:].isdigit():
            steps.append((int(name[5:]), name))
    if not steps:
        return None
    return os.path.join(root, max(steps)[1])


def stacked_from_jax(tree) -> Params:
    """A stacked reference-package tree (HWIO kernels under a leading stem
    axis, numpy leaves) -> this package's stacked layout, net by net."""
    n_stems = np.asarray(tree["up7"]["w"]).shape[0]
    nets = [
        weights.params_from_jax(
            {ln: {fn: np.asarray(v)[s] for fn, v in ly.items()}
             for ln, ly in tree.items()})
        for s in range(n_stems)
    ]
    return weights.stack_params(nets)


def train_state_from_jax(
    params, mu, nu, count: int, step: int, ema=None, *, lr: float,
    device: torch.device | str = "cuda",
) -> TrainState:
    """The reference package's train state -> this package's, on `device`.

    `params`, `mu`, `nu` and `ema` are its stacked trees as numpy arrays;
    `mu`, `nu` and `count` come from the Adam state of its
    `optax.chain(clip_by_global_norm, adam(lr))` (`opt_state[1][0]`), whose
    clip holds no state. The moments are elementwise, so they take the
    weights' HWIO -> OIHW / (Cin, Cout, kh, kw) permutation."""
    to_dev = lambda p: {ln: {fn: v.to(device) for fn, v in ly.items()}
                        for ln, ly in p.items()}
    p = trainable(to_dev(stacked_from_jax(params)))
    opt = torch.optim.Adam(param_leaves(p), lr=lr, betas=ADAM_BETAS,
                           eps=ADAM_EPS)
    moments = zip(param_leaves(to_dev(stacked_from_jax(mu))),
                  param_leaves(to_dev(stacked_from_jax(nu))))
    for leaf, (m, v) in zip(param_leaves(p), moments):
        opt.state[leaf] = {"step": torch.tensor(float(count)),
                           "exp_avg": m, "exp_avg_sq": v}
    return TrainState(
        params=p, optimizer=opt, step=int(step),
        ema_params=None if ema is None else to_dev(stacked_from_jax(ema)),
    )
