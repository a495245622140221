"""Checkpoint / resume for training state.

The reference has no compute-side checkpointing (its only persisted state is
the weight blobs). The reference package saves its TrainState with orbax
(spleeterrt_tpu/core/checkpoint.py); here one `torch.save` file in a step
directory holds the params, the optimizer's `state_dict`, the step and the
EMA shadow, and `restore` copies them into a template state on the
template's device. `train_state_from_jax` carries a state over from the
reference package: its params and its Adam moments, which are elementwise
and so take the weights' layout change.

A sharded state (core/train.py::shard_train_state) is saved in the same
format: `save` gathers every stem group's slice of the params, the Adam
moments of each leaf and the EMA, and the coordinator (rank 0) writes the
file; `restore` gives each rank its stem group's slice of what the file
holds. So a run saved at one world size resumes at another, bit for bit.
Both are collective in a sharded run, and every rank must see the
checkpoint's directory.

BS-RoFormer's weights (core/roformer.py) are one flat dict of named
tensors; `save_params` writes them as one `torch.save` file and
`load_roformer_params` reads one back onto a device, each name and shape
checked against the configuration's `param_shapes`.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from spleeterrt_tpu_torch.core import roformer, weights
from spleeterrt_tpu_torch.core.model import Params, num_stems
from spleeterrt_tpu_torch.core.train import (
    ADAM_BETAS,
    ADAM_EPS,
    TrainState,
    param_leaves,
    trainable,
)
from spleeterrt_tpu_torch.parallel.distributed import all_gather_cat, is_coordinator

STATE_FILE = "train_state.pt"


def _host(params: Params | None) -> Params | None:
    if params is None:
        return None
    return {ln: {fn: v.detach().cpu() for fn, v in ly.items()}
            for ln, ly in params.items()}


def _gathered(state: TrainState) -> dict:
    """What `save` writes, every stem group's slice stacked again (host
    tensors). Collective over a sharded state's stem groups."""
    group = state.mesh.get_group("stem")
    whole = lambda t: all_gather_cat(t.detach(), group).cpu()
    params = lambda p: None if p is None else {
        ln: {fn: whole(v) for fn, v in ly.items()} for ln, ly in p.items()}
    opt = state.optimizer.state_dict()
    opt["state"] = {
        i: {k: (v if k == "step" else whole(v)) for k, v in moments.items()}
        for i, moments in opt["state"].items()}
    return {"params": params(state.params), "optimizer": opt,
            "step": state.step, "ema_params": params(state.ema_params)}


def save(path: str | os.PathLike, state: TrainState) -> None:
    """Write a checkpoint directory (overwrites). For a sharded state every
    rank calls it; the coordinator writes, and all return once the file is
    in place."""
    if state.mesh is not None:
        data = _gathered(state)
    else:
        data = {
            "params": _host(state.params),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "ema_params": _host(state.ema_params),
        }
    if is_coordinator():
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, STATE_FILE)
        tmp = target + ".tmp"
        torch.save(data, tmp)
        os.replace(tmp, target)
    if state.mesh is not None:
        dist.barrier()


def _copy_into(dst: Params, src: Params) -> None:
    with torch.no_grad():
        for ln, ly in dst.items():
            for fn, v in ly.items():
                v.copy_(src[ln][fn])


def _slice(data: dict, template: TrainState) -> dict:
    """The rows of a sharded template's stem group in a whole checkpoint."""
    g, n_groups = template.mesh.get_coordinate()[0], template.mesh.size(0)
    per = num_stems(template.params)
    if num_stems(data["params"]) != per * n_groups:
        raise ValueError(f"a checkpoint of {num_stems(data['params'])} nets "
                         f"for {n_groups} stem groups of {per}")
    rows = slice(g * per, (g + 1) * per)
    params = lambda p: None if p is None else {
        ln: {fn: v[rows] for fn, v in ly.items()} for ln, ly in p.items()}
    opt = dict(data["optimizer"])
    opt["state"] = {
        i: {k: (v if k == "step" else v[rows]) for k, v in moments.items()}
        for i, moments in opt["state"].items()}
    return {**data, "params": params(data["params"]), "optimizer": opt,
            "ema_params": params(data["ema_params"])}


def restore(path: str | os.PathLike, template: TrainState) -> TrainState:
    """Restore into `template` (its params, optimizer and EMA tensors, on
    their devices) and return it. Both must hold an EMA, or neither. A
    sharded template (every rank calls it) takes its stem group's rows."""
    data = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    if (data["ema_params"] is None) != (template.ema_params is None):
        raise ValueError(f"{path}: the checkpoint and the template disagree "
                         f"on holding an EMA")
    if template.mesh is not None:
        data = _slice(data, template)
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


def save_params(path: str | os.PathLike, params: dict[str, torch.Tensor]) -> None:
    """Write a flat dict of named tensors (BS-RoFormer's weights) to one
    file, on the host."""
    torch.save({k: v.detach().cpu() for k, v in params.items()}, path)


def load_roformer_params(path: str | os.PathLike, cfg,
                         device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """BS-RoFormer's weights from a `save_params` file, float32 on
    `device`; ValueError where a name or a shape differs from
    `roformer.param_shapes(cfg)`."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    want = roformer.param_shapes(cfg)
    if set(data) != set(want):
        missing, extra = sorted(set(want) - set(data)), sorted(set(data) - set(want))
        raise ValueError(f"{path}: not BS-RoFormer weights of this configuration "
                         f"(missing {missing[:3]}, unexpected {extra[:3]})")
    for name, shape in want.items():
        if tuple(data[name].shape) != shape:
            raise ValueError(f"{path}: {name} is {tuple(data[name].shape)}, "
                             f"the configuration's is {shape}")
    return {k: data[k].to(device, torch.float32) for k in want}
