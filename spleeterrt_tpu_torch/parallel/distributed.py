"""Process-group bring-up and the global mesh.

The reference package's parallel/distributed.py brings up jax.distributed
for a multi-host run and lays a (stem, data) mesh over every device of
every host. Here one process drives one device (one rank), as torchrun
starts them: `initialize` brings the default process group up from
torchrun's environment (WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT) or from explicit arguments, and binds the rank to
`cuda:LOCAL_RANK`, or to the CPU when the caller asks for it.

A plain `python` start is world 1: the group still comes up (one rank, an
in-process store), so every mesh entry point runs the same code on one
card as on many. Bring-up failures raise; nothing drops to an ungrouped
run. The backend is NCCL for CUDA ranks and gloo for CPU ranks; `backend=`
overrides it (two ranks that share one card need gloo, since NCCL refuses
two ranks on one device).
"""

from __future__ import annotations

import contextlib
import datetime
import os

import torch
import torch.distributed as dist

# How long a collective may wait for its peers before it raises.
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)

_rank_device: torch.device | None = None


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def _bind(kind: str, local_rank: int | None, rank: int) -> torch.device:
    """The device of a rank: cuda:LOCAL_RANK (default the rank) or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    local = local_rank if local_rank is not None else _env_int("LOCAL_RANK", rank)
    if not 0 <= local < torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} has no CUDA device "
                           f"({torch.cuda.device_count()} visible)")
    return torch.device("cuda", local)


def initialize(
    device: str | torch.device = "cuda",
    *,
    backend: str | None = None,
    world_size: int | None = None,
    rank: int | None = None,
    local_rank: int | None = None,
    init_method: str | None = None,
    store: dist.Store | None = None,
    timeout: datetime.timedelta | None = None,
) -> torch.device:
    """Bring up the default process group; return this rank's device.

    `device` "cuda" binds the rank to cuda:LOCAL_RANK (raising where there
    is no card), "cpu" to the CPU. World size, rank and local rank default
    from the environment (1, 0 and the rank). The rendezvous is `store`,
    else `init_method`, else an in-process store at world 1 without
    MASTER_ADDR, else torchrun's "env://". A group that is already up is
    kept if it agrees with the world size and rank given and the device
    type."""
    global _rank_device
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"no rank device of type {kind!r}")
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("initialize: no CUDA device is available (pass "
                           "device='cpu' to run the ranks on the CPU)")
    if dist.is_initialized():
        up = (dist.get_world_size(), dist.get_rank())
        if (world_size not in (None, up[0]) or rank not in (None, up[1])
                or (_rank_device is not None and _rank_device.type != kind)):
            raise RuntimeError(
                f"a process group is already up (world {up[0]}, rank "
                f"{up[1]}, device {_rank_device}) that disagrees with world "
                f"{world_size}, rank {rank}, device type {kind}")
        if _rank_device is None:
            _rank_device = _bind(kind, local_rank, up[1])
        return _rank_device
    world = world_size if world_size is not None else _env_int("WORLD_SIZE", 1)
    me = rank if rank is not None else _env_int("RANK", 0)
    dev = _bind(kind, local_rank, me)

    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = dict(
        backend=backend or ("nccl" if dev.type == "cuda" else "gloo"),
        world_size=world, rank=me, timeout=timeout or DEFAULT_TIMEOUT,
    )
    if store is not None:
        kwargs["store"] = store
    elif init_method is not None:
        kwargs["init_method"] = init_method
    elif world == 1 and "MASTER_ADDR" not in os.environ:
        kwargs["store"] = dist.HashStore()
    else:
        kwargs["init_method"] = "env://"
    dist.init_process_group(**kwargs)
    _rank_device = dev
    return dev


def launched() -> bool:
    """Whether a launcher (torchrun) started this process as one rank of a
    group: its environment names the world size."""
    return "WORLD_SIZE" in os.environ


def shutdown() -> None:
    """Tear the default process group down (a no-op if none is up)."""
    global _rank_device
    if dist.is_initialized():
        dist.destroy_process_group()
    _rank_device = None


@contextlib.contextmanager
def process_group(device: str | torch.device = "cuda", **kwargs):
    """`initialize(device, **kwargs)` for the body of a `with`; the group
    is torn down after it if this call brought it up."""
    created = not dist.is_initialized()
    dev = initialize(device, **kwargs)
    try:
        yield dev
    finally:
        if created:
            shutdown()


def rank_device() -> torch.device:
    """The device `initialize` bound this rank to."""
    if _rank_device is None or not dist.is_initialized():
        raise RuntimeError("no process group is up; call initialize() first")
    return _rank_device


def global_mesh(stem_parallel: int = 1):
    """The (stem, data) mesh over every rank of the group; rank r sits at
    (r // n_data, r % n_data), so contiguous ranks (one host's, under
    torchrun) are neighbours on the data axis and its halo exchanges."""
    from spleeterrt_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(stem_parallel)


def is_coordinator() -> bool:
    """Rank 0 of the group (the only process of an ungrouped run)."""
    return not dist.is_initialized() or dist.get_rank() == 0


# ---------------------------------------------------------------------------
# Exchanges. Under NCCL tensors stay on the card. Gloo moves data through
# host memory in any case, and not every one of its ops takes a CUDA
# tensor, so under gloo (the CPU ranks of the tests, or two ranks sharing
# one card) a CUDA tensor is copied to the host for the exchange and back
# after it, the same way for every op.
# ---------------------------------------------------------------------------


def _via_host(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """Every rank's `t` (equal shapes) concatenated along `dim` in the
    group's rank order, on every rank of `group`."""
    host = _via_host(t, group)
    src = (t.cpu() if host else t).contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    out = torch.cat(parts, dim)
    return out.to(t.device) if host else out


def broadcast_(t: torch.Tensor, src: int = 0, group=None) -> None:
    """Fill `t` on every rank of `group` with global rank `src`'s `t`, in
    place (equal shapes and dtypes on every rank)."""
    if not _via_host(t, group):
        dist.broadcast(t, src, group=group)
        return
    buf = t.cpu()
    dist.broadcast(buf, src, group=group)
    t.copy_(buf)


def all_reduce_(tensors: list[torch.Tensor], group) -> None:
    """Sum each of `tensors` over `group`, in place, in one flat exchange."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    host = _via_host(flat, group)
    buf = flat.cpu() if host else flat
    dist.all_reduce(buf, group=group)
    if host:
        flat.copy_(buf)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def exchange(send: torch.Tensor | None, dst: int | None,
             recv: torch.Tensor | None, src: int | None, group) -> None:
    """One step of a shift between neighbours of `group`: `send` goes to
    global rank `dst` and `recv` is filled from global rank `src`; a None
    peer skips its half. Every rank of the shift calls it."""
    ops, host_recv = [], None
    if dst is not None:
        data = (send.cpu() if _via_host(send, group) else send).contiguous()
        ops.append(dist.P2POp(dist.isend, data, dst, group=group))
    if src is not None:
        host_recv = torch.empty(recv.shape, dtype=recv.dtype) if _via_host(
            recv, group) else None
        ops.append(dist.P2POp(dist.irecv, recv if host_recv is None else host_recv,
                              src, group=group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if host_recv is not None:
        recv.copy_(host_recv)
