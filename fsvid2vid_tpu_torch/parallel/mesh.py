"""Data parallelism over processes, one per GPU (the PyTorch counterpart of
fsvid2vid_tpu/parallel/mesh.py: `make_mesh`, `shard_batch`, `replicate`).

The JAX package puts every device on one mesh axis, 'data', shards the
global batch over it and lets GSPMD insert the collectives, so that
gradients and batch-norm statistics are the global batch's.  The port keeps
those semantics with PyTorch's idiom: one process per GPU, joined in a
torch.distributed process group (NCCL on CUDA, gloo on the CPU), launched
either by torchrun (`--distributed` reads RANK, WORLD_SIZE, MASTER_ADDR and
MASTER_PORT) or with explicit coordinates (`--coordinator_address host:port
--num_processes N --process_id i`; the address may also be an init URL such
as file:///path).  Each rank

  * reads its rows of the global batch (`local_rows`; the sequence loader
    takes shard_id = rank, num_shards = world, as JAX's `local_batch`);
  * starts from rank 0's parameters and buffers (`broadcast_state`, the
    counterpart of `replicate`);
  * averages its gradients with every other rank's between backward and
    the optimizer step (`all_reduce_grads`, training/step.py `_update`);
  * normalises with the global batch's statistics (`all_reduce_sum`, which
    gradients cross; models/layers.py `SyncBatchNorm`).

So every rank holds bitwise the same parameters and buffers after every
step.  A process outside a group is a world of one, and none of this runs.
"""
from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

from fsvid2vid_tpu_torch.utils.profiling import span

DEFAULT_TIMEOUT = datetime.timedelta(minutes=30)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_master() -> bool:
    """Rank 0 writes checkpoints, pages and logs (reference
    util/distributed.py master_only)."""
    return rank() == 0


def backend_for(device: torch.device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def init_url(address: str) -> str:
    """An init method from a coordinator address: host:port becomes
    tcp://host:port; a URL (tcp://, file://, env://) is kept."""
    return address if "://" in address else f"tcp://{address}"


def init(backend: str, init_method: str, world_size: Optional[int] = None,
         rank_: Optional[int] = None,
         timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> None:
    """Join the process group (torch.distributed.init_process_group).  With
    init_method 'env://' the world size and rank come from the environment
    (torchrun); a collective that waits longer than `timeout` raises."""
    kw = {} if world_size is None else dict(world_size=world_size, rank=rank_)
    dist.init_process_group(backend, init_method=init_method, timeout=timeout, **kw)


def destroy() -> None:
    if is_initialized():
        dist.destroy_process_group()


def rank_device(device: torch.device) -> torch.device:
    """A CUDA device without an index becomes this rank's card,
    cuda:LOCAL_RANK (torchrun sets it; else the rank modulo the cards)."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None or not is_initialized():
        return device
    local = int(os.environ.get("LOCAL_RANK", rank() % max(torch.cuda.device_count(), 1)))
    return torch.device("cuda", local)


def local_rows(n_global: int) -> slice:
    """This rank's rows of a global batch of n_global: the world splits it
    in equal shares in rank order, as JAX shards the batch axis."""
    w = world()
    if n_global % w:
        raise ValueError(f"a global batch of {n_global} does not split over {w} ranks")
    n = n_global // w
    return slice(rank() * n, (rank() + 1) * n)


def barrier() -> None:
    if is_initialized():
        dist.barrier()


@torch.no_grad()
def broadcast_state(modules: Iterable[torch.nn.Module]) -> None:
    """Every parameter and buffer of `modules` from rank 0."""
    if world() == 1:
        return
    for m in modules:
        for t in list(m.parameters()) + list(m.buffers()):
            dist.broadcast(t.data, 0)


@torch.no_grad()
def all_reduce_grads(params: Iterable[torch.nn.Parameter]) -> None:
    """Replace each gradient by its mean over the ranks, in one all-reduce
    per dtype.  A parameter without a gradient on some rank takes zeros
    there if any other rank has one, so the optimizer sees the same set
    everywhere (Adam skips a parameter whose gradient is None).  In a
    group: span fsv.train.all_reduce, and the gradients' bytes counted in
    `all_reduce_grads.bytes`."""
    if not is_initialized():
        return
    params = [p for p in params if p.requires_grad]
    if not params:
        return
    with span("fsv.train.all_reduce"):
        has = torch.tensor([p.grad is not None for p in params], dtype=torch.uint8)
        if dist.get_backend() == "nccl":
            has = has.to(params[0].device)
        dist.all_reduce(has, op=dist.ReduceOp.MAX)
        for p, h in zip(params, has.tolist()):
            if h and p.grad is None:
                p.grad = torch.zeros_like(p)
        by_dtype = {}
        for p in params:
            if p.grad is not None:
                by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
        w = world()
        for grads in by_dtype.values():
            flat = torch.cat([g.reshape(-1) for g in grads])
            _counted.bytes += flat.numel() * flat.element_size()
            dist.all_reduce(flat)
            flat /= w
            offset = 0
            for g in grads:
                g.copy_(flat[offset:offset + g.numel()].view_as(g))
                offset += g.numel()


all_reduce_grads.bytes = 0
_counted = all_reduce_grads    # the counter's holder, should a caller rebind the name


def all_reduce_mean(t: torch.Tensor) -> torch.Tensor:
    """`t` averaged over the ranks (not differentiable): the global batch's
    value of a loss that each rank took as the mean over its rows."""
    if not is_initialized():
        return t
    t = t.detach().clone()
    dist.all_reduce(t)
    return t / world()


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """`t` summed over the ranks, differentiably: the gradient of every
    rank's output flows back into every rank's input."""
    if world() == 1:
        return t
    from torch.distributed.nn.functional import all_reduce
    # the group named at the call: all_reduce's default is the group of
    # the time it was imported, gone once a process joins a second group
    return all_reduce(t, group=dist.group.WORLD)
