"""Process-group plumbing: start-up, env rows per rank, and the collectives.

The port of `gym_so100_tpu/parallel/dist.py`.  JAX runs one SPMD program on
a device mesh with an "env" axis: the env batch is sharded along it, the
learner is replicated, and XLA inserts the collectives.  Here each rank is
one process on one device (`torch.distributed`) that steps its own rows of
the env batch (`BatchedEnv.shard`), and the collectives are explicit:

* `all_gather_env`: env-leading tensors of every rank, concatenated in
  rank order (the trainer gathers each env-batch step's transitions, so
  every rank holds the whole replay buffer and makes the same updates);
* `replicate`: a broadcast from rank 0 (the counterpart of JAX's
  `replicate`);
* `all_reduce_mean_`: an average across ranks, in place (the gradients of
  `SAC.update` on a batch sharded across ranks);
* `any_across`: whether a flag is set on some rank.

A collective on CUDA tensors over gloo (two ranks sharing one card, which
NCCL refuses) passes through host memory; over NCCL it stays on the device.

Launch with `torchrun --nproc_per_node N ...`, or export JAX's variables
(JAX_COORDINATOR_ADDRESS, JAX_NUM_PROCESSES, JAX_PROCESS_ID).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def init_distributed(coordinator=None, num_processes=None, process_id=None,
                     device="cuda", backend=None):
    """Join the process group of a multi-process run; returns False when
    there is none to join (one process), True once joined.

    Arguments default from JAX's variables (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID), then torch's (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK), as torchrun sets them.  The backend
    follows `device`: NCCL for CUDA, gloo for the CPU; `backend` names
    another on purpose (gloo for several ranks on one card).  On CUDA each
    rank takes the card LOCAL_RANK (default: its rank modulo the cards)."""
    env = os.environ
    if coordinator is None:
        coordinator = env.get("JAX_COORDINATOR_ADDRESS")
        if coordinator is None and env.get("MASTER_ADDR"):
            coordinator = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None:
        num_processes = env.get("JAX_NUM_PROCESSES", env.get("WORLD_SIZE"))
    if coordinator is None and num_processes is None:
        return False
    if process_id is None:
        process_id = env.get("JAX_PROCESS_ID", env.get("RANK"))
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "a multi-process run needs a coordinator address, a number of "
            f"processes and a process id (got {coordinator!r}, {num_processes!r}, "
            f"{process_id!r})")
    if dist.is_initialized():
        return True
    device = resolve_device(device)
    rank, world = int(process_id), int(num_processes)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator}", world_size=world, rank=rank)
    return True


def rank_device(device="cuda") -> torch.device:
    """This rank's device: the card `init_distributed` chose on CUDA."""
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def env_mesh(n_ranks=None):
    """The process group over the first `n_ranks` ranks (all by default),
    which `BatchedEnv.shard` and `Trainer` take; None in a single-process
    run.  Every rank must call it (a new group is a collective)."""
    if not dist.is_initialized():
        return None
    if n_ranks is None or n_ranks == dist.get_world_size():
        return dist.group.WORLD
    return dist.new_group(list(range(n_ranks)))


def world(group=None):
    """(rank, world size) in `group`; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def env_rows(num_envs: int, group=None) -> slice:
    """This rank's rows of a `num_envs`-wide env batch: the rank-th of
    world-size equal blocks."""
    rank, size = world(group)
    if num_envs % size:
        raise ValueError(f"{num_envs} envs do not split over {size} ranks")
    n = num_envs // size
    return slice(rank * n, (rank + 1) * n)


def _map(fn, tree):
    """fn on each tensor of a tensor, or of a tuple, list, dict or
    dataclass of them."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _map(fn, getattr(tree, f.name)) for f in dataclasses.fields(tree)})
    return tree


def shard_env(tree, group=None):
    """This rank's rows of an env-leading tensor (or a tuple, list, dict or
    dataclass of them) that holds the whole batch."""
    return _map(lambda x: x[env_rows(x.shape[0], group)], tree)


def _via_host(x, group):
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather_env(tree, group=None):
    """Every rank's env-leading tensors (a tensor, or a tuple, list, dict or
    dataclass of them), concatenated along the env axis in rank order, on
    every rank."""
    _, size = world(group)

    def gather(x):
        src = x.cpu() if _via_host(x, group) else x
        parts = [torch.empty_like(src.contiguous()) for _ in range(size)]
        dist.all_gather(parts, src.contiguous(), group=group)
        return torch.cat(parts).to(x.device)

    return _map(gather, tree)


def _collective_(fn, tensors, group):
    """Run the in-place collective `fn` on each tensor, through host copies
    where the backend needs them."""
    for t in tensors:
        if _via_host(t, group):
            h = t.cpu()
            fn(h)
            t.copy_(h)
        else:
            fn(t)


def replicate(tree, group=None, src=0):
    """Broadcast the tensors of global rank `src` (a tensor, a tuple, list,
    dict or dataclass of them, or a module's parameters and buffers) to
    every rank, in place; returns `tree`."""
    if isinstance(tree, torch.nn.Module):
        tensors = [*tree.parameters(), *tree.buffers()]
    else:
        tensors = []
        _map(tensors.append, tree)
    with torch.no_grad():
        _collective_(lambda t: dist.broadcast(t, src, group=group), tensors, group)
    return tree


def all_reduce_mean_(tensors, group=None):
    """Average each tensor over the ranks, in place (one flat all-reduce);
    every rank ends with the same bits."""
    tensors = list(tensors)
    if not tensors:
        return
    _, size = world(group)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    _collective_(lambda t: dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group),
                 [flat], group)
    flat /= size
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


def any_across(flag: torch.Tensor, group=None) -> bool:
    """Whether the boolean tensor `flag` is set somewhere on some rank (one
    all-reduce and one host read)."""
    v = flag.any().to(torch.int32).reshape(1)
    _collective_(lambda t: dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group),
                 [v], group)
    return bool(v.item())
