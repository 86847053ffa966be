"""Process groups for multi-process runs.

Port of vit_search_tpu/parallel/mesh.py. The JAX package shards the global
batch over a device mesh and lets XLA insert the collectives. The port runs
one process per card in a ``torch.distributed`` process group, as the
reference's DDP job does (utils.py:241-307), and writes its collectives out:

- the backend follows the device: NCCL for a CUDA device, gloo for the CPU.
  A CUDA run whose NCCL init fails raises; it never carries on over gloo or
  on the CPU. ``init_distributed(backend="gloo")`` asks for gloo on a card
  by name (two processes on one card, which NCCL refuses);
- each process feeds the ``[lo, hi)`` rows of the global batch
  (:func:`batch_slice`) from its rank-sharded sampler, on the card
  ``cuda:<local rank>`` (:func:`process_device`);
- :func:`all_reduce_sum` sums host values (numpy) and device tensors over
  processes, :func:`sum_over_processes` does it inside autograd (the conv
  stem's batch statistics), :func:`all_reduce_mean_` averages gradients in
  place, :func:`all_gather` assembles the global batch, :func:`replicate`
  broadcasts parameters and buffers from rank 0.

Without a process group (one process, the default) every function here
returns its input and no collective runs. A group of one process
(``cli.launch`` with ``WORLD_SIZE=1``) runs every collective, each a sum
over one process.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

_local_rank = 0


def backend_for(device: Union[str, torch.device]) -> str:
    """NCCL on a CUDA device, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _init_method(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; a URL (``tcp://``, ``file://``,
    ``env://``) passes as it is."""
    return address if "://" in address else f"tcp://{address}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, *,
                     local_rank: Optional[int] = None, device=None,
                     backend: Optional[str] = None) -> None:
    """Join the process group (the reference's ``init_distributed_mode``,
    utils.py:285-306).

    A no-op without ``num_processes``: a single process needs no group.
    ``coordinator_address`` is ``host:port`` or an init-method URL (a
    ``file://`` store in the tests). ``local_rank`` (default: the process
    id) picks the card ``cuda:<local rank>``. ``backend`` defaults to
    :func:`backend_for` ``device`` (the card unless ``"cpu"``). One
    collective runs before this returns, so a backend that cannot start
    raises here.
    """
    global _local_rank
    if num_processes is None:
        return
    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    if coordinator_address is None:
        raise ValueError("a process group needs a coordinator address")
    dev = resolve_device(device)
    backend = backend or backend_for(dev)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device")
    rank = int(process_id or 0)
    _local_rank = int(rank if local_rank is None else local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(_local_rank)
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=int(num_processes), rank=rank)
    probe = torch.ones(1, device=_collective_device())
    dist.all_reduce(probe)   # NCCL makes its communicator here
    if int(probe.item()) != int(num_processes):
        raise RuntimeError(f"process group probe summed to {probe.item()}, "
                           f"expected {num_processes}")


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return process_index() == 0


def local_rank() -> int:
    """This process's card index on its host (0 without a group)."""
    return _local_rank if dist.is_initialized() else 0


def describe() -> str:
    """This process's place in the group, for the log."""
    if not dist.is_initialized():
        return "one process (no process group)"
    return (f"rank {process_index()} of {process_count()} over {dist.get_backend()}, "
            f"local rank {local_rank()}")


def process_device(device=None) -> torch.device:
    """:func:`device.resolve_device`, with a bare ``"cuda"`` taken to mean
    this process's card ``cuda:<local rank>`` in a process group."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank())
    return dev


def _collective_device() -> torch.device:
    """Where host values go for a collective: this card under NCCL (which
    moves only device memory), else the CPU."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", _local_rank)
    return torch.device("cpu")


def batch_slice(global_batch: int) -> Tuple[int, int]:
    """The ``[lo, hi)`` rows of the global batch that this process holds
    (equal shards)."""
    n, r = process_count(), process_index()
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over {n} processes")
    per = global_batch // n
    return r * per, (r + 1) * per


def barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def all_reduce_sum(x):
    """Sum of ``x`` over processes: a tensor gives a new tensor on its
    device, anything else (numpy arrays, numbers) a numpy array."""
    if not dist.is_initialized():
        return x
    if isinstance(x, torch.Tensor):
        out = x.clone()
        dist.all_reduce(out)
        return out
    arr = np.asarray(x)
    t = torch.as_tensor(arr, device=_collective_device()).clone()
    dist.all_reduce(t)
    return t.cpu().numpy().astype(arr.dtype, copy=False)


def any_process(flag: bool) -> bool:
    """True on every process when ``flag`` is true on any (a max-all-reduce)."""
    if not dist.is_initialized():
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=_collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def all_reduce_mean_(tensors: Iterable[torch.Tensor]) -> None:
    """Average ``tensors`` (one device, one dtype: the gradients) over
    processes in place, through one flat buffer."""
    tensors = list(tensors)
    if not dist.is_initialized() or not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat)
    flat.div_(dist.get_world_size())
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n


class _SumOverProcesses(torch.autograd.Function):
    """All-reduce sum whose backward all-reduces the incoming gradient:
    each process's input feeds every process's output."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone()
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        out = grad.contiguous().clone()
        dist.all_reduce(out)
        return out


def sum_over_processes(x: torch.Tensor) -> torch.Tensor:
    """:func:`all_reduce_sum` inside autograd (``x`` unchanged without a group)."""
    return _SumOverProcesses.apply(x) if dist.is_initialized() else x


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (equal shapes) concatenated along dim 0 in rank
    order. gloo takes CUDA tensors here as NCCL does (PyTorch 2.11 on the
    H100: all-reduce, broadcast and all-gather)."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


def replicate(module_or_tensors: Union[torch.nn.Module, Dict[str, torch.Tensor]]) -> None:
    """Give every process rank 0's parameters and buffers (a module) or
    tensors (a name -> tensor dict, such as an EMA), in place."""
    if not dist.is_initialized():
        return
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = [t.data for t in module_or_tensors.parameters()]
        tensors += list(module_or_tensors.buffers())
    else:
        tensors = [module_or_tensors[k] for k in sorted(module_or_tensors)]
    with torch.no_grad():
        for t in tensors:
            dist.broadcast(t, 0)
