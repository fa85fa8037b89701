"""The two collectives mesh training uses, over one axis group of a
:class:`~rectools_tpu_torch.parallel.mesh.ProcessMesh`.

A group of ``None`` is an axis of size one: nothing moves. Tensors stay on
the device the caller made them on. NCCL takes device tensors as they are.
gloo, the transport when several ranks share one card or run on the CPU, is
given host tensors: a device tensor is staged through host memory and the
result copied back, so the caller sees the same tensor on the same device
whichever transport carries it. The payloads of a train step are an (M,)
vector, an (N, D) tower gradient and one flat gradient buffer.
"""

import typing as tp

import torch
import torch.distributed as dist


def _stage(group: tp.Any, tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` has to pass through host memory for ``group``."""
    return tensor.device.type != "cpu" and dist.get_backend(group) == "gloo"


def all_reduce_sum(tensor: torch.Tensor, group: tp.Any) -> torch.Tensor:
    """``tensor`` summed over ``group``, in place; returns ``tensor``."""
    if group is None:
        return tensor
    if _stage(group, tensor):
        host = tensor.cpu()
        dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=dist.ReduceOp.SUM, group=group)
    return tensor


def all_gather(tensor: torch.Tensor, group: tp.Any) -> tp.List[torch.Tensor]:
    """Every rank's ``tensor`` (one shape on all ranks), in group-rank order."""
    if group is None:
        return [tensor]
    source = tensor.cpu() if _stage(group, tensor) else tensor.contiguous()
    parts = [torch.empty_like(source) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, source, group=group)
    return [part.to(tensor.device) for part in parts]

