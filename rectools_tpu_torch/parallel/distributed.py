"""The process-group runtime: joining the world, meshes that respect node
boundaries, and the rows of a global batch that belong to this rank.

One process drives one device. Every process calls :func:`initialize` once
before it makes a tensor, builds the same mesh, and passes its shape to the
model::

    from rectools_tpu_torch.parallel import distributed as dist

    dist.initialize("localhost:29500", num_processes=4, process_id=rank)
    mesh = dist.make_multihost_mesh(n_model=2)
    model = SASRecModel(..., training_module_kwargs={
        "mesh_shape": (mesh.shape["data"], mesh.shape["model"]),
    })
    model.fit(dataset)          # every rank, the same dataset and seed

Transport. NCCL when every rank has a card of its own (it refuses two ranks
on one device), gloo otherwise: ranks on the CPU, or several ranks sharing
one card. That is a choice of transport, not of device: tensors and kernels
stay where the caller put them, and ``parallel.collectives`` stages device
tensors through host memory for gloo. The model axis is kept inside a node
(:func:`make_multihost_mesh`), so its all-gathers stay on NVLink and only
the data axis's gradient sums cross nodes.
"""

import datetime
import socket
import typing as tp

import numpy as np
import torch
import torch.distributed as dist

from .mesh import DATA_AXIS, ProcessMesh

_initialized = False


def initialize(
    coordinator_address: tp.Optional[str] = None,
    num_processes: tp.Optional[int] = None,
    process_id: tp.Optional[int] = None,
    local_device_ids: tp.Optional[tp.Sequence[int]] = None,
    init_method: tp.Optional[str] = None,
    backend: tp.Optional[str] = None,
    timeout_s: float = 600.0,
) -> None:
    """Join (or form) the world. Idempotent per process.

    ``coordinator_address`` is ``host:port`` of rank 0 (``init_method``, e.g.
    ``file:///path``, takes its place when given). One process without a
    coordinator skips initialization, so single-device code pays nothing.
    ``backend=None`` picks NCCL when CUDA is available and each process of
    this node can have a card of its own (``local_device_ids`` given, or
    ``num_processes`` no larger than the visible cards), else gloo. With NCCL
    the process's current device is set to its card before any tensor is made.
    A collective that waits longer than ``timeout_s`` raises.
    """
    global _initialized
    if _initialized:
        return
    if coordinator_address is None and init_method is None and (num_processes is None or num_processes == 1):
        return  # single process: nothing to do
    if num_processes is None or process_id is None:
        raise ValueError("initialize: num_processes and process_id are required with a coordinator")
    if backend is None:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        backend = "nccl" if cards and (local_device_ids is not None or num_processes <= cards) else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_device_ids[0] if local_device_ids else process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend=backend,
        init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s),
    )
    _initialized = True


def shutdown() -> None:
    """Leave the world (the end of a worker process)."""
    global _initialized
    if dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False


def is_initialized() -> bool:
    return _initialized


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _ranks_by_node() -> tp.List[tp.List[int]]:
    """Global ranks grouped by the host they run on, hosts in order of their
    first rank."""
    if not dist.is_initialized():
        return [[0]]
    hosts: tp.List[tp.Optional[str]] = [None] * dist.get_world_size()
    dist.all_gather_object(hosts, socket.gethostname())
    groups: tp.Dict[str, tp.List[int]] = {}
    for rank, host in enumerate(hosts):
        groups.setdefault(tp.cast(str, host), []).append(rank)
    return list(groups.values())


def make_multihost_mesh(n_model: int = 1, n_data: tp.Optional[int] = None) -> ProcessMesh:
    """(data, model) mesh over all nodes with the model axis inside a node.

    Rows of the data axis that belong to one node are contiguous and each
    model group lives on one node, so the all-gathers and sums over ``model``
    never cross a node boundary. Raises if ``n_model`` does not divide the
    ranks of a node."""
    nodes = _ranks_by_node()
    per_node = len(nodes[0])
    if any(len(group) != per_node for group in nodes):
        raise ValueError("nodes run different numbers of ranks; cannot build a regular mesh")
    if per_node % n_model != 0:
        raise ValueError(
            f"n_model={n_model} must divide the ranks of a node {per_node} "
            "(the model axis must not cross a node boundary)"
        )
    total = per_node * len(nodes)
    expected_data = total // n_model
    if n_data is not None and n_data != expected_data:
        raise ValueError(f"n_data={n_data} inconsistent with {total} ranks / n_model={n_model}")
    return ProcessMesh(np.concatenate([np.asarray(group).reshape(-1, n_model) for group in nodes]))


def data_parallel_row_range(global_batch_size: int, mesh: ProcessMesh) -> tp.Tuple[int, int]:
    """[start, stop) rows of the global batch this rank works on: the slice of
    its data coordinate. The ranks of one model group share it."""
    n_data = mesh.size(DATA_AXIS)
    if global_batch_size % n_data != 0:
        raise ValueError(
            f"Batch size {global_batch_size} must be divisible by the data-axis size {n_data} for sharded training"
        )
    per_rank = global_batch_size // n_data
    start = mesh.index(DATA_AXIS) * per_rank
    return start, start + per_rank


def global_batch_to_local(batch: tp.Dict[str, np.ndarray], mesh: ProcessMesh) -> tp.Dict[str, np.ndarray]:
    """This rank's rows of every array of a global host batch (the counterpart
    of the JAX package's ``host_local_batch_to_global``: there a host hands in
    its rows and gets the global array, here a rank keeps its rows)."""
    out = {}
    for key, arr in batch.items():
        start, stop = data_parallel_row_range(arr.shape[0], mesh)
        out[key] = arr[start:stop]
    return out
