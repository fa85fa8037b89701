"""The (data, model) process mesh.

The JAX package is one controller over a ``jax.sharding.Mesh`` and lets XLA
place the collectives. Here every device has a process of its own and the
collectives are written out, so the mesh is the ``(n_data, n_model)`` grid of
ranks of the ``torch.distributed`` world, this rank's coordinates in it, and
one process group per axis: the ``data`` group joins the ranks that share a
model coordinate (they hold different batch rows and sum their gradients),
the ``model`` group joins the ranks that share a data coordinate (they hold
the same batch rows and different slices of the item tables).
"""

import typing as tp

import numpy as np
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"


def _world() -> tp.Tuple[int, int]:
    """(world size, this rank); (1, 0) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class ProcessMesh:
    """A grid of ranks with a process group per axis.

    ``ranks[d, m]`` is the global rank at data coordinate ``d`` and model
    coordinate ``m``. Building a mesh is a collective: every rank of the
    world must build the same grid, because ``dist.new_group`` needs all of
    them, in one order. An axis of size one has no group (``None``), and a
    world of one process needs no ``torch.distributed`` at all.
    """

    def __init__(self, ranks: np.ndarray) -> None:
        world, rank = _world()
        ranks = np.asarray(ranks, dtype=np.int64)
        if ranks.ndim != 2 or sorted(ranks.reshape(-1).tolist()) != list(range(world)):
            raise ValueError(f"a mesh is a 2-d grid of every rank of the world exactly once, got {ranks.tolist()}")
        self.ranks = ranks
        where = np.argwhere(ranks == rank)[0]
        self.coords: tp.Dict[str, int] = {DATA_AXIS: int(where[0]), MODEL_AXIS: int(where[1])}
        self.shape: tp.Dict[str, int] = {DATA_AXIS: ranks.shape[0], MODEL_AXIS: ranks.shape[1]}
        self._groups: tp.Dict[str, tp.Any] = {DATA_AXIS: None, MODEL_AXIS: None}
        # every rank creates every group, data groups first
        if ranks.shape[0] > 1:
            for m in range(ranks.shape[1]):
                group = dist.new_group(ranks[:, m].tolist())
                if m == self.coords[MODEL_AXIS]:
                    self._groups[DATA_AXIS] = group
        if ranks.shape[1] > 1:
            for d in range(ranks.shape[0]):
                group = dist.new_group(ranks[d, :].tolist())
                if d == self.coords[DATA_AXIS]:
                    self._groups[MODEL_AXIS] = group

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[axis]

    def group(self, axis: str) -> tp.Any:
        """The process group of this rank along ``axis``; None for size one."""
        return self._groups[axis]


def make_mesh(n_data: tp.Optional[int] = None, n_model: int = 1) -> ProcessMesh:
    """A (data, model) mesh over the world, the model axis over neighbouring
    ranks. By default every rank goes on the ``data`` axis."""
    world, _ = _world()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(
            f"n_data * n_model must equal the world size {world}: multi-device training runs one process per "
            "device, each joined to the world with parallel.distributed.initialize"
        )
    return ProcessMesh(np.arange(world).reshape(n_data, n_model))


def pad_to_multiple(n: int, m: int) -> int:
    """Round n up to a multiple of m (for even sharding)."""
    return ((n + m - 1) // m) * m
