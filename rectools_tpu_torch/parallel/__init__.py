"""Process meshes and collectives for multi-device training on
``torch.distributed`` — the port of rectools_tpu/parallel/."""

from .mesh import DATA_AXIS, MODEL_AXIS, ProcessMesh, make_mesh, pad_to_multiple

__all__ = ("DATA_AXIS", "MODEL_AXIS", "ProcessMesh", "make_mesh", "pad_to_multiple")
