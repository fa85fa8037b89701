"""rectools-tpu-torch: the PyTorch + CUDA (Hopper) port of rectools-tpu.

Same Dataset -> recommend contract as the JAX package, written in PyTorch,
with every Pallas kernel on the ported path rewritten by hand for sm_90a
(``csrc/``). Entry points run on the GPU unless the caller passes
``device="cpu"``, in which case each kernel's plain PyTorch twin runs.
"""

from .columns import Columns
from .exceptions import NotFittedError, NotFittedForStageError
from .types import AnyIds, AnySequence, ExternalId, ExternalIds, InternalId, InternalIds

__version__ = "0.1.0"

__all__ = [
    "AnyIds",
    "AnySequence",
    "Columns",
    "NotFittedError",
    "NotFittedForStageError",
    "ExternalId",
    "ExternalIds",
    "InternalId",
    "InternalIds",
    "__version__",
]
