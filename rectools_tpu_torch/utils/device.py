"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and raise when no card is present: there is
no quiet fallback to the CPU. Tests and CPU users pass ``device="cpu"``
explicitly, which routes every kernel wrapper to its plain PyTorch twin.
"""

import contextlib
import typing as tp

import numpy as np
import torch

DeviceLike = tp.Union[str, torch.device]


def resolve_device(device: DeviceLike) -> torch.device:
    """``torch.device`` for ``device``; raises if it is CUDA and none is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch twins on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}: expected 'cuda' or 'cpu'")
    return dev


@contextlib.contextmanager
def full_f32_matmul() -> tp.Iterator[None]:
    """Run float32 matrix products in full f32 (TF32 off) inside the block.

    The JAX reference multiplies at ``Precision.HIGHEST``; TF32 keeps about
    three decimal digits and reorders near-tied scores. The previous setting
    is restored on exit.
    """
    previous = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = previous


def host_to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """Copy a host array to ``device`` without a host sync: on CUDA the copy is
    staged through pinned memory and queued on the current stream."""
    t = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t
