"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes``. Libraries
are built at first use into ``build/kernels/`` at the repository root (git
ignores it), keyed by a hash of the sources and flags, so an edit to a
kernel rebuilds it and an unchanged kernel loads from the cache. A failed
build raises. :func:`build` starts one ``nvcc`` per source, all at once.

``LAUNCHES`` counts the launches each wrapper makes: a wrapper adds one
right after its kernel launched, and nowhere else, so a run can show that
its path went through the kernels.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import typing as tp
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("layer_norm", "attention", "topk_select")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
BUILD_TIMEOUT_S = 600

LAUNCHES: tp.Dict[str, int] = {"layer_norm_fwd": 0, "attention_fwd": 0, "group_topm": 0}

_LOCK = threading.Lock()
_LIBS: tp.Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    """Set every launch count to 0."""
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    cuda_home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    candidate = cuda_home / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH); cannot build the CUDA kernels")
    return found


def _so_path(name: str) -> Path:
    digest = hashlib.sha256()
    digest.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}_{digest.hexdigest()[:16]}.so"


def build(names: tp.Sequence[str] = SOURCES) -> tp.Dict[str, str]:
    """Compile every library in ``names`` that is not built yet, one ``nvcc``
    per source, all started together. Returns each compiled source's compiler
    output (register and spill report); raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs: tp.Dict[str, tp.Tuple[subprocess.Popen, Path, Path]] = {}
    try:
        for name in names:
            so_path = _so_path(name)
            if so_path.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp_path = so_path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp_path), str(CSRC / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            procs[name] = (proc, tmp_path, so_path)
        reports: tp.Dict[str, str] = {}
        failures = []
        for name, (proc, tmp_path, so_path) in procs.items():
            output, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            if proc.returncode != 0:
                failures.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{output}")
                continue
            os.replace(tmp_path, so_path)
            reports[name] = output
        if failures:
            raise RuntimeError("\n".join(failures))
        return reports
    finally:
        for proc, tmp_path, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp_path.unlink(missing_ok=True)


def load(name: str, signatures: tp.Dict[str, tp.Sequence[tp.Any]]) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu`` (built if needed), with
    ``argtypes`` set from ``signatures`` and an ``int`` return for each
    function (the ``cudaGetLastError`` of its launch)."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            so_path = _so_path(name)
            if not so_path.exists():
                build((name,))
            lib = ctypes.CDLL(str(so_path))
            for fn_name, argtypes in signatures.items():
                fn = getattr(lib, fn_name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check_launch(kernel: str, status: int) -> None:
    """Raise if a launch reported a CUDA error; otherwise count it."""
    if status != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {status}")
    LAUNCHES[kernel] += 1


def current_stream_ptr(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_f32(kernel: str, **tensors: torch.Tensor) -> None:
    """The wrappers' common input checks: CUDA, float32, one device, and no
    autograd (the kernels are forward-only; backward kernels come with the
    training slice)."""
    device = None
    for arg, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{kernel}: {arg} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel}: {arg} must be float32, got {t.dtype}")
        if device is not None and t.device != device:
            raise ValueError(f"{kernel}: all inputs must be on one device")
        if t.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(f"{kernel}: the CUDA kernel is forward-only; run under torch.no_grad()")
        device = t.device


def require_aligned(kernel: str, t: torch.Tensor, dims: tp.Sequence[int]) -> None:
    """float4 access: 16-byte aligned data, unit last stride, and the strides
    of ``dims`` multiples of 4 elements."""
    if t.stride(-1) != 1 or t.data_ptr() % 16 or any(t.stride(d) % 4 for d in dims):
        raise ValueError(
            f"{kernel}: tensor of shape {tuple(t.shape)} and strides {t.stride()} needs a unit last stride, "
            "16-byte alignment and outer strides that are multiples of 4"
        )
