"""Operators of the port. Each kernel module holds a hand-written CUDA kernel
(``csrc/``), its wrapper and its plain PyTorch twin (``*_reference``)."""

from ._native import LAUNCHES, build, reset_launches

__all__ = ["LAUNCHES", "build", "reset_launches"]
