"""Counter-hash dropout — port of rectools_tpu/models/nn/dropout.py.

The keep mask is a pure function of two 32-bit key words and the flat element
index, through the murmur3-style finalizers that the port keeps, as the JAX
package does, in ``ops/attention.py`` (uint32 arithmetic written out in
int64). For the same two key words the bits equal the JAX package's exactly.

Where the key words come from differs on purpose. The JAX package pulls a
flax key per layer (``make_rng("dropout")``, folded by module path); the port
does not reproduce that key stream. Its salts come from an explicit
``torch.Generator`` on the CPU that the training module owns, seeds from its
``seed`` and hands to every salt-drawing module (:func:`attach_generator`),
never from the global RNG: a CPU run and a CUDA run with the same seed then
draw the same masks.

Batch shards. Under a process mesh a rank holds rows ``[b0, b0 + b)`` of the
global batch and must draw those rows of the global batch's mask, as the JAX
package's single program does. The position of element ``i`` of the shard in
the global tensor is ``b0 · prod(shape[1:]) + i``, and because the hash input
is ``position · GOLDEN + salt`` the shift folds into the salt
(:func:`_shifted`). Modules that draw a mask for a batch-leading tensor carry
a ``batch_offset`` (0 on a single device) that the training module sets with
:func:`set_batch_offset`.
"""

import typing as tp

import numpy as np
import torch
from torch import nn

from ...ops.attention import GOLDEN, MASK32 as _MASK32, dropout_threshold, fmix32, mix32_fast

def _i32(x: int) -> int:
    """Wrap a Python int to int32 (two's complement)."""
    x &= _MASK32
    return x - (1 << 32) if x >= 1 << 31 else x


def _salt(words: tp.Sequence[int], mult: int) -> int:
    return _i32(_i32(words[0]) ^ _i32(_i32(words[1]) * mult))


def _shifted(salt: int, offset: int) -> int:
    """The salt that makes local position ``i`` hash as global position ``offset + i``."""
    return (salt + offset * GOLDEN) & _MASK32


def _positions(shape: tp.Sequence[int], device: torch.device) -> torch.Tensor:
    return torch.arange(int(np.prod(shape)), dtype=torch.int64, device=device).reshape(tuple(shape))


def hash_keep_mask(
    words: tp.Sequence[int],
    shape: tp.Sequence[int],
    rate: float,
    device: tp.Optional[torch.device] = None,
    offset: int = 0,
) -> torch.Tensor:
    """Boolean keep mask of ``shape``; P(keep) = 1 - rate, pure in (key words,
    index). ``offset`` is the flat position of element 0 in a larger tensor."""
    salt = _shifted(_salt(words, 40503) & _MASK32, offset)
    bits = mix32_fast((_positions(shape, device) * GOLDEN + salt) & _MASK32)
    return bits >= dropout_threshold(rate)


def hash_uniform_ints(
    words: tp.Sequence[int],
    shape: tp.Sequence[int],
    low: int,
    high: int,
    device: tp.Optional[torch.device] = None,
    offset: int = 0,
) -> torch.Tensor:
    """int64 tensor of ``shape``, ~uniform on [low, high) (counter-hash draw).
    ``offset`` is the flat position of element 0 in a larger tensor."""
    salt = _shifted(_salt(words, 48271) & _MASK32, offset)
    bits = fmix32((_positions(shape, device) * GOLDEN + salt) & _MASK32)
    return low + bits % (high - low)


def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` when that is a half type, as a JAX
    scalar takes the array's dtype (the dropout scale ``jnp.asarray(1 / (1 -
    rate), x.dtype)``, a weakly typed Python scale); unchanged otherwise."""
    if dtype in (torch.bfloat16, torch.float16):
        return float(torch.tensor(value, dtype=dtype))
    return value


def draw_key_words(generator: tp.Optional[torch.Generator]) -> tp.Tuple[int, int]:
    """Two int32 key words from ``generator``."""
    words = torch.randint(-(2**31), 2**31, (2,), generator=_required(generator))
    return int(words[0]), int(words[1])


def draw_attention_seed(generator: tp.Optional[torch.Generator]) -> int:
    """A seed on [0, 2^31 - 1), as the JAX module draws with ``jax.random.randint``."""
    return int(torch.randint(0, 2**31 - 1, (1,), generator=_required(generator)))


def _required(generator: tp.Optional[torch.Generator]) -> torch.Generator:
    if generator is None:
        raise RuntimeError(
            "dropout in training mode draws its salts from the training module's generator; "
            "give the module one with `attach_generator(...)` or call `.eval()`"
        )
    return generator


def attach_generator(module: nn.Module, generator: torch.Generator) -> None:
    """Make every salt-drawing submodule of ``module`` (those with a
    ``dropout_generator`` attribute) draw from ``generator``."""
    for sub in module.modules():
        if hasattr(sub, "dropout_generator"):
            sub.dropout_generator = generator


def set_batch_offset(module: nn.Module, rows: int) -> None:
    """Tell every mask-drawing submodule of ``module`` (those with a
    ``batch_offset`` attribute) that its inputs are rows ``rows...`` of the
    global batch."""
    for sub in module.modules():
        if hasattr(sub, "batch_offset"):
            sub.batch_offset = rows


def shifted_attention_seed(seed: int, batch_offset: int, n_heads: int) -> int:
    """The attention kernels salt batch·head row ``bh`` with ``seed + bh · 40503``;
    this is the int32 seed that makes local row ``bh`` draw the mask of global
    row ``batch_offset · n_heads + bh``."""
    return _i32(seed + batch_offset * n_heads * 40503)


class HashDropout(nn.Module):
    """``nn.Dropout`` counterpart backed by :func:`hash_keep_mask`."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate
        self.dropout_generator: tp.Optional[torch.Generator] = None
        self.batch_offset = 0  # first row of the global batch this module sees

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        if self.rate >= 1.0:
            return torch.zeros_like(x)
        offset = self.batch_offset * int(np.prod(x.shape[1:]))
        keep = hash_keep_mask(draw_key_words(self.dropout_generator), x.shape, self.rate, x.device, offset)
        return torch.where(keep, x * scalar_in(1.0 / (1.0 - self.rate), x.dtype), torch.zeros_like(x))
