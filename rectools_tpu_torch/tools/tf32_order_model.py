#!/usr/bin/env python3
"""A numpy model of a 3xTF32 dot product on ``mma.sync`` m16n8k8, to compare
the orders of its six products per 16-deep step (``csrc/tc_tile.cuh``) with
f32 FMA. Runs anywhere: ``python3 rectools_tpu_torch/tools/tf32_order_model.py``.

Each f32 operand is split into TF32 halves (``cvt.rna``: round to nearest,
ties away, at 10 mantissa bits); each ``mma`` adds its 8 exact products to
its accumulator and truncates the sum to f32 toward zero once; a 16-deep
step sums its six products into a fresh fragment that a rounded f32 add puts
onto the running sum. Orders: ``mma3_k16`` (per 8-deep step lo*hi, hi*lo,
hi*hi), ``hi_last`` (``mma3_k16_hi_last``: the four small products of both
steps, then the two hi*hi), and ``fresh_per_8`` (a fresh fragment per 8-deep
step). For 200,000 dot products of N(0, 1) vectors at depths 32 and 128 it
prints the mean, rms and largest error relative to the sum of |terms|.
"""

import numpy as np


def tf32(x: np.ndarray) -> np.ndarray:
    bits = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((bits + 0x1000) & 0xFFFFE000).astype(np.uint32).view(np.float32)


def trunc32(x64: np.ndarray) -> np.ndarray:
    x32 = x64.astype(np.float32)
    over = np.abs(x32.astype(np.float64)) > np.abs(x64)
    x32[over] = np.nextafter(x32[over], np.float32(0))
    return x32


def mma(t: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return trunc32(t.astype(np.float64) + (a.astype(np.float64) * b.astype(np.float64)).sum(-1))


def dot_3xtf32(a: np.ndarray, b: np.ndarray, order: str) -> np.ndarray:
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    c = np.zeros(a.shape[:-1], np.float32)
    for k0 in range(0, a.shape[-1], 16):
        steps = (slice(k0, k0 + 8), slice(k0 + 8, k0 + 16))
        t = np.zeros_like(c)
        if order == "mma3_k16":
            for s in steps:
                t = mma(mma(mma(t, al[..., s], bh[..., s]), ah[..., s], bl[..., s]), ah[..., s], bh[..., s])
        elif order == "hi_last":
            for s in steps:
                t = mma(mma(t, al[..., s], bh[..., s]), ah[..., s], bl[..., s])
            for s in steps:
                t = mma(t, ah[..., s], bh[..., s])
        else:  # fresh_per_8
            for s in steps:
                u = mma(mma(mma(np.zeros_like(c), al[..., s], bh[..., s]), ah[..., s], bl[..., s]), ah[..., s], bh[..., s])
                t = (t + u).astype(np.float32)
        c = (c + t).astype(np.float32)
    return c


def dot_f32_fma(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    c = np.zeros(a.shape[:-1], np.float32)
    for i in range(a.shape[-1]):
        c = (c.astype(np.float64) + a[..., i].astype(np.float64) * b[..., i].astype(np.float64)).astype(np.float32)
    return c


def main() -> None:
    rng = np.random.default_rng(0)
    for depth in (32, 128):
        a, b = (rng.normal(size=(200_000, depth)).astype(np.float32) for _ in range(2))
        exact = (a.astype(np.float64) * b.astype(np.float64)).sum(-1)
        size = np.abs(a.astype(np.float64) * b).sum(-1)
        results = {"f32 FMA": dot_f32_fma(a, b)}
        results.update({order: dot_3xtf32(a, b, order) for order in ("mma3_k16", "hi_last", "fresh_per_8")})
        for name, got in results.items():
            err = (got.astype(np.float64) - exact) / size
            print(f"depth {depth:3d} {name:11s} mean {err.mean():+.2e} rms {np.sqrt((err ** 2).mean()):.2e} "
                  f"max {np.abs(err).max():.2e}")


if __name__ == "__main__":
    main()
