#!/usr/bin/env python3
"""A short check of kernel 6 (``lse_partials_f32``) and kernel 18
(``stu_bwd_f32`` + ``stu_bwd_dq_f32``) on one NVIDIA GPU: build, the
compiler's register report, agreement with the twins, bits on a rerun, and
times.

Run from the repository root: ``python3
rectools_tpu_torch/tools/stu_lse_check.py`` (about a minute). It builds
``csrc/softmax_lse.cu`` and ``csrc/stu_attention.cu`` and prints ``ptxas``'s
registers and spills for the two kernels' tensor-core entries. Kernel 6:
at every feature width on ragged shapes, and at 51,200 x 128 session rows
against 15,872, 15,835 and 131,072 items, its largest error relative to the
twin in the card's chunks (per row), the same for plain TF32 products (the
control), and its time (CUDA events, mean of 5 after a warm-up). Kernel 18:
at ragged lengths and every head dim, at the HSTU training shape (B = 512, L
= 100, 4 heads of 32) and at B = 64, L = 1,024, its largest error against the
twin relative to the twin's largest entry, whether a rerun gives the same
bits, its launches, and at the two large shapes its time (and the dk/dv
launch's alone) beside autograd of the materialized form. The first line names the card and its power limit;
the last is one JSON object.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

M, D = 51200, 128
LSE_CATALOGS = (15872, 15835, 131072)
ENTRIES = ("lse_partials_tc", "stu_dkdv_tc", "stu_dq_tc")


def main() -> int:
    import torch
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import softmax_lse as sl
    from rectools_tpu_torch.ops import stu_attention as sa

    if not torch.cuda.is_available():
        print("stu_lse_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    t0 = time.time()
    reports = _native.build(("softmax_lse", "stu_attention"))
    print(f"build {time.time() - t0:.1f} s")
    for out in reports.values():
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(k in line for k in ENTRIES):
                print(line.strip()[:160])
                print("".join(f"    {nxt.strip()}\n" for nxt in lines[i + 1 : i + 4]
                              if "registers" in nxt or "spill" in nxt), end="")

    def time_ms(fn, iters: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def tf32(x):
        return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)

    def row_rel(got, ref) -> float:
        return ((got - ref).abs() / ref.abs()).max().item()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(6)
    out = {}
    for m, n, d in ((300, 2177, 32), (257, 1000, 64), (130, 4100, 128), (64, 64, 16), (130, 4100, 256)):
        s = 0.3 * torch.randn((m, d), generator=gen, device=dev)
        items = 0.3 * torch.randn((n, d), generator=gen, device=dev)
        _native.reset_launches()
        got = sl.streaming_lse(s, items)
        out[f"lse_{m}x{n}x{d}"] = dict(err=row_rel(got, sl.streaming_lse_partials_reference(s, items)),
                                       launches=_native.LAUNCHES["lse_partials_fwd"])
        print("kernel 6", m, n, d, out[f"lse_{m}x{n}x{d}"], flush=True)
    s = torch.randn((M, D), generator=gen, device=dev)
    for n in LSE_CATALOGS:
        items = 0.1 * torch.randn((n, D), generator=gen, device=dev)
        got = sl.streaming_lse(s, items)
        ref = sl.streaming_lse_partials_reference(s, items)
        plain_tf32 = sl.streaming_lse_partials_reference(tf32(s), tf32(items))
        out[f"lse_{n}"] = dict(
            err=row_rel(got, ref), err_plain_tf32=row_rel(plain_tf32, ref),
            bits=bool(torch.equal(got, sl.streaming_lse(s, items))), chunks=-(-n // sl.LSE_CHUNK),
            ms=time_ms(lambda: sl.streaming_lse(s, items)))
        print("kernel 6", M, n, D, out[f"lse_{n}"], flush=True)
        del items, got, ref
        torch.cuda.empty_cache()
    del s

    def stu_case(b, h, l, ad, lh, per_row):
        q, k = (torch.randn((b, l, h, ad), generator=gen, device=dev).transpose(1, 2) for _ in range(2))
        v, dout = (torch.randn((b, l, h, lh), generator=gen, device=dev).transpose(1, 2) for _ in range(2))
        gaps = torch.randint(1, 3 * 86400, (b, l + 2), generator=gen, device=dev)
        buckets = sa.time_buckets(1_600_000_000 + torch.cumsum(gaps, dim=1), l, 128)
        tw = 0.1 * torch.randn((129,), generator=gen, device=dev)
        pw = 0.1 * torch.randn((2 * l - 1,), generator=gen, device=dev)
        bias = sa.combined_bias(buckets, tw, pw, l, dev)
        n_pad = torch.randint(0, l, (b,), generator=gen, device=dev)
        n_pad[0], n_pad[-1] = 0, l
        timeline = (torch.arange(l, device=dev)[None, :] >= n_pad[:, None]).float()
        allowed = torch.ones((l, l), device=dev).tril()[None]
        if per_row:
            allowed = torch.maximum(allowed * timeline[:, None, :], torch.eye(l, device=dev)[None]).contiguous()
        return (q, k, v, bias, allowed, timeline), dout

    for b, h, l, ad, lh, per_row in ((2, 2, 80, 32, 32, False), (2, 2, 96, 64, 64, True), (3, 2, 7, 32, 64, False),
                                     (2, 2, 130, 64, 32, True), (2, 2, 80, 16, 16, False), (3, 2, 7, 8, 64, False),
                                     (512, 4, 100, 32, 32, False), (64, 4, 1024, 32, 32, False)):
        args, dout = stu_case(b, h, l, ad, lh, per_row)
        _native.reset_launches()
        got = sa.stu_bwd(*args, dout)
        launched = {k: _native.LAUNCHES[k] for k in ("stu_bwd", "stu_bwd_dq")}
        ref = sa.stu_bwd_reference(*args, dout)
        again = sa.stu_bwd(*args, dout)
        key = f"stu_bwd_{b}x{h}x{l}x{ad}x{lh}{'_per_row' if per_row else ''}"
        out[key] = dict(
            err={name: ((g - r).abs().max() / max(1.0, r.abs().max().item())).item()
                 for name, g, r in zip(("dq", "dk", "dv"), got, ref)},
            finite=all(bool(torch.isfinite(g).all()) for g in got),
            bits=all(bool(torch.equal(a, g)) for a, g in zip(again, got)), launches=launched)
        if b >= 64:
            leaves = [t.detach().clone().requires_grad_() for t in args[:3]]
            q, k, v = leaves
            bias, allowed, timeline = args[3:]
            mask = (allowed * timeline[:, :, None] * timeline[:, None, :])[:, None]
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
            lib_out = torch.einsum("bhqk,bhkd->bhqd", F.silu(s) / l * mask, v)
            ms = time_ms(lambda: sa.stu_bwd(*args, dout))
            route, sa.bwd_on_tensor_cores = sa.bwd_on_tensor_cores, lambda *_: False  # the dk/dv launch alone
            dkdv_ms = time_ms(lambda: sa.stu_bwd(*args, dout))
            sa.bwd_on_tensor_cores = route
            out[key].update(
                ms=ms, dkdv_ms=dkdv_ms, dq_ms=ms - dkdv_ms,
                library_ms=time_ms(lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)))
            del leaves, q, k, v, s, lib_out, mask
        print("kernel 18", key, out[key], flush=True)
        del args, dout, got, ref, again
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
