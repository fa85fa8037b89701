#!/usr/bin/env python3
"""A short check of kernels 6 and 8 (``lse_partials_f32``, ``lse_bias_f32``)
and kernels 18 and 19 (``stu_bwd_f32`` + ``stu_bwd_dq_f32``, ``stu_ds_f32``)
on one NVIDIA GPU: build, the compiler's register report, agreement with
the twins, bits on a rerun, and times.

Run from the repository root: ``python3
rectools_tpu_torch/tools/stu_lse_check.py`` (about a minute). It builds
``csrc/softmax_lse.cu`` and ``csrc/stu_attention.cu`` and prints ``ptxas``'s
registers and spills for the kernels' tensor-core entries. Kernel 6: at
every feature width on ragged shapes, and at 51,200 x 128 session rows
against 15,872, 15,835 and 131,072 items, its largest error relative to the
twin in the card's chunks (per row), the same for plain TF32 products (the
control), and its time (CUDA events, mean of 5 after a warm-up). Kernel 8:
the same at every feature width with invalid (-1e30) rows, a whole item
chunk of them in one case, whether a zero bias gives kernel 6's bits, and at
the mesh's three shapes (51,200 x 15,872; a (2, 2) shard, 25,600 x 7,936; the
last shard of a 15,835-row catalog cut four ways, one invalid row) with its
time. Kernels 18 and 19: at ragged lengths and every head dim, at the HSTU
training shape (B = 512, L = 100, 4 heads of 32) and at B = 64, L = 1,024,
the largest error against the twin relative to the twin's largest entry
(19: ds and its sums by time bucket), whether a rerun gives the same bits,
the launches, and at the two large shapes the times (18's dk/dv launch
alone; 19 with and without the bucket sums) beside autograd of the
materialized form (19: to the bias, then ``index_add_`` by bucket). The
first line names the card and its power limit; the last is one JSON object.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

M, D = 51200, 128
LSE_CATALOGS = (15872, 15835, 131072)
ENTRIES = ("lse_partials_tc", "stu_dkdv_tc", "stu_dq_tc", "stu_ds_tc")
NEG_BIG = -1e30


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

    def lse_bias_case(m, n, d, n_invalid, timed):  # timed: the scales of chip_smoke.py's mesh kernel phase
        s = (1.0 if timed else 0.3) * torch.randn((m, d), generator=gen, device=dev)
        items = (0.1 if timed else 0.3) * torch.randn((n, d), generator=gen, device=dev)
        bias = torch.zeros((n,), device=dev)
        if n_invalid:
            items[n - n_invalid :] = 0.0  # the zero rows a shard is padded with
            bias[n - n_invalid :] = NEG_BIG
        _native.reset_launches()
        got = sl.streaming_lse_fwd(s, items, bias)
        ref = sl.streaming_lse_bias_reference(s, items, bias)
        res = dict(err=row_rel(got, ref), finite=bool(torch.isfinite(got).all()),
                   bits=bool(torch.equal(got, sl.streaming_lse_fwd(s, items, bias))),
                   launches=_native.LAUNCHES["lse_bias_fwd"])
        if not n_invalid:  # a zero bias: kernel 6's bits
            res["kernel_6_bits"] = bool(torch.equal(got, sl.streaming_lse_fwd(s, items)))
        if timed:
            res["err_plain_tf32"] = row_rel(sl.streaming_lse_bias_reference(tf32(s), tf32(items), bias), ref)
            res["ms"] = time_ms(lambda: sl.streaming_lse_fwd(s, items, bias))
        return res

    ragged_shard = -(-15835 // 4)
    for m, n, d, n_invalid, timed in ((300, 2177, 32, 5, False), (257, 1000, 64, 1000, False),
                                      (130, 6200, 128, 2104, False), (64, 64, 16, 3, False),
                                      (130, 4100, 256, 0, False), (301, 2500, 128, 0, False),
                                      (M, 15872, D, 0, True), (M // 2, 7936, D, 0, True),
                                      (M // 2, ragged_shard, D, 4 * ragged_shard - 15835, True)):
        key = f"lse_bias_{m}x{n}x{d}_{n_invalid}_invalid"
        out[key] = lse_bias_case(m, n, d, n_invalid, timed)
        print("kernel 8", key, out[key], flush=True)
        torch.cuda.empty_cache()

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
        return (q, k, v, bias, allowed, timeline), dout, buckets

    for b, h, l, ad, lh, per_row in ((2, 2, 80, 32, 32, False), (2, 2, 96, 64, 64, True), (3, 2, 7, 32, 64, False),
                                     (2, 2, 130, 64, 32, True), (2, 4, 190, 64, 64, True), (2, 2, 80, 16, 16, False),
                                     (3, 2, 7, 8, 64, False),
                                     (512, 4, 100, 32, 32, False), (64, 4, 1024, 32, 32, False)):
        args, dout, buckets = stu_case(b, h, l, ad, lh, per_row)
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
        _native.reset_launches()
        ds = sa.stu_ds(*args, dout, buckets, 129)
        ds_key = f"stu_ds_{b}x{h}x{l}x{ad}x{lh}{'_per_row' if per_row else ''}"
        out[ds_key] = dict(launches=_native.LAUNCHES["stu_ds"], tile=sa.ds_tile(ad, lh))
        ref_ds = sa.stu_ds_reference(*args, dout, buckets, 129)
        again_ds = sa.stu_ds(*args, dout, buckets, 129)
        out[ds_key].update(
            err={name: ((g - r).abs().max() / max(1.0, r.abs().max().item())).item()
                 for name, g, r in zip(("ds", "bucket_sums"), ds, ref_ds)},
            finite=all(bool(torch.isfinite(g).all()) for g in ds),
            bits=all(bool(torch.equal(a, g)) for a, g in zip(again_ds, ds)),
            alone_bits=bool(torch.equal(sa.stu_ds(*args, dout)[0], ds[0])))
        if b >= 64:
            leaves = [t.detach().clone().requires_grad_() for t in (*args[:4],)]
            q, k, v, bias = leaves
            allowed, timeline = args[4:]
            mask = (allowed * timeline[:, :, None] * timeline[:, None, :])[:, None]
            s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
            lib_out = torch.einsum("bhqk,bhkd->bhqd", F.silu(s) / l * mask, v)
            ms = time_ms(lambda: sa.stu_bwd(*args, dout))
            route, sa.bwd_on_tensor_cores = sa.bwd_on_tensor_cores, lambda *_: False  # the dk/dv launch alone
            dkdv_ms = time_ms(lambda: sa.stu_bwd(*args, dout))
            sa.bwd_on_tensor_cores = route
            out[key].update(
                ms=ms, dkdv_ms=dkdv_ms, dq_ms=ms - dkdv_ms,
                library_ms=time_ms(lambda: torch.autograd.grad(lib_out, leaves[:3], dout, retain_graph=True)))

            def library_ds():
                (dbias,) = torch.autograd.grad(lib_out, leaves[3:], dout, retain_graph=True)
                return dbias, torch.zeros(129, device=dev).index_add_(0, buckets.reshape(-1), dbias.reshape(-1))

            out[ds_key].update(ms=time_ms(lambda: sa.stu_ds(*args, dout, buckets, 129)),
                               alone_ms=time_ms(lambda: sa.stu_ds(*args, dout)), library_ms=time_ms(library_ds))
            del leaves, q, k, v, bias, s, lib_out, mask
        print("kernel 18", key, out[key], flush=True)
        print("kernel 19", ds_key, out[ds_key], flush=True)
        del args, dout, got, ref, again, ds, ref_ds, again_ds
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
