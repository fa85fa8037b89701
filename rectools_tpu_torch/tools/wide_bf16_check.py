#!/usr/bin/env python3
"""A short check of the bf16 loss kernels at the widths D = 256 (the models'
default) and D = 16 on one NVIDIA GPU: build, the compiler's report, agreement
with the twins, bits on a rerun, and times.

Run from the repository root: ``python3
rectools_tpu_torch/tools/wide_bf16_check.py [--widths 256,16] [--small]``
(about a minute). It builds ``csrc/softmax_lse_bf16.cu`` and prints, for every
kernel instantiated at those widths, ``ptxas``'s registers, stack frame and
spills and the shared memory a block takes (``lse_bf16_smem_bytes``), failing
on a stack frame, a spill or more than 232,448 bytes. Then, on bf16 towers
through the public wrappers, at a small ragged shape and (unless ``--small``)
at the KION training shape 51,200 x 15,872 and a (2, 2) mesh's shard 25,600 x
7,936: kernel 6, kernel 8 (a few rows biased -1e30; a zero bias must give
kernel 6's bits), kernel 7's one pass and its two launches, kernel 12, kernels
13 + 14, kernel 9 and kernels 10 + 11, the partials budget set for each
route. Each: the launches, the error from its twin (lse per row, gradients
relative to the twin's largest entry), bits on a rerun and its time (CUDA
events, mean of 3 after a warm-up). The first line names the card and its
power limit; the last is one JSON object.
"""

import argparse
import json
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

LSE_RTOL, GRAD_RTOL = 1e-6, 2 ** -7
SMEM_LIMIT = 232_448  # bytes of shared memory a block may take on an H100
KERNELS = ("lse_partials_bf16_kernel", "ce_fused_bf16_kernel", "split_ds_bf16_kernel", "split_di_bf16_kernel",
           "lse_bwd_di_bf16_kernel")


def ptxas_entries(report: str) -> dict:
    """{mangled entry: {"registers", "stack", "spill_stores", "spill_loads"}}
    from ``ptxas -v`` output."""
    entries, current = {}, None
    for line in report.splitlines():
        match = re.search(r"Compiling entry function '([^']+)'", line)
        if match:
            current = entries.setdefault(match.group(1), {})
        elif current is not None and "bytes stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            current.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif current is not None and "Used" in line and "registers" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return entries


def main() -> int:
    import torch

    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import softmax_lse as sl

    parser = argparse.ArgumentParser()
    parser.add_argument("--widths", default="256,16")
    parser.add_argument("--small", action="store_true", help="only the small ragged shapes")
    args = parser.parse_args()
    widths = [int(w) for w in args.widths.split(",")]
    if not torch.cuda.is_available():
        print("wide_bf16_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    failures = []
    t0 = time.time()
    reports = _native.build(("softmax_lse_bf16",))
    print(f"build {time.time() - t0:.1f} s")
    lib = _native.load("softmax_lse_bf16", sl._SIGNATURES_BF16)
    for d in widths:
        smem = {k: lib.lse_bf16_smem_bytes(i, d) for i, k in enumerate(KERNELS)}
        print(f"D={d} shared memory a block: {smem}")
        if max(smem.values()) > SMEM_LIMIT:
            failures.append(f"smem D={d}")
        for name, e in ptxas_entries(reports.get("softmax_lse_bf16", "")).items():
            if any(f"{k}ILi{d}E" in name for k in KERNELS):
                print(f"  {name[:90]}: {e}")
                if e.get("stack", 1) or e.get("spill_stores", 1) or e.get("spill_loads", 1):
                    failures.append(f"stack or spill: {name}")

    def time_ms(fn, iters: int = 3) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def rel(got, ref) -> float:
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(24)
    bf = torch.bfloat16
    budget = sl.FUSED_BWD_PARTIALS_BUDGET
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    shapes = {"small": (333, 5003)} if args.small else {"small": (333, 5003), "train": (51200, 15872),
                                                         "shard_2x2": (25600, 7936)}
    out = {}
    for d in widths:
        for tag, (m, n) in shapes.items():
            s = torch.randn((m, d), generator=gen, device=dev).to(bf)
            items = (0.1 * torch.randn((n, d), generator=gen, device=dev)).to(bf)
            bias = torch.zeros((n,), device=dev)
            bias[n - 3:] = sl.NEG_BIG
            y = torch.randint(1, n, (m,), generator=gen, device=dev)
            y[m // 3 : m // 2] = n - 1
            y[torch.rand((m,), generator=gen, device=dev) < 0.1] = 0
            coeff = torch.where(y == 0, 0.0, 1.0 / float((y != 0).sum()))
            dlse = torch.randn((m,), generator=gen, device=dev) / m
            r = {}
            _native.reset_launches()
            lse = sl.streaming_lse(s, items)
            ref = sl.streaming_lse_bf16_reference(s, items)
            r["6_err"] = ((lse - ref).abs() / ref.abs()).max().item()
            r["6_bits"] = bool(torch.equal(lse, sl.streaming_lse(s, items)))
            r["6_ms"] = time_ms(lambda: sl.streaming_lse(s, items))
            lse_b = sl.streaming_lse_fwd(s, items, bias)
            ref_b = sl.streaming_lse_bias_bf16_reference(s, items, bias)
            r["8_err"] = ((lse_b - ref_b).abs() / ref_b.abs()).max().item()
            r["8_zero_bias_bits"] = bool(torch.equal(sl.streaming_lse_fwd(s, items, torch.zeros_like(bias)), lse))
            r["8_ms"] = time_ms(lambda: sl.streaming_lse_fwd(s, items, bias))
            r["lse_launches"] = {k: v for k, v in _native.LAUNCHES.items() if v}
            ok = r["6_err"] <= LSE_RTOL and r["8_err"] <= LSE_RTOL and r["6_bits"] and r["8_zero_bias_bits"]
            z = (lse - torch.log(coeff)).contiguous()
            plan = sl.fused_bwd_plan(m, n, d, n_sms, 2, bf)[2]
            routes = {  # name: (budget, launch keys, call, twin)
                "7": (1 << 62, ("ce_grads_fused_bf16",), lambda: sl.softmax_ce_grads_from_z(s, items, z, y, coeff),
                      lambda: sl.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff, partials=True)),
                "7_pair": (plan - 1, ("ce_grads_ds_bf16", "ce_grads_di_bf16"),
                           lambda: sl.softmax_ce_grads_from_z(s, items, z, y, coeff),
                           lambda: sl.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff, partials=False)),
                "12": (1 << 62, ("grads_z_fused_bf16",), lambda: sl.softmax_grads_from_z(s, items, z),
                       lambda: sl.softmax_grads_from_z_bf16_reference(s, items, z, partials=True)),
                "13_14": (0, ("grads_z_ds_bf16", "grads_z_di_bf16"), lambda: sl.softmax_grads_from_z(s, items, z),
                          lambda: sl.softmax_grads_from_z_bf16_reference(s, items, z, partials=False)),
                "9": (1 << 62, ("lse_bwd_fused_bf16",), lambda: sl.streaming_lse_bwd(s, items, bias, lse_b, dlse),
                      lambda: sl.streaming_lse_bwd_bf16_reference(s, items, bias, lse_b, dlse, partials=True)),
                "10_11": (0, ("lse_bwd_ds_bf16", "lse_bwd_di_bf16"),
                          lambda: sl.streaming_lse_bwd(s, items, bias, lse_b, dlse),
                          lambda: sl.streaming_lse_bwd_bf16_reference(s, items, bias, lse_b, dlse, partials=False)),
            }
            if sl.ce_takes_split_route(m, n, d, bf):  # kernel 7 is not this catalog's route
                del routes["7"], routes["7_pair"]
            for route, (forced, keys, call, twin) in routes.items():
                sl.FUSED_BWD_PARTIALS_BUDGET = forced
                try:
                    _native.reset_launches()
                    got = call()
                    launches = {k: v for k, v in _native.LAUNCHES.items() if v}
                    again = call()
                    want = twin()
                    errs = [rel(g, w) for g, w in zip(got, want)]
                    bits = all(bool(torch.equal(a, b)) for a, b in zip(got, again))
                    finite = all(bool(torch.isfinite(g).all()) for g in got)
                    ms = time_ms(call)
                finally:
                    sl.FUSED_BWD_PARTIALS_BUDGET = budget
                r[route] = {"errs": errs, "bits": bits, "ms": ms, "launches": launches}
                ok = ok and launches == {k: 1 for k in keys} and bits and finite and max(errs) <= GRAD_RTOL
                del got, again, want
            key = f"d{d}_{tag}"
            out[key] = r
            print(key, (m, n, d), json.dumps(r), flush=True)
            if not ok:
                failures.append(key)
            del s, items, bias, y, coeff, dlse, lse, ref, lse_b, ref_b, z
            torch.cuda.empty_cache()
    print(json.dumps({"failures": failures, "cases": out}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
