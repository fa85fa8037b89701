#!/usr/bin/env python3
"""A short check of the bf16 forms of kernels 8-11 (the mesh loss on bf16
towers) on one NVIDIA GPU: build, the compiler's register report, agreement
with the twins, bits on a rerun, and times.

Run from the repository root: ``python3
rectools_tpu_torch/tools/mesh_bf16_check.py`` (about a minute). It builds
``csrc/softmax_lse_bf16.cu``, prints ``ptxas``'s registers, shared memory and
spills for its kernels, then runs the biased lse (kernel 8), the fused
backward (kernel 9) and the split pair (kernels 10 + 11, the partials budget
forced to 0) through their wrappers on bf16 towers: at small ragged shapes
for D = 32, 64 and 128 (a -1e30 row in the middle and at the end, mixed-sign
cotangent), and at the shapes mesh training gives them at the KION width
(51,200 x 15,872; a (2, 2) shard 25,600 x 7,936; the last shard of the
15,835-row catalog cut four ways, 25,600 x 3,959 with one invalid row).
Each: the lse's largest error relative per row, ds and di relative to the
twin's largest entry, bits on a rerun, kernel 8's bits against kernel 6's at
a zero bias, the invalid rows' di exactly 0, and times (CUDA events, mean of
3 after a warm-up). The first line names the card and its power limit; the
last is one JSON object.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

LSE_RTOL, GRAD_RTOL = 1e-6, 2 ** -7
KERNELS = ("lse_partials_bf16_kernel", "ce_fused_bf16_kernel", "split_ds_bf16_kernel", "lse_bwd_di_bf16_kernel")


def main() -> int:
    import torch

    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import softmax_lse as sl

    if not torch.cuda.is_available():
        print("mesh_bf16_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    t0 = time.time()
    reports = _native.build(("softmax_lse_bf16",))
    print(f"build {time.time() - t0:.1f} s")
    for out in reports.values():
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(k in line for k in KERNELS):
                print(line.strip()[:160])
                print("".join(f"    {nxt.strip()}\n" for nxt in lines[i + 1 : i + 4]
                              if "registers" in nxt or "spill" in nxt or "smem" in nxt), end="")

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
        return ((got - ref).abs().max() / ref.abs().max()).item()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(22)
    bf = torch.bfloat16
    budget = sl.FUSED_BWD_PARTIALS_BUDGET
    cases = {f"small_d{d}": (333, 1000, d, (517, 999)) for d in (32, 64, 128)}
    cases.update(train=(51200, 15872, 128, ()), shard_2x2=(25600, 7936, 128, ()),
                 ragged_shard=(25600, 3959, 128, (3958,)))
    out, failures = {}, []
    for name, (m, n, d, invalid) in cases.items():
        s = torch.randn((m, d), generator=gen, device=dev).to(bf)
        items = (0.1 * torch.randn((n, d), generator=gen, device=dev)).to(bf)
        bias = torch.zeros((n,), device=dev)
        for row in invalid:
            items[row] = 0.0
            bias[row] = sl.NEG_BIG
        dlse = torch.randn((m,), generator=gen, device=dev) / m
        _native.reset_launches()
        lse = sl.streaming_lse_fwd(s, items, bias)
        ref = sl.streaming_lse_bias_bf16_reference(s, items, bias)
        r = dict(lse_err=((lse - ref).abs() / ref.abs()).max().item(),
                 lse_bits=torch.equal(lse, sl.streaming_lse_fwd(s, items, bias)))
        if not invalid:
            r["lse_bits_kernel6"] = torch.equal(lse, sl.streaming_lse_fwd(s, items))
        for route, forced in (("fused", 1 << 62), ("split", 0)):
            sl.FUSED_BWD_PARTIALS_BUDGET = forced
            got = sl.streaming_lse_bwd(s, items, bias, lse, dlse)
            again = sl.streaming_lse_bwd(s, items, bias, lse, dlse)
            twin = sl.streaming_lse_bwd_bf16_reference(s, items, bias, lse, dlse, partials=route == "fused")
            r[f"{route}_ds_err"], r[f"{route}_di_err"] = rel(got[0], twin[0]), rel(got[1], twin[1])
            r[f"{route}_bits"] = all(torch.equal(a, b) for a, b in zip(got, again))
            r[f"{route}_finite"] = all(bool(torch.isfinite(g).all()) for g in got)
            if invalid:
                r[f"{route}_invalid_di_zero"] = not bool(got[1][list(invalid)].any())
            r[f"{route}_ms"] = time_ms(lambda: sl.streaming_lse_bwd(s, items, bias, lse, dlse))
        sl.FUSED_BWD_PARTIALS_BUDGET = budget
        r["lse_ms"] = time_ms(lambda: sl.streaming_lse_fwd(s, items, bias))
        r["launches"] = {k: v for k, v in _native.LAUNCHES.items() if v}
        out[name] = r
        print(name, (m, n, d), r, flush=True)
        ok = (r["lse_err"] <= LSE_RTOL and r["lse_bits"] and r.get("lse_bits_kernel6", True)
              and all(r[f"{route}_{k}_err"] <= GRAD_RTOL for route in ("fused", "split") for k in ("ds", "di"))
              and all(r[f"{route}_bits"] and r[f"{route}_finite"] and r.get(f"{route}_invalid_di_zero", True)
                      for route in ("fused", "split")))
        if not ok:
            failures.append(name)
        del s, items, bias, dlse, lse, ref, got, again, twin
        torch.cuda.empty_cache()
    print(json.dumps({"failures": failures, "cases": out}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
