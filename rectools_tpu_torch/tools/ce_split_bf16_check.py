#!/usr/bin/env python3
"""A short check of the bf16 forms of kernel 7's two launches and of kernels
12-14 (bf16 training on large catalogs) on one NVIDIA GPU: build, the
compiler's register report, agreement with the twins, bits on a rerun, and
times.

Run from the repository root: ``python3
rectools_tpu_torch/tools/ce_split_bf16_check.py`` (about a minute). It builds
``csrc/softmax_lse_bf16.cu``, prints ``ptxas``'s registers, shared memory and
spills for its gradient kernels, then runs on bf16 towers, through the
wrappers: kernel 12 (``softmax_grads_from_z``, the budget lifted; kernel 7's
engine in ``csrc/ce_grads_bf16.cu``, built at first use), kernels 13 +
14 (the budget 0), kernel 7's two launches (the budget one byte under the
plan's one-pass partials) and the large-catalog CE route (the budget 0, against
kernel 7's one pass with the budget lifted), at small ragged shapes for D =
32, 64 and 128 with repeated labels and ignored rows, and at the KION training
shape 51,200 x 15,872 x 128. Each: ds and di relative to the twin's largest
entry, bits on a rerun, the launches, and times (CUDA events, mean of 3 after a
warm-up). The first line names the card and its power limit; the last is one
JSON object.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

SPLIT_RTOL, ROUTE_BAND = 2 ** -7, 2 ** -6
KERNELS = ("ce_fused_bf16_kernel", "split_ds_bf16_kernel", "split_di_bf16_kernel")


def main() -> int:
    import torch

    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import softmax_lse as sl

    if not torch.cuda.is_available():
        print("ce_split_bf16_check: needs an NVIDIA GPU", file=sys.stderr)
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
        return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(23)
    bf = torch.bfloat16
    budget = sl.FUSED_BWD_PARTIALS_BUDGET
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {"small_d32": (257, 2177, 32), "small_d64": (300, 4100, 64), "small_d128": (130, 20033, 128),
             "steps_d32": (40, 20011, 32), "train": (51200, 15872, 128)}
    out, failures = {}, []
    for name, (m, n, d) in cases.items():
        s = torch.randn((m, d), generator=gen, device=dev).to(bf)
        items = (0.1 * torch.randn((n, d), generator=gen, device=dev)).to(bf)
        y = torch.randint(1, n, (m,), generator=gen, device=dev)
        y[m // 3 : m // 2] = n - 1  # repeated labels on the catalog's tail
        y[torch.rand((m,), generator=gen, device=dev) < 0.1] = 0
        coeff = torch.where(y == 0, 0.0, 1.0 / float((y != 0).sum()))
        z = (sl.streaming_lse(s, items) - torch.log(coeff)).contiguous()
        plan = sl.fused_bwd_plan(m, n, d, n_sms, 2)[2]
        routes = {  # name: (budget, call, twin)
            "kernel_12": (1 << 62, lambda: sl.softmax_grads_from_z(s, items, z),
                          lambda: sl.softmax_grads_from_z_bf16_reference(s, items, z, partials=True)),
            "kernels_13_14": (0, lambda: sl.softmax_grads_from_z(s, items, z),
                              lambda: sl.softmax_grads_from_z_bf16_reference(s, items, z, partials=False)),
            "two_launches": (plan - 1, lambda: sl.softmax_ce_grads_from_z(s, items, z, y, coeff),
                             lambda: sl.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff,
                                                                                partials=False)),
            "one_pass": (1 << 62, lambda: sl.softmax_ce_grads_from_z(s, items, z, y, coeff),
                         lambda: sl.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff, partials=True)),
        }
        r, got = {}, {}
        for route, (forced, call, twin) in routes.items():
            sl.FUSED_BWD_PARTIALS_BUDGET = forced
            _native.reset_launches()
            got[route] = call()
            r[f"{route}_launches"] = {k: v for k, v in _native.LAUNCHES.items() if v}
            again = call()
            ref = twin()
            r[f"{route}_ds_err"], r[f"{route}_di_err"] = rel(got[route][0], ref[0]), rel(got[route][1], ref[1])
            r[f"{route}_bits"] = all(torch.equal(a, b) for a, b in zip(got[route], again))
            r[f"{route}_finite"] = all(bool(torch.isfinite(g).all()) for g in got[route])
            r[f"{route}_ms"] = time_ms(call)
            del again, ref
        sl.FUSED_BWD_PARTIALS_BUDGET = 0  # the large-catalog route against kernel 7's one pass on the same inputs
        route = sl.softmax_ce_grads_from_z(s, items, z, y, coeff)
        r["route_vs_one_pass"] = [rel(a, b) for a, b in zip(route, got["one_pass"])]
        r["route_ms"] = time_ms(lambda: sl.softmax_ce_grads_from_z(s, items, z, y, coeff))
        sl.FUSED_BWD_PARTIALS_BUDGET = budget
        out[name] = r
        print(name, (m, n, d), r, flush=True)
        ok = (all(r[f"{route}_{k}_err"] <= SPLIT_RTOL for route in routes for k in ("ds", "di") if route != "one_pass")
              and all(r[f"{route}_bits"] and r[f"{route}_finite"] for route in routes)
              and max(r["route_vs_one_pass"]) <= ROUTE_BAND)
        if not ok:
            failures.append(name)
        del s, items, y, coeff, z, got, route
        torch.cuda.empty_cache()
    print(json.dumps({"failures": failures, "cases": out}))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
