#!/usr/bin/env python3
"""A short check of the split gradient kernels on one NVIDIA GPU: build, the
compiler's register report, agreement with the twins, bits on a rerun, and
times.

Run from the repository root: ``python3
rectools_tpu_torch/tools/split_bwd_check.py`` (about a minute). It builds
``csrc/softmax_lse.cu``, prints ``ptxas``'s registers and spills for the
tensor-core gradient kernels, then at 51,200 x 128 session rows against
15,872 and 131,072 items runs the three split pairs through their wrappers
with the partials budget forced to 0 (kernel 7's two launches with the
large-catalog route set aside; kernels 10 + 11; kernels 13 + 14): each
pair's largest error against its twin in the split order relative to the
twin's largest entry, whether a rerun gives the same bits, its time (CUDA
events, mean of 3 after a warm-up), and kernels 13 and 14 timed alone. The
first line names the card and its power limit; the last is one JSON object.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

M, D, CATALOGS = 51200, 128, (15872, 131072)


def main() -> int:
    import torch

    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import softmax_lse as sl

    if not torch.cuda.is_available():
        print("split_bwd_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    t0 = time.time()
    reports = _native.build(("softmax_lse",))
    print(f"build {time.time() - t0:.1f} s")
    for out in reports.values():
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(k in line for k in ("grad_ds_tc", "grad_di_tc", "lse_bwd_fused_tc")):
                print(line.strip()[:160])
                print("".join(f"    {nxt.strip()}\n" for nxt in lines[i + 1 : i + 4]
                              if "registers" in nxt or "spill" in nxt), end="")

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
    gen = torch.Generator(device=dev).manual_seed(5)
    s = torch.randn((M, D), generator=gen, device=dev)
    budget, takes_route = sl.FUSED_BWD_PARTIALS_BUDGET, sl.ce_takes_split_route
    out = {}
    for n in CATALOGS:
        items = 0.1 * torch.randn((n, D), generator=gen, device=dev)
        y = torch.randint(1, n, (M,), generator=gen, device=dev)
        y[torch.rand((M,), generator=gen, device=dev) < 0.2] = 0
        coeff = (y != 0).float() / (y != 0).sum()
        lse = sl.streaming_lse(s, items)
        z = lse - torch.log(coeff)
        bias = torch.zeros(n, device=dev)
        dlse = torch.randn((M,), generator=gen, device=dev) / M
        sl.FUSED_BWD_PARTIALS_BUDGET, sl.ce_takes_split_route = 0, lambda *_: False
        pairs = {
            "ce": (lambda: sl.softmax_ce_grads_from_z(s, items, z, y, coeff),
                   lambda: sl.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=False)),
            "lse": (lambda: sl.streaming_lse_bwd(s, items, bias, lse, dlse),
                    lambda: sl.streaming_lse_bwd_reference(s, items, bias, lse, dlse, partials=False)),
            "z": (lambda: sl.softmax_grads_from_z(s, items, z),
                  lambda: sl.softmax_grads_from_z_reference(s, items, z, partials=False)),
        }
        for name, (kernel, twin) in pairs.items():
            _native.reset_launches()
            got, again, ref = kernel(), kernel(), twin()
            out[f"{name}_{n}"] = dict(
                err_ds=rel(got[0], ref[0]), err_di=rel(got[1], ref[1]),
                bits=all(torch.equal(a, b) for a, b in zip(got, again)), ms_pair=time_ms(kernel),
                launched={k: v for k, v in _native.LAUNCHES.items() if v})
            print(name, n, out[f"{name}_{n}"], flush=True)
        sl.FUSED_BWD_PARTIALS_BUDGET, sl.ce_takes_split_route = budget, takes_route
        lib = _native.load("softmax_lse", sl._SIGNATURES)
        stream = _native.current_stream_ptr(dev)
        n_chunks, chunk_rows = sl.split_bwd_plan(M, n, D, torch.cuda.get_device_properties(dev).multi_processor_count)
        ds_part, di = torch.empty((n_chunks, M, D), device=dev), torch.empty_like(items)
        args = (s.data_ptr(), items.data_ptr(), z.data_ptr())
        out[f"z_alone_{n}"] = dict(
            ds_ms=time_ms(lambda: lib.grads_z_ds_f32(*args, ds_part.data_ptr(), M, n, D, chunk_rows, n_chunks, stream)),
            di_ms=time_ms(lambda: lib.grads_z_di_f32(*args, di.data_ptr(), M, n, D, stream)))
        print("z alone", n, out[f"z_alone_{n}"], flush=True)
        del items, y, coeff, lse, z, bias, dlse, ds_part, di
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
