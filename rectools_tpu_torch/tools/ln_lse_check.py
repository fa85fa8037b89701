#!/usr/bin/env python3
"""A short check of kernel 4 (``layer_norm_bwd``, the LayerNorm backward),
kernel 15 (``lse_f32``, the carried-max lse) and kernel 16 (``lse_shift_f32``,
the bounded-shift lse) on one NVIDIA GPU: build, the compiler's register
report, agreement with the twins, bits on a rerun, event times and profiler
device times.

Run from the repository root: ``python3
rectools_tpu_torch/tools/ln_lse_check.py [--tree DIR] [--step]`` (a minute
or two). ``--tree`` imports ``rectools_tpu_torch`` from another checkout
(for example a ``git archive`` of the parent commit under the git-ignored
``build/``), so two versions can be timed in one call on one card.

Kernel 4, at the training shape (51,200 x 128) and at ragged shapes: its
largest error from the twin (dx absolute; dgamma and dbeta relative to their
largest entry), whether a rerun and calls at two shapes alternating on one
stream give the same bits, the call timed with CUDA events as
``chip_smoke.py`` times it (mean of 10 after 2 warm-ups), and the device
kernels of 20 calls by name from ``torch.profiler`` (their count a call and
mean device time; ``chip_smoke.py``'s helpers). ``--step``: the device time of kernel 4's kernels inside
one profiled SASRec train step at the KION width (``chip_smoke.py``'s frame
and configuration; 5 calls a step).

Kernel 15 (``USE_PARTIALS_FWD = False``) at 51,200 x 15,872 x 128: its
error relative to the twin per row, the same for plain TF32 products (the
control), bits on a rerun and its time, beside kernel 6's. Where the tree
has a cluster plan (``softmax_lse.lse_cluster_plan``): the same for every
cluster size C in 1, 2, 4, 8 (C = 1 is one block walking the whole catalog),
each with ``cudaOccupancyMaxActiveClusters`` (from a helper library the tool
builds under ``build/tools/``: the tree's ``softmax_lse.cu`` with one query
function added), at the three feature widths of the tensor-core tile.

Kernel 16 (``streaming_lse(..., bounded_shift=True)``) at 51,200 x 15,872 x
128 on the same inputs, and scaled by ``chip_smoke.SHIFT_WINDOW2_SCALE`` so
that window 2 serves the rows: the share of rows in window 1, its error
relative per row to its twin, to the twin in float64 (the exact function)
and, for the twin itself, to the float64 twin; the same for plain TF32
products (the control: the twin on TF32-rounded inputs); bits on a rerun,
its time, and the device kernel the profiler names (the tensor-core kernel
in its shift mode, or the SIMT ``lse_chunk_kernel`` of a tree from before
it). The first line names the card and its power limit; the last is one
JSON object.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
M, D, N = 51200, 128, 15872
CLUSTERS = (1, 2, 4, 8)
ENTRIES = ("ln_bwd", "lse_kernel", "lse_partials_tc", "lse_chunk")  # kernels whose ptxas report is printed
# cudaOccupancyMaxActiveClusters of kernel 15's tensor-core kernel: the tree's
# source with a query function, built beside the product's library
OCCUPANCY_SRC = r"""#include "{source}"

template <int D>
int lse_clusters(int cluster) {{
  if constexpr (tensor_cores(D)) {{
    cudaError_t err = cudaFuncSetAttribute(lse_partials_tc_kernel<D, {mode}>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(LseSmem<D>));
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = lse_cluster_config<D>(tc::kBM, cluster, nullptr, &attr);
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, lse_partials_tc_kernel<D, {mode}>, &cfg);
    return err == cudaSuccess ? n : -(int)err;
  }} else {{
    return -(int)cudaErrorInvalidValue;
  }}
}}

// the clusters of `cluster` blocks the card holds at once at width D; a
// negative cudaError_t where the query fails
extern "C" int lse_max_active_clusters(int D, int cluster) {{
  switch (D) {{
    case 32: return lse_clusters<32>(cluster);
    case 64: return lse_clusters<64>(cluster);
    case 128: return lse_clusters<128>(cluster);
    default: return -(int)cudaErrorInvalidValue;
  }}
}}
"""


def start_occupancy_build(native):
    """(nvcc process, library path) of the occupancy helper for the tree whose
    ``_native`` module is given."""
    out = HERE / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    cu = out / "lse_occupancy.cu"
    source = native.CSRC / "softmax_lse.cu"
    # kernel 15's template argument: a mode since kernel 16 joined the kernel, a flag before
    mode = "LseMode::kCluster" if "enum class LseMode" in source.read_text() else "true"
    cu.write_text(OCCUPANCY_SRC.format(source=source, mode=mode))
    so = out / "lse_occupancy.so"
    cmd = [native._nvcc(), *native.NVCC_FLAGS, "-o", str(so), str(cu)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--tree", type=Path, default=HERE, help="checkout whose rectools_tpu_torch is measured")
    parser.add_argument("--step", action="store_true", help="also profile one SASRec train step")
    args = parser.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    sys.path.insert(1, str(HERE))
    import torch

    import chip_smoke as smoke
    from rectools_tpu_torch.ops import _native, layer_norm
    from rectools_tpu_torch.ops import softmax_lse as sl

    if not torch.cuda.is_available():
        print("ln_lse_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; tree {args.tree}", flush=True)
    t0 = time.time()
    occupancy = start_occupancy_build(_native) if hasattr(sl, "lse_cluster_plan") else None
    reports = _native.build(("layer_norm", "softmax_lse"))
    print(f"build {time.time() - t0:.1f} s")
    for out in reports.values():
        lines = out.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(k in line for k in ENTRIES):
                print(line.strip()[:160])
                print("".join(f"    {nxt.strip()}\n" for nxt in lines[i + 1 : i + 4]
                              if "registers" in nxt or "spill" in nxt), end="")

    time_ms = smoke.time_ms

    def device_kernels(fn, calls: int) -> dict:
        return smoke.device_kernels(torch, fn, calls)

    def rel(got, ref) -> float:
        return ((got - ref).abs().max() / ref.abs().max()).item()

    def row_rel(got, ref) -> float:
        return ((got - ref).abs() / ref.abs()).max().item()

    def tf32(x):
        return smoke.tf32(torch, x)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    result = {"card": card, "tree": str(args.tree)}

    # kernel 4
    cases = {}
    for m, d in ((M, D), (1, 128), (8193, 128), (33, 96), (7, 1024), (65, 50)):
        x = torch.randn((m, d), generator=gen, device=dev) * 2 + 0.5
        gamma = torch.randn((d,), generator=gen, device=dev)
        dy = torch.randn((m, d), generator=gen, device=dev)
        cases[(m, d)] = (x, gamma, dy)
        _native.reset_launches()
        got = layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6)
        ref = layer_norm.layer_norm_bwd_reference(x, gamma, dy, 1e-6)
        res = dict(err_dx=(got[0] - ref[0]).abs().max().item(), err_sums=max(rel(got[1], ref[1]), rel(got[2], ref[2])),
                   launches=_native.LAUNCHES["layer_norm_bwd"],
                   bits=all(torch.equal(a, b) for a, b in zip(got, layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6))))
        if (m, d) == (M, D):
            res["ms"] = time_ms(lambda: layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6))
            res["device"] = device_kernels(lambda: layer_norm.layer_norm_bwd(x, gamma, dy, 1e-6), 20)
        result[f"ln_bwd_{m}x{d}"] = res
        print(f"kernel 4 {m}x{d}", res, flush=True)
    # calls at two shapes alternating on one stream: each the bits of its first call
    first = {key: layer_norm.layer_norm_bwd(*case, 1e-6) for key, case in cases.items()}
    alternating = all(
        all(torch.equal(a, b) for a, b in zip(layer_norm.layer_norm_bwd(*cases[key], 1e-6), first[key]))
        for _ in range(3) for key in ((8193, 128), (M, D), (1, 128), (M, D))
    )
    result["ln_bwd_alternating_bits"] = alternating
    print("kernel 4 alternating shapes, same bits:", alternating, flush=True)
    del cases, first
    torch.cuda.empty_cache()

    # kernel 15, beside kernel 6
    s = torch.randn((M, D), generator=gen, device=dev)
    items = 0.1 * torch.randn((N, D), generator=gen, device=dev)
    ref = sl.streaming_lse_reference(s, items)
    plain = row_rel(sl.streaming_lse_reference(tf32(s), tf32(items)), ref)
    for name, partials in (("lse_partials_fwd", True), ("lse_fwd", False)):
        sl.USE_PARTIALS_FWD = partials
        got = sl.streaming_lse(s, items)
        result[name] = dict(err=row_rel(got, ref), err_plain_tf32=plain, bits=bool(torch.equal(got, sl.streaming_lse(s, items))),
                            ms=time_ms(lambda: sl.streaming_lse(s, items), iters=5),
                            device=device_kernels(lambda: sl.streaming_lse(s, items), 3))
        print(name, result[name], flush=True)
    sl.USE_PARTIALS_FWD = True

    # kernel 16 in both windows
    for tag, scale in (("window_1", 1.0), ("window_2", smoke.SHIFT_WINDOW2_SCALE)):
        ss, ii = s * scale, items * scale
        twin = sl.streaming_lse_shift_reference(ss, ii)
        exact = sl.streaming_lse_shift_reference(ss.double(), ii.double())
        plain = sl.streaming_lse_shift_reference(tf32(ss), tf32(ii))
        before = _native.LAUNCHES["lse_shift_fwd"]
        got = sl.streaming_lse(ss, ii, bounded_shift=True)
        launches = _native.LAUNCHES["lse_shift_fwd"] - before
        _, l_sum, _ = sl.lse_shift_sums(ss, ii)
        res = dict(
            launches=launches, window_1_share=(l_sum >= sl.WINDOW1_FLOOR).float().mean().item(),
            err=row_rel(got, twin), err_exact=row_rel(got.double(), exact),
            twin_err_exact=row_rel(twin.double(), exact),
            err_plain_tf32=row_rel(plain, twin), plain_err_exact=row_rel(plain.double(), exact),
            finite=bool(torch.isfinite(got).all()),
            bits=bool(torch.equal(got, sl.streaming_lse(ss, ii, bounded_shift=True))),
            ms=time_ms(lambda: sl.streaming_lse(ss, ii, bounded_shift=True), iters=5),
            device=device_kernels(lambda: sl.streaming_lse(ss, ii, bounded_shift=True), 3),
        )
        result[f"lse_shift_fwd_{tag}"] = res
        print(f"kernel 16 {tag}", res, flush=True)
        del ss, ii, twin, exact, plain, got, l_sum
    torch.cuda.empty_cache()
    if occupancy is not None:
        proc, so = occupancy
        output, _ = proc.communicate(timeout=_native.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"ln_lse_check: nvcc failed for the occupancy helper:\n{output}")
        helper = ctypes.CDLL(str(so))
        helper.lse_max_active_clusters.argtypes = (ctypes.c_int, ctypes.c_int)
        lib = _native.load("softmax_lse", sl._SIGNATURES)
        stream = _native.current_stream_ptr(dev)
        for d in (32, 64, 128):
            sd, itd = s[:, :d].contiguous(), items[:, :d].contiguous()
            ref_d = sl.streaming_lse_reference(sd, itd)
            for c in CLUSTERS:
                rows = -(-(-(-N // sl.TILE)) // c) * sl.TILE
                out = torch.empty((M,), device=dev)

                def launch(out=out, sd=sd, itd=itd, c=c, rows=rows):
                    status = lib.lse_f32(sd.data_ptr(), itd.data_ptr(), out.data_ptr(), M, N, d, c, rows, stream)
                    assert status == 0, status

                launch()
                first_bits = out.clone()
                launch()
                res = dict(rows_per_rank=rows, err=row_rel(first_bits, ref_d), bits=bool(torch.equal(out, first_bits)),
                           ms=time_ms(launch, iters=5), max_active_clusters=helper.lse_max_active_clusters(d, c))
                result[f"lse_fwd_d{d}_c{c}"] = res
                print(f"kernel 15 d={d} C={c}", res, flush=True)
        result["lse_cluster_plan"] = sl.lse_cluster_plan(N)
    del s, items, ref
    torch.cuda.empty_cache()

    if args.step:
        import numpy as np
        import pandas as pd

        from rectools_tpu_torch import Columns
        from rectools_tpu_torch.dataset import Dataset
        from rectools_tpu_torch.models import SASRecModel
        from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet
        from rectools_tpu_torch.models.nn.transformers.training import pad_batch

        dataset = Dataset.construct(smoke.kion_frame(np, pd, Columns))
        model = SASRecModel(**smoke.TRAIN_CONFIG, item_net_block_types=(IdEmbeddingsItemNet,), device="cuda")
        model._build_model_from_dataset(dataset)
        tm = model.training_module
        tm.init_params()
        loader = iter(model.data_preparator.get_dataloader_train(np.random.default_rng(smoke.SEED)))
        batch = tm._device_batch(pad_batch(next(loader), smoke.TRAIN_B))
        tm._train_step(batch)
        step = device_kernels(lambda: tm._train_step(batch), 1)
        result["step_ln_bwd"] = {k: v for k, v in step.items() if "ln_bwd" in k}
        result["step_device_ms"] = sum(n * ms for n, ms in step.values())
        print("one SASRec step: kernel 4", result["step_ln_bwd"], "of", result["step_device_ms"], "ms", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
