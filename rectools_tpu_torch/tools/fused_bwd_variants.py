#!/usr/bin/env python3
"""Time the tensor-core gradient kernels, fused (kernels 7, 9 and 12) and
split (kernel 7's two launches, 10 + 11, 13 + 14), beside variants of their
source, on one NVIDIA GPU: what each design choice of
``csrc/softmax_lse.cu`` buys at the KION training shape.

Run from the repository root:
``python3 rectools_tpu_torch/tools/fused_bwd_variants.py`` (a few minutes).
Each variant is a copy of the package under ``build/variants/<name>`` with
one edit:

- ``tile``: the source as it is.
- ``cvt``: TF32 rounding by the ``cvt.rna.tf32.f32`` instruction instead of
  its two-integer-operation form (the same bits).
- ``straight``: the 3xTF32 products accumulated straight onto the running
  fragment, no fresh fragment per 16 k.
- ``simt``: the gradient kernels (and kernel 6, not timed here) on the SIMT
  tile with its plans (64-row session tiles; fused: two blocks per SM;
  split: ds over the whole catalog in one block per session tile): the
  kernels before the tensor cores.

``cvt`` and ``straight`` edit ``csrc/tc_tile.cuh``, which kernel 18 shares;
only ``softmax_lse`` is built and timed.

The variants build at once (one ``nvcc`` each), then each is timed in a
process of its own, in turns, twice: kernels 7 (one pass), 9 and 12, and
the split pairs with the partials budget forced to 0 (7's two launches,
10 + 11, 13 + 14), at 51,200 x 15,872 x 128 (CUDA events, mean of 5 after a
warm-up), each with its largest error against its twin (in the same order)
relative to the twin's largest entry.
One JSON line per variant and round; the first line names the card and its
power limit.
"""

import json
import shutil
import subprocess
import sys
import typing as tp
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
M, N, D = 51200, 15872, 128
CU = "rectools_tpu_torch/csrc/softmax_lse.cu"
CUH = "rectools_tpu_torch/csrc/tc_tile.cuh"  # the tile's helpers, shared with csrc/stu_attention.cu
PY = "rectools_tpu_torch/ops/softmax_lse.py"
# name: [(file, text in it, replacement)]
VARIANTS = {
    "tile": [],
    "cvt": [(CUH, "{ return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }",
             '{\n  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));\n  return r;\n}')],
    "straight": [(CUH, "  float t[4] = {0.f, 0.f, 0.f, 0.f};\n", "  float* t = c;\n"),
                 (CUH, "#pragma unroll\n  for (int e = 0; e < 4; ++e) c[e] += t[e];\n", "")],
    "simt": [(CU, "constexpr bool tensor_cores(int d) { return d >= 32 && d <= 128; }",
              "constexpr bool tensor_cores(int d) { return false; }"),
             (PY, "{d: (128, 1, 4) if 32 <= d <= 128 else (TILE, 2, 1) for d in SUPPORTED_D}",
              "{d: (TILE, 2, 1) for d in SUPPORTED_D}")],
}


def edited_sources(name: str) -> tp.Dict[str, str]:
    """The files that variant ``name`` changes, as they read after its edits;
    raises unless each text to replace is in its file exactly once."""
    out: tp.Dict[str, str] = {}
    for rel, old, new in VARIANTS[name]:
        text = out[rel] if rel in out else (REPO / rel).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: the text to replace is not once in {rel}: {old!r}")
        out[rel] = text.replace(old, new)
    return out


def worker() -> None:
    """Time kernels 7, 9 and 12 and the split pairs of the package on
    sys.path[0]."""
    import torch

    from rectools_tpu_torch.ops import softmax_lse as sl

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

    def err(got, ref) -> float:
        return max(((g - r).abs().max() / r.abs().max()).item() for g, r in zip(got, ref))

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    s = torch.randn((M, D), generator=gen, device=dev)
    items = 0.1 * torch.randn((N, D), generator=gen, device=dev)
    y = torch.randint(1, N, (M,), generator=gen, device=dev)
    y[torch.rand((M,), generator=gen, device=dev) < 0.2] = 0
    coeff = (y != 0).float() / (y != 0).sum()
    lse = sl.streaming_lse(s, items)
    z = lse - torch.log(coeff)
    bias = torch.zeros(N, device=dev)
    dlse = torch.randn((M,), generator=gen, device=dev) / M
    ce_takes_split_route = sl.ce_takes_split_route
    calls = {
        "kernel_7": (lambda: sl.softmax_ce_grads_from_z(s, items, z, y, coeff),
                     lambda: sl.softmax_ce_grads_from_z_reference(s, items, z, y, coeff)),
        "kernel_9": (lambda: sl.streaming_lse_bwd(s, items, bias, lse, dlse),
                     lambda: sl.streaming_lse_bwd_reference(s, items, bias, lse, dlse)),
        "kernel_12": (lambda: sl.softmax_grads_from_z(s, items, z),
                      lambda: sl.softmax_grads_from_z_reference(s, items, z)),
    }
    calls.update({
        "kernel_7_pair": (calls["kernel_7"][0],
                          lambda: sl.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=False)),
        "kernels_10_11": (calls["kernel_9"][0],
                          lambda: sl.streaming_lse_bwd_reference(s, items, bias, lse, dlse, partials=False)),
        "kernels_13_14": (calls["kernel_12"][0],
                          lambda: sl.softmax_grads_from_z_reference(s, items, z, partials=False)),
    })
    budget = sl.FUSED_BWD_PARTIALS_BUDGET
    out = {}
    for name, (kernel, twin) in calls.items():
        # the split pairs: no partials budget, and the CE gradients kept off the large-catalog route
        split = name in ("kernel_7_pair", "kernels_10_11", "kernels_13_14")
        sl.FUSED_BWD_PARTIALS_BUDGET = 0 if split else budget
        sl.ce_takes_split_route = (lambda *_: False) if split else ce_takes_split_route
        out[f"{name}_err"] = err(kernel(), twin())
        out[f"{name}_ms"] = time_ms(kernel)
    print(json.dumps(out))


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--worker":
        sys.path.insert(0, sys.argv[2])
        worker()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("fused_bwd_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    roots = {}
    for name in VARIANTS:
        root = REPO / "build" / "variants" / name
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "rectools_tpu_torch", root / "rectools_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        for rel, text in edited_sources(name).items():
            (root / rel).write_text(text)
        roots[name] = root
    build = "from rectools_tpu_torch.ops import _native; _native.build(('softmax_lse',))"
    procs = {name: subprocess.Popen([sys.executable, "-c", build], cwd=root) for name, root in roots.items()}
    for name, proc in procs.items():
        if proc.wait() != 0:
            raise RuntimeError(f"variant {name} did not build")
    for round_ in (1, 2):
        for name, root in roots.items():
            result = subprocess.run([sys.executable, __file__, "--worker", str(root)], capture_output=True, text=True)
            if result.returncode != 0:
                raise RuntimeError(f"variant {name}: {result.stderr[-2000:]}")
            print(json.dumps({"variant": name, "round": round_, **json.loads(result.stdout.strip().splitlines()[-1])}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
