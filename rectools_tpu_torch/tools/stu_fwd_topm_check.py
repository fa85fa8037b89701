#!/usr/bin/env python3
"""A short check of kernels 17 and 3 (``stu_fwd_f32``, ``group_topm_f32``) on
one NVIDIA GPU: build, the compiler's register report, agreement with the
twins, bits on a rerun, error against float64 in each 3xTF32 order, and times
beside the kernels they replaced and the library calls.

Run from the repository root on a machine with one GPU: ``python3
rectools_tpu_torch/tools/stu_fwd_topm_check.py`` (about three minutes). It builds
``csrc/stu_attention.cu`` and ``csrc/topk_select.cu`` as they are and as
VARIANTS edits them (the copies under ``build/variants/``, every build at
once) and prints ``ptxas``'s registers and spills of their kernels. The
variants: ``simt`` (the forward on the SIMT kernel at every head dim, as
before its redesign), ``order`` (``mma3_k16``'s 3xTF32 order), ``warp``
(every m on the top-m kernel of m > 16, the sorting kernel, launch key
``group_topm_warp``: at the serving m = 12 it sorts each whole group); and
three diagnostics of the tensor-core forward, timed only: ``no_act`` (a = s *
mask), ``tf32`` (plain TF32 products) and ``no_bias`` (no bias staged). Then,
on the builds as they are: the forward at ragged lengths, every head-dim
route, shared and per-row masks, against its twin (1e-5 of the twin's largest
entry, at least 1), zeros for the fully padded row, bits on a rerun; the
top-m at m = 1, 12,
16, 17, 50, 70 and 128 on edge-case groups against its twin, every slot. At the HSTU
training shape (B = 512, L = 100, 4 heads of 32) the largest error of the
twin and of the forward builds against float64. Last, each kernel timed
(CUDA events, mean of 20 after a warm-up) on each build in 8 rounds of turns
(the builds in order, then backwards), with each build's median, beside the
library call: the forward at B = 512 and at B = 64, L = 1,024, with every
length as likely, and at the serving batch B = 4,096 with the frame's
session lengths; the top-m at the serving shape (4,096 rows of 15,872
columns, m = 12) beside ``torch.topk``. The first line names the card and
its power limit; the last is one JSON object.
"""

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

TOL = 1e-5
TURNS = 8
# name: (source, [(file in csrc/, text, replacement), ...]); each text must be once in its file. The last three
# are diagnostics of the tensor-core forward, timed only: no activation (a = s * mask), plain TF32 products (the
# forward's 3xTF32 order without its small products), no bias staged
_STU, _TOPK = "stu_attention.cu", "topk_select.cu"
_FWD_ROUTE = "    if constexpr ({}) {{\n      const int smem = (int)sizeof(FwdSmem"
_STAGE_BIAS = "  {}stage_mask_async<kFwdMaskPitch, kFwdKeys, kFwdQueries, kFwdThreads>(st.bias,"
VARIANTS = {
    "simt": ("stu_attention", [(_STU, _FWD_ROUTE.format("stu_tensor_cores(AD, LH)"), _FWD_ROUTE.format("false"))]),
    "order": ("stu_attention", [(_STU, "constexpr bool kFwdHiLast = true;", "constexpr bool kFwdHiLast = false;")]),
    "warp": ("topk_select", [(_TOPK, f"  if (m <= {n}) return launch_select<{n}>",
                              f"  if (false) return launch_select<{n}>") for n in (4, 8, 12)]
             + [(_TOPK, "  if (m <= kSelectMaxM) return", "  if (false) return")]),
    "no_act": ("stu_attention", [(_STU, "  return fmaf(fmaf(-q, Lf, y), rL, q) * mask;", "  return x * mask;")]),
    "tf32": ("stu_attention", [("tc_tile.cuh", """  for (int ks = 0; ks < 2; ++ks) {
    mma(t, al[ks], bh[ks]);
    mma(t, ah[ks], bl[ks]);
  }
  mma(t, ah[0], bh[0]);""", """  mma(t, ah[0], bh[0]);""")]),
    "no_bias": ("stu_attention", [(_STU, _STAGE_BIAS.format(""), _STAGE_BIAS.format("if (false) "))]),
}
STU_CASES = (  # b, h, l, ad, lh, per-row mask
    (3, 4, 100, 32, 32, False), (3, 4, 100, 64, 64, True), (2, 2, 80, 32, 32, False), (2, 2, 96, 32, 32, True),
    (2, 4, 1024, 32, 32, True), (2, 2, 130, 64, 32, True), (3, 2, 7, 32, 64, False), (2, 2, 100, 16, 16, True),
    (2, 2, 33, 8, 8, False),
)


def variant_source(name: str) -> Path:
    """A copy of csrc/ with its files edited as VARIANTS[name] says."""
    root = REPO / "build" / "variants" / f"stu_fwd_topm_{name}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "rectools_tpu_torch" / "csrc", root)
    for file, old, new in VARIANTS[name][1]:
        text = (root / file).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"stu_fwd_topm_check: {old!r} is not once in csrc/{file}")
        (root / file).write_text(text.replace(old, new))
    return root


def main() -> int:
    import torch

    import chip_smoke
    from rectools_tpu_torch.ops import _native, stu_attention, topk_select

    if not torch.cuda.is_available():
        print("stu_fwd_topm_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    roots = {"as_is": _native.CSRC, **{name: variant_source(name) for name in VARIANTS}}

    def use(source: str, build: str) -> None:
        _native.CSRC = roots[build]
        _native._LIBS.pop(source, None)

    t0 = time.time()
    procs = {}  # every build at once, one nvcc each, into build/kernels/ under its own hash
    _native.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for build, source in (*((name, src) for name, (src, _) in VARIANTS.items()), ("as_is", "stu_attention"),
                          ("as_is", "topk_select")):
        _native.CSRC = roots[build]
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-o", str(_native._so_path(source)),
               str(roots[build] / f"{source}.cu")]
        procs[build, source] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for (build, source), proc in procs.items():
        lines = proc.communicate(timeout=_native.BUILD_TIMEOUT_S)[0].splitlines()
        if proc.returncode != 0:
            raise RuntimeError(f"stu_fwd_topm_check: nvcc failed for {build} {source}.cu:\n" + "\n".join(lines))
        for i, line in enumerate(lines):
            if "Compiling entry" in line and ("stu_fwd" in line or "group_topm" in line):
                regs = [nxt.strip() for nxt in lines[i + 1 : i + 4] if "registers" in nxt or "spill" in nxt]
                print(f"{build}: {line.strip()[:150]}\n    " + "\n    ".join(regs))
    use("stu_attention", "as_is")
    print(f"build {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(11)
    out = {"stu_fwd": {}, "group_topm": {}}
    for b, h, l, ad, lh, per_row in STU_CASES:
        q, k = (torch.randn((b, l, h, ad), generator=gen, device=dev).transpose(1, 2) for _ in range(2))
        v = torch.randn((b, l, h, lh), generator=gen, device=dev).transpose(1, 2)
        _, _, _, _, bias, allowed, timeline, _ = chip_smoke._stu_case(torch, dev, gen, b, l, per_row)
        args = (q, k, v, bias, allowed, timeline)
        _native.reset_launches()
        got = stu_attention.stu_fwd(*args)
        launches = {key: _native.LAUNCHES[key] for key in ("stu_fwd", "stu_fwd_simt")}
        ref = stu_attention.stu_reference(*args)
        err = (got - ref).abs().max().item()
        ok = bool(torch.isfinite(got).all()) and err <= TOL * max(1.0, ref.abs().max().item())
        out["stu_fwd"][f"{b}x{h}x{l}x{ad}x{lh}{'_per_row' if per_row else ''}"] = dict(
            err=err, ok=ok, padded_row_zero=not bool(got[-1].any()),
            bits=bool(torch.equal(stu_attention.stu_fwd(*args), got)), launches=launches)
    print("stu_fwd cases", out["stu_fwd"], flush=True)

    for m in (1, 12, 16, 17, 50, 70, 128):
        rng = torch.Generator(device=dev).manual_seed(m)
        x = torch.randn((64, 124 * 128), generator=rng, device=dev)
        x[:, 5::7] = x[:, 3::7].clone()  # ties
        x[1, :128] = 0.5  # 128 equal values
        x[2, 128:256] = float("-inf")
        x[3, 256:384] = float("-inf")  # fewer than m finite values
        x[3, 256:256 + max(m // 2, 1)] = 1.0
        x[4, 512:640] = torch.round(x[4, 512:640] * 4) / 4  # coarse ties across the m-th slot
        x[:, -1] = float("-inf")
        _native.reset_launches()
        vals, lanes = topk_select.group_topm(x, m)
        ref_vals, ref_lanes = topk_select.group_topm_reference(x, m)
        out["group_topm"][f"m={m}"] = dict(
            equal=bool(torch.equal(vals, ref_vals) and torch.equal(lanes, ref_lanes)),
            launches={key: _native.LAUNCHES[key] for key in ("group_topm", "group_topm_warp")})
    print("group_topm cases", out["group_topm"], flush=True)

    # error against float64 at the training shape, each forward build
    q, k, v, _, bias, allowed, timeline, _ = chip_smoke._stu_case(torch, dev, gen, 512, 100)
    args = (q, k, v, bias, allowed, timeline)
    ref64 = stu_attention.stu_reference(*(t.double() for t in args))
    vs64 = {"twin": (stu_attention.stu_reference(*args).double() - ref64).abs().max().item()}
    for build in ("as_is", "order", "simt"):
        use("stu_attention", build)
        vs64[build] = (stu_attention.stu_fwd(*args).double() - ref64).abs().max().item()
    use("stu_attention", "as_is")
    out["stu_fwd_err_vs_float64"] = vs64
    print(f"stu_fwd max abs err against float64 at B=512, L=100: {vs64}", flush=True)
    del q, k, v, bias, allowed, timeline, args, ref64
    torch.cuda.empty_cache()

    def time_ms(fn, iters: int = 20) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    def turns(source: str, builds: tuple, fn) -> dict:
        times = {build: [] for build in builds}
        for build in (*builds, *reversed(builds)) * (TURNS // 2):
            use(source, build)
            times[build].append(time_ms(fn))
        use(source, "as_is")
        return {"median_ms": {build: sorted(ms)[len(ms) // 2] for build, ms in times.items()}, "ms": times}

    def library(q, k, v, bias, allowed, timeline):
        l = q.shape[2]
        mask = (allowed * timeline[:, :, None] * timeline[:, None, :])[:, None]
        s = torch.einsum("bhqd,bhkd->bhqk", q, k) + bias[:, None]
        return torch.einsum("bhqk,bhkd->bhqd", torch.nn.functional.silu(s) / l * mask, v)

    times = {}
    for name, (b, l, serving) in {"train": (512, 100, False), "long_ctx": (64, 1024, False),
                                  "serving": (4096, 100, True)}.items():
        q, k, v, _, bias, allowed, timeline, _ = chip_smoke._stu_case(torch, dev, gen, b, l, serving=serving)
        args = (q, k, v, bias, allowed, timeline)
        times[f"stu_fwd_{name}"] = turns("stu_attention", ("as_is", "simt", "order", "no_act", "tf32", "no_bias"),
                                         lambda: stu_attention.stu_fwd(*args))
        times[f"stu_fwd_{name}"]["library_ms"] = time_ms(lambda: library(*args), iters=3)
        print(f"stu_fwd {name}", times[f"stu_fwd_{name}"]["median_ms"], flush=True)
        del q, k, v, bias, allowed, timeline, args
        torch.cuda.empty_cache()
    scores = torch.randn((4096, 15872), generator=gen, device=dev)
    scores[:, 15871:] = float("-inf")
    times["group_topm_serving"] = turns("topk_select", ("as_is", "warp"),
                                        lambda: topk_select.group_topm(scores, 12))
    times["group_topm_serving"]["library_ms"] = time_ms(lambda: torch.topk(scores, 10, dim=1))
    print("group_topm serving", times["group_topm_serving"]["median_ms"], flush=True)
    out["times"] = times
    print(json.dumps(out))
    fine = all(c["ok"] and c["bits"] and c["padded_row_zero"] for c in out["stu_fwd"].values()) and all(
        c["equal"] for c in out["group_topm"].values())
    return 0 if fine else 1


if __name__ == "__main__":
    sys.exit(main())
