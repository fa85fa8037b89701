#!/usr/bin/env python3
"""Time kernel 7's bf16 engine (``csrc/ce_grads_bf16.cu``, which also runs
kernel 12's bf16 one pass: the engine without the label term) beside variants
of its source on one NVIDIA GPU: where a one pass's time goes, by taking one
part of the work out at a time; and where its two roles round a probability
apart.

Run from the repository root:
``python3 rectools_tpu_torch/tools/ce_grads_bf16_variants.py`` (about three
minutes). Each variant is a copy of the source under ``build/variants/`` with
the edits below, built at once (one ``nvcc`` each) into a library of its own;
``edited_source`` refuses a variant whose texts to replace the source no
longer holds as often as it says:

- ``engine``: the source as it is.
- ``no_exp``: (P - D) from the logit itself, no exponential.
- ``fast_exp``: ``__expf`` (one ``ex2.approx`` after a multiply) for ``expf``.
- ``no_product_1``: the logits left as they are, no first product.
- ``no_product_2``: no second product (ds or di stays 0).
- ``stages_2``: a ring of two stages instead of four.
- ``guarded_consumers``: the consumers' per-tile waits with the producer's
  hang guard (a clock and a trap).
- ``no_setmaxnreg``: no ``setmaxnreg``: every thread keeps the 168
  registers of the launch.
- ``probe``: the engine, and an entry ``ce_fused_bf16_probe`` that also
  writes each role's bf16 (P - D), (M, N) row-major: the two roles compute
  each logit in transposed orientations, so a bf16 (P - D) could round apart
  between them.

Only ``engine`` and ``probe`` compute the function; the others are timings.
Each build prints ptxas's stack and spill stores a width and form (``k7``
with the label term, ``k12`` without). Each library is timed in turns, twice,
at 51,200 x 15,872 and D = 16, 128 and 256 (CUDA events, mean of 3 after a
warm-up): the one pass ``ce_fused_bf16``, kernel 12's ``grads_z_fused_bf16``,
and the two launches' ``ce_ds_bf16`` and ``ce_di_bf16`` alone (NaN where the
entry refused the launch). Then the probe at D = 128 and 256: how many entries of
the two roles' (P - D) differ, by how many bf16 steps at most. One JSON line a
variant and round; the first line names the card and its power limit.
"""

import ctypes
import json
import re
import subprocess
import sys
import typing as tp
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CU = "rectools_tpu_torch/csrc/ce_grads_bf16.cu"
M, N, WIDTHS = 51200, 15872, (16, 128, 256)
# name: [(text in the source, replacement, times it appears)]
VARIANTS: tp.Dict[str, tp.List[tp.Tuple[str, str, int]]] = {
    "engine": [],
    "no_exp": [("expf(x[", "(x[", 4)],
    "fast_exp": [("expf(x[", "__expf(x[", 4)],
    "no_product_1": [("wgmma_ss_n64(x, da + k_step<D>(kk), db + k_step<D>(kk), kk > 0);", ";", 1)],
    "no_product_2": [("Rs<D, 1>::mma(acc, a[kk], dm + mn_step<D>(kk), 1);", ";", 1)],
    "stages_2": [("constexpr int kStages = 4;", "constexpr int kStages = 2;", 1)],
    "guarded_consumers": [("    bar_wait<false>(&sm.full[stage], (t / kStages) & 1);",
                           "    bar_wait<true>(&sm.full[stage], (t / kStages) & 1);", 1)],
    "no_setmaxnreg": [('    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));\n', "", 1),
                      ('    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));\n', "", 1)],
    "probe": [
        ("struct Params {\n", "__nv_bfloat16* g_probe[2];  // ce_fused_bf16_probe's outputs\nstruct Params {\n", 1),
        ("  float* di_out;\n", "  float* di_out;\n  __nv_bfloat16* probe_ds;\n  __nv_bfloat16* probe_di;\n", 1),
        ("    // product 2 (ds += (P - D) items)", """    if (p.probe_ds != nullptr) {  // this role's (P - D)
      __nv_bfloat16* probe = kDi ? p.probe_di : p.probe_ds;
#pragma unroll
      for (int i = 0; i < 32; ++i) {  // i = 8 kk + 2 q + (column & 1)
        const uint32_t v = a[i >> 3][(i >> 1) & 3];
        const long long r = row[(i >> 1) & 1], c = col0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const long long session = kDi ? c : r, item = kDi ? r : c;
        if (session < p.M && item < p.N)
          probe[session * p.N + item] = __ushort_as_bfloat16((unsigned short)((i & 1) ? v >> 16 : v & 0xffffu));
      }
    }
    // product 2 (ds += (P - D) items)""", 1),
        ("  p.ds_mode = bf16_partials ? 1 : 0;\n",
         "  p.ds_mode = bf16_partials ? 1 : 0;\n  p.probe_ds = g_probe[0];\n  p.probe_di = g_probe[1];\n", 1),
        ("// Bytes of dynamic shared memory a block takes at width D;", """extern "C" int ce_fused_bf16_probe(const void* s, const void* items, const float* z, const long long* y,
                                   const float* coeff, void* ds_part, float* di, void* probe_ds, void* probe_di,
                                   long long M, long long N, int D, long long chunk_rows, int bf16_partials,
                                   cudaStream_t stream) {
  g_probe[0] = static_cast<__nv_bfloat16*>(probe_ds);
  g_probe[1] = static_cast<__nv_bfloat16*>(probe_di);
  const int status = ce_fused_bf16(s, items, z, y, coeff, ds_part, di, M, N, D, chunk_rows, bf16_partials, stream);
  g_probe[0] = g_probe[1] = nullptr;
  return status;
}

// Bytes of dynamic shared memory a block takes at width D;""", 1),
    ],
}
# the probe variant's entry: ce_fused_bf16's arguments with the two (M, N) bf16 outputs after di
PROBE_SIGNATURE = (ctypes.c_void_p,) * 9 + (ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                            ctypes.c_int, ctypes.c_void_p)


def edited_source(name: str) -> str:
    """The source as variant ``name`` has it; raises unless each text to
    replace appears as often as the variant says."""
    text = (REPO / CU).read_text()
    for old, new, times in VARIANTS[name]:
        if text.count(old) != times:
            raise RuntimeError(f"variant {name}: {old!r} appears {text.count(old)} times in {CU}, not {times}")
        text = text.replace(old, new)
    return text


def _form(mangled: str) -> str:
    """"D=... k7" or "D=... k12" of the engine's kernel name: its width and
    whether it has the label term (kernel 7) or not (kernel 12)."""
    found = re.search(r"kernelILi(\d+)ELb(\d)E", mangled)
    return f"D={found.group(1)} {'k7' if found.group(2) == '1' else 'k12'}" if found else mangled


def frames(report: str) -> tp.Dict[str, tp.Tuple[int, int]]:
    """{"D=... k7" / "D=... k12": (stack bytes, spill store bytes)} of each
    kernel in ``nvcc``'s ``ptxas -v`` report."""
    out: tp.Dict[str, tp.Tuple[int, int]] = {}
    name = None
    for line in report.splitlines():
        found = re.search(r"Compiling entry function '(\S*kernelILi\d+ELb\dE\S*)'", line)
        if found:
            name = _form(found.group(1))
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
        if frame and name is not None:
            out[name] = (int(frame.group(1)), int(frame.group(2)))
            name = None
    return out


def highest_registers(native, so: Path) -> tp.Dict[str, int]:
    """{kernel: the highest register its machine code names} from
    ``cuobjdump -sass`` (above the launch count where ``setmaxnreg`` gave the
    consumers more)."""
    cuobjdump = Path(native._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(so)], capture_output=True, text=True).stdout
    out: tp.Dict[str, int] = {}
    name = None
    for line in sass.splitlines():
        found = re.search(r"Function : (\S+)", line)
        if found:
            name = _form(found.group(1))
            out[name] = 0
        elif name is not None:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            if regs:
                out[name] = max(out[name], *regs)
    return out


def main() -> int:
    import torch

    sys.path.insert(0, str(REPO))
    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import softmax_lse as sl

    if not torch.cuda.is_available():
        print("ce_grads_bf16_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    out_dir = REPO / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in VARIANTS:
        cu = out_dir / f"ce_grads_bf16_{name}.cu"
        cu.write_text(edited_source(name))
        so = cu.with_suffix(".so")
        cmd = [_native._nvcc(), *_native.NVCC_FLAGS, "-I", str(_native.CSRC), "-o", str(so), str(cu)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        report, _ = proc.communicate(timeout=_native.BUILD_TIMEOUT_S)
        if proc.returncode != 0:
            print(f"variant {name} failed to build:\n{report}", file=sys.stderr)
            return 1
        print(json.dumps({"variant": name, "built": True, "stack_and_spill_store_bytes": frames(report),
                          "highest_register": highest_registers(_native, so)}), flush=True)
        lib = ctypes.CDLL(str(so))
        signatures = {**sl._SIGNATURES_CE_BF16, **({"ce_fused_bf16_probe": PROBE_SIGNATURE} if name == "probe" else {})}
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    dev = torch.device("cuda")
    bf = torch.bfloat16
    stream = _native.current_stream_ptr(dev)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def time_ms(fn, iters: int = 3) -> float:
        if fn() != 0:
            return float("nan")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            status = fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters if status == 0 else float("nan")  # a refused launch: nan

    cases = {}
    for d in WIDTHS:
        gen = torch.Generator(device=dev).manual_seed(d)
        s = torch.randn((M, d), generator=gen, device=dev).to(bf)
        items = (0.1 * torch.randn((N, d), generator=gen, device=dev)).to(bf)
        y = torch.randint(1, N, (M,), generator=gen, device=dev)
        coeff = torch.full((M,), 1.0 / M, device=dev)
        z = (sl.streaming_lse(s, items) - torch.log(coeff)).contiguous()
        n_chunks, chunk_rows = sl.split_bwd_plan(M, N, d, n_sms, sl.FUSED_BWD_CHUNK, bf)
        cases[d] = dict(s=s, items=items, y=y, coeff=coeff, z=z, chunks=(n_chunks, chunk_rows),
                        ds_bf16=torch.empty((-(-N // sl.FUSED_BWD_CHUNK), M, d), dtype=bf, device=dev),
                        ds_f32=torch.empty((n_chunks, M, d), device=dev), di=torch.empty((N, d), device=dev))
    for turn in range(2):
        for name, lib in libs.items():
            row = {"variant": name, "turn": turn}
            for d, c in cases.items():
                head = tuple(c[k].data_ptr() for k in ("s", "items", "z", "y", "coeff"))
                row[f"one_pass_d{d}_ms"] = time_ms(lambda: lib.ce_fused_bf16(
                    *head, c["ds_bf16"].data_ptr(), c["di"].data_ptr(), M, N, d, sl.FUSED_BWD_CHUNK, 1, stream))
                row[f"kernel_12_d{d}_ms"] = time_ms(lambda: lib.grads_z_fused_bf16(
                    *head[:3], c["ds_bf16"].data_ptr(), c["di"].data_ptr(), M, N, d, sl.FUSED_BWD_CHUNK, 1, stream))
                row[f"ds_d{d}_ms"] = time_ms(lambda: lib.ce_ds_bf16(
                    *head, c["ds_f32"].data_ptr(), M, N, d, c["chunks"][1], c["chunks"][0], sl.FUSED_BWD_CHUNK,
                    stream))
                row[f"di_d{d}_ms"] = time_ms(lambda: lib.ce_di_bf16(*head, c["di"].data_ptr(), M, N, d, stream))
            print(json.dumps(row), flush=True)
    for d in (128, 256):
        c = cases[d]
        p_ds, p_di = (torch.zeros((M, N), dtype=bf, device=dev) for _ in range(2))
        status = libs["probe"].ce_fused_bf16_probe(
            *(c[k].data_ptr() for k in ("s", "items", "z", "y", "coeff", "ds_bf16", "di")), p_ds.data_ptr(),
            p_di.data_ptr(), M, N, d, sl.FUSED_BWD_CHUNK, 1, stream)
        torch.cuda.synchronize()
        apart = p_ds != p_di
        differ, steps = int(apart.sum().item()), 0.0
        if differ:
            a, b = p_ds[apart].float(), p_di[apart].float()
            ulp = torch.exp2(torch.frexp(torch.maximum(a.abs(), b.abs()))[1].float() - 8)  # a bf16 step there
            steps = ((a - b).abs() / ulp).max().item()
        print(json.dumps({"probe": f"M={M} N={N} D={d}", "status": status, "differ": differ, "entries": M * N,
                          "max_bf16_steps": steps}), flush=True)
        del p_ds, p_di
    return 0


if __name__ == "__main__":
    sys.exit(main())
