#!/usr/bin/env python3
"""Time kernel 2's bf16 forward (``attn_fwd_onepass_bf16_kernel`` in
``csrc/attention_bf16.cu``) beside one-edit variants of its source on one
NVIDIA GPU: where its time goes, by taking one part of the work out at a
time, and what another exponential does to its time and its rounding.

Run from the repository root:
``python3 rectools_tpu_torch/tools/attention_bf16_variants.py [NAME ...]``
(about two minutes; NAMEs pick variants, all by default). Each variant is a
copy of the source under ``build/variants/`` with the edits of VARIANTS,
built at once (one ``nvcc`` each) into a library of its own;
``edited_source`` refuses a variant whose texts to replace the source no
longer holds as often as it says. ``as_is`` and ``expf`` compute the
function; the others are timings only (their values are wrong).

Each library runs the forward through ``ops.attention.attention_fwd`` at
the training shape (B = 512, L = 100; 4 heads of 32, 8 and 64, one head of
16), causal and under BERT4Rec's (B, 1, L, L) bias, dropout 0.2 and 0:
CUDA events, mean of 20 calls after a warm-up, the libraries in turns
(forwards, then backwards, TURNS times), the median of each. For the
variants that compute the function, also the error against the twin
(``attention_bf16_reference``): out relative to its largest entry, lse per
row relative to max(|lse|, 1), and how many out entries differ in their
bits from ``as_is``'s. The first line names the card and its power limit;
then one JSON line a shape and one a variant's build.
"""

import ctypes
import json
import math
import subprocess
import sys
import typing as tp
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CU = "rectools_tpu_torch/csrc/attention_bf16.cu"
TURNS = 2
SHAPES = ((4, 32), (4, 8), (4, 64), (1, 16))  # heads, head dim at B = 512, L = 100 (d 128, 32, 256, 16)
BIAS_STAGE = """  if (p.bias != nullptr)
    stage_bias(bias_s, BP, p.bias + b * p.bias_sb + h0 * p.bias_sh, L, 0, L, 0, L, threadIdx.x, blockDim.x);
"""
HEAD_STAGE = """    stage_rows<DH>(s, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, 0, rows, L, threadIdx.x, blockDim.x);
    stage_rows<DH>(s + rows * PD, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, 0, rows, L, threadIdx.x, blockDim.x);
    stage_rows<DH>(s + 2 * rows * PD, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, 0, rows, L, threadIdx.x, blockDim.x);
"""
CARVEOUT = """  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_fwd_onepass_bf16_kernel<DH, kDropout, kMode>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
"""
EX2 = 'asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, kLog2e)));'
# name: [(text in the source, replacement, times it appears)]
VARIANTS: tp.Dict[str, tp.List[tp.Tuple[str, str, int]]] = {
    "as_is": [],
    "expf": [(EX2, "y = expf(x);", 1)],  # the exponential the twin and the backward use
    "no_exp": [(EX2, "y = __fmul_rn(x, kLog2e);", 1)],
    "no_score_product": [("      bt::mma(acc[0], qa[kk], b0);\n      bt::mma(acc[1], qa[kk], b1);",
                          "      acc[0][0] += __uint_as_float(b0[0]);\n      acc[1][0] += __uint_as_float(b1[1]);", 1)],
    "no_sum": [("l4[nf & 3] += exp_of(__fsub_rn(lo_of(sc[nf][hh]), m)) + exp_of(__fsub_rn(hi_of(sc[nf][hh]), m));",
                "l4[nf & 3] += lo_of(sc[nf][hh]);", 1)],
    "no_pv": [("pv_step<DH>(a, vs, 16 * kk, o);", "o[0][0] += __uint_as_float(a[0] ^ a[1] ^ a[2] ^ a[3]);", 1)],
    "no_bias_stage": [(BIAS_STAGE, "", 1)],
    "loads_only": [("      if (jg < nk) {", "      if (false) {", 1),
                   ("      if (kk < nk) {", "      if (false) {", 1)],
    "no_loads": [(BIAS_STAGE, "", 1), (HEAD_STAGE, "", 1)],
    "no_carveout": [(CARVEOUT, "", 1)],
    "no_score_pass": [("      if (jg < nk) {", "      if (false) {", 1)],
    "no_p_pass": [("      if (kk < nk) {", "      if (false) {", 1)],
    "no_stores": [("    store_rows<DH>(p, b, h, r0, const_cast<__nv_bfloat16*>(qs) + r0 * PD, o, lse);\n", "", 1)],
    "heads_2": [("constexpr int kHeadsPerBlock = 4;", "constexpr int kHeadsPerBlock = 2;", 1)],
    "heads_1": [("constexpr int kHeadsPerBlock = 4;", "constexpr int kHeadsPerBlock = 1;", 1)],
    "slots_2": [("return dh == 64 ? 1 : 2;", "return 2;", 1)],
}
COMPUTING = ("as_is", "expf")  # the variants whose values are the function's


def edited_source(name: str) -> str:
    """The source as variant ``name`` has it; raises unless each text to
    replace appears as often as the variant says."""
    text = (REPO / CU).read_text()
    for old, new, times in VARIANTS[name]:
        if text.count(old) != times:
            raise RuntimeError(f"variant {name}: {old!r} appears {text.count(old)} times in {CU}, not {times}")
        text = text.replace(old, new)
    return text


def main() -> int:
    import torch

    sys.path.insert(0, str(REPO))
    from rectools_tpu_torch.models.nn.transformers import TransformerBackbone
    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import attention as attn

    if not torch.cuda.is_available():
        print("attention_bf16_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    names = sys.argv[1:] or list(VARIANTS)
    names = ["as_is", *(n for n in names if n != "as_is")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card}), flush=True)
    out_dir = REPO / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = out_dir / f"attention_bf16_{name}.cu"
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
        clean = report.count("0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads")
        print(json.dumps({"variant": name, "built": True, "kernels_without_stack_or_spill": clean}), flush=True)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in attn._SIGNATURES_BF16.items():
            getattr(lib, fn).argtypes = list(argtypes)
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib

    def use(name: str) -> None:
        _native._LIBS["attention_bf16"] = libs[name]

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

    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(28)
    b, l = 512, 100
    causal = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    lengths = torch.randint(1, l + 1, (b,), generator=gen, device=dev)  # BERT4Rec: left-padded sessions
    lengths[0], lengths[1] = 1, l
    sessions = (torch.arange(l, device=dev)[None, :] >= (l - lengths)[:, None]).long()
    rule = type("Rule", (), {"use_causal_attn": False, "use_key_padding_mask": True})()
    biases = {"causal": causal.contiguous(), "bidirectional": TransformerBackbone._build_attn_bias(rule, sessions)}
    for h, dh in SHAPES:
        q, k, v = (torch.randn((b, l, h, dh), generator=gen, device=dev).to(bf).transpose(1, 2) for _ in range(3))
        scale = 1.0 / math.sqrt(dh)
        for kind, bias in biases.items():
            for rate in (0.2, 0.0):
                fwd = lambda: attn.attention_fwd(q, k, v, bias, scale, rate, 1234)  # noqa: E731
                row: tp.Dict[str, tp.Any] = {"shape": f"B={b} H={h} L={l} dh={dh}", "bias": kind, "dropout": rate}
                ref_o, ref_lse = attn.attention_bf16_reference(q, k, v, bias, scale, rate, 1234)
                outs = {}
                for name in (n for n in names if n in COMPUTING):
                    use(name)
                    o, lse = fwd()
                    outs[name] = o
                    row[f"{name}_err_out"] = ((o.float() - ref_o.float()).abs().max()
                                              / ref_o.float().abs().max()).item()
                    row[f"{name}_err_lse"] = ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item()
                    row[f"{name}_out_bits_apart_from_as_is"] = int((o != outs["as_is"]).sum().item())
                times: tp.Dict[str, tp.List[float]] = {name: [] for name in names}
                for _ in range(TURNS):
                    for name in (*names, *reversed(names)):
                        use(name)
                        times[name].append(time_ms(fwd))
                row.update({f"{name}_ms": sorted(ms)[len(ms) // 2] for name, ms in times.items()})
                print(json.dumps(row), flush=True)
        del q, k, v
        torch.cuda.empty_cache()
    _native._LIBS.pop("attention_bf16", None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
