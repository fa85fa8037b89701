#!/usr/bin/env python3
"""A short check of kernels 2 and 5 (``attn_fwd_f32``, ``attn_bwd_f32``) on
one NVIDIA GPU: build, the compiler's register report, agreement with the
twins, keep bits, bits on a rerun, and times beside the SIMT kernels.

Run from the repository root: ``python3
rectools_tpu_torch/tools/attention_check.py`` (about two minutes). It builds
``csrc/attention.cu`` three times: as it is (head dims 32 and 64 on the
tensor cores), with ``attn_tensor_cores`` returning false (every head dim on
the SIMT kernels) and with ``kHiLast`` false (the tensor-core kernels in
``mma3_k16``'s 3xTF32 order), the variants into ``build/variants/``, and
prints ``ptxas``'s registers and spills for each. Then, on the build as it is:
at ragged lengths, every head dim, no bias, the causal bias, a key-padding
bias and a fully masked query row, with and without dropout 0.2, the largest
absolute error of out, lse, dq, dk and dv against the twins and whether each
is within the GPU tests' limit (atol = rtol = 1e-5),
whether a rerun gives the same bits, and the launches; the keep bits against
the twin's mask at head dims 32 and 64. At the training shape (B = 512, L =
100, 4 heads of 32, causal bias, dropout 0.2): whether each half of the
batch, run alone (with a mesh data shard's seed), gives the whole batch's
bits, and every build's and the twin's largest error against float64. Last,
at that shape the forward and the backward, and at the serving shape (B =
4,096, no dropout) the forward, each timed (CUDA events, mean of 50 after a
warm-up) on every build in 4 rounds of turns (as it is, the variants, the
variants backwards, as it is), with each build's median, beside SDPA and its
autograd. The
first line names the card and its power limit; the last is one JSON object.
"""

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

TOL = 1e-5
MASK_VALUE = -1e9
RULE = "constexpr bool attn_tensor_cores(int dh) { return dh == 32 || dh == 64; }"
ORDER = "constexpr bool kHiLast = true; "
TURNS = 4  # rounds of (as it is, the variants, the variants backwards, as it is) per timed shape
# the builds timed beside the source as it is: every head dim on the SIMT kernels, and the tensor-core
# kernels with mma3_k16's 3xTF32 order (hi * hi products interleaved with the small ones)
VARIANTS = {"simt": (RULE, RULE.replace("dh == 32 || dh == 64", "false")),
            "order": (ORDER, ORDER.replace("true", "false"))}
CASES = (  # b, h, l, dh, bias kind, dropout rate
    (3, 4, 100, 32, "causal", 0.2), (3, 4, 100, 64, "causal", 0.2), (3, 4, 37, 32, "key_padding", 0.2),
    (3, 4, 257, 64, "key_padding", 0.0), (2, 3, 100, 32, "masked_row", 0.2), (2, 2, 130, 32, "none", 0.0),
    (3, 4, 200, 64, "key_padding", 0.2), (2, 2, 1, 32, "none", 0.2), (3, 4, 12, 16, "none", 0.2),
    (2, 4, 100, 8, "causal", 0.2), (3, 4, 257, 64, "masked_row", 0.0), (2, 3, 100, 16, "masked_row", 0.2),
)


def variant_source(name: str) -> Path:
    """A copy of csrc/ with attention.cu edited as VARIANTS[name] says."""
    old, new = VARIANTS[name]
    root = REPO / "build" / "variants" / f"attention_{name}"
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "rectools_tpu_torch" / "csrc", root)
    text = (root / "attention.cu").read_text()
    if text.count(old) != 1:
        raise RuntimeError(f"attention_check: {old!r} is not once in csrc/attention.cu")
    (root / "attention.cu").write_text(text.replace(old, new))
    return root


def main() -> int:
    import torch
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import _native
    from rectools_tpu_torch.ops import attention as attn

    if not torch.cuda.is_available():
        print("attention_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0])
    sources = {"tc": _native.CSRC, **{name: variant_source(name) for name in VARIANTS}}

    def use(route: str) -> None:
        _native.CSRC = sources[route]
        _native._LIBS.pop("attention", None)

    t0 = time.time()
    for route in (*VARIANTS, "tc"):  # tc last: the checks below run on it
        use(route)
        lines = _native.build(("attention",)).get("attention", "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "attn_" in line:
                regs = [nxt.strip() for nxt in lines[i + 1 : i + 4] if "registers" in nxt or "spill" in nxt]
                print(f"{route}: {line.strip()[:150]}\n    " + "\n    ".join(regs))
    print(f"build {time.time() - t0:.1f} s", flush=True)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(10)

    def blhd(b, l, h, dh):
        return torch.randn((b, l, h, dh), generator=gen, device=dev).transpose(1, 2)

    def bias_of(kind: str, b: int, l: int):
        causal = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, MASK_VALUE)
        if kind == "none":
            return None
        if kind == "causal":
            return causal[None, None].contiguous()
        if kind == "masked_row":  # the causal mask with query row l // 3 masked everywhere
            bias = causal.clone()
            bias[l // 3] = MASK_VALUE
            return bias[None, None].contiguous()
        lengths = torch.randint(1, l + 1, (b,), generator=gen, device=dev)  # key padding, left
        pad = torch.arange(l, device=dev)[None, :] < (l - lengths)[:, None]
        kp = torch.where(pad, MASK_VALUE, 0.0)[:, None, None, :] + causal
        kp[:, :, torch.arange(l), torch.arange(l)] = 0.0
        return kp.contiguous()

    out = {}
    for b, h, l, dh, kind, rate in CASES:
        q, k, v, dout = (blhd(b, l, h, dh) for _ in range(4))
        bias = bias_of(kind, b, l)
        scale, seed = 1.0 / math.sqrt(dh), 4242 + l
        _native.reset_launches()
        o, lse = attn.attention_fwd(q, k, v, bias, scale, rate, seed)
        delta = (dout * o).sum(-1).contiguous()
        grads = attn.attention_bwd(q, k, v, bias, lse, delta, dout, scale, rate, seed)
        launches = {key: _native.LAUNCHES[key] for key in ("attention_fwd", "attention_bwd")}
        ref_o, ref_lse = attn.attention_reference(q, k, v, bias, scale, rate, seed)
        ref_grads = attn.attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale, rate, seed)
        again = (*attn.attention_fwd(q, k, v, bias, scale, rate, seed),
                 *attn.attention_bwd(q, k, v, bias, lse, delta, dout, scale, rate, seed))
        got = (o, lse, *grads)
        refs = (ref_o, ref_lse, *ref_grads)
        err = {name: (g - r).abs().max().item() for name, g, r in zip(("out", "lse", "dq", "dk", "dv"), got, refs)}
        key = f"{b}x{h}x{l}x{dh}_{kind}_{rate}"
        bits = all(bool(torch.equal(a, g)) for a, g in zip(again, got))
        finite = all(bool(torch.isfinite(g).all()) for g in got)
        if kind == "masked_row":  # that row's dq is a cancelling sum (tests/test_torch_kernels.py): reported apart
            rows = torch.arange(l, device=dev) != l // 3
            err["dq_masked_row"] = (got[2][:, :, l // 3] - refs[2][:, :, l // 3]).abs().max().item()
            got, refs = (*got[:2], got[2][:, :, rows], *got[3:]), (*refs[:2], refs[2][:, :, rows], *refs[3:])
        ok = all(bool(torch.allclose(g, r, atol=TOL, rtol=TOL)) for g, r in zip(got, refs))
        out[key] = dict(err=err, ok=ok, finite=finite, bits=bits, launches=launches)
        print("case", key, out[key], flush=True)

    for dh in (32, 64):  # keep bits: q = k = 0 gives p = 1 / L, one-hot v carries each key's drop
        b, h, l, rate, seed = 2, 3, 40, 0.3, 77
        zeros = torch.zeros((b, h, l, dh), device=dev)
        kept = torch.empty((b, h, l, l), dtype=torch.bool, device=dev)
        for c0 in range(0, l, dh):
            w = min(dh, l - c0)
            onehot = torch.zeros((b, l, h, dh), device=dev)
            onehot[:, torch.arange(c0, c0 + w), :, torch.arange(w)] = 1.0
            probe, _ = attn.attention_fwd(zeros, zeros, onehot.transpose(1, 2), None, 1.0, rate, seed)
            kept[..., c0 : c0 + w] = probe[..., :w] > 0
        out[f"keep_bits_{dh}"] = bool(torch.equal(kept, attn.dropout_keep_mask(seed, b, h, l, rate, dev).bool()))
        print(f"keep bits at head dim {dh}: {out[f'keep_bits_{dh}']}", flush=True)

    # a row's bits do not depend on the batch: the training shape whole and as
    # two halves (the second with the seed a data shard of a mesh gets)
    from rectools_tpu_torch.models.nn.dropout import shifted_attention_seed

    b, l, h, dh, rate, seed = 512, 100, 4, 32, 0.2, 987654321
    q, k, v, dout = (blhd(b, l, h, dh) for _ in range(4))
    causal, scale = bias_of("causal", 1, l), 1.0 / math.sqrt(dh)
    o, lse = attn.attention_fwd(q, k, v, causal, scale, rate, seed)
    delta = (dout * o).sum(-1).contiguous()
    grads = attn.attention_bwd(q, k, v, causal, lse, delta, dout, scale, rate, seed)
    same = True
    for lo in (0, b // 2):
        part = slice(lo, lo + b // 2)
        s_seed = shifted_attention_seed(seed, lo, h)
        o_p, lse_p = attn.attention_fwd(q[part], k[part], v[part], causal, scale, rate, s_seed)
        g_p = attn.attention_bwd(q[part], k[part], v[part], causal, lse[part].contiguous(),
                                 delta[part].contiguous(), dout[part], scale, rate, s_seed)
        same &= all(bool(torch.equal(x, y[part])) for x, y in zip((o_p, lse_p, *g_p), (o, lse, *grads)))
    out["batch_halves_bits"] = same
    print(f"batch halves give the whole batch's bits: {same}", flush=True)

    # error against float64 on the same inputs, both builds: the forward from
    # q, k, v; the backward from the float64 forward's lse and delta
    d64 = [t.double() for t in (q, k, v, causal, dout)]
    o64, lse64 = attn.attention_reference(*d64[:4], scale, rate, seed)
    delta64 = (d64[4] * o64).sum(-1)
    ref64 = (o64, lse64, *attn.attention_bwd_reference(*d64[:4], lse64, delta64, d64[4], scale, rate, seed))
    lse32, delta32 = lse64.float().contiguous(), delta64.float().contiguous()
    twin = (*attn.attention_reference(q, k, v, causal, scale, rate, seed),
            *attn.attention_bwd_reference(q, k, v, causal, lse32, delta32, dout, scale, rate, seed))
    vs64 = {"twin": [(a.double() - e).abs().max().item() for a, e in zip(twin, ref64)]}
    for route in ("tc", *VARIANTS):
        use(route)
        got = (*attn.attention_fwd(q, k, v, causal, scale, rate, seed),
               *attn.attention_bwd(q, k, v, causal, lse32, delta32, dout, scale, rate, seed))
        vs64[route] = [(a.double() - e).abs().max().item() for a, e in zip(got, ref64)]
    use("tc")
    out["err_vs_float64"] = vs64  # out, lse, dq, dk, dv
    print(f"max abs err against float64 (out, lse, dq, dk, dv): {vs64}", flush=True)
    del q, k, v, dout, o, lse, delta, grads, d64, o64, lse64, delta64, ref64, twin
    torch.cuda.empty_cache()

    def time_ms(fn, iters: int = 50) -> float:
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    l, h, dh, rate, seed = 100, 4, 32, 0.2, 987654321
    scale = 1.0 / math.sqrt(dh)
    causal = bias_of("causal", 1, l)
    shapes = {}
    for b in (512, 4096):
        q, k, v, dout = (blhd(b, l, h, dh) for _ in range(4))
        r = rate if b == 512 else 0.0
        o, lse = attn.attention_fwd(q, k, v, causal, scale, r, seed)
        delta = (dout * o).sum(-1).contiguous()
        fwd = lambda: attn.attention_fwd(q, k, v, causal, scale, r, seed)  # noqa: E731
        bwd = lambda: attn.attention_bwd(q, k, v, causal, lse, delta, dout, scale, r, seed)  # noqa: E731
        name = "train" if b == 512 else "serving"
        routes = ("tc", *VARIANTS)
        times = {"fwd": {route: [] for route in routes}, "bwd": {route: [] for route in routes}}
        for route in (*routes, *reversed(routes)) * TURNS:
            use(route)
            times["fwd"][route].append(time_ms(fwd))
            if b == 512:
                times["bwd"][route].append(time_ms(bwd))
        use("tc")
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(*leaves, attn_mask=causal, scale=scale)
        median = {what: {route: sorted(ms)[len(ms) // 2] for route, ms in by_route.items() if ms}
                  for what, by_route in times.items()}
        shapes[name] = dict(
            median_ms=median, fwd_ms=times["fwd"], fwd_library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=causal, scale=scale)))
        if b == 512:
            shapes[name].update(bwd_ms=times["bwd"], bwd_library_ms=time_ms(
                lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)))
        print(name, shapes[name], flush=True)
        del q, k, v, dout, o, lse, delta, leaves, lib_out
        torch.cuda.empty_cache()
    out["times"] = shapes
    print(json.dumps(out))
    return 0 if all(c["ok"] and c["bits"] and c["finite"] for c in out.values() if isinstance(c, dict) and "ok" in c) \
        and out["keep_bits_32"] and out["keep_bits_64"] and out["batch_halves_bits"] else 1


if __name__ == "__main__":
    sys.exit(main())
