#!/usr/bin/env python3
"""Time the port's fused lse backward (kernel 9) over its launch grid, on one
NVIDIA GPU, beside the split pair (kernels 10 + 11) and the biased forward
(kernel 8).

Run from the repository root:
``python3 rectools_tpu_torch/tools/lse_bwd_grid.py``. For the three shapes
mesh training gives the kernels at the KION width (a (1, 1) mesh:
51,200 x 15,872; a (2, 2) shard: 25,600 x 7,936; the last shard of the
15,835-row catalog cut four ways: 25,600 x 3,959 with one invalid row) it
prints one JSON line per (item chunk rows, session groups): blocks in the
grid, bytes of partials, milliseconds (CUDA events, mean of 3 after a
warm-up) and the largest error against the twin relative to the twin's
largest entry. The session-group counts are those that give 1, 2, 3 and 4
blocks per multiprocessor, and one just over a wave (the grid the first
version of the wrapper chose), which shows what a partial second wave costs.
At D = 128 the kernel runs the tensor-core tile (128-row session tiles; one
block of 227 KB of shared memory fits a multiprocessor, so 2-4 blocks per
multiprocessor are 2-4 waves).
``rectools_tpu_torch.ops.softmax_lse.fused_bwd_plan`` holds the choice made
from these numbers. The first line names the card and its power limit.
"""

import json
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

D = 128
SHAPES = ((51200, 15872, 0), (25600, 7936, 0), (25600, 3959, 1))  # session rows, item rows, invalid rows
CHUNKS = (1024, 2048, 4096)


def time_ms(torch, fn, iters: int = 3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    import torch

    from rectools_tpu_torch.ops import softmax_lse

    if not torch.cuda.is_available():
        print("lse_bwd_grid: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(json.dumps({"card": card, "multiprocessors": n_sms}))
    plan, chunk_rows = softmax_lse.fused_bwd_plan, softmax_lse.FUSED_BWD_CHUNK
    for m, n, n_invalid in SHAPES:
        gen = torch.Generator().manual_seed(m + n)
        s = torch.randn(m, D, generator=gen).to(dev)
        items = (0.1 * torch.randn(n, D, generator=gen)).to(dev)
        bias = torch.zeros(n, device=dev)
        if n_invalid:
            items[n - n_invalid:] = 0.0
            bias[n - n_invalid:] = softmax_lse.NEG_BIG
        dlse = (torch.randn(m, generator=gen) / m).to(dev)
        lse = softmax_lse.streaming_lse_fwd(s, items, bias)
        ref = softmax_lse.streaming_lse_bwd_reference(s, items, bias, lse, dlse)
        split_ref = softmax_lse.streaming_lse_bwd_reference(s, items, bias, lse, dlse, partials=False)

        def backward():
            return softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)

        def worst(got, ref=ref) -> float:
            return max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))

        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 0
        forward_ms = time_ms(torch, lambda: softmax_lse.streaming_lse_fwd(s, items, bias))
        print(json.dumps({"m": m, "n": n, "kernel_8_ms": forward_ms, "kernels_10_11_ms": time_ms(torch, backward),
                          "kernels_10_11_err": worst(backward(), split_ref)}), flush=True)
        softmax_lse.FUSED_BWD_PARTIALS_BUDGET = 1 << 62
        m_tiles = -(-m // softmax_lse._BWD_TILE[D][0])
        for chunk in CHUNKS:
            n_chunks = -(-n // chunk)
            wanted = sorted({max(1, k * n_sms // n_chunks) for k in (1, 2, 3, 4)} | {-(-n_sms // n_chunks)})
            for groups in wanted:
                tiles_per_group = -(-m_tiles // groups)
                n_groups = -(-m_tiles // tiles_per_group)
                softmax_lse.FUSED_BWD_CHUNK = chunk
                softmax_lse.fused_bwd_plan = lambda *_: (tiles_per_group, n_groups, 0)
                blocks = n_chunks * n_groups
                print(json.dumps({"m": m, "n": n, "chunk": chunk, "session_groups": n_groups, "blocks": blocks,
                                  "blocks_per_multiprocessor": blocks / n_sms,
                                  "partials_bytes": (n_chunks * m + n_groups * n) * D * 4,
                                  "kernel_9_ms": time_ms(torch, backward), "kernel_9_err": worst(backward())}),
                      flush=True)
        softmax_lse.fused_bwd_plan, softmax_lse.FUSED_BWD_CHUNK = plan, chunk_rows
    return 0


if __name__ == "__main__":
    sys.exit(main())
