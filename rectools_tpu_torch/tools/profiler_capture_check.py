#!/usr/bin/env python3
"""How often a torch.profiler capture on one NVIDIA GPU comes back without
some of its device records, which launches lose them, and what keeps the
records of the calls a capture counts.

Run from the repository root:
``python3 rectools_tpu_torch/tools/profiler_capture_check.py`` (about two
minutes). For each call below and each way of CAPTURE_MODES, CAPTURES
captures; each runs its uncounted warm-up work, then CALLS calls inside a
``record_function`` span. A launch's runtime record (``cudaLaunchKernel``,
``cuLaunchKernelEx``, ``cudaMemsetAsync``, ...) and its kernel's device
record share a correlation id, so the script knows which launches of the
span left no device record: it prints how many captures lack one, how many
records went missing, and at which of the span's calls (0 to CALLS - 1).
Calls: a one-element add (a kernel of a few microseconds), kernel 2's bf16
forward at B = 512, H = 4, L = 100, dh = 32 under the causal bias with
dropout 0.2 (one kernel a call, launched through ctypes), and bf16 SDPA on
the same values (a memset and a cuDNN kernel a call). The first line names
the card, its power limit and the torch and CUDA versions; then one JSON
line a call and way.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CAPTURES, CALLS = 30, 5
SPAN = "measured calls"
SPIN_CYCLES = 2_000_000  # about a millisecond of one spinning kernel at the H100's clock
# the work a capture runs before its span, uncounted: host sleep (s), a spinning kernel, calls of the same work
CAPTURE_MODES = {
    "plain": dict(sleep=0.0, spin=False, warm_calls=0),
    "sleep_5ms": dict(sleep=0.005, spin=False, warm_calls=0),
    "spin": dict(sleep=0.0, spin=True, warm_calls=0),
    "one_call": dict(sleep=0.0, spin=False, warm_calls=1),
    "spin_one_call": dict(sleep=0.0, spin=True, warm_calls=1),
    "spin_two_calls": dict(sleep=0.0, spin=True, warm_calls=2),
}


def is_launch(name: str) -> bool:
    """Whether a host record names a runtime or driver call that puts work on the card."""
    return name.startswith("cu") and any(word in name for word in ("Launch", "Memset", "Memcpy"))


def main() -> int:
    import torch
    import torch.nn.functional as F
    from torch.autograd import DeviceType

    sys.path.insert(0, str(REPO))
    from rectools_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        print("profiler_capture_check: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda}), flush=True)
    dev, bf = torch.device("cuda"), torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(7)
    b, h, l, dh = 512, 4, 100, 32
    q, k, v = (torch.randn((b, l, h, dh), generator=gen, device=dev).to(bf).transpose(1, 2) for _ in range(3))
    causal = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    mask = causal.to(bf)
    x = torch.zeros(1, device=dev)
    calls = {  # name: (the call, the launches it makes)
        "add": (lambda: x.add_(0.0), 1),
        "attention_fwd_bf16": (lambda: attention.attention_fwd(q, k, v, causal, dh ** -0.5, 0.2, 1), 1),
        "sdpa_bf16": (lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=dh ** -0.5), 2),
    }
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for name, (fn, per_call) in calls.items():
        fn()
        for mode, how in CAPTURE_MODES.items():
            short, missing, at_call = 0, 0, [0] * CALLS
            for _ in range(CAPTURES):
                torch.cuda.synchronize()
                with torch.profiler.profile(activities=activities) as prof:
                    time.sleep(how["sleep"])
                    if how["spin"]:
                        torch.cuda._sleep(SPIN_CYCLES)
                    for _ in range(how["warm_calls"]):
                        fn()
                    torch.cuda.synchronize()
                    with torch.profiler.record_function(SPAN):
                        for _ in range(CALLS):
                            fn()
                        torch.cuda.synchronize()
                events = prof.events()
                span = next(e for e in events if e.name == SPAN and e.device_type == DeviceType.CPU)
                launches = sorted((e for e in events if e.device_type == DeviceType.CPU and is_launch(e.name)
                                   and span.time_range.start <= e.time_range.start <= span.time_range.end),
                                  key=lambda e: e.time_range.start)
                recorded = {e.id for e in events if e.device_type == DeviceType.CUDA and e.name != SPAN}
                lost = [i for i, e in enumerate(launches) if e.id not in recorded]
                if lost:
                    short += 1
                    missing += len(lost)
                    for i in lost:
                        at_call[min(i // per_call, CALLS - 1)] += 1
            print(json.dumps({"call": name, "mode": mode, "captures": CAPTURES, "calls": CALLS,
                              "launches_a_call": per_call, "short_captures": short, "records_missing": missing,
                              "missing_at_call": at_call}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
