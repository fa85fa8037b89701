#!/usr/bin/env python3
"""Drive the PyTorch port (rectools_tpu_torch) on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. Phases, each on its
own lines; any failure exits nonzero and prints no result:

1. device  — require CUDA, print the card's name and power limit, TF32 off.
2. build   — compile every CUDA kernel of the serving path from csrc/
             (one nvcc per source, all at once) and print the seconds.
3. kernels — each kernel at the shapes the serving path gives it (B = 4096
             sessions, L = 100, d = 128, 4 heads, 15,872-column catalog):
             held against its plain PyTorch twin on the same inputs on the
             card, and timed beside its twin, one PyTorch library call
             (a yardstick only; the port never calls it) and its bound.
4. main    — SASRecModel serving at the KION width: a synthetic KION-shaped
             frame (8,192 users, sessions of 1-300 Zipf-drawn items over
             15,871 ids) -> Dataset.construct -> load_jax_params with random
             weights in the flax layout from a seed -> recommend(k=10,
             filter_viewed=True) in two 4,096-session batches -> one
             recommend_to_items. Checks the launch counts of every kernel on
             the path, the output (k unseen items per user, scores
             non-increasing) and agreement with the port's own CPU run on 64
             users; times warm calls and profiles one (device time by kernel,
             device busy share, host functions).

Output, last lines: one JSON object with every kernel's numbers, the
``nvidia-smi`` name and power limit, and ``{"ok": true, "device": ...}``.
"""

import json
import math
import subprocess
import sys
import time
from pathlib import Path

SEED = 20260
N_USERS = 8192
N_ITEM_IDS = 15871  # + PAD = 15,872 rows, 124 groups of 128
SESSION_MAX_LEN = 100
N_FACTORS = 128
N_HEADS = 4
N_BLOCKS = 2
K = 10
PEAK_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, data sheet
PEAK_F32_FLOP_PER_S = 67e12  # H100 SXM FP32 outside the tensor cores, data sheet
LN_TOL = 1e-5
ATTN_TOL = 1e-5
SCORE_RTOL, SCORE_ATOL, TIE_GAP = 1e-4, 1e-4, 1e-4  # GPU vs CPU run: f32 sums in another order


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, message: str) -> None:
    if not cond:
        raise SmokeFailure(message)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_ops: float) -> tuple:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------- phase 3


def kernel_phase(torch, dev, b: int = 4096) -> dict:
    import torch.nn.functional as F

    from rectools_tpu_torch.ops import attention, layer_norm, topk_select

    gen = torch.Generator(device=dev).manual_seed(SEED)
    l, h, d = SESSION_MAX_LEN, N_HEADS, N_FACTORS
    dh = d // h
    results = {}

    # LayerNorm: (B*L, d), 5 calls per batch on the path
    x = torch.randn((b * l, d), generator=gen, device=dev) * 2 + 0.5
    gamma = torch.randn((d,), generator=gen, device=dev)
    beta = torch.randn((d,), generator=gen, device=dev)
    y = layer_norm.layer_norm(x, gamma, beta, 1e-6)
    err = (y - layer_norm.layer_norm_reference(x, gamma, beta, 1e-6)).abs().max().item()
    check(err <= LN_TOL, f"layer_norm kernel disagrees with its twin: max abs err {err}")
    n_bytes = 2 * x.numel() * 4 + 2 * d * 4
    results["layer_norm_fwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: layer_norm.layer_norm(x, gamma, beta, 1e-6)),
        plain_ms=time_ms(lambda: layer_norm.layer_norm_reference(x, gamma, beta, 1e-6)),
        library_ms=time_ms(lambda: F.layer_norm(x, (d,), gamma, beta, 1e-6)),
        bound=bound_ms(n_bytes, 8 * x.numel()),
    )
    del x, y

    # attention: (B, L, H, dh) projections read through strides, causal bias (1, 1, L, L)
    q, k, v = (torch.randn((b, l, h, dh), generator=gen, device=dev) for _ in range(3))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    bias = torch.where(torch.ones((l, l), dtype=torch.bool, device=dev).tril(), 0.0, -1e9)[None, None]
    scale = 1.0 / math.sqrt(dh)
    out, lse = attention.attention_fwd(qt, kt, vt, bias, scale)
    ref_out, ref_lse = attention.attention_reference(qt, kt, vt, bias, scale)
    err = max((out - ref_out).abs().max().item(), (lse - ref_lse).abs().max().item())
    check(err <= ATTN_TOL, f"attention kernel disagrees with its twin: max abs err {err}")
    n_bytes = 4 * q.numel() * 4 + lse.numel() * 4 + bias.numel() * 4
    n_ops = 4 * b * h * l * l * dh  # q·kᵀ and p·v, 2 operations per multiply-add
    results["attention_fwd"] = dict(
        max_abs_err=err,
        ms=time_ms(lambda: attention.attention_fwd(qt, kt, vt, bias, scale)),
        plain_ms=time_ms(lambda: attention.attention_reference(qt, kt, vt, bias, scale), iters=3),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=bias, scale=scale)),
        bound=bound_ms(n_bytes, n_ops),
    )
    del q, k, v, qt, kt, vt, out, lse, ref_out, ref_lse

    # grouped top-m: the (B, 15,872) masked score rows, m = 12
    n_pad = (N_ITEM_IDS + 1 + 127) // 128 * 128
    m = topk_select.pick_m(n_pad, K)
    scores = torch.randn((b, n_pad), generator=gen, device=dev)
    scores[:, N_ITEM_IDS:] = float("-inf")
    vals, lanes = topk_select.group_topm(scores, m)
    ref_vals, ref_lanes = topk_select.group_topm_reference(scores, m)
    finite = torch.isfinite(ref_vals)
    check(bool(torch.equal(vals, ref_vals)), "group_topm values differ from its twin")
    check(bool(torch.equal(lanes[finite], ref_lanes[finite])), "group_topm lane ids differ from its twin")
    g = n_pad // 128
    n_bytes = scores.numel() * 4 + b * g * m * 8
    results["group_topm"] = dict(
        max_abs_err=(vals - ref_vals)[finite].abs().max().item(),
        ms=time_ms(lambda: topk_select.group_topm(scores, m)),
        plain_ms=time_ms(lambda: topk_select.group_topm_reference(scores, m), iters=3),
        library_ms=time_ms(lambda: torch.topk(scores, K, dim=1)),
        bound=bound_ms(n_bytes, scores.numel()),
    )
    del scores, vals, lanes, ref_vals, ref_lanes
    torch.cuda.empty_cache()
    for name, r in results.items():
        print(
            f"kernel {name}: max_abs_err={r['max_abs_err']:.3g} ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
            f"library_ms={r['library_ms']:.4f} bound_ms={r['bound'][0]:.4f} ({r['bound'][1]})"
        )
    return results


# ---------------------------------------------------------------- phase 4


def kion_frame(np, pd, Columns):
    """Synthetic KION-shaped interactions: session lengths 1-300, Zipf items."""
    rng = np.random.default_rng(SEED)
    lengths = rng.integers(1, 301, size=N_USERS)
    users = np.repeat(np.arange(N_USERS), lengths)
    items = (rng.zipf(1.2, size=len(users)) - 1) % N_ITEM_IDS
    seconds = rng.integers(0, 90 * 86400, size=len(users))
    # every item id once more, last in time, so the table has all 15,871 ids
    cover_users = rng.integers(0, N_USERS, size=N_ITEM_IDS)
    users = np.concatenate([users, cover_users])
    items = np.concatenate([items, np.arange(N_ITEM_IDS)])
    seconds = np.concatenate([seconds, 90 * 86400 + np.arange(N_ITEM_IDS)])
    return pd.DataFrame(
        {
            Columns.User: users,
            Columns.Item: items,
            Columns.Weight: np.ones(len(users), np.float32),
            Columns.Datetime: pd.Timestamp("2021-03-13") + pd.to_timedelta(seconds, unit="s"),
        }
    )


def flax_params(np, n_items: int) -> dict:
    """Random weights in the JAX package's flax layout, from the seed."""
    rng = np.random.default_rng(SEED + 1)
    d = N_FACTORS

    def dense(fan_in, fan_out):
        return {
            "kernel": (rng.normal(size=(fan_in, fan_out)) / math.sqrt(fan_in)).astype(np.float32),
            "bias": (0.02 * rng.normal(size=(fan_out,))).astype(np.float32),
        }

    def norm():
        return {
            "scale": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
            "bias": (0.1 * rng.normal(size=(d,))).astype(np.float32),
        }

    layers = {
        f"block_{i}": {
            "q_layer_norm": norm(),
            "multi_head_attn": {name: dense(d, d) for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ff_layer_norm": norm(),
            "feed_forward": {"ff_linear_1": dense(d, d), "ff_linear_2": dense(d, d)},
        }
        for i in range(N_BLOCKS)
    }
    layers["last_layernorm"] = norm()
    return {
        "item_model": {"item_net_blocks_0": {"ids_emb": (0.1 * rng.normal(size=(n_items, d))).astype(np.float32)}},
        "pos_encoding_layer": {"pos_emb": (0.1 * rng.normal(size=(SESSION_MAX_LEN, d))).astype(np.float32)},
        "transformer_layers": layers,
    }


def compare_reco(np, got, ref, k: int) -> int:
    """Per user: scores close; items equal wherever the score is separated
    from its neighbours by more than TIE_GAP (``ref`` holds k + 1 rows per
    user, so the k-th position has a neighbour below). Returns users compared."""
    n = 0
    for user, g in got.groupby("user_id", sort=False):
        r = ref[ref["user_id"] == user]
        gs, rs = g["score"].to_numpy()[:k], r["score"].to_numpy()
        check(len(gs) == k and len(rs) == k + 1, f"user {user}: {len(gs)} / {len(rs)} rows")
        check(
            np.allclose(gs, rs[:k], rtol=SCORE_RTOL, atol=SCORE_ATOL),
            f"user {user}: scores differ from the CPU run: {gs} vs {rs[:k]}",
        )
        gap = np.abs(np.diff(rs))
        separated = np.ones(k, bool)
        separated[1:] &= gap[: k - 1] > TIE_GAP
        separated &= gap[:k] > TIE_GAP
        gi, ri = g["item_id"].to_numpy()[:k], r["item_id"].to_numpy()[:k]
        check(bool(np.all(gi[separated] == ri[separated])), f"user {user}: items differ: {gi} vs {ri}")
        n += 1
    return n


def profile_phase(torch, recommend) -> dict:
    """Where one warm recommend's time goes: device time by kernel name
    (torch.profiler), the device busy share of the call's wall time, and the
    host functions with the most cumulative time (cProfile; it inflates
    Python-heavy parts, so read it for where, not how much)."""
    import cProfile
    import io
    import pstats

    from torch.autograd import DeviceType

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        recommend()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    def device_us(event) -> float:
        return float(getattr(event, "self_device_time_total", getattr(event, "self_cuda_time_total", 0.0)))

    # only events that ran on the card: CPU operators report their kernels'
    # time too, and counting both would count each kernel twice
    rows = sorted(
        ((device_us(e), e.count, e.key) for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        reverse=True,
    )
    device_ms = sum(r[0] for r in rows) / 1e3
    print(f"profile: {device_ms:.2f} ms of device work in a {wall_ms:.1f} ms call, "
          f"busy share {device_ms / wall_ms:.4f}")
    for us, count, name in rows[:12]:
        print(f"profile: device {us / 1e3:8.3f} ms x{count:<3d} {name[:90]}")

    host = cProfile.Profile()
    host.enable()
    recommend()
    host.disable()
    out = io.StringIO()
    pstats.Stats(host, stream=out).sort_stats("cumulative").print_stats(25)
    for line in out.getvalue().splitlines():
        if "rectools_tpu_torch" in line or "{method" in line:
            print(f"profile: host {line.strip()}")
    return {"profiled_wall_ms": wall_ms, "device_ms": device_ms, "device_busy_share": device_ms / wall_ms}


def main_phase(torch, np, pd, port, dev) -> dict:
    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.models import SASRecModel
    from rectools_tpu_torch.models.nn.item_net import IdEmbeddingsItemNet

    t0 = time.perf_counter()
    df = kion_frame(np, pd, Columns)
    dataset = Dataset.construct(df)
    build_s = time.perf_counter() - t0
    print(f"main: frame {len(df)} interactions, {dataset.user_id_map.size} users, built in {build_s:.1f} s")
    config = dict(
        n_blocks=N_BLOCKS, n_heads=N_HEADS, n_factors=N_FACTORS, session_max_len=SESSION_MAX_LEN,
        dropout_rate=0.2, item_net_block_types=(IdEmbeddingsItemNet,),
    )
    params = flax_params(np, N_ITEM_IDS + 1)
    model = SASRecModel(**config, device=dev).load_jax_params(dataset, params)
    check(model.backbone.item_model.n_items == N_ITEM_IDS + 1, "item table is not 15,872 rows")
    batch = model._effective_recommend_batch_size()
    check(batch == 4096, f"recommend batch resolved to {batch}, expected 4096")
    users = dataset.user_id_map.external_ids
    n_batches = math.ceil(len(users) / batch)

    port.reset_launches()
    t0 = time.perf_counter()
    reco = model.recommend(users, dataset, k=K, filter_viewed=True)
    first_s = time.perf_counter() - t0
    launches = dict(port.LAUNCHES)
    expected = {"attention_fwd": N_BLOCKS * n_batches, "layer_norm_fwd": (2 * N_BLOCKS + 1) * n_batches,
                "group_topm": n_batches}
    check(launches == expected, f"launches on the main path {launches}, expected {expected}")
    print(f"main: recommend {len(users)} users in {n_batches} batches, launches {launches}")

    check(len(reco) == K * len(users), f"{len(reco)} rows, expected {K * len(users)}")
    check(bool((reco.groupby("user_id").size() == K).all()), "some user did not get k items")
    seen = set(zip(df[Columns.User].to_numpy().tolist(), df[Columns.Item].to_numpy().tolist()))
    check(not any(p in seen for p in zip(reco["user_id"].tolist(), reco["item_id"].tolist())), "a seen item came back")
    scores = reco["score"].to_numpy().reshape(len(users), K)
    check(bool(np.isfinite(scores).all()), "non-finite scores")
    check(bool((np.diff(scores, axis=1) <= 0).all()), "scores not non-increasing within a user")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        model.recommend(users, dataset, k=K, filter_viewed=True)
        times.append(time.perf_counter() - t0)
    warm_s = float(np.median(times))
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    print(f"main: recommend wall first {first_s:.3f} s, warm median {warm_s:.3f} s of {[round(t, 3) for t in times]}, "
          f"{len(users) / warm_s:.0f} users/s, peak device memory {peak_mb:.0f} MiB")

    profile = profile_phase(torch, lambda: model.recommend(users, dataset, k=K, filter_viewed=True))

    port.reset_launches()
    targets = model.data_preparator.get_known_item_ids()[:2048]
    i2i = model.recommend_to_items(targets, dataset, k=K)
    check(len(i2i) == K * len(targets), f"i2i returned {len(i2i)} rows")
    check(port.LAUNCHES["group_topm"] == 1, f"i2i launches {dict(port.LAUNCHES)}")
    print(f"main: recommend_to_items {len(targets)} items, launches {dict(port.LAUNCHES)}")

    # the port's own CPU run (plain twins) on 64 users, same weights
    sample = users[:64]
    cpu_model = SASRecModel(**config, device="cpu").load_jax_params(dataset, params)
    ref = cpu_model.recommend(sample, dataset, k=K + 1, filter_viewed=True)
    got = model.recommend(sample, dataset, k=K, filter_viewed=True)
    n_cmp = compare_reco(np, got, ref, K)
    print(f"main: {n_cmp} users agree with the CPU run (score rtol {SCORE_RTOL}, atol {SCORE_ATOL})")
    return {"launches": launches, "first_s": first_s, "warm_s": warm_s, "warm_samples_s": times,
            "users_per_s": len(users) / warm_s, "peak_device_mib": peak_mb, **profile}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "rectools_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no rectools_tpu_torch/ beside {Path(__file__).name}; run it from a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))
    import numpy as np
    import pandas as pd

    import rectools_tpu_torch.ops as port

    # phase 1: device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_name_and_power()
    print(f"device: {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; nvidia-smi: {card}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    # phase 2: build
    t0 = time.perf_counter()
    reports = port.build()
    print(f"build: {len(reports)} sources compiled in {time.perf_counter() - t0:.1f} s")
    for name, report in reports.items():
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    # phase 3: kernels
    kernels = kernel_phase(torch, torch.device("cuda"))

    # phase 4: main path
    main_result = main_phase(torch, np, pd, port, "cuda")

    sources = {
        "layer_norm_fwd": ("rectools_tpu_torch/csrc/layer_norm.cu", "rectools_tpu/ops/layer_norm.py:27"),
        "attention_fwd": ("rectools_tpu_torch/csrc/attention.cu", "rectools_tpu/ops/attention.py:104"),
        "group_topm": ("rectools_tpu_torch/csrc/topk_select.cu", "rectools_tpu/ops/topk_select.py:49"),
    }
    line = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": sources[name][0],
                "replaces": sources[name][1],
                "launches": main_result["launches"][name],
                "max_abs_err": r["max_abs_err"],
                "ms": r["ms"],
                "plain_ms": r["plain_ms"],
                "bound_ms": r["bound"][0],
                "bound_by": r["bound"][1],
                "library_ms": r["library_ms"],
            }
            for name, r in kernels.items()
        ],
        "recommend": {k: v for k, v in main_result.items() if k != "launches"},
    }
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
