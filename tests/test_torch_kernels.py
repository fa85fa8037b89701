"""The port's hand-written CUDA kernels against their plain PyTorch twins, on
the card, plus the port's package-level guards.

This file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch. The kernel tests are marked ``gpu`` and skip
without a card; on one, run
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py``
(``--noconftest`` because tests/conftest.py configures JAX).
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rectools_tpu_torch.dataset import IdMap
from rectools_tpu_torch.models import (
    ALSModel,
    BERT4RecModel,
    BPRModel,
    DSSMModel,
    HSTUModel,
    HybridMFModel,
    SASRecModel,
    TorchRanker,
)
from rectools_tpu_torch.models.nn.transformers import LiGRLayers, TransformerBackbone
from rectools_tpu_torch.ops import _native, attention, layer_norm, softmax_lse, stu_attention, topk, topk_select
from rectools_tpu_torch.tools import (ItemToItemAnnRecommender, attention_bf16_variants, ce_grads_bf16_variants,
                                      fused_bwd_variants, stu_fwd_topm_check)

REPO = Path(__file__).resolve().parents[1]
MASK_VALUE = -1e9
# Relative to the twin's largest entry: the gradient kernels on the
# tensor-core tile, fused (7's one pass, 9, 12) and split (7's two launches,
# 10, 11, 13, 14), at D in 32..128 (3xTF32, a fresh fragment per 16 k), where
# plain TF32 and 3xTF32 accumulated straight on land above it; the SIMT
# kernels (D = 16, 256).
TC_RTOL, SIMT_RTOL = 6e-6, 1e-4
# the lse forwards on that tile (kernels 6, 8 and 15), relative per row from
# their twins; plain TF32 products land above it
LSE_TC_RTOL = 1e-6


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 as ``cvt.rna.tf32.f32`` does: a plain-TF32 control's operands."""
    return ((x.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _grads_rtol(d: int) -> float:
    return TC_RTOL if softmax_lse._BWD_TILE[d][0] == 128 else SIMT_RTOL


def _t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


def _imported_modules(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_imports_no_jax_and_nothing_of_the_jax_package() -> None:
    sources = sorted((REPO / "rectools_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(sources) > 20
    assert {"mesh.py", "distributed.py", "collectives.py", "launch.py"} <= {
        path.name for path in sources if path.parent.name == "parallel"
    }
    scanned = {str(path.relative_to(REPO / "rectools_tpu_torch")) for path in sources if path.name != "chip_smoke.py"}
    assert {"native/__init__.py", "metrics/scoring.py", "metrics/ranking.py", "model_selection/cross_validate.py",
            "model_selection/time_split.py", "models/serialization.py", "utils/array_ops.py", "ops/als.py",
            "ops/bpr.py", "ops/hybrid_mf.py", "models/als.py", "models/bpr.py", "models/hybrid_mf.py",
            "models/nn/dssm.py", "dataset/dssm_datasets.py", "compat.py", "models/ranking/__init__.py",
            "models/ranking/candidate_ranking.py", "models/ranking/catboost_reranker.py", "tools/__init__.py",
            "tools/ann.py", "visuals/__init__.py", "visuals/metrics_app.py", "visuals/visual_app.py"} <= scanned
    offenders = {}
    for path in sources:
        bad = {
            name for name in _imported_modules(path)
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "rectools_tpu")
        }
        if bad:
            offenders[str(path.relative_to(REPO))] = sorted(bad)
    assert not offenders, offenders


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch: pytest.MonkeyPatch) -> None:
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    objects = np.ones((4, 2), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        SASRecModel()
    with pytest.raises(RuntimeError, match="cuda"):
        HSTUModel()
    for cls in (ALSModel, BPRModel, HybridMFModel, DSSMModel):
        with pytest.raises(RuntimeError, match="cuda"):
            cls()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchRanker(topk.Distance.DOT, objects, objects)
    with pytest.raises(RuntimeError, match="cuda"):
        topk.TopKEngine(objects)
    with pytest.raises(RuntimeError, match="cuda"):
        ItemToItemAnnRecommender(objects, IdMap.from_values(np.arange(4)))


def test_fused_bwd_tile_rows_match_the_cuda_source() -> None:
    """The wrapper plans the gradient kernels' grids, fused and split, from
    ``_BWD_TILE``; the kernels are built for the session rows of
    csrc/softmax_lse.cu (and refuse another grid on the card). The two agree
    at every D: one rule picks the tensor-core tile for the fused kernel and
    for both split kernels, and only that tile cuts the catalog into ds
    chunks."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "softmax_lse.cu").read_text()
    assert "constexpr bool tensor_cores(int d) { return d >= 32 && d <= 128; }" in src
    assert src.count("if constexpr (tensor_cores(D))") == 3  # launch_ds, launch_di, launch_chunks (kernels 6, 8, 16)
    assert "constexpr bool kTensorCores = tensor_cores(D);" in src  # launch_fused
    for kernel in ("grad_ds_tc_kernel", "grad_di_tc_kernel"):
        assert f"{kernel}<D, F><<<" in src
    tc_rows = int(re.search(r"namespace tc \{\s*constexpr int kBM = (\d+);", src).group(1))
    simt_rows = int(re.search(r"^constexpr int kBM = (\d+);", src, re.M).group(1))
    rows = {d: tile[0] for d, tile in softmax_lse._BWD_TILE.items()}
    assert rows == {d: tc_rows if 32 <= d <= 128 else simt_rows for d in softmax_lse.SUPPORTED_D}
    # the SIMT split ds kernel takes one chunk (launch_ds refuses another count)
    assert "if (n_chunks != 1) return (int)cudaErrorInvalidValue;" in src
    assert {d: tile[2] == 1 for d, tile in softmax_lse._BWD_TILE.items()} == {
        d: rows[d] == simt_rows for d in softmax_lse.SUPPORTED_D}


def test_lse_partials_tile_matches_the_cuda_source() -> None:
    """Kernels 6 and 16 take the tensor-core kernel (128-row session tiles of
    ``namespace tc``; kernel 16 in its shift mode) for exactly the D of the
    gradient kernels' tensor-core rule and the SIMT kernel otherwise. Both
    tiles walk the same ``LSE_CHUNK``-row item chunks, whole 64-row item
    tiles, so the twin's chunks are the card's: 8 at the training shape, whose
    400 x 8 = 3,200 blocks of one per multiprocessor fill the last wave to 97%
    (one chunk per session tile would leave 4 blocks alone in a fourth). No
    float atomics: each block writes its own partials."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "softmax_lse.cu").read_text()
    launch = src[src.index("int launch_chunks(") :]
    launch = launch[: launch.index("\n}\n")]
    assert "if constexpr (tensor_cores(D)) {" in launch and "kShift &&" not in launch
    assert "constexpr LseMode kMode = kShift ? LseMode::kShift : LseMode::kPartials;" in launch
    assert "lse_partials_tc_kernel<D, kMode><<<grid, tc::kThreads, smem, stream>>>" in launch
    assert "lse_chunk_kernel<D, kShift><<<grid, kThreads, smem, stream>>>" in launch
    assert "#define CALL_LSE_SHIFT(D, ...) launch_chunks<D, true>(__VA_ARGS__)" in src
    assert "atomicAdd(" not in src
    grid = "const dim3 grid((unsigned)((M + tc::kBM - 1) / tc::kBM), (unsigned)((N + chunk_rows - 1) / chunk_rows));"
    assert grid in src
    tile = re.search(r"namespace tc \{\s*constexpr int kBM = (\d+);[^\n]*\n\s*constexpr int kBN = (\d+);", src)
    tc_rows, item_rows = int(tile.group(1)), int(tile.group(2))
    assert item_rows == softmax_lse.TILE and softmax_lse.LSE_CHUNK % item_rows == 0
    assert {d for d in softmax_lse.SUPPORTED_D if softmax_lse._BWD_TILE[d][0] == tc_rows} == {32, 64, 128}
    blocks = -(-51200 // tc_rows) * -(-15872 // softmax_lse.LSE_CHUNK)
    assert blocks == 3200 and blocks / (-(-blocks // 132) * 132) > 0.96


def test_layer_norm_bwd_is_one_launch_in_the_cuda_source() -> None:
    """Kernel 4 is one launch: ``ln_bwd_f32`` (and its bf16 form
    ``ln_bwd_bf16``) launches ``ln_bwd_kernel`` and nothing else, whose last
    block sums the partial rows after an integer ticket (no float atomics) and
    resets the counter. The ``.cu`` picks the
    warps a block from D alone (16 up to D = 256, else 8) and reads every row
    in the forward kernel's lane layout, with no second path by alignment;
    ``bwd_partition`` gives every M at most ``MAX_BWD_BLOCKS`` non-empty
    blocks that cover it: 128 x 400 rows at the training shape (51,200 rows),
    65 rows in the last of 65 at 8,193."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "layer_norm.cu").read_text()
    entry = src[src.index('extern "C" int ln_bwd_f32('):]
    assert "<<<" not in entry and src.count("<<<") == 2  # the forward's launch and the backward's
    assert "ln_bwd_kernel<VPL, T, G><<<n_blocks, 32 * warps, smem, stream>>>" in src
    assert "ticket = atomicAdd(counter, 1u);" in src and "*counter = 0u;" in src
    assert "atomicAdd(" not in src.replace("atomicAdd(counter, 1u)", "")
    assert "constexpr int bwd_warps(int d) { return d <= 256 ? 16 : 8; }" in src
    assert "const int warps = bwd_warps(d);" in src
    assert "float4" not in src and "uintptr_t" not in src
    assert layer_norm.bwd_partition(51200) == (128, 400)
    assert layer_norm.bwd_partition(8193) == (65, 127) and layer_norm.bwd_partition(1) == (1, 1)
    assert layer_norm.bwd_partition(0) == (1, 1)
    for m in list(range(1, 700)) + [8192, 8193, 51199, 51200, 409600, 10**7 + 3]:
        blocks, rows = layer_norm.bwd_partition(m)
        assert 1 <= blocks <= layer_norm.MAX_BWD_BLOCKS and (blocks - 1) * rows < m <= blocks * rows, m


def test_lse_cluster_plan_matches_the_cuda_source() -> None:
    """Kernel 15 takes kernel 6's tensor-core kernel with the cluster epilogue
    (``lse_partials_tc_kernel<D, LseMode::kCluster>``, launched with a cluster dimension)
    exactly where kernel 6 takes the tile, and the SIMT ``lse_kernel`` at D =
    16 and 256. ``lse_cluster_plan`` is a function of N alone, within the
    ``.cu``'s limit of 8 ranks: at the training shape 8 ranks of 31 item tiles
    (1,984 rows), 400 x 8 = 3,200 blocks as kernel 6's; one rank under one
    tile; ranks past the last tile where the tiles do not fill the plan."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "softmax_lse.cu").read_text()
    launch = src[src.index("int launch_lse(") :]
    launch = launch[: launch.index("\n}\n")]
    assert "constexpr bool kTensorCores = tensor_cores(D);\n  if constexpr (kTensorCores) {" in launch
    assert "cudaLaunchKernelEx(&cfg, lse_partials_tc_kernel<D, LseMode::kCluster>, s, items," in launch
    assert "lse_kernel<D><<<" in launch
    assert "attr->val.clusterDim.y = (unsigned)cluster;" in src
    assert "if (cluster < 1 || cluster > 8 || rank_rows <= 0 || rank_rows % kBN || cluster * rank_rows < N)" in src
    assert softmax_lse.LSE_CLUSTER_MAX == 8
    assert softmax_lse.lse_cluster_plan(15872) == (8, 1984)
    assert -(-51200 // 128) * softmax_lse.lse_cluster_plan(15872)[0] == 3200
    assert softmax_lse.lse_cluster_plan(40) == (1, 64) and softmax_lse.lse_cluster_plan(0) == (1, 64)
    for n in list(range(1, 3000, 7)) + [15835, 65536, 131072, 10**6 + 1]:
        cluster, rows = softmax_lse.lse_cluster_plan(n)
        assert 1 <= cluster <= 8 and rows % softmax_lse.TILE == 0 and cluster * rows >= n
        assert cluster == min(8, -(-n // softmax_lse.TILE))
    assert softmax_lse.lse_cluster_plan(576) == (8, 128)  # 9 tiles: ranks 5-7 own none


def test_stu_bwd_tile_matches_the_cuda_source() -> None:
    """The wrapper launches the backward's second kernel (dq), and counts the
    forward's launch as the tensor-core one, exactly for the head dims the
    ``.cu`` puts on the tensor cores, whose blocks own ``BWD_TILE`` keys and
    ``BWD_TILE`` queries."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "stu_attention.cu").read_text()
    rule = "{ return (ad == 32 || ad == 64) && (lh == 32 || lh == 64); }"
    assert f"constexpr bool stu_tensor_cores(int ad, int lh) {rule}" in src and stu_attention.TC_HEAD_DIMS == (32, 64)
    assert src.count("if constexpr (stu_tensor_cores(AD, LH))") == 3  # the forward, the dk/dv and the dq launch
    assert "stu_fwd_tc_kernel<AD, LH><<<(unsigned)blocks, kFwdThreads, smem, stream>>>(p);" in src
    for name in ("kTcKeys", "kTcQueries"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == stu_attention.BWD_TILE
    dims = stu_attention.SUPPORTED_HEAD_DIMS
    assert {(a, l) for a in dims for l in dims if stu_attention.bwd_on_tensor_cores(a, l)} == {
        (a, l) for a in (32, 64) for l in (32, 64)}


def test_group_topm_routes_match_the_cuda_source() -> None:
    """The wrapper counts a launch as the thread-per-group kernel's
    (``group_topm``) exactly for the m the ``.cu`` gives it, up to
    ``SELECT_MAX_M``, with lists of 4, 8, 12 or 16 entries; a larger m takes
    the sorting kernel (``group_topm_sort_kernel``, launch key
    ``group_topm_warp``): eight lanes of 16 pairs a group."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "topk_select.cu").read_text()
    assert int(re.search(r"constexpr int kSelectMaxM = (\d+);", src).group(1)) == topk_select.SELECT_MAX_M == 16
    entry = src[src.index('extern "C" int group_topm_f32('):]
    sizes = [int(n) for n in re.findall(r"if \(m <= (\d+)\) return launch_select<\1>", entry)]
    assert sizes == [4, 8, 12] and "if (m <= kSelectMaxM) return launch_select<kSelectMaxM>" in entry
    assert entry.index("launch_select<kSelectMaxM>") < entry.index("group_topm_sort_kernel<<<")
    assert not re.search(r"\bgroup_topm_kernel\b", src)  # the first port's butterfly kernel is gone
    lanes = int(re.search(r"constexpr int kSortLanes = (\d+);", src).group(1))
    assert lanes * 16 == topk_select.GROUP_W and "constexpr int kSortPerLane = kGroupW / kSortLanes;" in src


def test_attention_tile_matches_the_cuda_source() -> None:
    """Kernels 2 and 5 take the tensor-core kernels exactly at
    ``attention.TC_HEAD_DIMS`` (one rule in the ``.cu``, used by both
    launches), on the tiles the wrapper module names, which the CPU emulation
    of their order (tests/test_torch_ops_training.py) walks: a forward block
    of 4 warps owns ``FWD_TILE`` queries and steps ``FWD_TILE`` keys; a
    backward block of 8 warps owns a (b, h) row, ``BWD_KEY_TILE`` keys a step
    (16 a warp) and ``BWD_QUERY_TILE`` queries a step. At the SASRec training
    shape that is 4,096 forward and 2,048 backward blocks."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "attention.cu").read_text()
    rule = "constexpr bool attn_tensor_cores(int dh) { return dh == 32 || dh == 64; }"
    assert rule in src and attention.TC_HEAD_DIMS == (32, 64)
    assert set(attention.TC_HEAD_DIMS) < set(attention.SUPPORTED_HEAD_DIMS)
    assert src.count("if constexpr (attn_tensor_cores(DH))") == 2  # launch_fwd, launch_bwd
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kFwdTile", "kFwdThreads", "kBwdKeys", "kBwdQueries", "kBwdThreads")}
    assert const["kFwdTile"] == attention.FWD_TILE
    assert (const["kBwdKeys"], const["kBwdQueries"]) == (attention.BWD_KEY_TILE, attention.BWD_QUERY_TILE)
    assert const["kFwdThreads"] == 32 * attention.FWD_TILE // 16 and const["kBwdThreads"] == 32 * attention.BWD_KEY_TILE // 16
    assert "const long long blocks = (long long)p.B * p.H * ((p.L + kFwdTile - 1) / kFwdTile);" in src
    assert "attn_bwd_tc_kernel<DH, kDropout><<<(unsigned)(p.B * p.H), kBwdThreads, smem, stream>>>(p);" in src
    assert 512 * 4 * -(-100 // attention.FWD_TILE) == 4096


def test_bf16_attention_forward_plan_matches_the_cuda_source() -> None:
    """Kernel 2's bf16 forward (``attn_fwd_onepass_bf16_kernel``) plans its
    launch with the constants the wrapper module names: rows kept in
    registers up to ``BF16_FWD_REG_KEYS`` keys (a block per b and group of
    ``BF16_FWD_HEADS`` heads sharing the bias, a warp per 16 query rows),
    else blocks of ``BF16_FWD_TILE`` query rows with the rows in shared
    memory up to ``BF16_FWD_SMEM_KEYS`` keys. The two-pass kernel it
    replaced is gone, and the backward keeps its ``BF16_TILE``-row tiles."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "attention_bf16.cu").read_text()
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kRegKeys", "kHeadsPerBlock", "kFwdTile", "kFwdTileThreads", "kSmemKeys", "kT")}
    assert (const["kRegKeys"], const["kHeadsPerBlock"], const["kFwdTile"], const["kSmemKeys"]) == (
        attention.BF16_FWD_REG_KEYS, attention.BF16_FWD_HEADS, attention.BF16_FWD_TILE, attention.BF16_FWD_SMEM_KEYS)
    assert const["kFwdTileThreads"] == 2 * attention.BF16_FWD_TILE and const["kT"] == attention.BF16_TILE
    assert "attn_fwd_bf16_kernel" not in src


@pytest.mark.parametrize("name", sorted(attention_bf16_variants.VARIANTS))
def test_attention_bf16_variants_still_apply(name: str) -> None:
    """Each variant that tools/attention_bf16_variants.py times on the card
    finds each text it replaces as often as it says in today's source, and
    changes it (but the source as it is)."""
    edited = attention_bf16_variants.edited_source(name)
    src = (REPO / attention_bf16_variants.CU).read_text()
    assert (edited == src) == (name == "as_is")


def test_lse_bias_chunks_match_the_cuda_source() -> None:
    """Kernel 8 is kernel 6's launch with a bias: ``lse_bias_f32`` runs the
    same (session tile, item chunk) grid on the same two tiles, and the
    wrapper gives it ``LSE_CHUNK``-row chunks and combines its partials as
    kernel 6's, so its twin's chunks are the card's. The carried-max kernel
    (15) keeps no bias."""
    import inspect

    src = (REPO / "rectools_tpu_torch" / "csrc" / "softmax_lse.cu").read_text()
    entry = src[src.index('extern "C" int lse_bias_f32('):]
    entry = entry[: entry.index("\n}\n")]
    assert "DISPATCH_D(D, CALL_LSE_PARTIALS, s, items, nullptr, bias, m_part, l_part, M, N, chunk_rows, stream)" in entry
    assert "chunk_rows % kBN" in entry
    assert "#define CALL_LSE_PARTIALS(D, ...) launch_chunks<D, false>(__VA_ARGS__)" in src
    assert "lse_partials_tc_kernel<D, kMode><<<grid, tc::kThreads, smem, stream>>>(s, items, shift, bias, " in src
    assert "lse_kernel<D><<<" in src and "kBias" not in src
    launch = inspect.getsource(softmax_lse._launch_chunked_lse)
    # kernels 6, 8 and 16 (and their bf16 forms) take one tail of arguments: LSE_CHUNK-row chunks, two partials
    assert "tail = (part_a.data_ptr(), part_b.data_ptr(), m, n, d, LSE_CHUNK, stream)" in launch
    assert 'getattr(lib, f"lse_bias{suffix}")(*pointers, row_bias.data_ptr(), *tail)' in launch
    assert softmax_lse._SIGNATURES["lse_bias_f32"] == softmax_lse._SIGNATURES["lse_partials_f32"][:2] + (
        softmax_lse._C,) + softmax_lse._SIGNATURES["lse_partials_f32"][2:]
    fwd = inspect.getsource(softmax_lse.streaming_lse_fwd)
    assert "combine_lse_partials(*_launch_chunked_lse(kernel, sessions, items, row_bias=row_bias))" in fwd
    twin = inspect.signature(softmax_lse.streaming_lse_bias_reference).parameters["chunk"].default
    assert twin == softmax_lse.LSE_CHUNK


def test_stu_ds_tile_matches_the_cuda_source() -> None:
    """Kernel 19's wrapper sizes the bucket partials by ``ds_tile``, which is
    the ``.cu``'s tile at every head dim: ``BWD_TILE`` x ``BWD_TILE`` (keys x
    queries) on the tensor cores, exactly where the backward takes them, and
    ``DS_TILE_KEYS`` x ``DS_TILE_QUERIES`` on the SIMT kernel; both kernels
    number their partial rows (batch row, key tile, query tile) on a grid of
    (B, key tiles, query tiles), the twin's block order. At the HSTU training
    shape that is 512 x 2 x 2 blocks."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "stu_attention.cu").read_text()
    launch = src[src.index("struct DsLaunch {"):]
    launch = launch[: launch.index("\n};\n")]
    assert "constexpr bool kTensorCores = stu_tensor_cores(AD, LH);" in launch
    assert "constexpr int kKeys = kTensorCores ? kTcKeys : kKT, kQueries = kTensorCores ? kTcQueries : kDQ;" in launch
    assert "const dim3 grid((unsigned)p.B, (unsigned)((p.L + kKeys - 1) / kKeys), (unsigned)((p.L + kQueries - 1) / " \
           "kQueries));" in launch
    assert "stu_ds_tc_kernel<AD, LH><<<grid, kTcThreads, smem, stream>>>(p);" in launch
    assert "stu_ds_kernel<AD, LH><<<grid, kKT, smem, stream>>>(p);" in launch
    assert "n_partials != (long long)grid.x * grid.y * grid.z" in launch
    assert src.count("((long long)(b * gridDim.y + blockIdx.y) * gridDim.z + blockIdx.z) * p.n_entries") == 2
    const = {name: int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
             for name in ("kKT", "kDQ", "kTcKeys", "kTcQueries")}
    assert (const["kKT"], const["kDQ"]) == (stu_attention.DS_TILE_KEYS, stu_attention.DS_TILE_QUERIES)
    assert const["kTcKeys"] == const["kTcQueries"] == stu_attention.BWD_TILE
    dims = stu_attention.SUPPORTED_HEAD_DIMS
    assert {(a, l): stu_attention.ds_tile(a, l) for a in dims for l in dims} == {
        (a, l): (64, 64) if stu_attention.bwd_on_tensor_cores(a, l) else (128, 32) for a in dims for l in dims}
    keys, queries = stu_attention.ds_tile(32, 32)
    assert 512 * -(-100 // keys) * -(-100 // queries) == 2048


@pytest.mark.parametrize("name", sorted(fused_bwd_variants.VARIANTS))
def test_fused_bwd_variants_still_apply(name: str) -> None:
    """Each variant that tools/fused_bwd_variants.py times on the card finds
    each text it replaces exactly once in today's sources."""
    edited = fused_bwd_variants.edited_sources(name)
    assert set(edited) == {rel for rel, _, _ in fused_bwd_variants.VARIANTS[name]}
    for rel, text in edited.items():
        assert text != (REPO / rel).read_text()


@pytest.mark.parametrize("name", sorted(stu_fwd_topm_check.VARIANTS))
def test_stu_fwd_topm_check_variants_still_apply(name: str) -> None:
    """Each variant that tools/stu_fwd_topm_check.py builds and times on the
    card finds each text it replaces exactly once in today's source."""
    source, edits = stu_fwd_topm_check.VARIANTS[name]
    assert (REPO / "rectools_tpu_torch" / "csrc" / f"{source}.cu").exists()
    for file, old, new in edits:
        assert (REPO / "rectools_tpu_torch" / "csrc" / file).read_text().count(old) == 1 and old != new


# ------------------------------------------------------------------ kernels on the card


@pytest.fixture
def cuda() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _causal_bias(l: int) -> np.ndarray:
    return np.where(np.tril(np.ones((l, l), dtype=bool)), 0.0, MASK_VALUE).astype(np.float32)[None, None]


def _bidirectional_bias(rng: np.random.Generator, b: int, l: int) -> np.ndarray:
    """BERT4Rec's (B, 1, L, L) bias, from the backbone's own rule (key padding,
    no causal mask, the diagonal kept) over left-padded sessions: one of
    length 1, one full, the others drawn."""
    lengths = rng.integers(1, l + 1, size=b)
    lengths[:2] = (1, l)
    sessions = torch.from_numpy((np.arange(l)[None, :] >= (l - lengths)[:, None]).astype(np.int64))
    rule = type("Rule", (), {"use_causal_attn": False, "use_key_padding_mask": True})()
    return TransformerBackbone._build_attn_bias(rule, sessions).numpy()


def _masked_row_bias(l: int) -> np.ndarray:
    """The causal bias with query row l // 3 masked everywhere: its lse is
    about MASK_VALUE and p = exp(s - lse) is 1 for every key, in the twin and
    in the kernels (never skipped)."""
    bias = _causal_bias(l)
    bias[..., l // 3, :] = MASK_VALUE
    return bias


@pytest.mark.gpu
@pytest.mark.parametrize("m,d,eps", [(4099, 128, 1e-6), (33, 96, 1e-8), (7, 1024, 1e-6), (102400, 256, 1e-6)])
def test_cuda_layer_norm_matches_twin(cuda: torch.device, m: int, d: int, eps: float) -> None:
    rng = np.random.default_rng(m)
    x = _t((rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)).to(cuda)
    g, b = (_t(rng.normal(size=(d,)).astype(np.float32)).to(cuda) for _ in range(2))
    before = _native.LAUNCHES["layer_norm_fwd"]
    got = layer_norm.layer_norm(x, g, b, eps)
    assert _native.LAUNCHES["layer_norm_fwd"] == before + 1
    torch.testing.assert_close(got, layer_norm.layer_norm_reference(x, g, b, eps), atol=1e-5, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("bias_kind", ["none", "causal", "key_padding", "masked_row", "bidirectional"])
@pytest.mark.parametrize("l,dh", [(100, 32), (12, 16), (257, 64), (100, 64), (37, 32)])
def test_cuda_attention_matches_twin(cuda: torch.device, bias_kind: str, l: int, dh: int) -> None:
    rng = np.random.default_rng(l)
    b, h = 3, 4
    q, k, v = (_t(rng.normal(size=(b, l, h, dh)).astype(np.float32)).to(cuda) for _ in range(3))  # (B, L, H, dh)
    bias = None
    if bias_kind == "causal":
        bias = _t(_causal_bias(l)).to(cuda)
    elif bias_kind == "masked_row":
        bias = _t(_masked_row_bias(l)).to(cuda)
    elif bias_kind == "key_padding":
        pad = np.arange(l)[None, :] < rng.integers(0, l, size=b)[:, None]
        kp = np.where(pad, MASK_VALUE, 0.0)[:, None, None, :] + _causal_bias(l)
        kp[:, :, np.arange(l), np.arange(l)] = 0.0
        bias = _t(kp.astype(np.float32)).to(cuda)
    elif bias_kind == "bidirectional":
        bias = _t(_bidirectional_bias(rng, b, l)).to(cuda)
    scale = 1.0 / dh**0.5
    before = _native.LAUNCHES["attention_fwd"]
    out, lse = attention.attention_fwd(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), bias, scale)
    assert _native.LAUNCHES["attention_fwd"] == before + 1
    assert out.transpose(1, 2).is_contiguous()
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    ref_out, ref_lse = attention.attention_reference(qt, kt, vt, bias, scale)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    again = attention.attention_fwd(qt, kt, vt, bias, scale)  # the same bits on a rerun
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)


def _topm_cases(m: int) -> np.ndarray:
    """(10, 5 * 128) scores whose groups hold the selection's edge cases:
    N(0, 1) scores, ties inside a group, 128 equal values, fewer than m
    finite values among -inf, ties straddling the m-th slot, +inf values, all
    -inf, and a row of plain co-counts (non-negative integers, about 90%
    zeros: runs of tied zeros across the m-th slot)."""
    rng = np.random.default_rng(m)
    x = rng.normal(size=(10, 5 * 128)).astype(np.float32)
    x[:, [3, 40, 77, 127]] = 5.0  # ties inside a group: lowest lane first
    x[1, 128:256] = 1.0  # 128 equal values
    x[2, 256:384] = -np.inf  # all -inf: (-inf, lane 0) every slot
    x[4, 600:] = -np.inf
    x[5, 128:256] = -np.inf  # fewer than m finite values: the rest (-inf, lane 0)
    x[5, 128 + rng.choice(128, max(m // 2, 1), replace=False)] = rng.normal(size=max(m // 2, 1))
    straddle = rng.normal(size=128).astype(np.float32) - 10.0  # m - 2 larger values, then 6 ties
    straddle[rng.choice(128, max(m - 2, 0), replace=False)] = 5.0 + np.arange(max(m - 2, 0))
    below = np.flatnonzero(straddle < 0)
    straddle[rng.choice(below, min(6, below.size), replace=False)] = 1.0
    x[6, 256:384] = straddle
    x[7, [130, 200, 201]] = np.inf
    x[8, 384:512] = np.round(x[8, 384:512], 1)  # coarse ties everywhere
    cocount = np.zeros(5 * 128, np.float32)
    nonzero = rng.choice(5 * 128, 64, replace=False)
    cocount[nonzero] = rng.integers(1, 4, nonzero.size)
    x[9] = cocount
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("m", [1, 12, 16, 17, 33, 50, 64, 70, 128])
def test_cuda_group_topm_matches_twin(cuda: torch.device, m: int) -> None:
    """Every value and every lane id equal to the twin's, the (-inf, lane 0)
    slots included, on both kernels: the thread-per-group one up to m = 16
    (``SELECT_MAX_M``), the sorting one above (m > 32 stores each group in
    several runs of 32; m = 128 is the whole group in order), co-counts whose
    tied zeros straddle the m-th slot; a row stride wider than the groups;
    the same bits on a rerun."""
    xt = _t(_topm_cases(m)).to(cuda)
    key = "group_topm" if m <= topk_select.SELECT_MAX_M else "group_topm_warp"
    before = dict(_native.LAUNCHES)
    vals, lanes = topk_select.group_topm(xt, m)
    assert {k: _native.LAUNCHES[k] - before[k] for k in ("group_topm", "group_topm_warp")} == {
        k: int(k == key) for k in ("group_topm", "group_topm_warp")}
    ref_vals, ref_lanes = topk_select.group_topm_reference(xt, m)
    torch.testing.assert_close(vals, ref_vals, atol=0, rtol=0)
    torch.testing.assert_close(lanes, ref_lanes, atol=0, rtol=0)
    assert bool(torch.isneginf(vals[2, 2]).all()) and not lanes[2, 2].any()
    again = topk_select.group_topm(xt, m)
    assert torch.equal(again[0], vals) and torch.equal(again[1], lanes)
    wide = torch.full((10, 6 * 128), float("nan"), device=cuda)
    wide[:, : 5 * 128] = xt
    got = topk_select.group_topm(wide[:, : 5 * 128], m)
    assert torch.equal(got[0], vals) and torch.equal(got[1], lanes)


@pytest.mark.gpu
def test_cuda_grouped_top_k_matches_cpu(cuda: torch.device) -> None:
    x = np.random.default_rng(3).normal(size=(64, 15872)).astype(np.float32)
    vals, idx = topk_select.grouped_exact_top_k(_t(x).to(cuda), 10)
    ref_vals, ref_idx = topk_select.grouped_exact_top_k(_t(x), 10)
    torch.testing.assert_close(vals.cpu(), ref_vals, atol=0, rtol=0)
    torch.testing.assert_close(idx.cpu(), ref_idx, atol=0, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("adversarial", [False, True])
def test_cuda_rank_topk_matches_cpu(cuda: torch.device, adversarial: bool) -> None:
    from scipy import sparse

    rng = np.random.default_rng(7)
    n_subjects, n_objects, d, k = 300, 5000, 16, 20
    objects = rng.normal(size=(n_objects, d)).astype(np.float32)
    if adversarial:  # scores sorted along the catalog: group 0 holds the whole top k
        objects[:, 0] = np.linspace(100.0, 1.0, n_objects)
        objects[:, 1:] = 0.0
    subjects = np.abs(rng.normal(size=(n_subjects, d))).astype(np.float32) + 0.1
    seen = sparse.random(n_subjects, n_objects, density=0.01, format="csr", random_state=1)
    whitelist = np.sort(rng.choice(n_objects, size=4000, replace=False))
    kwargs = dict(k=k, filter_pairs_csr=seen, sorted_object_whitelist=whitelist, batch_size=128)
    got = topk.rank_topk(subjects, objects, np.arange(n_subjects), device=cuda, **kwargs)
    expected = topk.rank_topk(subjects, objects, np.arange(n_subjects), device="cpu", **kwargs)
    np.testing.assert_array_equal(got[0], expected[0])
    np.testing.assert_array_equal(got[1], expected[1])
    np.testing.assert_allclose(got[2], expected[2], rtol=1e-5, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("distance", ["DOT", "COSINE", "EUCLIDEAN"])
def test_cuda_query_batch_matches_cpu(cuda: torch.device, distance: str) -> None:
    """``TopKEngine.query_batch`` (the ANN tools' call) on the card against
    the CPU twin: 4,097 rows in two batches of 4,096 rows over 5,000
    objects, a third of them copies (exact ties; dyadic entries keep every
    score exact), k = 60 > m = 12, seen lists on odd rows. The same items in
    the same order; kernel 3 launched once a batch and no other kernel (a
    batch the certificate sends to the sort is sorted again without it)."""
    rng = np.random.default_rng(19)
    n, d, b, k = 5000, 16, 4097, 60
    objects = (rng.integers(-16, 17, size=(n, d)) / 8).astype(np.float32)
    objects[rng.choice(n, n // 3, replace=False)] = objects[rng.choice(n, n // 3)]
    subjects = (rng.integers(-16, 17, size=(b, d)) / 8).astype(np.float32)
    seen = rng.integers(0, n, size=(b, 9))
    seen[::2] = n
    got_engine = topk.TopKEngine(objects, distance=topk.Distance[distance], device=cuda)
    before = dict(_native.LAUNCHES)
    fallbacks = topk_select.FALLBACKS["query_batch"]
    got = got_engine.query_batch(subjects, k, seen)
    launches = sum(_native.LAUNCHES[key] - before[key] for key in ("group_topm", "group_topm_warp"))
    assert launches == 2 and all(_native.LAUNCHES[key] == before[key] for key in before
                                 if key not in ("group_topm", "group_topm_warp"))
    assert topk_select.FALLBACKS["query_batch"] >= fallbacks
    ref = topk.TopKEngine(objects, distance=topk.Distance[distance], device="cpu").query_batch(subjects, k, seen)
    np.testing.assert_array_equal(got[2], ref[2])
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-6)


@pytest.mark.gpu
def test_cuda_item_knn_truncation_matches_cpu(cuda: torch.device) -> None:
    """Kernel 3 at ItemKNN's truncation shape: integer co-counts of a sparse
    15,871-item matrix (most rows end in tied zeros), K = 50, in 4,096-row
    blocks. The truncated table equals the CPU's (the twin), bit for bit;
    one group_topm_warp launch a block (50 candidates a group); no block is
    sorted again; each block's group top-50 equals the twin's."""
    import torch.nn.functional as F

    from rectools_tpu_torch.models.item_knn import TRUNCATE_BLOCK_ROWS, _truncate_topk_rows

    n, k = 15871, 50
    gen = torch.Generator(device=cuda).manual_seed(16)
    x = (torch.rand((2048, n), generator=gen, device=cuda) < 0.003).float()
    s = x.T @ x
    before, fallbacks = _native.LAUNCHES["group_topm_warp"], topk_select.FALLBACKS["exact_top_k"]
    got = _truncate_topk_rows(s, k)
    n_blocks = -(-n // TRUNCATE_BLOCK_ROWS)
    assert _native.LAUNCHES["group_topm_warp"] - before == n_blocks
    assert topk_select.FALLBACKS["exact_top_k"] == fallbacks
    assert torch.equal(got.cpu(), _truncate_topk_rows(s.cpu(), k))
    n_pad = -(-n // topk_select.GROUP_W) * topk_select.GROUP_W
    for start in range(0, n, TRUNCATE_BLOCK_ROWS):
        block = F.pad(s[start : start + TRUNCATE_BLOCK_ROWS], (0, n_pad - n), value=float("-inf"))
        vals, lanes = topk_select.group_topm(block, k)
        ref_vals, ref_lanes = topk_select.group_topm_reference(block, k)
        assert torch.equal(vals, ref_vals) and torch.equal(lanes, ref_lanes)


@pytest.mark.gpu
def test_cuda_als_half_step_and_fit_match_cpu(cuda: torch.device) -> None:
    """ALS on the card (cuBLAS products, batched cuSOLVER Cholesky) against
    its CPU run: a half-step with confidences below 1 and negative ones
    within 1e-5 of the largest entry, a singular system a NaN row on both,
    and 3 iterations with feature-column resets within 1e-4."""
    from scipy import sparse

    from rectools_tpu_torch.ops import als

    rng = np.random.default_rng(17)
    dense = (rng.random((3000, 900)) < 0.02) * rng.uniform(-2.0, 4.0, (3000, 900))
    csr = sparse.csr_matrix(dense.astype(np.float32))
    y = rng.normal(size=(900, 64)).astype(np.float32)
    got, ref = als.als_half_step(csr, y, 0.05, device=cuda), als.als_half_step(csr, y, 0.05, device="cpu")
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    y[:, 5] = 0.0  # a Gram without that direction and no regularization: no system is SPD
    assert np.isnan(als.als_half_step(csr[:50], y, 0.0, device=cuda)[np.diff(csr[:50].indptr) > 0]).all()
    pos = abs(csr)
    u0, i0 = (rng.random((3000, 70)) * 0.01).astype(np.float32), (rng.random((900, 70)) * 0.01).astype(np.float32)
    resets = dict(user_reset_cols=(0, 4), user_reset_values=rng.random((3000, 4)).astype(np.float32),
                  item_reset_cols=(68, 70), item_reset_values=rng.random((900, 2)).astype(np.float32))
    on_card = als.als_fit(pos, u0, i0, 0.05, 3, device=cuda, **resets)
    on_cpu = als.als_fit(pos, u0, i0, 0.05, 3, device="cpu", **resets)
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())


@pytest.mark.gpu
def test_cuda_bpr_scatter_repeats_its_bits(cuda: torch.device) -> None:
    """BPR's scatter-adds (``index_put_`` with accumulate, sorted) give the
    same bits on a rerun of a fit on the card, with many duplicate rows a
    step; on the same draws the card's fit is the CPU's within 1e-5."""
    from scipy import sparse

    from rectools_tpu_torch.ops import bpr

    rng = np.random.default_rng(18)
    rows = np.repeat(np.arange(2000), rng.integers(1, 60, 2000))
    cols = (rng.zipf(1.3, len(rows)) - 1) % 500
    csr = sparse.csr_matrix((np.ones(len(rows), np.float32), (rows, cols)), shape=(2000, 500))
    csr.data[:] = 1.0
    first = bpr.bpr_fit(csr, 64, 0.05, 0.01, 3, 5, batch_size=8192, device=cuda)
    second = bpr.bpr_fit(csr, 64, 0.05, 0.01, 3, 5, batch_size=8192, device=cuda)
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)

    def shared_draws():
        draw = bpr.generator_draws(torch.Generator().manual_seed(7), 500)
        return lambda *args: tuple(t.clone() for t in draw(*args))

    on_card = bpr.bpr_fit(csr, 64, 0.05, 0.01, 3, 5, batch_size=8192, device=cuda, draw=shared_draws())
    on_cpu = bpr.bpr_fit(csr, 64, 0.05, 0.01, 3, 5, batch_size=8192, device="cpu", draw=shared_draws())
    for a, b in zip(on_card, on_cpu):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * np.abs(b).max())


@pytest.mark.gpu
def test_cuda_uniform_draws_give_a_batch_its_block_again(cuda: torch.device) -> None:
    """RandomModel's redraw of a batch whose certificate failed, from the
    card's generator state saved at the first draw."""
    draw = topk.uniform_draws(torch.Generator(device=cuda).manual_seed(1))
    first, second = draw(0, (64, 15872)), draw(1, (64, 15872))
    assert first.device.type == "cuda" and not torch.equal(first, second)
    assert torch.equal(draw(0, (64, 15872)), first) and torch.equal(draw(1, (64, 15872)), second)


@pytest.mark.gpu
def test_cuda_sasrec_recommend_matches_cpu(cuda: torch.device) -> None:
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.models.nn.item_net import CatFeaturesItemNet, IdEmbeddingsItemNet

    rng = np.random.default_rng(9)
    n = 3000
    df = pd.DataFrame({
        Columns.User: rng.integers(0, 200, n),
        Columns.Item: rng.integers(0, 300, n),
        Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
    })
    items = np.unique(df[Columns.Item])
    features = pd.DataFrame({"id": items, "feature": "genre", "value": rng.integers(0, 7, len(items))})
    dataset = Dataset.construct(df, item_features_df=features, cat_item_features=["genre"])
    config = dict(
        n_blocks=2, n_heads=4, n_factors=64, session_max_len=20, use_key_padding_mask=True,
        item_net_block_types=(IdEmbeddingsItemNet, CatFeaturesItemNet), recommend_batch_size=64,
    )
    models = {}
    for dev in ("cpu", "cuda"):
        model = SASRecModel(**config, device=dev)
        model._build_model_from_dataset(dataset)
        model.is_fitted = True
        models[dev] = model
    state = {
        name: _t(np.random.default_rng(len(name)).normal(scale=0.3, size=tuple(t.shape)).astype(np.float32))
        for name, t in models["cpu"].backbone.state_dict().items()
    }
    for model in models.values():
        model.backbone.load_state_dict(state)
    users = np.unique(df[Columns.User])
    got = models["cuda"].recommend(users, dataset, k=8, filter_viewed=True)
    expected = models["cpu"].recommend(users, dataset, k=8, filter_viewed=True)
    np.testing.assert_array_equal(got[Columns.User], expected[Columns.User])
    np.testing.assert_allclose(got[Columns.Score], expected[Columns.Score], rtol=1e-4, atol=1e-4)
    same = (got[Columns.Item].to_numpy() == expected[Columns.Item].to_numpy()).mean()
    assert same > 0.99  # only near-tied neighbours may swap

    targets = items[:50]
    got = models["cuda"].recommend_to_items(targets, dataset, k=8)
    expected = models["cpu"].recommend_to_items(targets, dataset, k=8)
    np.testing.assert_array_equal(got[Columns.TargetItem], expected[Columns.TargetItem])
    np.testing.assert_allclose(got[Columns.Score], expected[Columns.Score], rtol=1e-4, atol=1e-5)
    assert (got[Columns.Item].to_numpy() == expected[Columns.Item].to_numpy()).mean() > 0.99


# ------------------------------------------------------------------ training kernels on the card


PROFILE_SPAN = "counted calls"  # the record_function span around the calls a capture counts


def _device_kernels(fn, calls: int = 20) -> dict:
    """{device kernel name: launches} of ``calls`` calls of ``fn``
    (torch.profiler). The device records of a capture's first launches go
    missing now and then (tools/profiler_capture_check.py), so each capture
    first runs a spinning kernel and two calls of ``fn`` that it does not
    count, then counts the device records of the launches made inside a
    ``record_function`` span around the ``calls`` calls (a launch's host
    record and its kernel's record share a correlation id). While a kernel
    shows fewer launches than calls, a capture is taken again (up to five
    times); each kernel gets the most records any capture kept of it."""
    from collections import Counter

    from torch.autograd import DeviceType

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    best: Counter = Counter()
    for _ in range(5):
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=activities) as prof:
            torch.cuda._sleep(2_000_000)
            fn()
            fn()
            torch.cuda.synchronize()
            with torch.profiler.record_function(PROFILE_SPAN):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
        events = prof.events()
        span = next(e.time_range for e in events if e.name == PROFILE_SPAN and e.device_type == DeviceType.CPU)
        launched = {e.id for e in events if e.device_type == DeviceType.CPU and e.name.startswith("cu")
                    and any(word in e.name for word in ("Launch", "Memset", "Memcpy"))
                    and span.start <= e.time_range.start <= span.end}
        names = Counter(e.name for e in events
                        if e.device_type == DeviceType.CUDA and e.id in launched and e.name != PROFILE_SPAN)
        for name, count in names.items():  # no capture keeps more records than launches: the most kept
            best[name] = max(best[name], count)
        if best and min(best.values()) >= calls:
            break
    return dict(best)


@pytest.mark.gpu
@pytest.mark.parametrize("m,d", [(5000, 128), (33, 96), (7, 1024), (51200, 128), (1, 128), (8193, 128), (65, 50),
                                 (102400, 256)])
def test_cuda_layer_norm_bwd_matches_twin(cuda: torch.device, m: int, d: int) -> None:
    """Kernel 4 against its twin (dx within 1e-5; dγ and dβ, sums over m
    rows, within 1e-5 · max(1, m / 1000)): the training shape (51,200 x 128),
    one row, a ragged last block (8,193 rows: 65 blocks of 127, the last of
    65), D = 50; one launch a call, the same bits on a rerun and when calls at
    another shape run between on the same stream (the ticket counter is left
    at 0)."""
    rng = np.random.default_rng(m + 1)
    x = _t((rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)).to(cuda)
    g = _t(rng.normal(size=(d,)).astype(np.float32)).to(cuda)
    dy = _t(rng.normal(size=(m, d)).astype(np.float32)).to(cuda)
    before = _native.LAUNCHES["layer_norm_bwd"]
    got = layer_norm.layer_norm_bwd(x, g, dy, 1e-6)
    assert _native.LAUNCHES["layer_norm_bwd"] == before + 1
    ref = layer_norm.layer_norm_bwd_reference(x, g, dy, 1e-6)
    assert (got[0] - ref[0]).abs().max().item() <= 1e-5  # dx: O(1) entries
    for a, b in zip(got[1:], ref[1:]):  # dγ, dβ: sums over m rows
        torch.testing.assert_close(a, b, atol=1e-5 * max(1.0, m / 1000), rtol=1e-5)
    kernels = _device_kernels(lambda: layer_norm.layer_norm_bwd(x, g, dy, 1e-6))
    assert len(kernels) == 1 and "ln_bwd_kernel" in next(iter(kernels)) and set(kernels.values()) == {20}, kernels
    # deterministic: the same bits twice, and after calls at another shape on this stream
    again = layer_norm.layer_norm_bwd(x, g, dy, 1e-6)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    other = 8193 if m != 8193 else 1
    xo = _t((rng.normal(size=(other, d)) * 3 + 1).astype(np.float32)).to(cuda)
    dyo = _t(rng.normal(size=(other, d)).astype(np.float32)).to(cuda)
    first_other = layer_norm.layer_norm_bwd(xo, g, dyo, 1e-6)
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(layer_norm.layer_norm_bwd(x, g, dy, 1e-6), got))
        assert all(torch.equal(a, b) for a, b in zip(layer_norm.layer_norm_bwd(xo, g, dyo, 1e-6), first_other))


def _blhd(rng: np.random.Generator, b: int, l: int, h: int, dh: int, dev: torch.device) -> torch.Tensor:
    return _t(rng.normal(size=(b, l, h, dh)).astype(np.float32)).to(dev).transpose(1, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("l,dh,bias_kind", [(100, 32, "causal"), (12, 16, "none"), (200, 64, "key_padding"),
                                          (100, 64, "causal"), (37, 32, "key_padding"), (100, 32, "masked_row"),
                                          (100, 32, "bidirectional"), (37, 64, "bidirectional"),
                                          (200, 32, "causal")])
def test_cuda_attention_fwd_bwd_with_dropout_matches_twin(
    cuda: torch.device, rate: float, l: int, dh: int, bias_kind: str
) -> None:
    rng = np.random.default_rng(l + dh)
    b, h, seed = 3, 4, 123457
    q, k, v, dout = (_blhd(rng, b, l, h, dh, cuda) for _ in range(4))
    bias = None
    if bias_kind == "causal":
        bias = _t(_causal_bias(l)).to(cuda)
    elif bias_kind == "masked_row":
        bias = _t(_masked_row_bias(l)).to(cuda)
    elif bias_kind == "key_padding":  # (B, 1, L, L): per-batch strides in both kernels
        pad = np.arange(l)[None, :] < rng.integers(0, l, size=b)[:, None]
        kp = np.where(pad, MASK_VALUE, 0.0)[:, None, None, :] + _causal_bias(l)
        kp[:, :, np.arange(l), np.arange(l)] = 0.0
        bias = _t(kp.astype(np.float32)).to(cuda)
    elif bias_kind == "bidirectional":  # BERT4Rec's: every unit of a long session live, a session of length 1
        bias = _t(_bidirectional_bias(rng, b, l)).to(cuda)
    scale = 1.0 / dh**0.5
    out, lse = attention.attention_fwd(q, k, v, bias, scale, rate, seed)
    ref_out, ref_lse = attention.attention_reference(q, k, v, bias, scale, rate, seed)
    torch.testing.assert_close(out, ref_out, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(lse, ref_lse, atol=1e-5, rtol=1e-5)
    delta = (dout * out).sum(-1).contiguous()
    before = _native.LAUNCHES["attention_bwd"]
    got = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, rate, seed)
    assert _native.LAUNCHES["attention_bwd"] == before + 1
    expected = attention.attention_bwd_reference(q, k, v, bias, lse, delta, dout, scale, rate, seed)
    rows = torch.ones(l, dtype=torch.bool, device=cuda)
    if bias_kind == "masked_row":
        # The fully masked row has p = 1 on every key, so its ds is the size
        # of delta (about 100, not a probability's) and its dq a cancelling sum
        # of L such terms: two f32 orders part there by that sum's rounding
        # (the twin itself is 8e-5 / 4e-4 from the exact sum of its own terms
        # at L = 100 / 257). That row's dq, the kernel's and the twin's, is
        # held to the f32 error bound of the exact sum, L * 2^-24 * sum |ds k|
        # * scale; every other entry to 1e-5 as usual.
        r = l // 3
        rows[r] = False
        p = torch.exp(attention._scores(q, k, bias, scale)[:, :, r] - lse[:, :, r, None])  # (B, H, L)
        dp = torch.einsum("bhd,bhkd->bhk", dout[:, :, r], v)
        if rate > 0.0:
            dp = dp * attention.dropout_keep_mask(seed, b, h, l, rate, cuda)[:, :, r] / (1.0 - rate)
        ds = (p * (dp - delta[:, :, r, None])).double()
        exact = torch.einsum("bhk,bhkd->bhd", ds, k.double()) * scale
        bound = l * 2.0**-24 * torch.einsum("bhk,bhkd->bhd", ds.abs(), k.double().abs()) * scale
        for dq in (got[0], expected[0]):
            assert ((dq[:, :, r].double() - exact).abs() <= bound).all()
    torch.testing.assert_close(got[0][:, :, rows], expected[0][:, :, rows], atol=1e-5, rtol=1e-5)
    for a, e in zip(got[1:], expected[1:]):
        torch.testing.assert_close(a, e, atol=1e-5, rtol=1e-5)
    # the same bits on a rerun, forward and backward
    again = attention.attention_fwd(q, k, v, bias, scale, rate, seed)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    again = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, rate, seed)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.gpu
def test_cuda_attention_dropout_bits_match_twin(cuda: torch.device) -> None:
    """The kernel's keep bits are the twin's: with v = one-hot key columns, the
    output of one query row is its dropped probability row."""
    b, h, l, seed, rate = 2, 3, 40, 77, 0.3
    q = torch.zeros((b, h, l, 64), device=cuda)  # uniform probabilities 1/l
    k = torch.zeros_like(q)
    v = torch.zeros_like(q)
    v[:, :, torch.arange(l), torch.arange(l)] = 1.0
    out, _ = attention.attention_fwd(q, k, v, None, 1.0, rate, seed)
    kept = (out[..., :l] > 0).cpu()
    expected = attention.dropout_keep_mask(seed, b, h, l, rate).bool()
    assert torch.equal(kept, expected)


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,d", [(300, 2177, 16), (257, 2177, 32), (300, 4100, 64), (130, 20033, 128),
                                   (129, 4100, 256), (51200, 15835, 128)])
def test_cuda_lse_partials_matches_twin(cuda: torch.device, m: int, n: int, d: int) -> None:
    """Kernel 6 (tensor-core tile at D = 32..128, SIMT at 16 and 256) at
    ragged session and item counts, and at the training width on the odd
    catalog, against its twin in the card's chunks: 1e-5 relative per row,
    one launch, the same bits on a rerun."""
    rng = np.random.default_rng(m + n + d)
    s = _t((0.3 * rng.normal(size=(m, d))).astype(np.float32)).to(cuda)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    before = _native.LAUNCHES["lse_partials_fwd"]
    lse = softmax_lse.streaming_lse(s, items)
    assert _native.LAUNCHES["lse_partials_fwd"] == before + 1
    ref = softmax_lse.streaming_lse_partials_reference(s, items)
    assert torch.isfinite(lse).all()
    assert ((lse - ref).abs() / ref.abs()).max().item() <= 1e-5
    assert torch.equal(softmax_lse.streaming_lse(s, items), lse)


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("partials", [True, False])
@pytest.mark.parametrize(
    "m,n,d",
    [(51, 300, 32), (1000, 2111, 128), (64, 64, 16), (130, 4100, 256), (257, 1000, 64), (300, 2177, 128),
     (700, 20000, 128), (300, 20033, 64), (1000, 15873, 128), (2000, 20480, 256)],
)
def test_cuda_streaming_lse_and_ce_grads_match_twin(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, m: int, n: int, d: int, partials: bool, route: str
) -> None:
    """Kernel 6 (``USE_PARTIALS_FWD``) or kernel 15 against its twin, then
    kernel 7 from that lse: its one pass (``ce_fused_f32``) or, with the
    budget forced to 0 below the large-catalog threshold, its two launches,
    against the twin in the same summation order; ragged tiles on both axes
    (257 and 300 rows against 128-row session tiles); catalogs of ~20,000
    items, whose split ds sums cross several item chunks; the same bits on a
    second run."""
    rng = np.random.default_rng(n)
    s = _t((0.3 * rng.normal(size=(m, d))).astype(np.float32)).to(cuda)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", partials)
    key = "lse_partials_fwd" if partials else "lse_fwd"
    before = dict(_native.LAUNCHES)
    lse = softmax_lse.streaming_lse(s, items)
    assert {k: _native.LAUNCHES[k] - before[k] for k in ("lse_partials_fwd", "lse_fwd")} == {
        "lse_partials_fwd": int(partials), "lse_fwd": int(not partials)}
    twin = softmax_lse.streaming_lse_partials_reference if partials else softmax_lse.streaming_lse_reference
    torch.testing.assert_close(lse, twin(s, items), atol=0, rtol=1e-5)
    if not partials and 32 <= d <= 128:  # kernel 15 on the 3xTF32 tile: LSE_TC_RTOL per row
        assert ((lse - twin(s, items)).abs() / twin(s, items).abs()).max().item() <= LSE_TC_RTOL
    assert _native.LAUNCHES[key] == before[key] + 1
    y = _t(rng.integers(0, n, size=m)).to(cuda)
    coeff = _t(rng.uniform(0, 1e-2, size=m).astype(np.float32)).to(cuda)
    coeff[::7] = 0.0  # ignored rows: z = +inf
    z = lse - torch.log(coeff)
    if route == "split":
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
        monkeypatch.setattr(softmax_lse, "ce_takes_split_route", lambda *_: False)
    before = dict(_native.LAUNCHES)
    ds, di = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    launched = {k: _native.LAUNCHES[k] - before[k] for k in ("ce_grads_fused", "ce_grads_ds", "ce_grads_di")}
    assert launched == ({"ce_grads_fused": 1, "ce_grads_ds": 0, "ce_grads_di": 0} if route == "fused"
                        else {"ce_grads_fused": 0, "ce_grads_ds": 1, "ce_grads_di": 1})
    ref_ds, ref_di = softmax_lse.softmax_ce_grads_from_z_reference(s, items, z, y, coeff, partials=route == "fused")
    for got, ref in ((ds, ref_ds), (di, ref_di)):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= _grads_rtol(d) * ref.abs().max().item()
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    assert torch.equal(again[0], ds) and torch.equal(again[1], di)  # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize(
    "m,n,d",
    [(51, 300, 32), (257, 1000, 64), (1000, 2111, 128), (130, 40, 64), (100, 576, 128), (70, 2177, 32),
     (300, 15872, 128)],
)
def test_cuda_carried_max_lse_on_the_tensor_cores(cuda: torch.device, monkeypatch: pytest.MonkeyPatch, m: int,
                                                  n: int, d: int) -> None:
    """Kernel 15 (``USE_PARTIALS_FWD = False``) on the 3xTF32 tile in clusters
    of ``lse_cluster_plan`` at D = 32, 64 and 128: within ``LSE_TC_RTOL`` per
    row of its twin, where plain TF32 products (the control) land above it;
    one launch, the same bits on a rerun, and within 1e-5 of kernel 6. The
    cases: a catalog under one item tile (one rank), plans that leave ranks
    with no tile (576, 2,111 and 2,177 items), M not a multiple of 128, the
    KION catalog (8 ranks of 31 tiles)."""
    rng = np.random.default_rng(m * n + d)
    s = _t(rng.normal(size=(m, d)).astype(np.float32)).to(cuda)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    cluster, rows = softmax_lse.lse_cluster_plan(n)
    assert (cluster - -(-n // rows) > 0) == (n in (576, 2111, 2177)) and (cluster == 1) == (n < 64)
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", False)
    before = dict(_native.LAUNCHES)
    lse = softmax_lse.streaming_lse(s, items)
    assert {k: _native.LAUNCHES[k] - before[k] for k in ("lse_partials_fwd", "lse_fwd")} == {
        "lse_partials_fwd": 0, "lse_fwd": 1}
    ref = softmax_lse.streaming_lse_reference(s, items)
    plain = softmax_lse.streaming_lse_reference(_tf32(s), _tf32(items))
    rel = ((lse - ref).abs() / ref.abs()).max().item()
    rel_plain = ((plain - ref).abs() / ref.abs()).max().item()
    assert torch.isfinite(lse).all() and rel <= LSE_TC_RTOL < rel_plain, (rel, rel_plain)
    assert torch.equal(softmax_lse.streaming_lse(s, items), lse)
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", True)
    kernel_6 = softmax_lse.streaming_lse(s, items)
    assert ((kernel_6 - lse).abs() / lse.abs()).max().item() <= 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.3, 1.0, 1.5, 4.0])
@pytest.mark.parametrize("m,n,d", [(51, 300, 32), (700, 4500, 128), (130, 2177, 256)])
def test_cuda_lse_shift_matches_twin(cuda: torch.device, m: int, n: int, d: int, scale: float) -> None:
    """Kernel 16 against its twin on the card: both windows, and past the
    contract (scale 4 at d = 32) -inf rows where the gap passes ~170, never
    NaN. Rows with a gap between 120 and 170 are left out: the twin's sums and
    the kernel's round differently near the flush. At d = 32 and 128 it is the
    tensor-core kernel in its shift mode: inside the contract within
    ``LSE_TC_RTOL`` per row of its twin and of the twin in float64, where
    plain TF32 products land above (the zero row and scale 4, whose only row
    inside the contract is that one, left out); at d = 256 the SIMT
    ``lse_chunk_kernel``. The profiler names the kernel that ran; a rerun
    gives the same bits; a zero session row (shift 0, every term 1) gives
    log N."""
    rng = np.random.default_rng(m + n)
    s = _t((scale * rng.normal(size=(m, d)) / np.sqrt(d / 32)).astype(np.float32)).to(cuda)
    items = _t((scale * rng.normal(size=(n, d)) / np.sqrt(d / 32)).astype(np.float32)).to(cuda)
    s[m // 2] = 0.0
    before = _native.LAUNCHES["lse_shift_fwd"]
    got = softmax_lse.streaming_lse(s, items, bounded_shift=True)
    assert _native.LAUNCHES["lse_shift_fwd"] == before + 1
    ref = softmax_lse.streaming_lse_shift_reference(s, items)
    gap = softmax_lse.lse_shift(s, items) - (s @ items.T).max(dim=1).values
    assert not torch.isnan(got).any()
    inside, outside = gap < 120, gap > 170
    torch.testing.assert_close(got[inside], ref[inside], atol=1e-6, rtol=1e-5)
    assert torch.isneginf(got[outside]).all() and torch.isneginf(ref[outside]).all()
    assert torch.equal(softmax_lse.streaming_lse(s, items, bounded_shift=True), got)
    assert abs(got[m // 2].item() - np.log(n)) <= 1e-6 * np.log(n)
    if 32 <= d <= 128 and scale < 4.0:
        exact = softmax_lse.streaming_lse_shift_reference(s.double(), items.double())
        plain = softmax_lse.streaming_lse_shift_reference(_tf32(s), _tf32(items))
        rows = inside.clone()
        rows[m // 2] = False

        def row_rel(a: torch.Tensor, b: torch.Tensor) -> float:
            return ((a[rows].double() - b[rows].double()).abs() / b[rows].double().abs()).max().item()

        rel, rel_plain = max(row_rel(got, ref), row_rel(got, exact)), min(row_rel(plain, ref), row_rel(plain, exact))
        assert rel <= LSE_TC_RTOL < rel_plain, (rel, rel_plain)
    if scale == 1.0:
        names = _device_kernels(lambda: softmax_lse.streaming_lse(s, items, bounded_shift=True))
        lse_kernels = [k for k in names if "lse_partials_tc_kernel" in k or "lse_chunk_kernel" in k]
        expected = "lse_partials_tc_kernel" if 32 <= d <= 128 else "lse_chunk_kernel"
        assert len(lse_kernels) == 1 and expected in lse_kernels[0], names


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize(
    "m,n,d",
    [(51, 300, 32), (1000, 2111, 128), (64, 64, 16), (130, 4177, 256), (257, 1000, 64), (700, 20000, 128),
     (90, 19999, 32)],
)
def test_cuda_softmax_grads_from_z_match_twins(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, m: int, n: int, d: int, route: str
) -> None:
    """Kernel 12 (or 13 + 14 with the budget forced to 0) against its twin in
    the same summation order; z = +inf rows give exactly 0 in ds; the same
    bits on a second run."""
    rng = np.random.default_rng(3 * n + m)
    s = _t((0.3 * rng.normal(size=(m, d))).astype(np.float32)).to(cuda)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    coeff = _t(rng.uniform(0, 1e-2, size=m).astype(np.float32)).to(cuda)
    coeff[::5] = 0.0
    z = softmax_lse.streaming_lse(s, items) - torch.log(coeff)
    if route == "split":
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    before = dict(_native.LAUNCHES)
    ds, di = softmax_lse.softmax_grads_from_z(s, items, z)
    launched = {k: _native.LAUNCHES[k] - before[k] for k in ("grads_z_fused", "grads_z_ds", "grads_z_di")}
    assert launched == ({"grads_z_fused": 1, "grads_z_ds": 0, "grads_z_di": 0} if route == "fused"
                        else {"grads_z_fused": 0, "grads_z_ds": 1, "grads_z_di": 1})
    ref = softmax_lse.softmax_grads_from_z_reference(s, items, z, partials=route == "fused")
    for got, expected in zip((ds, di), ref):
        assert torch.isfinite(got).all()
        assert (got - expected).abs().max().item() <= _grads_rtol(d) * expected.abs().max().item()
    assert not ds[coeff == 0].any()
    again = softmax_lse.softmax_grads_from_z(s, items, z)
    assert torch.equal(again[0], ds) and torch.equal(again[1], di)  # no atomics: the same bits


@pytest.mark.gpu
@pytest.mark.parametrize("d", [32, 128, 256])
def test_cuda_split_ds_entries_refuse_another_chunk_count(cuda: torch.device, d: int) -> None:
    """The split ds entries take the plan's item chunks from the caller and
    refuse a count that their chunk rows do not give (or, on the SIMT tile,
    any count but 1), as the fused entries refuse another grid."""
    m, n = 300, 5000
    s, items = torch.zeros((m, d), device=cuda), torch.zeros((n, d), device=cuda)
    z = torch.zeros((m,), device=cuda)
    n_chunks, chunk_rows = softmax_lse.split_bwd_plan(m, n, d, 132)
    ds_part = torch.empty((n_chunks + 1, m, d), device=cuda)
    lib = _native.load("softmax_lse", softmax_lse._SIGNATURES)
    stream = _native.current_stream_ptr(cuda)
    args = (s.data_ptr(), items.data_ptr(), z.data_ptr(), ds_part.data_ptr(), m, n, d)
    assert lib.grads_z_ds_f32(*args, chunk_rows, n_chunks, stream) == 0
    assert lib.grads_z_ds_f32(*args, chunk_rows, n_chunks + 1, stream) != 0
    assert lib.grads_z_ds_f32(*args, chunk_rows + 1, n_chunks, stream) != 0  # not a multiple of 64
    if d == 256:
        assert n_chunks == 1 and lib.grads_z_ds_f32(*args, 64 * -(-n // 128), 2, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,d", [(300, 5000, 64), (1000, 2111, 128)])
def test_cuda_ce_split_route_matches_kernel_7(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, m: int, n: int, d: int
) -> None:
    """The very-large-catalog route of the CE gradients (kernels 13 + 14 and
    the label term in torch, the budget forced to 0) against kernel 7 on the
    same inputs, and its bits on a second run (the label sum has no atomics)."""
    rng = np.random.default_rng(m * n)
    s = _t((0.3 * rng.normal(size=(m, d))).astype(np.float32)).to(cuda)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    y = _t(rng.integers(0, n, size=m)).to(cuda)
    y[:40] = 7  # repeated labels: several rows add into one di row
    coeff = _t(rng.uniform(0, 1e-2, size=m).astype(np.float32)).to(cuda)
    coeff[::7] = 0.0
    z = softmax_lse.streaming_lse(s, items) - torch.log(coeff)
    kernel_7 = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    before = dict(_native.LAUNCHES)
    route = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    launched = {k: _native.LAUNCHES[k] - before[k]
                for k in ("ce_grads_fused", "ce_grads_ds", "ce_grads_di", "grads_z_ds", "grads_z_di")}
    assert launched == {"ce_grads_fused": 0, "ce_grads_ds": 0, "ce_grads_di": 0, "grads_z_ds": 1, "grads_z_di": 1}
    for got, expected in zip(route, kernel_7):
        assert (got - expected).abs().max().item() <= 1e-4 * expected.abs().max().item()
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    assert torch.equal(again[0], route[0]) and torch.equal(again[1], route[1])


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize(
    "m,n,d,n_invalid",
    [(51, 300, 32, 7), (1000, 2111, 128, 1), (64, 64, 16, 64), (200, 4200, 64, 0), (130, 77, 256, 3),
     (700, 20000, 128, 5), (333, 20111, 32, 0), (300, 6200, 64, 2104), (97, 2500, 16, 0), (130, 4100, 256, 0)],
)
def test_cuda_biased_lse_and_its_vjp_match_twins(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, m: int, n: int, d: int, n_invalid: int, route: str
) -> None:
    """Kernels 8 and 9 (or 10 + 11 with the budget forced to 0) against their
    twins: a bias with -1e30 rows (a whole invalid shard included, and the
    last two ``LSE_CHUNK`` item chunks wholly invalid in one case), ragged
    tiles, a mixed-sign cotangent. Kernel 8 at every D within ``LSE_RTOL`` per
    row of its twin in the card's chunks, the same bits on a rerun, and with
    a zero bias kernel 6's bits."""
    rng = np.random.default_rng(n + m)
    s = _t((0.3 * rng.normal(size=(m, d))).astype(np.float32)).to(cuda)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda)
    bias = torch.zeros(n, device=cuda)
    if n_invalid:
        bias[n - n_invalid :] = softmax_lse.NEG_BIG
    dlse = _t(rng.normal(size=m).astype(np.float32)).to(cuda)
    before = dict(_native.LAUNCHES)
    lse = softmax_lse.streaming_lse_fwd(s, items, bias)
    assert _native.LAUNCHES["lse_bias_fwd"] == before["lse_bias_fwd"] + 1
    assert torch.isfinite(lse).all()
    ref_lse = softmax_lse.streaming_lse_bias_reference(s, items, bias)
    torch.testing.assert_close(lse, ref_lse, atol=1e-6, rtol=1e-5)
    assert ((lse - ref_lse).abs() / ref_lse.abs()).max().item() <= 1e-5  # LSE_RTOL, per row
    assert torch.equal(softmax_lse.streaming_lse_fwd(s, items, bias), lse)
    if not n_invalid:  # an all-zero bias is kernel 6's result, bit for bit
        monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", True)
        assert torch.equal(lse, softmax_lse.streaming_lse_fwd(s, items))
    if route == "split":
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    ds, di = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
    launched = {k: _native.LAUNCHES[k] - before[k] for k in ("lse_bwd_fused", "lse_bwd_ds", "lse_bwd_di")}
    assert launched == ({"lse_bwd_fused": 1, "lse_bwd_ds": 0, "lse_bwd_di": 0} if route == "fused"
                        else {"lse_bwd_fused": 0, "lse_bwd_ds": 1, "lse_bwd_di": 1})
    ref_ds, ref_di = softmax_lse.streaming_lse_bwd_reference(s, items, bias, lse, dlse, partials=route == "fused")
    for got, ref in ((ds, ref_ds), (di, ref_di)):
        assert torch.isfinite(got).all()
        assert (got - ref).abs().max().item() <= _grads_rtol(d) * ref.abs().max().item()
    if 0 < n_invalid < n:  # an invalid row's gradient is exactly 0
        assert not di[n - n_invalid :].any()
    again = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
    assert torch.equal(again[0], ds) and torch.equal(again[1], di)  # no atomics: the same bits


@pytest.mark.gpu
def test_cuda_streaming_lse_autograd_matches_cpu(cuda: torch.device) -> None:
    rng = np.random.default_rng(5)
    s_np = (0.3 * rng.normal(size=(300, 64))).astype(np.float32)
    i_np = (0.3 * rng.normal(size=(2500, 64))).astype(np.float32)
    g_np = rng.normal(size=300).astype(np.float32)
    grads = {}
    for dev in (torch.device("cpu"), cuda):
        s, items = _t(s_np).to(dev).requires_grad_(True), _t(i_np).to(dev).requires_grad_(True)
        (softmax_lse.streaming_lse(s, items) * _t(g_np).to(dev)).sum().backward()
        grads[dev.type] = (s.grad.cpu(), items.grad.cpu())
    for got, ref in zip(grads["cuda"], grads["cpu"]):
        assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


@pytest.mark.gpu
def test_cuda_sasrec_fit_matches_cpu(cuda: torch.device) -> None:
    """Three train steps with dropout on the card and on the CPU twins, from the
    same start weights (the fit's own Xavier init from the model's seed) and
    the same dropout generator seed."""
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset

    rng = np.random.default_rng(12)
    n = 2000
    df = pd.DataFrame({
        Columns.User: rng.integers(0, 96, n),
        Columns.Item: rng.integers(0, 3000, n),
        Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
    })
    dataset = Dataset.construct(df)
    config = dict(n_blocks=2, n_heads=4, n_factors=64, session_max_len=20, dropout_rate=0.2, batch_size=32,
                  epochs=1, training_module_kwargs={"fused_softmax_chunk": 512})
    models = {dev: SASRecModel(**config, device=dev) for dev in ("cpu", "cuda")}
    for model in models.values():
        model._build_model_from_dataset(dataset)
    models["cpu"].training_module.init_params()
    start = {k: v.clone() for k, v in models["cpu"].backbone.state_dict().items()}
    for model in models.values():
        model.training_module.load_params(start)
    _native.reset_launches()
    for model in models.values():
        model.training_module.fit(model.data_preparator.get_dataloader_train,
                                  model.data_preparator.get_dataloader_val, 1)
    assert _native.LAUNCHES["lse_partials_fwd"] == 3 and _native.LAUNCHES["ce_grads_fused"] == 3
    assert _native.LAUNCHES["ce_grads_ds"] == _native.LAUNCHES["ce_grads_di"] == 0
    assert _native.LAUNCHES["attention_bwd"] == 6 and _native.LAUNCHES["layer_norm_bwd"] == 15
    cpu_loss = models["cpu"].training_module.train_loss_history
    gpu_loss = models["cuda"].training_module.train_loss_history
    np.testing.assert_allclose(gpu_loss, cpu_loss, rtol=1e-4)
    cpu_state = models["cpu"].backbone.state_dict()
    for name, value in models["cuda"].backbone.state_dict().items():
        # the key-projection biases have a zero gradient in exact arithmetic, so
        # Adam moves them by the sign of rounding noise: held to steps * lr
        tol = 3 * 1e-3 if name.endswith("multi_head_attn.k_proj.bias") else 1e-4
        assert (value.cpu() - cpu_state[name]).abs().max().item() <= tol, name



def _small_frame(seed: int, n_users: int, n_items: int):
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset

    rng = np.random.default_rng(seed)
    n = 2000
    return Dataset.construct(pd.DataFrame({
        Columns.User: rng.integers(0, n_users, n),
        Columns.Item: rng.integers(0, n_items, n),
        Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**6, n), unit="s"),
    }))


FIT_FAMILIES = {
    "bert4rec": (BERT4RecModel, {}),
    "esasrec_shared_remat": (SASRecModel, {"transformer_layers_type": LiGRLayers, "loss": "sampled_softmax",
                                           "n_negatives": 16,
                                           "training_module_kwargs": {"negatives_sharing": "batch", "remat": True}}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("family", sorted(FIT_FAMILIES))
def test_cuda_family_fit_matches_cpu(cuda: torch.device, family: str) -> None:
    """BERT4Rec (the bidirectional key-padding bias, PAD and MASK) and eSASRec
    with shared negatives and remat: three train steps with dropout on the card
    and on the CPU twins from the same start, as the SASRec test does; the
    key-projection biases held to steps * lr."""
    model_cls, kwargs = FIT_FAMILIES[family]
    dataset = _small_frame(13, 96, 3000)
    config = dict(n_blocks=2, n_heads=4, n_factors=64, session_max_len=20, dropout_rate=0.2, batch_size=32,
                  epochs=1, **kwargs)
    models = {dev: model_cls(**config, device=dev) for dev in ("cpu", "cuda")}
    for model in models.values():
        model._build_model_from_dataset(dataset)
    models["cpu"].training_module.init_params()
    start = {k: v.clone() for k, v in models["cpu"].backbone.state_dict().items()}
    for model in models.values():
        model.training_module.load_params(start)
    _native.reset_launches()
    for model in models.values():
        model.training_module.fit(model.data_preparator.get_dataloader_train,
                                  model.data_preparator.get_dataloader_val, 1)
    steps = models["cuda"].training_module.global_step
    assert steps == 3 and _native.LAUNCHES["attention_bwd"] == 2 * steps
    assert _native.LAUNCHES["layer_norm_bwd"] == 4 * steps
    recomputes = steps if family.endswith("remat") else 0  # remat runs the encoder's forward again in the backward
    assert _native.LAUNCHES["attention_fwd"] == 2 * (steps + recomputes)
    np.testing.assert_allclose(models["cuda"].training_module.train_loss_history,
                               models["cpu"].training_module.train_loss_history, rtol=1e-4)
    cpu_state = models["cpu"].backbone.state_dict()
    for name, value in models["cuda"].backbone.state_dict().items():
        tol = 3 * 1e-3 if name.endswith("multi_head_attn.k_proj.bias") else 1e-4
        assert (value.cpu() - cpu_state[name]).abs().max().item() <= tol, name


@pytest.mark.gpu
@pytest.mark.parametrize("loss", ["softmax", "sampled_softmax"])
def test_cuda_remat_fit_equals_plain_fit(cuda: torch.device, loss: str) -> None:
    """On the card, a fit with remat=True at dropout 0.2 takes the plain fit's
    path: the same losses and parameters (1e-6), the encoder's forward kernels
    launched once more a step."""
    dataset = _small_frame(14, 96, 3000)
    runs = {}
    for remat in (False, True):
        _native.reset_launches()
        model = SASRecModel(n_blocks=2, n_heads=4, n_factors=64, session_max_len=20, dropout_rate=0.2,
                            batch_size=32, epochs=2, loss=loss, n_negatives=16, seed=3, device="cuda",
                            training_module_kwargs={"fused_softmax_chunk": 512, "remat": remat}).fit(dataset)
        runs[remat] = (model, dict(_native.LAUNCHES))
    (plain, plain_launches), (remat, remat_launches) = runs[False], runs[True]
    steps = remat.training_module.global_step
    assert remat_launches["layer_norm_fwd"] == plain_launches["layer_norm_fwd"] + 5 * steps
    assert remat_launches["attention_bwd"] == plain_launches["attention_bwd"] == 2 * steps
    np.testing.assert_allclose(remat.training_module.train_loss_history, plain.training_module.train_loss_history,
                               rtol=1e-6)
    plain_state = plain.backbone.state_dict()
    for name, value in remat.backbone.state_dict().items():
        assert (value - plain_state[name]).abs().max().item() <= 1e-6, name


# ------------------------------------------------------------------ STU attention kernels on the card


def _stu_inputs(b: int, h: int, l: int, ad: int, lh: int, dev: torch.device, per_row_allowed: bool = False):
    """q, k, v, dout in the layer's (B, L, H, d) memory, a (B, L, L) bias made
    of time buckets and positions, a timeline with left padding and one fully
    padded row, the causal mask, shared or with key padding, and the buckets."""
    rng = np.random.default_rng(1000 * l + ad + lh)
    q, k = (_blhd(rng, b, l, h, ad, dev) for _ in range(2))
    v, dout = (_blhd(rng, b, l, h, lh, dev) for _ in range(2))
    ts = 1_600_000_000 + np.sort(rng.integers(0, 86400 * 30, size=(b, l + 2)), axis=1)
    tw = (0.1 * rng.normal(size=(129,))).astype(np.float32)
    pw = (0.1 * rng.normal(size=(2 * l - 1,))).astype(np.float32)
    buckets = stu_attention.time_buckets(_t(ts).to(dev), l, 128)
    bias = stu_attention.combined_bias(buckets, _t(tw).to(dev), _t(pw).to(dev), l, dev)
    real = np.arange(l)[None, :] >= rng.integers(0, l, size=b)[:, None]  # left padding
    real[0] = True
    real[-1] = False
    timeline = _t(real.astype(np.float32)).to(dev)
    allowed = np.tril(np.ones((l, l), np.float32))[None]
    if per_row_allowed:
        allowed = np.maximum(allowed * real[:, None, :], np.eye(l, dtype=np.float32)[None])
    return q, k, v, dout, bias, _t(np.ascontiguousarray(allowed, dtype=np.float32)).to(dev), timeline, buckets


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,h,l,ad,lh,per_row_allowed",
    [(3, 4, 100, 32, 32, False), (2, 2, 80, 16, 16, False), (2, 2, 96, 16, 16, True), (3, 2, 7, 8, 64, False),
     (2, 2, 130, 64, 8, True), (2, 4, 1024, 32, 32, False), (2, 2, 80, 32, 32, False), (2, 2, 96, 32, 32, True),
     (2, 2, 96, 64, 64, True), (3, 2, 7, 32, 64, False), (2, 2, 130, 64, 32, True), (2, 2, 100, 8, 8, False),
     (2, 4, 190, 64, 64, True), (2, 2, 1024, 16, 16, False), (2, 4, 1024, 64, 64, True)],
)
def test_cuda_stu_kernels_match_twins(
    cuda: torch.device, b: int, h: int, l: int, ad: int, lh: int, per_row_allowed: bool
) -> None:
    """Forward 1e-5 absolute, gradients 1e-4 absolute against the twins on the
    card (sums over up to 1,024 keys or queries and 4 heads in another order);
    at L = 1,024 the scores reach tens, so the tolerances there scale with the
    twin's largest entry. The backward runs on the tensor cores in two
    launches (``stu_bwd``, ``stu_bwd_dq``) at head dims of 32 and 64, on the
    SIMT kernel in one at 8 and 16, and so does the forward (launch keys
    ``stu_fwd``, ``stu_fwd_simt``); the score gradient is one launch on
    either tile (64 x 64 on the tensor cores at 32 and 64). out, dq, dk, dv,
    ds and its sums by bucket come out bit-equal on a second run."""
    q, k, v, dout, bias, allowed, timeline, buckets = _stu_inputs(b, h, l, ad, lh, cuda, per_row_allowed)
    args = (q, k, v, bias, allowed, timeline)
    before = dict(_native.LAUNCHES)
    out = stu_attention.stu_fwd(*args)
    got = stu_attention.stu_bwd(*args, dout)
    ds, sums = stu_attention.stu_ds(*args, dout, buckets, 129)
    tc = int(stu_attention.bwd_on_tensor_cores(ad, lh))
    keys = ("stu_fwd", "stu_fwd_simt", "stu_bwd", "stu_bwd_dq", "stu_ds")
    assert [_native.LAUNCHES[n] - before[n] for n in keys] == [tc, 1 - tc, 1, tc, 1]
    assert out.transpose(1, 2).is_contiguous() and all(g.transpose(1, 2).is_contiguous() for g in got)
    ref_out = stu_attention.stu_reference(*args)
    scale = max(1.0, ref_out.abs().max().item())
    torch.testing.assert_close(out, ref_out, atol=1e-5 * scale, rtol=0)
    assert not out[-1].any()  # a fully padded row gives zeros
    for g, ref in zip((*got, ds, sums), (*stu_attention.stu_bwd_reference(*args, dout),
                                         *stu_attention.stu_ds_reference(*args, dout, buckets, 129))):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, ref, atol=1e-4 * max(1.0, ref.abs().max().item()), rtol=0)
    assert sums.abs().max() > 0
    again = (stu_attention.stu_fwd(*args), *stu_attention.stu_bwd(*args, dout),
             *stu_attention.stu_ds(*args, dout, buckets, 129))
    assert all(torch.equal(a, g) for a, g in zip(again, (out, *got, ds, sums)))
    alone, none = stu_attention.stu_ds(*args, dout)  # without buckets: the same ds, no sums
    assert none is None and torch.equal(alone, ds)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,h,l,ad,lh,per_row_allowed",
    [(3, 4, 1024, 32, 32, True), (2, 4, 1024, 64, 64, False), (2, 2, 1024, 32, 64, True), (4, 4, 1024, 16, 16, True),
     (64, 4, 100, 32, 32, False), (5, 2, 33, 64, 32, False), (3, 2, 100, 8, 8, True)],
)
def test_cuda_stu_fwd_routes_long_context_and_rerun(
    cuda: torch.device, b: int, h: int, l: int, ad: int, lh: int, per_row_allowed: bool
) -> None:
    """The forward alone: the tensor-core route at head dims 32 and 64, the
    SIMT one at 8 and 16; at L = 1,024 each block walks 32 key tiles through
    its ring of two stages; within 1e-5 of the twin's largest entry (at least
    1), the same bits on a rerun, zeros for the fully padded row."""
    q, k, v, _, bias, allowed, timeline, _ = _stu_inputs(b, h, l, ad, lh, cuda, per_row_allowed)
    args = (q, k, v, bias, allowed, timeline)
    before = dict(_native.LAUNCHES)
    out = stu_attention.stu_fwd(*args)
    tc = int(stu_attention.bwd_on_tensor_cores(ad, lh))
    assert [_native.LAUNCHES[n] - before[n] for n in ("stu_fwd", "stu_fwd_simt")] == [tc, 1 - tc]
    ref = stu_attention.stu_reference(*args)
    torch.testing.assert_close(out, ref, atol=1e-5 * max(1.0, ref.abs().max().item()), rtol=0)
    assert not out[-1].any()
    assert torch.equal(stu_attention.stu_fwd(*args), out)


@pytest.mark.gpu
def test_cuda_stu_attention_autograd_matches_cpu(cuda: torch.device) -> None:
    """The whole op (buckets, bias, three kernels, the two table reductions)
    on the card against the CPU twins, and the table gradients bit-equal on a
    second run; the card's integer buckets equal the CPU's."""
    rng = np.random.default_rng(8)
    b, l, h, d = 4, 100, 4, 32
    arrays = [rng.normal(size=(b, l, h, d)).astype(np.float32) for _ in range(3)]
    ts = 1_600_000_000 + np.sort(rng.integers(0, 86400 * 90, size=(b, l + 2)), axis=1)
    tw, pw = (0.1 * rng.normal(size=(129,))).astype(np.float32), (0.1 * rng.normal(size=(199,))).astype(np.float32)
    timeline = (np.arange(l)[None, :] >= rng.integers(0, l, size=b)[:, None]).astype(np.float32)
    allowed = np.tril(np.ones((l, l), np.float32))

    def run(dev):
        leaves = [_t(a).to(dev).requires_grad_() for a in (*arrays, tw, pw)]
        out = stu_attention.stu_dot_product_attention(
            *leaves[:3], _t(ts).to(dev), _t(timeline).to(dev), _t(allowed).to(dev), leaves[3], leaves[4], 128
        )
        grads = torch.autograd.grad((out**2).sum(), leaves)
        return [out.detach().cpu(), *(g.cpu() for g in grads)]

    _native.reset_launches()
    got, again, expected = run(cuda), run(cuda), run("cpu")
    assert [_native.LAUNCHES[n] for n in ("stu_fwd", "stu_bwd", "stu_bwd_dq", "stu_ds")] == [2, 2, 2, 2]
    torch.testing.assert_close(got[0], expected[0], atol=1e-5, rtol=0)
    for g, e in zip(got[1:], expected[1:]):
        torch.testing.assert_close(g, e, atol=1e-4, rtol=0)
    assert all(torch.equal(a, g) for a, g in zip(again, got))
    on_card = stu_attention.time_buckets(_t(ts).to(cuda), l, 128).cpu()
    assert torch.equal(on_card, stu_attention.time_buckets(_t(ts), l, 128))


@pytest.mark.gpu
def test_cuda_stu_refuses_other_head_dims(cuda: torch.device) -> None:
    q, k, v, _, bias, allowed, timeline, _ = _stu_inputs(2, 2, 16, 8, 8, cuda)
    wide = torch.zeros((2, 2, 16, 24), device=cuda)
    with pytest.raises(ValueError, match="must be in"):
        stu_attention.stu_fwd(wide, wide, v, bias, allowed, timeline)
    with pytest.raises(ValueError, match="must be in"):
        stu_attention.stu_fwd(q, k, wide, bias, allowed, timeline)


@pytest.mark.gpu
@pytest.mark.parametrize("key_padding", [False, True])
def test_cuda_hstu_fit_and_recommend_match_cpu(cuda: torch.device, key_padding: bool) -> None:
    """Three train steps with dropout and a recommend with context, on the card
    and on the CPU twins, from the same start weights and dropout seed."""
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset
    from rectools_tpu_torch.dataset.context import get_context

    rng = np.random.default_rng(12)
    n = 2000
    df = pd.DataFrame({
        Columns.User: rng.integers(0, 96, n),
        Columns.Item: rng.integers(0, 3000, n),
        Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**7, n), unit="s"),
    })
    dataset = Dataset.construct(df)
    config = dict(n_blocks=2, n_heads=4, n_factors=64, session_max_len=20, dropout_rate=0.2, batch_size=32, epochs=1,
                  use_key_padding_mask=key_padding, training_module_kwargs={"fused_softmax_chunk": 512})
    models = {dev: HSTUModel(**config, device=dev) for dev in ("cpu", "cuda")}
    for model in models.values():
        model._build_model_from_dataset(dataset)
    models["cpu"].training_module.init_params()
    start = {k: v.clone() for k, v in models["cpu"].backbone.state_dict().items()}
    for model in models.values():
        model.training_module.load_params(start)
    _native.reset_launches()
    for model in models.values():
        model.training_module.fit(model.data_preparator.get_dataloader_train,
                                  model.data_preparator.get_dataloader_val, 1)
        model.is_fitted = True
    # heads of 16: the SIMT forward and backward, one launch each, no dq launch of its own
    assert [_native.LAUNCHES[n] for n in ("stu_fwd", "stu_fwd_simt", "stu_bwd", "stu_bwd_dq", "stu_ds")] == [
        0, 6, 6, 0, 6]
    assert _native.LAUNCHES["layer_norm_bwd"] == 12 and _native.LAUNCHES["attention_fwd"] == 0
    np.testing.assert_allclose(models["cuda"].training_module.train_loss_history,
                               models["cpu"].training_module.train_loss_history, rtol=1e-4)
    cpu_state = models["cpu"].backbone.state_dict()
    for name, value in models["cuda"].backbone.state_dict().items():
        assert (value.cpu() - cpu_state[name]).abs().max().item() <= 1e-4, name
    users = np.unique(df[Columns.User])
    context = get_context(pd.DataFrame({Columns.User: users, Columns.Item: 0,
                                        Columns.Datetime: pd.Timestamp("2021-06-01")}))
    got = models["cuda"].recommend(users, dataset, k=8, filter_viewed=True, context=context)
    expected = models["cpu"].recommend(users, dataset, k=8, filter_viewed=True, context=context)
    np.testing.assert_array_equal(got[Columns.User], expected[Columns.User])
    np.testing.assert_allclose(got[Columns.Score], expected[Columns.Score], rtol=1e-4, atol=1e-4)
    assert (got[Columns.Item].to_numpy() == expected[Columns.Item].to_numpy()).mean() > 0.99


# ------------------------------------------------------------------ the bf16 forms (compute_dtype="bfloat16")

# The twins multiply the bf16 values in f32, exactly, so only the order of
# f32 sums differs and, where two sums straddle a rounding boundary, a bf16
# value lands one step apart (chip_smoke.py states the same limits): kernel 6
# relative per row; kernel 7 relative to the largest entry, ds 2^-6 (the 8
# item chunks' bf16 partials) and di 2^-10; kernels 2 and 5 one bf16 step of
# the largest entry.
BF16_LSE_RTOL, BF16_DS_RTOL, BF16_DI_RTOL, BF16_ATTN_RTOL = 1e-6, 2 ** -6, 2 ** -10, 2 ** -7


def _max_rel(got: torch.Tensor, ref: torch.Tensor) -> float:
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,d", [(257, 2177, 32), (300, 4100, 64), (130, 20033, 128), (51, 300, 128),
                                   (1000, 15872, 128), (333, 5003, 256), (5000, 15872, 256), (257, 2177, 16),
                                   (5000, 15872, 16)])
def test_cuda_bf16_lse_and_ce_grads_match_twin(cuda: torch.device, m: int, n: int, d: int) -> None:
    """Kernels 6 and 7's bf16 forms against their twins on the card, launched
    once each, the same bits on a rerun, ragged tails included."""
    rng = np.random.default_rng(m + n + d)
    bf = torch.bfloat16
    s = _t(rng.normal(size=(m, d)).astype(np.float32)).to(cuda).to(bf)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda).to(bf)
    before = dict(_native.LAUNCHES)
    lse = softmax_lse.streaming_lse(s, items)
    assert _native.LAUNCHES["lse_partials_fwd_bf16"] == before["lse_partials_fwd_bf16"] + 1
    assert _native.LAUNCHES["lse_partials_fwd"] == before["lse_partials_fwd"]
    ref = softmax_lse.streaming_lse_bf16_reference(s, items)
    assert ((lse.double() - ref.double()).abs() / ref.double().abs()).max().item() <= BF16_LSE_RTOL
    assert torch.equal(lse, softmax_lse.streaming_lse(s, items))
    y = _t(rng.integers(0, n, size=m)).to(cuda)
    coeff = torch.where(y == 0, 0.0, 1.0 / m)
    z = (lse - torch.log(coeff)).contiguous()
    got = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    assert _native.LAUNCHES["ce_grads_fused_bf16"] == before["ce_grads_fused_bf16"] + 1
    assert _native.LAUNCHES["ce_grads_fused"] == before["ce_grads_fused"]
    expected = softmax_lse.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff)
    for g, e, tol in zip(got, expected, (BF16_DS_RTOL, BF16_DI_RTOL)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert _max_rel(g, e) <= tol
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def _bf16_attention_bias(rng: np.random.Generator, kind: str, b: int, h: int, l: int, dev: torch.device):
    """The bias of a bf16 attention case: none, the causal (1, 1, L, L) mask,
    the causal mask with a fully masked row, a (B, 1, L, L) key padding on
    the causal mask, BERT4Rec's (B, 1, L, L) bias, or a per-head (B, H, L,
    L) bias (each head its own drawn key padding on the causal mask, the
    diagonal kept)."""
    if kind == "none":
        return None
    if kind == "causal":
        return _t(_causal_bias(l)).to(dev)
    if kind == "masked_row":
        return _t(_masked_row_bias(l)).to(dev)
    if kind == "key_padding":
        pad = np.arange(l)[None, :] < rng.integers(0, l, size=b)[:, None]
        return _t((np.where(pad, MASK_VALUE, 0.0)[:, None, None, :] + _causal_bias(l)).astype(np.float32)).to(dev)
    if kind == "bidirectional":
        return _t(_bidirectional_bias(rng, b, l)).to(dev)
    assert kind == "per_head"
    bias = np.where(rng.random((b, h, 1, l)) < 0.3, MASK_VALUE, 0.0) + _causal_bias(l)
    bias[..., np.arange(l), np.arange(l)] = 0.0
    return _t(bias.astype(np.float32)).to(dev)


def _check_bf16_attention(cuda: torch.device, b: int, h: int, l: int, dh: int, bias_kind: str, rate: float) -> None:
    """Kernels 2 and 5's bf16 forms at (b, h, l, dh) under ``bias_kind``
    against their twins: out and lse, dq, dk and dv, launched once each, the
    same bits on a rerun."""
    rng = np.random.default_rng(l + dh)
    seed, bf = 123457, torch.bfloat16
    q, k, v, dout = (_blhd(rng, b, l, h, dh, cuda).to(bf) for _ in range(4))
    bias = _bf16_attention_bias(rng, bias_kind, b, h, l, cuda)
    scale = 1.0 / dh**0.5
    before = dict(_native.LAUNCHES)
    out, lse = attention.attention_fwd(q, k, v, bias, scale, rate, seed)
    ref_out, ref_lse = attention.attention_bf16_reference(q, k, v, bias, scale, rate, seed)
    assert out.dtype == bf and _max_rel(out, ref_out) <= BF16_ATTN_RTOL
    # the lse of the rounded scores: a score one bf16 step apart moves it by up to that step
    assert ((lse - ref_lse).abs() / ref_lse.abs().clamp(min=1.0)).max().item() <= BF16_ATTN_RTOL
    delta = (dout.float() * out.float()).sum(-1).contiguous()
    got = attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, rate, seed)
    expected = attention.attention_bwd_bf16_reference(q, k, v, bias, lse, delta, dout, scale, rate, seed)
    for g, e in zip(got, expected):
        assert g.dtype == bf and _max_rel(g, e) <= BF16_ATTN_RTOL
    assert [_native.LAUNCHES[key] - before[key] for key in ("attention_fwd_bf16", "attention_bwd_bf16",
                                                            "attention_fwd", "attention_bwd")] == [1, 1, 0, 0]
    again = attention.attention_fwd(q, k, v, bias, scale, rate, seed)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    assert all(torch.equal(a, g) for a, g in zip(
        attention.attention_bwd(q, k, v, bias, lse, delta, dout, scale, rate, seed), got))


# the bf16 forward's edges: each side of its switch from rows in registers to rows in shared memory (128 | 129
# keys) and of the longest row kept there (1,024 | 1,025), every head dim with and without dropout, the bias of
# each shape ((B, H, L, L), (1, 1, L, L), (B, 1, L, L)) and none
BF16_FWD_EDGE_CASES = [
    (l, dh, ("per_head", "causal", "bidirectional", "none")[(i + j) % 4], rate)
    for i, l in enumerate((1, 16, 64, attention.BF16_FWD_REG_KEYS, attention.BF16_FWD_REG_KEYS + 1, 256,
                           attention.BF16_FWD_SMEM_KEYS, attention.BF16_FWD_SMEM_KEYS + 1))
    for j, dh in enumerate((8, 16, 32, 64))
    for rate in (0.0, 0.2)
]


@pytest.mark.gpu
@pytest.mark.parametrize("l,dh,bias_kind,rate", [(100, 32, "causal", 0.2), (12, 16, "none", 0.0),
                                                 (200, 64, "key_padding", 0.2), (37, 32, "bidirectional", 0.2),
                                                 (100, 32, "masked_row", 0.0), (130, 64, "causal", 0.0),
                                                 (100, 8, "causal", 0.2), (70, 8, "key_padding", 0.0),
                                                 (37, 8, "masked_row", 0.2)] + BF16_FWD_EDGE_CASES)
def test_cuda_bf16_attention_matches_twin(cuda: torch.device, l: int, dh: int, bias_kind: str, rate: float) -> None:
    """Kernels 2 and 5's bf16 forms against their twins on the card: out and
    lse, dq, dk and dv, launched once each, the same bits on a rerun; at
    heads of 8 too (the 8-deep products over the head dim), and at the
    forward's edges (BF16_FWD_EDGE_CASES)."""
    _check_bf16_attention(cuda, 3, 4, l, dh, bias_kind, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("b,h,l,dh,bias_kind,rate", [
    (3, 5, 100, 32, "causal", 0.2), (2, 6, 100, 16, "bidirectional", 0.0), (1, 7, 64, 64, "none", 0.2),
    (2, 7, 1, 8, "causal", 0.0), (4, 3, 128, 8, "per_head", 0.2), (512, 1, 100, 16, "causal", 0.2),
    (128, 4, 100, 32, "per_head", 0.0)])
def test_cuda_bf16_attention_partial_head_groups_match_twin(
    cuda: torch.device, b: int, h: int, l: int, dh: int, bias_kind: str, rate: float
) -> None:
    """The bf16 forward where the heads of a b do not fill whole groups of
    the rows mode's blocks (B·H not a multiple of the grouping), and where a
    block owns one head (a per-head bias, or one head: the narrow fit's
    shape, with blocks sharing each SM), against the twins."""
    assert l <= attention.BF16_FWD_REG_KEYS  # the rows mode
    assert bias_kind == "per_head" or h == 1 or h % attention.BF16_FWD_HEADS != 0
    _check_bf16_attention(cuda, b, h, l, dh, bias_kind, rate)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [100, 300])
def test_cuda_bf16_attention_forward_is_the_onepass_kernel(cuda: torch.device, l: int) -> None:
    """The profiler names the bf16 forward's kernel once a call, in its rows
    mode (L = 100) and its tiles mode (L = 300), and never the two-pass
    kernel it replaced (``attn_fwd_bf16_kernel``)."""
    rng = np.random.default_rng(l)
    q, k, v = (_blhd(rng, 8, l, 4, 32, cuda).to(torch.bfloat16) for _ in range(3))
    bias = _t(_causal_bias(l)).to(cuda)
    kernels = _device_kernels(lambda: attention.attention_fwd(q, k, v, bias, 32 ** -0.5, 0.2, 5))
    forward = {n: c for n, c in kernels.items() if "attn_fwd" in n}
    assert len(forward) == 1 and "attn_fwd_onepass_bf16_kernel" in next(iter(forward)), kernels
    assert set(forward.values()) == {20} and not any("attn_fwd_bf16_kernel" in n for n in kernels), kernels


@pytest.mark.gpu
@pytest.mark.parametrize("l,dh", [(100, 32), (100, 8), (300, 64)])
def test_cuda_bf16_attention_batch_halves_give_the_whole_batch_bits(cuda: torch.device, l: int, dh: int) -> None:
    """A row's out and lse do not depend on the rest of the batch: each half
    of the batch, run alone with the seed a mesh data shard gets
    (``shifted_attention_seed``), gives the whole batch's bits, dropout
    included, under BERT4Rec's (B, 1, L, L) bias."""
    from rectools_tpu_torch.models.nn.dropout import shifted_attention_seed

    rng = np.random.default_rng(l + dh)
    b, h, seed = 16, 4, 987654321
    q, k, v = (_blhd(rng, b, l, h, dh, cuda).to(torch.bfloat16) for _ in range(3))
    bias = _t(_bidirectional_bias(rng, b, l)).to(cuda)
    out, lse = attention.attention_fwd(q, k, v, bias, dh ** -0.5, 0.2, seed)
    for lo in (0, b // 2):
        part = slice(lo, lo + b // 2)
        o_p, lse_p = attention.attention_fwd(q[part], k[part], v[part], bias[part], dh ** -0.5, 0.2,
                                             shifted_attention_seed(seed, lo, h))
        assert torch.equal(o_p, out[part]) and torch.equal(lse_p, lse[part])


@pytest.mark.gpu
def test_cuda_bf16_embedding_scatter_sums_in_index_order(cuda: torch.device) -> None:
    """The bf16 table's gather backward on the card: duplicates summed in bf16
    in index order (the sorted scatter), the CPU's one-thread bits."""
    rng = np.random.default_rng(3)
    table = _t(rng.normal(size=(300, 64)).astype(np.float32))
    idx = _t(rng.zipf(1.2, size=51200) % 300)
    upstream = _t(rng.normal(size=(51200, 64)).astype(np.float32)).to(torch.bfloat16)
    grads = {}
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for dev in ("cpu", "cuda"):
            t = table.to(dev).detach().requires_grad_()
            t.to(torch.bfloat16)[idx.to(dev)].backward(upstream.to(dev))
            grads[dev] = t.grad.cpu()
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(grads["cuda"], grads["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["sasrec", "bert4rec", "esasrec"])
def test_cuda_bf16_fit_matches_cpu(cuda: torch.device, family: str) -> None:
    """One epoch (3 steps) of bf16 compute on the card and on the CPU twins
    from the same start: the bf16 forms launched, the losses within 1e-3, the
    f32 master weights within 1e-4 on average (Adam moves a noise-level entry
    by up to lr a step on either side)."""
    _bf16_fit_card_against_cpu(cuda, family, n_factors=64, n_heads=2)


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["sasrec", "bert4rec"])
def test_cuda_bf16_fit_at_heads_of_8_matches_cpu(cuda: torch.device, family: str) -> None:
    """The same at n_factors 32 with the default 4 heads: attention's bf16
    forms at head dim 8 on the card."""
    _bf16_fit_card_against_cpu(cuda, family, n_factors=32, n_heads=4)


@pytest.mark.gpu
@pytest.mark.parametrize("n_factors,n_heads", [(256, 4), (16, 1)])
def test_cuda_bf16_fit_at_the_wide_and_narrow_widths_matches_cpu(
    cuda: torch.device, n_factors: int, n_heads: int
) -> None:
    """The same at the models' default width (256, 4 heads: attention at head
    dim 64, the loss's bf16 forms at D = 256 on 64-row session tiles) and at
    D = 16 (one head): the bf16 loss forms launched, no f32 loss kernel."""
    _bf16_fit_card_against_cpu(cuda, "sasrec", n_factors=n_factors, n_heads=n_heads)


@pytest.mark.gpu
@pytest.mark.parametrize("n_factors,n_heads", [(32, 4), (64, 2)])
def test_cuda_bf16_hstu_fit_matches_cpu(cuda: torch.device, n_factors: int, n_heads: int) -> None:
    """The same for HSTU at head dims 8 (n_factors 32, 4 heads) and 32 (64, 2
    heads): the bf16 forms of kernels 17-19 (18 in its two launches) and of
    LayerNorm's kernels on the card, no f32 STU or LayerNorm launch."""
    _bf16_fit_card_against_cpu(cuda, "hstu", n_factors=n_factors, n_heads=n_heads)


def _bf16_fit_card_against_cpu(cuda: torch.device, family: str, n_factors: int, n_heads: int) -> None:
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset

    rng = np.random.default_rng(21)
    n = 3000
    df = pd.DataFrame({
        Columns.User: np.arange(n) % 96, Columns.Item: rng.zipf(1.2, n) % 3000, Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**7, n), unit="s"),
    })
    dataset = Dataset.construct(df)
    model_type = {"bert4rec": BERT4RecModel, "hstu": HSTUModel}.get(family, SASRecModel)
    if family == "esasrec":
        extra = {"transformer_layers_type": LiGRLayers, "loss": "sampled_softmax", "n_negatives": 16,
                 "training_module_kwargs": {"compute_dtype": "bfloat16", "negatives_on_device": False}}
    else:
        extra = {"training_module_kwargs": {"compute_dtype": "bfloat16", "fused_softmax_chunk": 512}}
    config = dict(n_blocks=2, n_heads=n_heads, n_factors=n_factors, session_max_len=20, dropout_rate=0.0,
                  batch_size=32, epochs=1, **extra)
    models = {dev: model_type(**config, device=dev) for dev in ("cpu", "cuda")}
    for model in models.values():
        model._build_model_from_dataset(dataset)
    models["cpu"].training_module.init_params()
    start = {k: v.clone() for k, v in models["cpu"].backbone.state_dict().items()}
    for model in models.values():
        model.training_module.load_params(start)
    _native.reset_launches()
    for model in models.values():
        model.training_module.fit(model.data_preparator.get_dataloader_train,
                                  model.data_preparator.get_dataloader_val, 1)
    steps = models["cuda"].training_module.global_step
    assert steps == 3
    if family == "hstu":
        assert all(_native.LAUNCHES[k] == 2 * steps for k in STU_BF16_KEYS[:4])
        assert not any(_native.LAUNCHES[k] for k in STU_BF16_KEYS[4:])
    else:
        assert _native.LAUNCHES["attention_fwd_bf16"] == _native.LAUNCHES["attention_bwd_bf16"] == 2 * steps
    loss_launches = steps if family != "esasrec" else 0
    assert _native.LAUNCHES["lse_partials_fwd_bf16"] == _native.LAUNCHES["ce_grads_fused_bf16"] == loss_launches
    assert _native.LAUNCHES["attention_fwd"] == _native.LAUNCHES["ce_grads_fused"] == 0
    norms = 5 if family == "sasrec" else 4  # two a block, and SASRec's closing LayerNorm
    assert _native.LAUNCHES["layer_norm_fwd_bf16"] == _native.LAUNCHES["layer_norm_bwd_bf16"] == norms * steps
    assert _native.LAUNCHES["layer_norm_fwd"] == _native.LAUNCHES["layer_norm_bwd"] == 0
    np.testing.assert_allclose(models["cuda"].training_module.train_loss_history,
                               models["cpu"].training_module.train_loss_history, rtol=1e-3)
    cpu_state = models["cpu"].backbone.state_dict()
    diffs = [(value.cpu() - cpu_state[name]).abs().reshape(-1)
             for name, value in models["cuda"].backbone.state_dict().items()]
    assert all(value.dtype == torch.float32 for value in cpu_state.values())
    assert torch.cat(diffs).mean().item() <= 1e-4


# Kernels 17-19 in bf16: out, dq, dk, dv (bf16) and ds with its bucket sums (f32) against the twins, relative
# to the largest entry. The twins round at the same points; a score or da whose f32 sum lands on the other side of
# a rounding boundary moves that entry by one bf16 step, as for kernels 2 and 5.
BF16_STU_RTOL = 2 ** -7
STU_BF16_KEYS = ("stu_fwd_bf16", "stu_bwd_bf16", "stu_bwd_dq_bf16", "stu_ds_bf16", "stu_fwd", "stu_fwd_simt",
                 "stu_bwd", "stu_bwd_dq", "stu_ds")


@pytest.mark.gpu
@pytest.mark.parametrize(
    "b,h,l,ad,lh,per_row_allowed",
    [(512, 4, 100, 32, 32, False), (64, 4, 1024, 32, 32, False), (3, 2, 77, 16, 64, True), (2, 2, 130, 64, 16, False),
     (3, 4, 7, 32, 32, True), (2, 2, 190, 64, 64, True), (2, 2, 100, 16, 16, False), (512, 4, 100, 8, 8, False),
     (3, 2, 77, 8, 16, True), (2, 2, 130, 16, 8, False)],
)
def test_cuda_bf16_stu_kernels_match_twins(
    cuda: torch.device, b: int, h: int, l: int, ad: int, lh: int, per_row_allowed: bool
) -> None:
    """The four bf16 launches of kernels 17-19 against their twins on the
    card, at the HSTU training shape, at L = 1,024 and at ragged lengths and
    mixed head dims, dims of 8 among them: one launch each and none of the
    f32 forms, a fully padded row of zeros, the same bits on a rerun."""
    bf = torch.bfloat16
    q, k, v, dout, bias, allowed, timeline, buckets = _stu_inputs(b, h, l, ad, lh, cuda, per_row_allowed)
    q, k, v, dout = (t.to(bf) for t in (q, k, v, dout))
    args = (q, k, v, bias, allowed, timeline)
    before = dict(_native.LAUNCHES)
    out = stu_attention.stu_fwd(*args)
    got = stu_attention.stu_bwd(*args, dout)
    ds, sums = stu_attention.stu_ds(*args, dout, buckets, 129)
    assert [_native.LAUNCHES[n] - before[n] for n in STU_BF16_KEYS] == [1, 1, 1, 1, 0, 0, 0, 0, 0]
    assert out.dtype == bf and all(g.dtype == bf for g in got) and ds.dtype == sums.dtype == torch.float32
    expected = (stu_attention.stu_bf16_reference(*args), *stu_attention.stu_bwd_bf16_reference(*args, dout),
                *stu_attention.stu_ds_bf16_reference(*args, dout, buckets, 129))
    for name, g, e in zip(("out", "dq", "dk", "dv", "ds", "sums"), (out, *got, ds, sums), expected):
        assert bool(torch.isfinite(g.float()).all()), name
        assert _max_rel(g, e) <= BF16_STU_RTOL, (name, _max_rel(g, e))
    for g in (out, *got, ds):
        assert not g[-1].any()  # the fully padded batch row
    again = (stu_attention.stu_fwd(*args), *stu_attention.stu_bwd(*args, dout),
             *stu_attention.stu_ds(*args, dout, buckets, 129))
    assert all(torch.equal(a, g) for a, g in zip(again, (out, *got, ds, sums)))
    alone, none = stu_attention.stu_ds(*args, dout)
    assert none is None and torch.equal(alone, ds)


@pytest.mark.gpu
def test_cuda_bf16_stu_refuses_mixed_dtypes_and_head_dim_8(cuda: torch.device) -> None:
    """A bf16 / f32 operand set raises TypeError before anything launches.
    Heads of 8 in bf16, which raised NotImplementedError before their forms
    existed, launch kernel 19's bf16 form and match its twin."""
    q, k, v, dout, bias, allowed, timeline, buckets = _stu_inputs(2, 2, 20, 16, 16, cuda, False)
    bf = torch.bfloat16
    before = dict(_native.LAUNCHES)
    with pytest.raises(TypeError, match="mixed operand dtypes"):
        stu_attention.stu_fwd(q.to(bf), k, v.to(bf), bias, allowed, timeline)
    with pytest.raises(TypeError, match="mixed operand dtypes"):
        stu_attention.stu_bwd(q.to(bf), k.to(bf), v.to(bf), bias, allowed, timeline, dout)
    assert dict(_native.LAUNCHES) == before
    q8 = q[..., :8].contiguous().to(bf)
    args = (q8, q8, v.to(bf), bias, allowed, timeline, dout.to(bf), buckets, 129)
    got = stu_attention.stu_ds(*args)
    assert _native.LAUNCHES["stu_ds_bf16"] - before["stu_ds_bf16"] == 1
    for g, e in zip(got, stu_attention.stu_ds_bf16_reference(*args)):
        assert _max_rel(g, e) <= BF16_STU_RTOL


# Kernels 8-11 in bf16 (the mesh loss on bf16 towers): the lse relative per row; ds and di (f32, before the
# autograd function rounds them) relative to the twin's largest entry, where a pw, p or s * dlse one bf16 step
# apart (its f32 value straddling a rounding boundary) moves a sum: up to 1.2e-3 on an H100 at the training
# shape (rectools_tpu_torch/tools/mesh_bf16_check.py)
BF16_MESH_GRAD_RTOL = 2 ** -7
MESH_BF16_KEYS = ("lse_bias_fwd_bf16", "lse_bwd_fused_bf16", "lse_bwd_ds_bf16", "lse_bwd_di_bf16",
                  "lse_partials_fwd_bf16", "ce_grads_fused_bf16", "lse_bias_fwd", "lse_bwd_fused", "lse_bwd_ds",
                  "lse_bwd_di")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,d,invalid", [(333, 1000, 32, (517, 999)), (257, 2177, 64, ()),
                                           (130, 4100, 128, (4099,)), (25600, 3959, 128, (3958,)),
                                           (25600, 7936, 128, ()), (333, 4100, 256, (517, 4099)),
                                           (25600, 7936, 256, ()), (257, 2177, 16, (2176,)), (25600, 7936, 16, ())])
def test_cuda_bf16_mesh_lse_kernels_match_twins(
    cuda: torch.device, monkeypatch, m: int, n: int, d: int, invalid: tuple
) -> None:
    """Kernel 8's bf16 form (kernel 6's bits at a zero bias) and the VJP's,
    fused (kernel 9) and split (10 + 11, the partials budget forced to 0),
    against their twins on the card: one launch each and none of the f32
    forms, -1e30 rows with a zero di, the same bits on a rerun."""
    rng = np.random.default_rng(m + n + d)
    bf = torch.bfloat16
    s = _t(rng.normal(size=(m, d)).astype(np.float32)).to(cuda).to(bf)
    items = _t((0.1 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda).to(bf)
    bias = torch.zeros(n, device=cuda)
    for row in invalid:
        items[row] = 0.0
        bias[row] = softmax_lse.NEG_BIG
    dlse = _t((rng.normal(size=m) / m).astype(np.float32)).to(cuda)  # mixed sign
    before = dict(_native.LAUNCHES)
    lse = softmax_lse.streaming_lse_fwd(s, items, bias)
    ref = softmax_lse.streaming_lse_bias_bf16_reference(s, items, bias)
    assert ((lse.double() - ref.double()).abs() / ref.double().abs()).max().item() <= BF16_LSE_RTOL
    assert torch.equal(lse, softmax_lse.streaming_lse_fwd(s, items, bias))
    if not invalid:
        assert torch.equal(lse, softmax_lse.streaming_lse_fwd(s, items))  # kernel 6's bits
    routes = {"fused": 1 << 62, "split": 0}
    for route, budget in routes.items():
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", budget)
        got = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
        expected = softmax_lse.streaming_lse_bwd_bf16_reference(s, items, bias, lse, dlse, partials=route == "fused")
        for g, e in zip(got, expected):
            assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
            assert _max_rel(g, e) <= BF16_MESH_GRAD_RTOL, (route, _max_rel(g, e))
        if invalid:
            assert not got[1][list(invalid)].any()
        again = softmax_lse.streaming_lse_bwd(s, items, bias, lse, dlse)
        assert all(torch.equal(a, g) for a, g in zip(again, got))
    counts = [_native.LAUNCHES[key] - before[key] for key in MESH_BF16_KEYS]
    assert counts == [2, 2, 2, 2, 0 if invalid else 1, 0, 0, 0, 0, 0]


@pytest.mark.gpu
def test_cuda_bf16_mesh_fit_matches_cpu(cuda: torch.device) -> None:
    """One epoch (3 steps) of bf16 compute at ``mesh_shape=(1, 1)`` on the card
    and on the CPU twins from the same start: kernels 8 and 9's bf16 forms
    once a step and none of kernels 6 and 7, the losses within 1e-3, the f32
    master weights within 1e-4 on average."""
    import pandas as pd

    from rectools_tpu_torch import Columns
    from rectools_tpu_torch.dataset import Dataset

    rng = np.random.default_rng(22)
    n = 3000
    df = pd.DataFrame({
        Columns.User: np.arange(n) % 96, Columns.Item: rng.zipf(1.2, n) % 3000, Columns.Weight: 1.0,
        Columns.Datetime: pd.Timestamp("2021-01-01") + pd.to_timedelta(rng.integers(0, 10**7, n), unit="s"),
    })
    dataset = Dataset.construct(df)
    config = dict(n_blocks=2, n_heads=2, n_factors=64, session_max_len=20, dropout_rate=0.0, batch_size=32, epochs=1,
                  training_module_kwargs={"compute_dtype": "bfloat16", "fused_softmax_chunk": 512,
                                          "mesh_shape": (1, 1)})
    models = {dev: SASRecModel(**config, device=dev) for dev in ("cpu", "cuda")}
    for model in models.values():
        model._build_model_from_dataset(dataset)
    models["cpu"].training_module.init_params()
    start = {k: v.clone() for k, v in models["cpu"].backbone.state_dict().items()}
    for model in models.values():
        model.training_module.load_params(start)
    _native.reset_launches()
    for model in models.values():
        model.training_module.fit(model.data_preparator.get_dataloader_train,
                                  model.data_preparator.get_dataloader_val, 1)
    steps = models["cuda"].training_module.global_step
    assert steps == 3
    assert _native.LAUNCHES["lse_bias_fwd_bf16"] == _native.LAUNCHES["lse_bwd_fused_bf16"] == steps
    assert all(_native.LAUNCHES[key] == 0 for key in ("lse_partials_fwd_bf16", "ce_grads_fused_bf16",
                                                      "lse_partials_fwd", "ce_grads_fused", "lse_bias_fwd",
                                                      "lse_bwd_fused"))
    np.testing.assert_allclose(models["cuda"].training_module.train_loss_history,
                               models["cpu"].training_module.train_loss_history, rtol=1e-3)
    cpu_state = models["cpu"].backbone.state_dict()
    diffs = [(value.cpu() - cpu_state[name]).abs().reshape(-1)
             for name, value in models["cuda"].backbone.state_dict().items()]
    assert torch.cat(diffs).mean().item() <= 1e-4


# Kernel 7's two launches and kernels 12-14 in bf16 against their twins, relative to the twin's largest entry:
# the twins round at the kernels' points, so only the order of f32 sums differs and, where a sum straddles a
# rounding boundary, a bf16 value lands one step apart (2^-7, the limit chip_smoke.py holds them to)
BF16_SPLIT_RTOL = 2 ** -7
CE_SPLIT_BF16_KEYS = ("ce_grads_fused_bf16", "ce_grads_ds_bf16", "ce_grads_di_bf16", "grads_z_fused_bf16",
                      "grads_z_ds_bf16", "grads_z_di_bf16")
F32_LOSS_KEYS = ("ce_grads_fused", "ce_grads_ds", "ce_grads_di", "grads_z_fused", "grads_z_ds", "grads_z_di")


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,d", [(257, 2177, 32), (300, 4100, 64), (130, 20033, 128), (51, 300, 128),
                                   (40, 20011, 32), (1000, 15872, 128), (333, 5003, 256), (40, 20011, 256),
                                   (257, 2177, 16), (1000, 15872, 16)])
def test_cuda_bf16_grads_z_and_ce_split_routes_match_twins(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, m: int, n: int, d: int
) -> None:
    """On bf16 towers: kernel 12 (its partials within the budget) and 13 + 14
    (the budget 0), kernel 7's two launches (a budget between the JAX rule's
    bytes and the plan's) and the large-catalog route (the budget 0), each
    against its twin in its order, launched once each and no f32 form,
    ignored rows' ds exactly 0, the same bits on a rerun."""
    rng = np.random.default_rng(7 * n + m)
    bf = torch.bfloat16
    s = _t(rng.normal(size=(m, d)).astype(np.float32)).to(cuda).to(bf)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda).to(bf)
    y = _t(rng.integers(0, n, size=m)).to(cuda)
    y[m // 3 : m // 2] = n - 1  # repeated labels on the catalog's tail
    coeff = torch.where(y == 0, 0.0, 1.0 / m)
    z = (softmax_lse.streaming_lse(s, items) - torch.log(coeff)).contiguous()
    n_sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = softmax_lse.fused_bwd_plan(m, n, d, n_sms, 2, bf)[2]
    cases = {  # name: (budget, the function, its twin, launch keys)
        "kernel 12": (1 << 62, lambda: softmax_lse.softmax_grads_from_z(s, items, z),
                      lambda: softmax_lse.softmax_grads_from_z_bf16_reference(s, items, z, partials=True),
                      ("grads_z_fused_bf16",)),
        "kernels 13 + 14": (0, lambda: softmax_lse.softmax_grads_from_z(s, items, z),
                            lambda: softmax_lse.softmax_grads_from_z_bf16_reference(s, items, z, partials=False),
                            ("grads_z_ds_bf16", "grads_z_di_bf16")),
        "kernel 7's two launches": (plan - 1, lambda: softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff),
                                    lambda: softmax_lse.softmax_ce_grads_from_z_bf16_reference(
                                        s, items, z, y, coeff, partials=False),
                                    ("ce_grads_ds_bf16", "ce_grads_di_bf16")),
    }
    for what, (budget, fn, twin, keys) in cases.items():
        monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", budget)
        if what == "kernel 7's two launches":
            assert not softmax_lse.ce_takes_split_route(m, n, d, bf)
        before = dict(_native.LAUNCHES)
        got = fn()
        launched = {k: _native.LAUNCHES[k] - before[k] for k in (*CE_SPLIT_BF16_KEYS, *F32_LOSS_KEYS)}
        assert launched == {k: int(k in keys) for k in launched}, (what, launched)
        for g, e in zip(got, twin()):
            assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
            assert _max_rel(g, e) <= BF16_SPLIT_RTOL, (what, _max_rel(g, e))
        if what != "kernel 7's two launches":
            assert not got[0][coeff == 0].any()
        again = fn()
        assert all(torch.equal(a, g) for a, g in zip(again, got)), what
    # the large-catalog route: kernels 13 + 14 and the label term in f32, against the one pass on the same inputs
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 1 << 62)
    one_pass = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 0)
    before = dict(_native.LAUNCHES)
    route = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    assert [_native.LAUNCHES[k] - before[k] for k in ("grads_z_ds_bf16", "grads_z_di_bf16", "ce_grads_fused_bf16",
                                                      "ce_grads_ds_bf16")] == [1, 1, 0, 0]
    for g, e in zip(route, one_pass):  # the two routes round at other points (ROADMAP §3): a bf16 band
        assert _max_rel(g, e) <= 2 ** -6
    assert all(torch.equal(a, g) for a, g in zip(softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff), route))


@pytest.mark.gpu
def test_cuda_bf16_split_entries_refuse_another_grid(cuda: torch.device) -> None:
    """The bf16 split ds entries take the plan's chunks and refuse another
    count, chunk rows or a step that is not a multiple of 64 rows."""
    m, n, d = 300, 5000, 32
    bf = torch.bfloat16
    s, items = torch.zeros((m, d), device=cuda, dtype=bf), torch.zeros((n, d), device=cuda, dtype=bf)
    z, coeff = torch.zeros((m,), device=cuda), torch.zeros((m,), device=cuda)
    y = torch.zeros((m,), device=cuda, dtype=torch.int64)
    n_chunks, chunk_rows = softmax_lse.split_bwd_plan(m, n, d, 132, softmax_lse.FUSED_BWD_CHUNK)
    ds_part = torch.empty((n_chunks + 1, m, d), device=cuda)
    lib = _native.load("softmax_lse_bf16", softmax_lse._SIGNATURES_BF16)
    ce_lib = _native.load("ce_grads_bf16", softmax_lse._SIGNATURES_CE_BF16)
    stream = _native.current_stream_ptr(cuda)
    ce = (s.data_ptr(), items.data_ptr(), z.data_ptr(), y.data_ptr(), coeff.data_ptr(), ds_part.data_ptr(), m, n, d)
    assert ce_lib.ce_ds_bf16(*ce, chunk_rows, n_chunks, softmax_lse.FUSED_BWD_CHUNK, stream) == 0
    assert ce_lib.ce_ds_bf16(*ce, chunk_rows, n_chunks + 1, softmax_lse.FUSED_BWD_CHUNK, stream) != 0
    assert ce_lib.ce_ds_bf16(*ce, chunk_rows, n_chunks, 100, stream) != 0
    gz = (s.data_ptr(), items.data_ptr(), z.data_ptr(), ds_part.data_ptr(), m, n, d)
    assert lib.grads_z_ds_bf16(*gz, chunk_rows, n_chunks, stream) == 0
    assert lib.grads_z_ds_bf16(*gz, chunk_rows + 1, n_chunks, stream) != 0
    torch.cuda.synchronize()


# ------------------------------------------------------------------ kernels 1, 4, 15 and 16 in bf16


@pytest.mark.gpu
@pytest.mark.parametrize("gamma_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m,d", [(51200, 16), (51200, 128), (51200, 256), (51199, 128), (33, 96), (7, 1024),
                                 (1, 128)])
def test_cuda_bf16_layer_norm_is_the_widened_route_to_the_bit(
    cuda: torch.device, m: int, d: int, gamma_dtype: torch.dtype
) -> None:
    """Kernels 1 and 4's bf16 forms (``ln_fwd_bf16``, ``ln_bwd_bf16``) on bf16
    x and dy with bf16 or f32 γ, β: one launch each and no f32 launch; bit for
    bit the f32 kernels on the widened operands, y and dx rounded to bf16 and
    dγ, dβ to γ's dtype (widening is exact and each output is rounded once);
    the same bits on a rerun; within one bf16 step (2^-8 of the largest entry)
    of the bf16 twins, whose f32 sums run in another order."""
    rng = np.random.default_rng(m + d)
    bf = torch.bfloat16
    x = _t((rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)).to(cuda).to(bf)
    dy = _t(rng.normal(size=(m, d)).astype(np.float32)).to(cuda).to(bf)
    g = _t((1 + 0.3 * rng.normal(size=d)).astype(np.float32)).to(cuda).to(gamma_dtype)
    b = _t((0.3 * rng.normal(size=d)).astype(np.float32)).to(cuda).to(gamma_dtype)
    keys = ("layer_norm_fwd_bf16", "layer_norm_bwd_bf16", "layer_norm_fwd", "layer_norm_bwd")
    before = dict(_native.LAUNCHES)
    y = layer_norm.layer_norm_fwd(x, g, b, 1e-6)
    grads = layer_norm.layer_norm_bwd(x, g, dy, 1e-6)
    assert [_native.LAUNCHES[k] - before[k] for k in keys] == [1, 1, 0, 0]
    assert y.dtype == grads[0].dtype == bf and grads[1].dtype == grads[2].dtype == gamma_dtype
    assert torch.equal(y, layer_norm.layer_norm_fwd(x.float(), g.float(), b.float(), 1e-6).to(bf))
    widened = layer_norm.layer_norm_bwd(x.float(), g.float(), dy.float(), 1e-6)
    assert torch.equal(grads[0], widened[0].to(bf))
    assert all(torch.equal(a, w.to(gamma_dtype)) for a, w in zip(grads[1:], widened[1:]))
    assert torch.equal(layer_norm.layer_norm_fwd(x, g, b, 1e-6), y)
    assert all(torch.equal(a, c) for a, c in zip(layer_norm.layer_norm_bwd(x, g, dy, 1e-6), grads))
    assert _max_rel(y, layer_norm.layer_norm_bf16_reference(x, g, b, 1e-6)) <= 2 ** -8
    for a, w in zip(grads, layer_norm.layer_norm_bwd_bf16_reference(x, g, dy, 1e-6)):
        assert _max_rel(a, w) <= 2 ** -8


@pytest.mark.gpu
def test_cuda_layer_norm_refuses_f32_x_with_bf16_gamma(cuda: torch.device) -> None:
    """f32 x with bf16 γ has no kernel form: ValueError on the card as on the
    CPU, and nothing launches."""
    x, g = torch.ones((4, 32), device=cuda), torch.ones((32,), device=cuda, dtype=torch.bfloat16)
    before = dict(_native.LAUNCHES)
    for call in (lambda: layer_norm.layer_norm_fwd(x, g, g), lambda: layer_norm.layer_norm_bwd(x, g, x)):
        with pytest.raises(ValueError, match="has no kernel form"):
            call()
    assert dict(_native.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float16, torch.float64])
def test_cuda_layer_norm_and_lse_refuse_other_float_dtypes(cuda: torch.device, monkeypatch: pytest.MonkeyPatch,
                                                           dtype: torch.dtype) -> None:
    """float16 and float64 operands (all of one dtype) have no kernel form:
    the LayerNorm and lse wrappers raise TypeError before a launch, and never
    hand such pointers to an f32 or bf16 kernel."""
    x, g = torch.ones((4, 32), device=cuda, dtype=dtype), torch.ones((32,), device=cuda, dtype=dtype)
    s, items = torch.ones((4, 32), device=cuda, dtype=dtype), torch.ones((300, 32), device=cuda, dtype=dtype)
    lse, dlse = torch.zeros((4,), device=cuda), torch.ones((4,), device=cuda)
    calls = [
        lambda: layer_norm.layer_norm_fwd(x, g, g),
        lambda: layer_norm.layer_norm_bwd(x, g, x),
        lambda: softmax_lse.lse_shift_sums(s, items),
        lambda: softmax_lse.streaming_lse_fwd(s, items, bounded_shift=True),
        lambda: softmax_lse.streaming_lse_fwd(s, items),
        lambda: softmax_lse.streaming_lse_bwd(s, items, None, lse, dlse),
    ]
    before = dict(_native.LAUNCHES)
    for partials in (True, False):
        monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", partials)
        for call in calls:
            with pytest.raises(TypeError, match=f"must be torch.(float32|bfloat16), got {dtype}"):
                call()
    assert dict(_native.LAUNCHES) == before


@pytest.mark.gpu
@pytest.mark.parametrize("m,n,d", [(130, 2177, 16), (51, 300, 32), (257, 4100, 64), (130, 40, 64), (1000, 576, 128),
                                   (300, 15872, 128), (130, 2177, 256)])
def test_cuda_bf16_carried_max_lse_matches_twin(cuda: torch.device, monkeypatch: pytest.MonkeyPatch, m: int, n: int,
                                                d: int) -> None:
    """Kernel 15's bf16 form (``lse_bf16``, ``USE_PARTIALS_FWD = False``) in
    clusters of ``lse_cluster_plan`` at every width: one launch and no other
    lse forward; within ``LSE_TC_RTOL`` per row of its twin; the same bits on
    a rerun; within 1e-6 of kernel 6's bf16 form. The cases: one rank (40
    items), ranks past the last tile (576, 2,177 items), M not a multiple of
    128, the KION catalog (8 ranks of 31 tiles)."""
    rng = np.random.default_rng(m * n + d)
    bf = torch.bfloat16
    s = _t(rng.normal(size=(m, d)).astype(np.float32)).to(cuda).to(bf)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(cuda).to(bf)
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", False)
    keys = ("lse_fwd_bf16", "lse_partials_fwd_bf16", "lse_fwd", "lse_partials_fwd")
    before = dict(_native.LAUNCHES)
    lse = softmax_lse.streaming_lse(s, items)
    assert [_native.LAUNCHES[k] - before[k] for k in keys] == [1, 0, 0, 0]
    ref = softmax_lse.streaming_lse_carried_bf16_reference(s, items)
    rel = ((lse - ref).abs() / ref.abs()).max().item()
    assert lse.dtype == torch.float32 and torch.isfinite(lse).all() and rel <= LSE_TC_RTOL, rel
    assert torch.equal(softmax_lse.streaming_lse(s, items), lse)
    monkeypatch.setattr(softmax_lse, "USE_PARTIALS_FWD", True)
    kernel_6 = softmax_lse.streaming_lse(s, items)
    assert ((kernel_6 - lse).abs() / lse.abs()).max().item() <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("scale", [0.3, 1.0, 1.5, 4.0])
@pytest.mark.parametrize("m,n,d", [(130, 2177, 16), (51, 300, 32), (300, 4500, 64), (700, 4500, 128),
                                   (130, 2177, 256)])
def test_cuda_bf16_lse_shift_matches_twin(cuda: torch.device, m: int, n: int, d: int, scale: float) -> None:
    """Kernel 16's bf16 form (``lse_shift_bf16``, ``bounded_shift=True``): one
    launch and no f32 one; the shift from the widened towers; inside the
    contract (bound gap under 120) within ``LSE_TC_RTOL`` per row of its twin
    in both windows, past it (gap over 170, scale 4) -inf rows in both, never
    NaN; the same bits on a rerun; a zero session row (shift 0, every term 1)
    gives log N. Its backward is kernel 9's bf16 form."""
    rng = np.random.default_rng(m + n)
    bf = torch.bfloat16
    s = _t((scale * rng.normal(size=(m, d)) / np.sqrt(d / 32)).astype(np.float32)).to(cuda).to(bf)
    items = _t((scale * rng.normal(size=(n, d)) / np.sqrt(d / 32)).astype(np.float32)).to(cuda).to(bf)
    s[m // 2] = 0.0
    keys = ("lse_shift_fwd_bf16", "lse_shift_fwd")
    before = dict(_native.LAUNCHES)
    got = softmax_lse.streaming_lse(s, items, bounded_shift=True)
    assert [_native.LAUNCHES[k] - before[k] for k in keys] == [1, 0]
    shift, l, l2 = softmax_lse.lse_shift_sums_bf16_reference(s, items)
    ref = softmax_lse.select_shift_window(shift, l, l2)
    assert torch.equal(softmax_lse.lse_shift(s, items), softmax_lse.lse_shift(s.float(), items.float()))
    gap = shift - (s.float() @ items.float().T).max(dim=1).values
    inside, outside = gap < 120, gap > 170
    assert not torch.isnan(got).any() and inside[m // 2]
    rel = ((got[inside] - ref[inside]).abs() / ref[inside].abs()).max().item()
    assert rel <= LSE_TC_RTOL, rel
    assert torch.isneginf(got[outside]).all() and torch.isneginf(ref[outside]).all()
    assert torch.equal(softmax_lse.streaming_lse(s, items, bounded_shift=True), got)
    assert abs(got[m // 2].item() - np.log(n)) <= 1e-6 * np.log(n)
    if outside.any():  # an lse of -inf has no gradient
        return
    ts, ti = s.clone().requires_grad_(True), items.clone().requires_grad_(True)
    before = dict(_native.LAUNCHES)
    softmax_lse.streaming_lse(ts, ti, bounded_shift=True).sum().backward()
    bwd = _native.LAUNCHES["lse_bwd_fused_bf16"] + _native.LAUNCHES["lse_bwd_ds_bf16"]
    assert bwd - before["lse_bwd_fused_bf16"] - before["lse_bwd_ds_bf16"] == 1
    assert ts.grad.dtype == ti.grad.dtype == bf
    assert torch.isfinite(ts.grad.float()).all() and torch.isfinite(ti.grad.float()).all()


# Kernels 1, 4, 15 and 16 in f32 on seeded inputs: a digest of each form's output bits, as the f32 kernels gave them
# on an H100 before their bf16 forms were added (the f32 instantiations of the templated LayerNorm kernels, and the
# f32 lse forwards, keep those bits).
F32_DIGESTS = {
    "ln_fwd_51200x128": "dd77d907cd3df550",
    "ln_bwd_51200x128": "b86463a03e04f6bb",
    "ln_fwd_4099x96": "9cefca4d3aefaf7d",
    "ln_bwd_4099x96": "a5592d6f3ff07b6d",
    "ln_fwd_7x1024": "1f17cb3e604db201",
    "ln_bwd_7x1024": "f4546cf3cd85d91d",
    "ln_fwd_51200x256": "9dcfbf8e3e4eda30",
    "ln_bwd_51200x256": "bb2a8a04e5c483af",
    "lse_fwd_300x15872x128": "6a12042b548896e8",
    "lse_shift_fwd_300x15872x128": "41a9db1731d5dd76",
    "lse_fwd_130x2177x16": "faa002384e0b35c3",
    "lse_shift_fwd_130x2177x16": "fa476ae17c44f839",
    "lse_fwd_257x1000x64": "b1c29ff74156c31f",
    "lse_shift_fwd_257x1000x64": "17711987950d7d2e",
    "lse_fwd_130x2177x256": "e1dff909b3a61350",
    "lse_shift_fwd_130x2177x256": "8c85a5b1bba181b7",
}


def _f32_digests(dev: torch.device) -> dict:
    """{case: the first 16 hex digits of the SHA-256 of its output bytes}
    for kernels 1, 4, 15 and 16 in f32 at shapes of the main path and ragged
    ones."""
    import hashlib

    def digest(*tensors: torch.Tensor) -> str:
        h = hashlib.sha256()
        for t in tensors:
            h.update(t.detach().cpu().contiguous().numpy().tobytes())
        return h.hexdigest()[:16]

    out = {}
    for m, d in ((51200, 128), (4099, 96), (7, 1024), (51200, 256)):
        rng = np.random.default_rng(m + d)
        x = _t((rng.normal(size=(m, d)) * 3 + 1).astype(np.float32)).to(dev)
        dy = _t(rng.normal(size=(m, d)).astype(np.float32)).to(dev)
        g = _t((1 + 0.3 * rng.normal(size=d)).astype(np.float32)).to(dev)
        b = _t((0.3 * rng.normal(size=d)).astype(np.float32)).to(dev)
        out[f"ln_fwd_{m}x{d}"] = digest(layer_norm.layer_norm_fwd(x, g, b, 1e-6))
        out[f"ln_bwd_{m}x{d}"] = digest(*layer_norm.layer_norm_bwd(x, g, dy, 1e-6))
    partials = softmax_lse.USE_PARTIALS_FWD
    try:
        softmax_lse.USE_PARTIALS_FWD = False
        for m, n, d in ((300, 15872, 128), (130, 2177, 16), (257, 1000, 64), (130, 2177, 256)):
            rng = np.random.default_rng(m * n + d)
            s = _t(rng.normal(size=(m, d)).astype(np.float32)).to(dev)
            items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(dev)
            out[f"lse_fwd_{m}x{n}x{d}"] = digest(softmax_lse.streaming_lse(s, items))
            out[f"lse_shift_fwd_{m}x{n}x{d}"] = digest(softmax_lse.streaming_lse(s, items, bounded_shift=True))
    finally:
        softmax_lse.USE_PARTIALS_FWD = partials
    return out


@pytest.mark.gpu
def test_cuda_f32_forms_keep_their_bits(cuda: torch.device) -> None:
    """``compute_dtype="float32"`` keeps its bits: kernels 1, 4, 15 and 16 in
    f32 give, on the same seeded inputs, the bits they gave before their bf16
    forms were added."""
    assert _f32_digests(cuda) == F32_DIGESTS


# ------------------------------------------------------------------ kernel 7's bf16 forms on the wgmma engine


def test_ce_grads_bf16_entries_match_the_cuda_source() -> None:
    """Kernel 7's bf16 entries of ops/softmax_lse.py ``_SIGNATURES_CE_BF16``
    are C functions of csrc/ce_grads_bf16.cu, each with as many parameters as
    its ctypes signature, and of no other library; the source dispatches every
    width of ``SUPPORTED_D`` and walks the wrapper's 64-row item tiles."""
    src = (REPO / "rectools_tpu_torch" / "csrc" / "ce_grads_bf16.cu").read_text()
    old = (REPO / "rectools_tpu_torch" / "csrc" / "softmax_lse_bf16.cu").read_text()
    for name, argtypes in softmax_lse._SIGNATURES_CE_BF16.items():
        found = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
        assert found is not None, name
        assert len([a for a in found.group(1).split(",") if a.strip()]) == len(argtypes), name
        assert f'extern "C" int {name}(' not in old and name not in softmax_lse._SIGNATURES_BF16
    widths = {int(w) for w in re.findall(r"case (\d+): return fn\(std::integral_constant<int, \d+>\{\}\);", src)}
    assert widths == set(softmax_lse.SUPPORTED_D)
    assert int(re.search(r"^constexpr int kTileRows = (\d+);", src, re.M).group(1)) == softmax_lse.TILE
    assert "ce_grads_bf16" in _native.SOURCES


@pytest.mark.parametrize("name", sorted(ce_grads_bf16_variants.VARIANTS))
def test_ce_grads_bf16_variants_still_apply(name: str) -> None:
    """Each variant that tools/ce_grads_bf16_variants.py times on the card
    finds each text it replaces as often as it says in today's source, and
    changes it (but the source as it is)."""
    edited = ce_grads_bf16_variants.edited_source(name)
    src = (REPO / ce_grads_bf16_variants.CU).read_text()
    assert (edited == src) == (name == "engine")


# the launch keys of each form of kernel 7 in bf16, and the kernel both run (csrc/ce_grads_bf16.cu)
CE_BF16_FORMS = {"one_pass": ("ce_grads_fused_bf16",), "two_launches": ("ce_grads_ds_bf16", "ce_grads_di_bf16")}
CE_BF16_ENGINE_KERNEL = "ce_grads_bf16_kernel"
CE_BF16_OLD_KERNELS = ("ce_fused_bf16_kernel", "split_ds_bf16_kernel", "split_di_bf16_kernel")


def _ce_bf16_case(dev: torch.device, m: int, n: int, d: int) -> tuple:
    """(s, items, z, y, coeff) on bf16 towers: a sixth of the rows labelled on
    the catalog's last row, label 0 with coeff 0 (z = +inf) on a tenth."""
    rng = np.random.default_rng(m * 7 + n + d)
    bf = torch.bfloat16
    s = _t(rng.normal(size=(m, d)).astype(np.float32)).to(dev).to(bf)
    items = _t((0.3 * rng.normal(size=(n, d))).astype(np.float32)).to(dev).to(bf)
    y = _t(rng.integers(1, n, size=m)).to(dev)
    y[m // 3 : m // 2] = n - 1
    y[: max(1, m // 10)] = 0
    coeff = torch.where(y == 0, 0.0, 1.0 / m)
    z = (softmax_lse.streaming_lse(s, items) - torch.log(coeff)).contiguous()
    return s, items, z, y, coeff


def _ce_bf16_budget(monkeypatch: pytest.MonkeyPatch, form: str, m: int, n: int, d: int) -> None:
    """The partials budget that puts kernel 7's bf16 CE gradients on ``form``."""
    plan = softmax_lse.fused_bwd_plan(m, n, d, torch.cuda.get_device_properties(0).multi_processor_count,
                                      softmax_lse._ds_itemsize(torch.bfloat16), torch.bfloat16)[2]
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 1 << 62 if form == "one_pass" else plan - 1)
    assert not softmax_lse.ce_takes_split_route(m, n, d, torch.bfloat16)


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(CE_BF16_FORMS))
@pytest.mark.parametrize("d", softmax_lse.SUPPORTED_D)
@pytest.mark.parametrize("m,n", [(257, 2177), (130, 6181), (64, 2112), (51, 300)])
def test_cuda_ce_grads_bf16_engine_matches_twin(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, form: str, d: int, m: int, n: int
) -> None:
    """Kernel 7's bf16 forms at the engine's edges (M not a multiple of 64,
    N ending inside an item tile and inside a 2,048-row chunk, one session
    tile and a catalog of whole tiles, labels on the catalog's last row,
    label 0 with coeff 0 and z = +inf) against the twin in the form's order: ds within BF16_DS_RTOL and di
    within BF16_DI_RTOL of the largest entry, ignored rows' ds exactly 0, one
    launch of each of the form's keys and of no other kernel-7 key, the same
    bits on a rerun."""
    s, items, z, y, coeff = _ce_bf16_case(cuda, m, n, d)
    _ce_bf16_budget(monkeypatch, form, m, n, d)
    keys = ("ce_grads_fused", "ce_grads_ds", "ce_grads_di", *(k for ks in CE_BF16_FORMS.values() for k in ks))
    before = dict(_native.LAUNCHES)
    got = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    assert {k: _native.LAUNCHES[k] - before[k] for k in keys} == {k: int(k in CE_BF16_FORMS[form]) for k in keys}
    ref = softmax_lse.softmax_ce_grads_from_z_bf16_reference(s, items, z, y, coeff, partials=form == "one_pass")
    for g, e, tol in zip(got, ref, (BF16_DS_RTOL, BF16_DI_RTOL)):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert _max_rel(g, e) <= tol
    assert not got[0][coeff == 0].any()
    again = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.gpu
@pytest.mark.parametrize("form", sorted(CE_BF16_FORMS))
def test_cuda_ce_grads_bf16_runs_the_engine_kernel(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, form: str
) -> None:
    """Both forms of kernel 7 in bf16 run csrc/ce_grads_bf16.cu's kernel, one
    launch a wrapper key (the one pass one a call, the two launches two), and
    none of softmax_lse_bf16.cu's gradient kernels."""
    m, n, d = 1000, 15872, 128
    s, items, z, y, coeff = _ce_bf16_case(cuda, m, n, d)
    _ce_bf16_budget(monkeypatch, form, m, n, d)
    calls, expected = 4, 4 * len(CE_BF16_FORMS[form])

    def call() -> None:  # an elementwise kernel after the form's launches: a capture's last record can go missing
        softmax_lse.softmax_ce_grads_from_z(s, items, z, y, coeff)[1].add_(0.0)

    seen = set()  # the kernels of every capture taken
    for _ in range(5):  # a capture now and then drops a record of a short kernel: take it again
        names = _device_kernels(call, calls)
        seen |= set(names)
        if sum(v for k, v in names.items() if CE_BF16_ENGINE_KERNEL in k) == expected:
            break
    assert sum(v for k, v in names.items() if CE_BF16_ENGINE_KERNEL in k) == expected
    assert not [k for k in seen if any(old in k for old in CE_BF16_OLD_KERNELS)]


@pytest.mark.gpu
@pytest.mark.parametrize("d", softmax_lse.SUPPORTED_D)
@pytest.mark.parametrize("m,n", [(257, 2177), (130, 6181), (64, 2112), (51, 300)])
def test_cuda_grads_z_bf16_runs_on_the_engine(
    cuda: torch.device, monkeypatch: pytest.MonkeyPatch, d: int, m: int, n: int
) -> None:
    """Kernel 12 in bf16 (its partials within the budget) at the engine's
    edges: one ``grads_z_fused_bf16`` launch and no other loss key, ds and di
    within BF16_SPLIT_RTOL of the twin's largest entry (kernel 12's limit: with
    no label term di's largest entry is a sum of probabilities, where a P one
    bf16 step apart weighs more than against kernel 7's label rows), ignored
    rows' ds exactly 0, the same bits on a rerun, and the bits of kernel 7's
    one pass with coeff = 0 (the engine with the label term at zero)."""
    s, items, z, y, coeff = _ce_bf16_case(cuda, m, n, d)
    monkeypatch.setattr(softmax_lse, "FUSED_BWD_PARTIALS_BUDGET", 1 << 62)
    keys = (*CE_SPLIT_BF16_KEYS, *F32_LOSS_KEYS)
    before = dict(_native.LAUNCHES)
    got = softmax_lse.softmax_grads_from_z(s, items, z)
    assert {k: _native.LAUNCHES[k] - before[k] for k in keys} == {k: int(k == "grads_z_fused_bf16") for k in keys}
    ref = softmax_lse.softmax_grads_from_z_bf16_reference(s, items, z, partials=True)
    for g, e in zip(got, ref):
        assert g.dtype == torch.float32 and bool(torch.isfinite(g).all())
        assert _max_rel(g, e) <= BF16_SPLIT_RTOL
    assert not got[0][coeff == 0].any()
    assert all(torch.equal(a, g) for a, g in zip(softmax_lse.softmax_grads_from_z(s, items, z), got))
    no_label = softmax_lse.softmax_ce_grads_from_z(s, items, z, y, torch.zeros_like(coeff))
    assert all(torch.equal(a, g) for a, g in zip(no_label, got))


@pytest.mark.gpu
def test_cuda_grads_z_bf16_runs_the_engine_kernel(cuda: torch.device) -> None:
    """Kernel 12 in bf16 runs csrc/ce_grads_bf16.cu's kernel, one launch a
    call, and none of softmax_lse_bf16.cu's gradient kernels; z at an
    address that is not 16-byte aligned is copied for TMA and gives the same
    bits."""
    m, n, d = 1000, 15872, 128
    s, items, z, _, _ = _ce_bf16_case(cuda, m, n, d)
    calls = 4

    def call() -> None:  # an elementwise kernel after the launch: a capture's last record can go missing
        softmax_lse.softmax_grads_from_z(s, items, z)[1].add_(0.0)

    seen = set()
    for _ in range(5):  # a capture now and then drops a record of a short kernel: take it again
        names = _device_kernels(call, calls)
        seen |= set(names)
        if sum(v for k, v in names.items() if CE_BF16_ENGINE_KERNEL in k) == calls:
            break
    assert sum(v for k, v in names.items() if CE_BF16_ENGINE_KERNEL in k) == calls
    assert not [k for k in seen if any(old in k for old in CE_BF16_OLD_KERNELS)]
    shifted = torch.empty((m + 1,), device=cuda)[1:]
    shifted.copy_(z)
    assert shifted.data_ptr() % 16 != 0
    got = softmax_lse.softmax_grads_from_z(s, items, z)
    assert all(torch.equal(a, g) for a, g in zip(softmax_lse.softmax_grads_from_z(s, items, shifted), got))


@pytest.mark.gpu
def test_cuda_ce_grads_bf16_entries_refuse_bad_arguments(cuda: torch.device) -> None:
    """The engine's entries (kernel 7's and kernel 12's) refuse chunk rows
    that are not a multiple of 64, a width outside ``SUPPORTED_D`` and rows
    past its 32-bit indices, and launch nothing for an empty catalog."""
    m, n, d = 300, 5000, 32
    bf = torch.bfloat16
    s, items = torch.zeros((m, d), device=cuda, dtype=bf), torch.zeros((n, d), device=cuda, dtype=bf)
    z, coeff = torch.zeros((m,), device=cuda), torch.zeros((m,), device=cuda)
    y = torch.zeros((m,), device=cuda, dtype=torch.int64)
    ds_part = torch.empty((-(-n // softmax_lse.FUSED_BWD_CHUNK), m, d), device=cuda, dtype=bf)
    di = torch.empty((n, d), device=cuda)
    lib = _native.load("ce_grads_bf16", softmax_lse._SIGNATURES_CE_BF16)
    stream = _native.current_stream_ptr(cuda)
    head = (s.data_ptr(), items.data_ptr(), z.data_ptr(), y.data_ptr(), coeff.data_ptr(), ds_part.data_ptr(),
            di.data_ptr())
    assert lib.ce_fused_bf16(*head, m, n, d, softmax_lse.FUSED_BWD_CHUNK, 1, stream) == 0
    assert lib.ce_fused_bf16(*head, m, n, d, 100, 1, stream) != 0
    assert lib.ce_fused_bf16(*head, m, n, 48, softmax_lse.FUSED_BWD_CHUNK, 1, stream) != 0
    assert lib.ce_di_bf16(*head[:5], di.data_ptr(), m, n, 48, stream) != 0
    assert lib.ce_di_bf16(*head[:5], di.data_ptr(), 1 << 31, n, d, stream) != 0  # rows past 32-bit indices
    assert lib.ce_fused_bf16(*head, m, 0, d, softmax_lse.FUSED_BWD_CHUNK, 1, stream) == 0
    assert lib.ce_grads_bf16_smem_bytes(256) <= 232_448 and lib.ce_grads_bf16_smem_bytes(48) == 1
    gz = (s.data_ptr(), items.data_ptr(), z.data_ptr(), ds_part.data_ptr(), di.data_ptr())
    assert lib.grads_z_fused_bf16(*gz, m, n, d, softmax_lse.FUSED_BWD_CHUNK, 1, stream) == 0
    assert lib.grads_z_fused_bf16(*gz, m, n, d, 100, 1, stream) != 0
    assert lib.grads_z_fused_bf16(*gz, m, n, 48, softmax_lse.FUSED_BWD_CHUNK, 1, stream) != 0
    assert lib.grads_z_fused_bf16(*gz, 1 << 31, n, d, softmax_lse.FUSED_BWD_CHUNK, 1, stream) != 0
    torch.cuda.synchronize()
