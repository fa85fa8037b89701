// Streaming logsumexp over an item table and the softmax gradients that go
// with it, float32, without the (M, N) logits ever reaching device memory.
//
// Replaces:
// - rectools_tpu/ops/softmax_lse.py:169 `_lse_fwd_partials_kernel`
//   (`lse_partials_f32`, kernel 6, the default forward): per (item chunk,
//   session tile) the chunk's (max, sum of exp) of s . items^T, written to
//   (n_chunks, M) partials that the caller combines.
// - :127 `_lse_fwd_tail_kernel` (`lse_f32`, kernel 15, `USE_PARTIALS_FWD =
//   False`): one running (max, sum of exp) per row over the whole catalog,
//   merged in the launch (no partials in device memory, no combine launch).
// - :50 `_lse_shift_kernel` (`lse_shift_f32`, kernel 16, `bounded_shift`):
//   l = sum exp(logit - shift) and l2 = sum exp(logit - shift + 64) per (item
//   chunk, session tile) with the caller's per-row shift, no max.
// - :99 `_lse_fwd_kernel` (`lse_bias_f32`, kernel 8): kernel 6 with a bias
//   per item column (0, or -1e30 for the rows that only pad a mesh shard),
//   added to each logit before the chunk's running (max, sum of exp); the
//   same (n_chunks, M) partials, which the caller combines. Each chunk's max
//   starts at -1e30, so an all-invalid slice gives -1e30 + log(count), never
//   NaN; a zero bias gives kernel 6's bits.
// - :643 `_ce_grads_z_fused_kernel` (kernel 7): with P = exp(s items^T - z)
//   and D = coeff * onehot(y), ds = (P - D) items and di = (P - D)^T s, in one
//   pass (`ce_fused_f32`) or in two launches that each recompute the logits
//   (`ce_ds_f32`, `ce_di_f32`: 8 M N D operations for the function's 6).
// - :234 `_bwd_fused_kernel` (`lse_bwd_fused_f32`, kernel 9) and :205
//   `_dsessions_kernel` / :266 `_ditems_kernel` (`lse_bwd_ds_f32` /
//   `lse_bwd_di_f32`, kernels 10, 11): the generic lse VJP, pw =
//   exp((logit + bias[n]) - lse[m]) * dlse[m], dlse of any sign.
// - :591 `_grads_z_fused_kernel` (`grads_z_fused_f32`, kernel 12), :757
//   `_ds_z_kernel` and :774 `_di_z_kernel` (`grads_z_ds_f32` /
//   `grads_z_di_f32`, kernels 13, 14): pw = exp(logit - z[m]), no bias, no
//   multiplier, no label term.
// The three gradient forms are one template (`Form`: kLse, kCE, kZ). In all
// of them session rows past M and item rows past N load as zeros and get pw
// forced to 0 (the NaN rule of softmax_lse.py:636-640: garbage times 0 can
// be NaN); rows with z = +inf (PAD targets, coeff = 0) contribute nothing; an
// item row with bias -1e30 gets exp(-1e30 - lse) = 0, so its di row is 0.
// No float atomics anywhere: every run gives the same bits.
//
// Bound on an H100 at the training shape M = 512 * 100 = 51,200 sessions, N
// = 15,872 items, D = 128: one logit pass is 2 M N D = 208 GFLOP; the
// gradients are three such products (logits, ds, di), 624 GFLOP: 9.31 ms at
// 67 TFLOP/s FP32, or, as 3xTF32 tensor-core products (three TF32 products
// per f32 product), 3 * 624 GFLOP at 495 TFLOP/s = 3.78 ms. The bytes (inputs
// read once, outputs written once) are 0.06 GB, 0.02 ms: operations bound.
// A split kernel does two of the three products: 2.52 ms (3xTF32) or 6.21
// ms (FP32) each at the training shape, 20.8 / 51.3 ms at 131,072 items.
//
// Two tiles.
//
// The tensor-core tile: the gradient kernels for D in {32, 64, 128}, fused
// (7's one pass, 9, 12: `lse_bwd_fused_tc_kernel`) and split (7's two
// launches, 10 + 11, 13 + 14: `grad_ds_tc_kernel`, `grad_di_tc_kernel`;
// below the fused kernel's notes). The JAX reference is f32,
// and plain TF32 keeps about three digits (4.4e-4 of the largest entry at the
// training shape: chip_smoke.py's control), so the products are 3xTF32: each
// f32 operand x splits
// into hi = tf32_rna(x) and lo = tf32_rna(x - hi) (`cvt.rna.tf32.f32`), and
// `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32` accumulates lo*hi, then
// hi*lo, then hi*hi in f32; the dropped lo*lo is ~2^-22 relative.
// - Grid: block (x, y) owns an item chunk of `chunk_rows` (2,048) rows and a
//   group of 128-row session tiles; for each of its session tiles it walks
//   the chunk's 64-row item tiles. One block of 256 threads (8 warps) per
//   SM: 8 chunks x 16 groups = 128 blocks at the training shape, one wave on
//   132 SMs.
// - Per (session tile, item tile) pair, three products: the logits (128 x
//   64, warps 4 x 2, 32 x 32 each), ds += P items (128 x D, warps 2 x 4) into
//   registers that become the ds partial of (chunk, session tile), and di +=
//   P^T s (64 x D, warps 2 x 4) onto the di partial rows of the item tile,
//   which the block alone writes. The probability tile is formed in the
//   logits' accumulator fragments by weighted_probs<F>'s formulas (the kCE
//   label compared as its column in the item tile) and staged in shared
//   memory as its TF32 halves, read as A for ds and as transposed A for di.
// - Stages: the item tiles come by 16-byte `cp.async` into a ring of two,
//   the next tile loading while this pair multiplies; the session tile and
//   the di partial rows by `cp.async` too. Shared memory 231,936 bytes at D =
//   128 (session tile 64 KB, item ring 64 KB, P halves 64 KB, di rows 32 KB,
//   row vectors), under the 232,448 a block can have, so one block per SM.
// - Banks: every staged tile is row-major with rows of a multiple of 32
//   floats and its columns' bits 2-4 XORed by the row (`tc::swz`), so the
//   fragment loads (8 rows x 4 columns, or 4 rows x 8 columns) hit 32
//   distinct banks and 16-byte copies land whole.
// - The di read-modify-write: 128 session rows per read-modify-write halve
//   the SIMT tile's traffic. At the training shape 400 x 248 pairs write a
//   64 x 128 block (32 KB) each and read it back for all but each group's
//   first session tile: 3.25 + 3.12 = 6.4 GB a call, ~1.9 ms at 3.35 TB/s,
//   against 12.7 GB for 64-row tiles; the reads arrive by `cp.async` under
//   the logits and ds products. Partials: ds (8, M, D) and di (16, N, D),
//   210 + 130 = 340 MB (324 MiB), under the 512 MiB budget; the caller sums
//   each over its first axis in a fixed order.
// - Accumulation: the tensor cores' f32 accumulation truncates, so each
//   fragment takes its six products of 16 k in a fresh fragment that a
//   rounded f32 add puts onto the running one (`tc::mma_k16`): 0.7-3.3e-6 of
//   the largest entry from the f32 twin at the training and mesh shapes,
//   against 1.3-3.0e-5 accumulated straight on (which failed the
//   card-vs-CPU fit check); the kernel checks hold the tile to 6e-6. The
//   TF32 rounding is two integer operations, not the conversion instruction
//   (16 a clock per SM).
// - Registers (ptxas -v): 255 at D = 128, 224-229 at 64, 184-186 at 32, no
//   spills; the 16-k loops stay rolled (unrolled, the compiler spilled
//   80-130 bytes at D = 128 and the kernels ran 4-10% slower).
// - What bounds it: issue slots and latency, at 8 warps per SM. Each
//   `mma.sync` comes with ~6 other instructions (the TF32 splits of the item
//   and session fragments, the fresh-fragment adds, fragment loads, address
//   arithmetic, the exp); the kernels run at ~28% of the 3xTF32 rate.
//   `wgmma` and operands split once into shared memory are the next steps.
//
// The split kernels on the same tile, products and fragment layouts (`tc::`
// helpers on pointers, so each kernel has a shared-memory struct of its own):
// - ds (`grad_ds_tc_kernel`): block (x, y) owns the 128-row session tile x
//   and item chunk y, walks the chunk's 64-row item tiles through a ring of
//   two by `cp.async` (the next tile loading under this pair's products),
//   with products 1 (the logits) and 2 (ds += P items, 64 floats a thread at
//   D = 128, in registers), and writes the ds partial of (chunk, session
//   tile); two barriers a pair. The caller plans the chunks
//   (ops/softmax_lse.py `split_bwd_plan`): one block per SM (198,656 bytes of
//   shared memory at D = 128), and one block per session tile would leave
//   the fourth of 3.03 waves to 4 blocks at the training shape, so the
//   catalog is cut into the 1-4 chunks that fill the last wave best: 4 at
//   51,200 rows (400 x 4 = 1,600 blocks, 93% of 13 waves), whatever the
//   catalog, so the partials are 4 M D floats (105 MB at the training
//   width), summed by the caller in a fixed order.
// - di (`grad_di_tc_kernel`): block x owns the 64-row item tile x and walks
//   every 128-row session tile through a ring of two, with products 1 and 3
//   (di += P^T s, 32 floats a thread at D = 128), and writes its di rows: N
//   / 64 blocks, 248 at 15,872 items (2 waves), 2,048 at 131,072 (15.5).
//   Shared memory 231,680 bytes at D = 128 (item tile 32 KB, session ring
//   128 KB, P halves 64 KB, one set of row vectors refilled by `cp.async`
//   once the probability tile that read them is complete: a second set would
//   pass the 232,448-byte limit).
// - Registers (ptxas -v): ds 253 / 177 / 152 at D = 128 / 64 / 32, di 241 /
//   183 / 160, no spills. Accuracy: the ds running sum is 3,968 items long at
//   the training shape and 32,768 at 131,072 (2,048 fresh-fragment adds), di's
//   51,200 sessions; 2.0-4.3e-6 of the twin's largest entry on an H100 at
//   both shapes (limit 6e-6).
// - What bounds them: as the fused kernel, issue slots and latency at 8
//   warps per SM: ~30% of the 3xTF32 rate (8.5-9.2 ms against 2.52 at the
//   training shape; NVIDIA H100 80GB HBM3, 700 W, PERF.md section 6). The
//   pair does four products where the function needs three (the logits
//   twice), which keeps kernel 7's two launches behind one autograd pass of
//   the materialized logits.
//
// Kernels 6 and 8 on the same tile (`lse_partials_tc_kernel`, D in {32, 64,
// 128}; kernel 8 passes its bias, kernel 6 none): product 1 alone, 208 GFLOP
// at the training shape, 1.26 ms in 3xTF32 (3.11 FP32). Block (x, y) owns
// the 128-row session tile x and the item chunk y of
// `chunk_rows` (2,048, as the SIMT kernel's) rows and walks the chunk's item
// tiles through a `cp.async` ring of two; one block of 8 warps per SM
// (131,072 bytes of tiles at D = 128): 8 chunks at the training shape, 3,200
// blocks, the last wave 97% full. The bias of each item tile comes with it
// in the same ring, and each thread reads the bias of its eight columns
// once a tile.
// Each thread folds the four rows of its accumulator fragments
// into running (max, sum of exp) pairs, 36 `expf` an item tile; the four
// threads of a row merge theirs by shuffles, the two warp columns through
// shared memory, once per block. Registers (ptxas -v) 174 / 154 / 144 at D =
// 128 / 64 / 32, no spills. Kernel 6 ran 4.80-4.90 ms at the training shape
// and kernel 8 4.74-4.89 (1.36-1.39 on a (2, 2) mesh's shard, 0.80 on the
// ragged one; NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6), 26% of the
// 3xTF32 rate: bound, as the gradient kernels, by issue slots and latency at
// 8 warps per SM (the operand splits, the exps). Their error from the f32
// twin in the same chunks is ~1e-7 per row; plain TF32 products gave
// 1.6-2.1e-5.
//
// Kernel 15 on the same tile (`lse_partials_tc_kernel<D, kCluster>`, D in {32,
// 64, 128}): one block per 128-row session tile walking the whole catalog
// would give 400 blocks at one block per SM, 3.03 waves in 4 rounds of 248
// item tiles. So a thread-block cluster of C blocks (launched with a cluster
// dimension of (1, C, 1)) shares each session tile, rank q walking the item
// rows [q * rank_rows, (q + 1) * rank_rows) with kernel 6's loop: C = min(8,
// item tiles) and rank_rows = ceil(tiles / C) * 64, a function of N alone
// (ops/softmax_lse.py `lse_cluster_plan`; a rank past the last tile adds
// (-1e30, 0)). Each rank merges its rows' (max, sum of exp) into shared
// memory; after `cluster.sync()` rank 0 reads the other ranks' pairs through
// distributed shared memory in rank order, merges them and writes lse; a
// second `cluster.sync()` keeps every rank resident until it has read. At
// the training shape: 8 ranks of 31 tiles, kernel 6's 3,200 blocks.
// `cudaOccupancyMaxActiveClusters` (tools/ln_lse_check.py) gives 15 clusters
// of 8 at once (120 SMs), 30 of 4, 66 of 2 and 132 of 1. Measured at 51,200
// x 15,872 x 128 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6):
// C = 8 5.22-5.30 ms, 4
// 5.36-5.45, 2 5.33-5.38, one walk (C = 1) 6.03-6.10, the SIMT kernel it
// replaced 9.79-10.07; kernel 6 keeps an 8% lead on its free grid (25 rounds
// of 132 blocks against 27 of 120). 9.5e-8 relative per row from the f32
// twin, plain TF32 1.8-2.0e-5.
//
// Kernel 16 on the same tile (`lse_partials_tc_kernel<D, kShift>`, D in {32,
// 64, 128}): kernel 6's grid, tiles, ring and loop (3,200 blocks at the
// training shape, 8 chunks of 2,048 item rows), with the caller's shift of
// the thread's four fragment rows read once at the start and, per item tile,
// plain sums of expf(x) and expf(x + 64) with x = logit - shift over the
// thread's columns below the chunk's end: no max, no bias, 64 `expf` a
// thread a tile against kernel 6's 36. The end sums the four threads of a
// row by shuffles and adds warp column 1's rows to column 0's: a fixed
// order, the same bits on every run; the caller sums the (n_chunks, M)
// partials of each window over the chunks. A masked column is skipped, never
// added as exp(-1e30 - shift), so a zero session row (shift 0) sums exactly
// N ones. Registers (ptxas -v) 179 / 159 / 149 at D = 128 / 64 / 32, no
// spills. At the training shape it runs at kernel 6's time, 4.95-4.97 ms in
// both windows against the SIMT kernel's 8.29-8.37 (NVIDIA H100 80GB HBM3,
// 700 W; PERF.md section 6): the extra exps cost nothing measurable, and its
// bound is kernel 6's (1.26 ms in 3xTF32, 3.11 FP32).
//
// The SIMT tile: everything else (kernels 6, 8, 15 and 16 and the gradient
// kernels, fused and split, at D = 16 and 256). 256 threads in a 16 x
// 16 grid; a block holds a 64-row session tile and a 64-row item tile whole
// in shared memory (rows padded to D + 1 floats so the per-thread row reads
// are conflict-free) and forms their 64 x 64 logits, each thread a 4 x 4
// micro-tile (rows ty + 16a, columns tx + 16b) with f32 FMA. At 21-25
// TFLOP/s it runs at a third of the FP32 peak.
// - lse_f32 (D = 16, 256): a block owns a session tile and streams every item
//   tile with a running (max, sum of exp) per row; the 16 threads of a row
//   merge theirs by shuffles. 800 blocks at the training shape, 3 or 2
//   resident per SM.
// - lse_partials_f32 / lse_bias_f32 / lse_shift_f32: a block owns (session
//   tile, item chunk of 2,048 rows); blockIdx.x runs over the session tiles,
//   so the blocks in flight share a chunk in L2; 6,400 blocks, 16.2 waves.
// - The split gradient kernels at D = 16 and 256: `grad_ds_kernel` owns a
//   session tile and streams every item tile (ds in registers, one chunk),
//   `grad_di_kernel` owns an item tile and streams every session tile (di in
//   registers); each recomputes the logits.
// - `lse_bwd_fused_kernel` (D = 16, 256): the tensor-core kernel's grid on
//   this tile, 64-row session tiles, two blocks per SM, the di rows read and
//   written in device memory per pair (the swizzle needs rows of 32 floats,
//   and a 128 x 256 ds accumulator would take 128 registers a thread).
// No fast-math: subnormals reach the edge of kernel 16's shift windows.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;  // session rows per tile
constexpr int kBN = 64;  // item rows per tile
constexpr int kThreads = 256;
constexpr float kNegBig = -1e30f;
// kernel 16's second window: its terms scaled by e^64 inside the exp
constexpr float kWindow2Offset = 64.f;

// Which gradient kernels take the tensor-core tile: D in {32, 64, 128}. D =
// 16 has rows under the swizzle's 32 floats; at D = 256 a 128 x 256 ds
// accumulator is 128 registers a thread.
constexpr bool tensor_cores(int d) { return d >= 32 && d <= 128; }

// rows [row0, row0 + 64) of an (R, D) row-major matrix into tile[64][D + 1],
// zeros past R
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, long long row0, long long rows) {
  for (int idx = threadIdx.x; idx < 64 * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4);
    const int c4 = idx - r * (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < rows) v = reinterpret_cast<const float4*>(src + (row0 + r) * D)[c4];
    float* dst = tile + r * (D + 1) + 4 * c4;
    dst[0] = v.x;
    dst[1] = v.y;
    dst[2] = v.z;
    dst[3] = v.w;
  }
}

// acc[a][b] = s_tile[ty + 16a] . i_tile[tx + 16b]
template <int D>
__device__ __forceinline__ void tile_logits(const float* s_tile, const float* i_tile, int ty, int tx,
                                            float acc[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
#pragma unroll 4
  for (int k = 0; k < D; ++k) {
    float sa[4], ib[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) sa[a] = s_tile[(ty + 16 * a) * (D + 1) + k];
#pragma unroll
    for (int b = 0; b < 4; ++b) ib[b] = i_tile[(tx + 16 * b) * (D + 1) + k];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(sa[a], ib[b], acc[a][b]);
  }
}

// fold the columns of one logit tile below `n_end` into each row's running
// (max, sum of exp)
__device__ __forceinline__ void running_update(const float acc[4][4], float m_run[4], float l_run[4], long long n0,
                                               long long n_end, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float mx = m_run[a];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (n0 + tx + 16 * b < n_end) mx = fmaxf(mx, acc[a][b]);
    float l = l_run[a] * expf(m_run[a] - mx);
#pragma unroll
    for (int b = 0; b < 4; ++b)
      if (n0 + tx + 16 * b < n_end) l += expf(acc[a][b] - mx);
    m_run[a] = mx;
    l_run[a] = l;
  }
}

// merge the running (max, sum of exp) of the 16 threads of a row (lanes
// tx = 0..15 of one half warp); every lane ends with the row's pair
__device__ __forceinline__ void running_merge(float& m, float& l) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
    const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
    const float m_new = fmaxf(m, m_o);
    l = l * expf(m - m_new) + l_o * expf(m_o - m_new);
    m = m_new;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    lse_kernel(const float* __restrict__ s, const float* __restrict__ items, float* __restrict__ lse, long long M,
               long long N) {
  extern __shared__ float smem[];
  float* s_tile = smem;
  float* i_tile = smem + kBM * (D + 1);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.x * kBM;
  load_tile<D>(s_tile, s, row0, M);

  float m_run[4], l_run[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    m_run[a] = kNegBig;
    l_run[a] = 0.f;
  }
  for (long long n0 = 0; n0 < N; n0 += kBN) {
    __syncthreads();  // the previous item tile is consumed (and s_tile loaded)
    load_tile<D>(i_tile, items, n0, N);
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(s_tile, i_tile, ty, tx, acc);
    running_update(acc, m_run, l_run, n0, N, tx);
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float m = m_run[a], l = l_run[a];
    running_merge(m, l);
    const long long row = row0 + ty + 16 * a;
    if (tx == 0 && row < M) lse[row] = m + logf(l);
  }
}

// Block (x, y) owns session tile x and item rows [y * chunk_rows, (y + 1) *
// chunk_rows) and writes one partial per row of its tile: out_a and out_b are
// (gridDim.y, M). kShift (kernel 16): out_a = sum exp(logit - shift[m]),
// out_b = sum exp(logit - shift[m] + 64). Otherwise (kernel 6, and kernel 8
// with `bias`, added to each logit column; the bias tile sits behind the
// item tile in shared memory): out_a = the chunk's max logit, out_b = sum
// exp(logit - max).
template <int D, bool kShift>
__global__ void __launch_bounds__(kThreads)
    lse_chunk_kernel(const float* __restrict__ s, const float* __restrict__ items, const float* __restrict__ shift,
                     const float* __restrict__ bias, float* __restrict__ out_a, float* __restrict__ out_b,
                     long long M, long long N, long long chunk_rows) {
  extern __shared__ float smem[];
  float* s_tile = smem;
  float* i_tile = smem + kBM * (D + 1);
  float* bs = i_tile + kBN * (D + 1);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.x * kBM;
  const long long n_begin = (long long)blockIdx.y * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  load_tile<D>(s_tile, s, row0, M);

  float a_run[4], b_run[4], sh[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long row = row0 + ty + 16 * a;
    sh[a] = kShift && row < M ? shift[row] : 0.f;
    a_run[a] = kShift ? 0.f : kNegBig;
    b_run[a] = 0.f;
  }
  for (long long n0 = n_begin; n0 < n_end; n0 += kBN) {
    __syncthreads();  // the previous item tile is consumed (and s_tile loaded)
    load_tile<D>(i_tile, items, n0, n_end);
    if (bias != nullptr && threadIdx.x < kBN) bs[threadIdx.x] = n0 + threadIdx.x < n_end ? bias[n0 + threadIdx.x] : 0.f;
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(s_tile, i_tile, ty, tx, acc);
    if (bias != nullptr) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += bs[tx + 16 * b];
    }
    if (kShift) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (n0 + tx + 16 * b >= n_end) continue;
          const float x = acc[a][b] - sh[a];
          a_run[a] += expf(x);
          b_run[a] += expf(x + kWindow2Offset);
        }
    } else {
      running_update(acc, a_run, b_run, n0, n_end, tx);
    }
  }
  float* __restrict__ a_mine = out_a + (long long)blockIdx.y * M;
  float* __restrict__ b_mine = out_b + (long long)blockIdx.y * M;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float va = a_run[a], vb = b_run[a];
    if (kShift) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        va += __shfl_xor_sync(0xffffffffu, va, off);
        vb += __shfl_xor_sync(0xffffffffu, vb, off);
      }
    } else {
      running_merge(va, vb);
    }
    const long long row = row0 + ty + 16 * a;
    if (tx == 0 && row < M) {
      a_mine[row] = va;
      b_mine[row] = vb;
    }
  }
}

// Shared layout of the gradient kernels: session tile, item tile, the
// weighted probability tile [64][65], then two per-row vectors and the
// per-column bias of the current tiles, then y of the session tile.
template <int D>
constexpr int grad_smem_bytes() {
  return (2 * 64 * (D + 1) + kBM * (kBN + 1) + 2 * kBM + kBN) * (int)sizeof(float) + kBM * (int)sizeof(long long);
}

// The per-row and per-column inputs of a gradient kernel, in its three forms.
// kLse (generic lse VJP): row_a = lse, row_b = dlse, bias per item row.
// kCE (softmax-CE from z): row_a = z, row_b = coeff, y = labels, no bias.
// kZ (softmax from z): row_a = z alone.
enum Form : int { kLse = 0, kCE = 1, kZ = 2 };

struct GradRows {
  const float* row_a;
  const float* row_b;
  const long long* y;
  const float* bias;
};

struct GradSmem {
  float* s_tile;
  float* i_tile;
  float* p_tile;
  float* zs;
  float* cs;
  float* bs;
  long long* ys;
};

template <int D>
__device__ __forceinline__ GradSmem grad_smem(float* smem) {
  GradSmem sh;
  sh.s_tile = smem;
  sh.i_tile = sh.s_tile + kBM * (D + 1);
  sh.p_tile = sh.i_tile + kBN * (D + 1);
  sh.zs = sh.p_tile + kBM * (kBN + 1);
  sh.cs = sh.zs + kBM;
  sh.bs = sh.cs + kBM;
  sh.ys = reinterpret_cast<long long*>(sh.bs + kBN);
  return sh;
}

// row vectors of session rows [row0, row0 + kRows); rows past M get row_a =
// +inf and row_b = 0, so their probabilities and label terms vanish
template <int F, int kRows, class Label>
__device__ __forceinline__ void load_row_vectors(float* zs, float* cs, Label* ys, const GradRows& in,
                                                 long long row0, long long M) {
  for (int r = threadIdx.x; r < kRows; r += blockDim.x) {
    const bool ok = row0 + r < M;
    zs[r] = ok ? in.row_a[row0 + r] : INFINITY;
    if (F != kZ) cs[r] = ok ? in.row_b[row0 + r] : 0.f;
    if (F == kCE) ys[r] = ok ? (Label)in.y[row0 + r] : (Label)-1;
  }
}

template <int F>
__device__ __forceinline__ void load_rows(const GradSmem& sh, const GradRows& in, long long row0, long long M) {
  load_row_vectors<F, kBM>(sh.zs, sh.cs, sh.ys, in, row0, M);
}

// bias of item rows [n0, n0 + 64), 0 past N (those columns are forced to 0)
template <int F>
__device__ __forceinline__ void load_cols(const GradSmem& sh, const GradRows& in, long long n0, long long N) {
  if (F != kLse) return;
  for (int c = threadIdx.x; c < kBN; c += kThreads) sh.bs[c] = n0 + c < N ? in.bias[n0 + c] : 0.f;
}

// kCE:  p_tile[row][col] = exp(logit - z) - coeff * [col == y]
// kZ:   p_tile[row][col] = exp(logit - z)
// kLse: p_tile[row][col] = exp((logit + bias) - lse) * dlse
// and 0 for columns past N and rows past M
template <int F>
__device__ __forceinline__ void weighted_probs(const float acc[4][4], const GradSmem& sh, long long row0,
                                               long long M, long long n0, long long N, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b;
      const long long col = n0 + c;
      float pw = 0.f;
      if (col < N && row0 + r < M) {
        if (F == kLse) {
          pw = expf((acc[a][b] + sh.bs[c]) - sh.zs[r]) * sh.cs[r];
        } else {
          pw = expf(acc[a][b] - sh.zs[r]);
          if (F == kCE && col == sh.ys[r]) pw -= sh.cs[r];
        }
      }
      sh.p_tile[r * (kBN + 1) + c] = pw;
    }
  }
}

// out[a][c] += sum_n p_tile[ty + 16a][n] * i_tile[n][tx + 16c]
template <int D>
__device__ __forceinline__ void accumulate_ds(const GradSmem& sh, int ty, int tx, float out[4][(D + 15) / 16]) {
  constexpr int kC = (D + 15) / 16;
#pragma unroll 2
  for (int n = 0; n < kBN; ++n) {
    float pa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[a] = sh.p_tile[(ty + 16 * a) * (kBN + 1) + n];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      const float iv = col < D ? sh.i_tile[n * (D + 1) + col] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) out[a][c] = fmaf(pa[a], iv, out[a][c]);
    }
  }
}

// out[a][c] += sum_m p_tile[m][ty + 16a] * s_tile[m][tx + 16c]
template <int D>
__device__ __forceinline__ void accumulate_di(const GradSmem& sh, int ty, int tx, float out[4][(D + 15) / 16]) {
  constexpr int kC = (D + 15) / 16;
#pragma unroll 2
  for (int m = 0; m < kBM; ++m) {
    float pa[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) pa[a] = sh.p_tile[m * (kBN + 1) + ty + 16 * a];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      const float sv = col < D ? sh.s_tile[m * (D + 1) + col] : 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) out[a][c] = fmaf(pa[a], sv, out[a][c]);
    }
  }
}

template <int D>
__device__ __forceinline__ void zero_out(float out[4][(D + 15) / 16]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < (D + 15) / 16; ++c) out[a][c] = 0.f;
}

// rows row0 + ty + 16a (below `rows`) of a (rows, D) matrix <- out
template <int D>
__device__ __forceinline__ void store_rows(float* __restrict__ dst, const float out[4][(D + 15) / 16],
                                           long long row0, long long rows, int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long row = row0 + ty + 16 * a;
    if (row >= rows) continue;
#pragma unroll
    for (int c = 0; c < (D + 15) / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < D) dst[row * D + col] = out[a][c];
    }
  }
}

template <int D, int F>
__global__ void __launch_bounds__(kThreads)
    grad_ds_kernel(const float* __restrict__ s, const float* __restrict__ items, GradRows in,
                   float* __restrict__ ds, long long M, long long N) {
  extern __shared__ float smem[];
  const GradSmem sh = grad_smem<D>(smem);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.x * kBM;
  load_tile<D>(sh.s_tile, s, row0, M);
  load_rows<F>(sh, in, row0, M);

  float out[4][(D + 15) / 16];
  zero_out<D>(out);
  for (long long n0 = 0; n0 < N; n0 += kBN) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<D>(sh.i_tile, items, n0, N);
    load_cols<F>(sh, in, n0, N);
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(sh.s_tile, sh.i_tile, ty, tx, acc);
    weighted_probs<F>(acc, sh, row0, M, n0, N, ty, tx);
    __syncthreads();
    accumulate_ds<D>(sh, ty, tx, out);
  }
  store_rows<D>(ds, out, row0, M, ty, tx);
}

template <int D, int F>
__global__ void __launch_bounds__(kThreads)
    grad_di_kernel(const float* __restrict__ s, const float* __restrict__ items, GradRows in,
                   float* __restrict__ di, long long M, long long N) {
  extern __shared__ float smem[];
  const GradSmem sh = grad_smem<D>(smem);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long n0 = (long long)blockIdx.x * kBN;
  load_tile<D>(sh.i_tile, items, n0, N);
  load_cols<F>(sh, in, n0, N);

  float out[4][(D + 15) / 16];  // items ty + 16a, dims tx + 16c
  zero_out<D>(out);
  for (long long row0 = 0; row0 < M; row0 += kBM) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<D>(sh.s_tile, s, row0, M);
    load_rows<F>(sh, in, row0, M);
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(sh.s_tile, sh.i_tile, ty, tx, acc);
    weighted_probs<F>(acc, sh, row0, M, n0, N, ty, tx);
    __syncthreads();
    accumulate_di<D>(sh, ty, tx, out);
  }
  store_rows<D>(di, out, n0, N, ty, tx);
}

// Both gradients from one logit pass, of the biased lse (kLse) or of the
// softmax from z (kZ). Block (x, y) owns item rows [x * chunk_rows, (x + 1) *
// chunk_rows) and session tiles [y * tiles_per_group, (y + 1) *
// tiles_per_group). ds_part is (gridDim.x, M, D), di_part is (gridDim.y, N,
// D); every element of both is written.
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
    lse_bwd_fused_kernel(const float* __restrict__ s, const float* __restrict__ items, GradRows in,
                         float* __restrict__ ds_part, float* __restrict__ di_part, long long M, long long N,
                         long long chunk_rows, long long tiles_per_group) {
  extern __shared__ float smem[];
  const GradSmem sh = grad_smem<D>(smem);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long n_begin = (long long)blockIdx.x * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  const long long m_tiles = (M + kBM - 1) / kBM;
  const long long t_begin = (long long)blockIdx.y * tiles_per_group;
  const long long t_end = t_begin + tiles_per_group < m_tiles ? t_begin + tiles_per_group : m_tiles;
  float* __restrict__ ds_mine = ds_part + (long long)blockIdx.x * M * D;
  float* __restrict__ di_mine = di_part + (long long)blockIdx.y * N * D;

  for (long long t = t_begin; t < t_end; ++t) {
    const long long row0 = t * kBM;
    __syncthreads();  // the previous session tile is consumed
    load_tile<D>(sh.s_tile, s, row0, M);
    load_rows<F>(sh, in, row0, M);
    float out[4][(D + 15) / 16];
    zero_out<D>(out);
    for (long long n0 = n_begin; n0 < n_end; n0 += kBN) {
      __syncthreads();  // the previous item and probability tiles are consumed
      load_tile<D>(sh.i_tile, items, n0, n_end);
      load_cols<F>(sh, in, n0, n_end);
      __syncthreads();
      float acc[4][4];
      tile_logits<D>(sh.s_tile, sh.i_tile, ty, tx, acc);
      weighted_probs<F>(acc, sh, row0, M, n0, n_end, ty, tx);
      __syncthreads();
      accumulate_ds<D>(sh, ty, tx, out);
      float di_tile[4][(D + 15) / 16];
      zero_out<D>(di_tile);
      accumulate_di<D>(sh, ty, tx, di_tile);
      // this block alone writes these rows of its di partial: plain
      // read-modify-write, in session-tile order
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const long long item = n0 + ty + 16 * a;
        if (item >= n_end) continue;
#pragma unroll
        for (int c = 0; c < (D + 15) / 16; ++c) {
          const int col = tx + 16 * c;
          if (col >= D) continue;
          float* p = di_mine + item * D + col;
          *p = t == t_begin ? di_tile[a][c] : *p + di_tile[a][c];
        }
      }
    }
    store_rows<D>(ds_mine, out, row0, M, ty, tx);
  }
}

// ---------------------------------------------------------------- the tensor-core tile

#include "tc_tile.cuh"

namespace tc {

constexpr int kBM = 128;       // session rows per tile
constexpr int kBN = 64;        // item rows per tile
constexpr int kThreads = 256;  // 8 warps

// The block's shared memory: the session tile, a ring of two item tiles,
// the probability tile split into its TF32 halves, the di partial rows of
// the item tile as the earlier session tiles left them, the row vectors of
// the session tile and the bias of each item tile. 231,936 bytes at D = 128
// (the limit is 232,448).
template <int D>
struct Smem {
  float s[kBM * D];
  float items[2][kBN * D];
  uint32_t p_hi[kBM * kBN];
  uint32_t p_lo[kBM * kBN];
  float di[kBN * D];
  float zs[kBM];
  float cs[kBM];
  int ys[kBM];  // the label, < N < 2^31 (ce_fused_f32 checks)
  float bs[2][kBN];
};

// The split ds kernel's: the session tile, a ring of two item tiles, the
// probability tile's halves, the session tile's row vectors, each item
// tile's bias. 198,656 bytes at D = 128.
template <int D>
struct SplitDsSmem {
  float s[kBM * D];
  float items[2][kBN * D];
  uint32_t p_hi[kBM * kBN];
  uint32_t p_lo[kBM * kBN];
  float zs[kBM];
  float cs[kBM];
  int ys[kBM];  // the label, < N < 2^31 (ce_ds_f32 checks)
  float bs[2][kBN];
};

// The split di kernel's: the block's item tile and its bias, a ring of two
// session tiles, the probability tile's halves, and one set of row vectors,
// refilled by cp.async once the probability tile that read them is complete
// (two sets would pass the limit). 231,680 bytes at D = 128 (the limit is
// 232,448).
template <int D>
struct SplitDiSmem {
  float items[kBN * D];
  float s[2][kBM * D];
  uint32_t p_hi[kBM * kBN];
  uint32_t p_lo[kBM * kBN];
  float zs[kBM];
  float cs[kBM];
  long long ys[kBM];  // the label as the caller gave it (int64, copied whole)
  float bs[kBN];
};

// row vectors of session rows [row0, row0 + kBM) by cp.async (zeros past M,
// where the probability tile is forced to 0 anyway)
template <int F>
__device__ __forceinline__ void load_row_vectors_async(float* zs, float* cs, long long* ys, const GradRows& in,
                                                       long long row0, long long M) {
  const int r = threadIdx.x;
  if (r >= kBM) return;
  const bool ok = row0 + r < M;
  const long long src = ok ? row0 + r : 0;
  cp_async4(&zs[r], in.row_a + src, ok);
  if (F != kZ) cp_async4(&cs[r], in.row_b + src, ok);
  if (F == kCE) cp_async8(&ys[r], in.y + src, ok);
}

// rows [row0, row0 + kRows) of an (R, D) row-major matrix into a swizzled
// tile by cp.async, zeros past `rows`
template <int D, int kRows>
__device__ __forceinline__ void load_tile(float* tile, const float* __restrict__ src, long long row0, long long rows) {
  static_assert(kRows * (D / 4) % kThreads == 0, "whole copies per thread");
#pragma unroll
  for (int i = 0; i < kRows * (D / 4) / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = idx / (D / 4);
    const int c = 4 * (idx % (D / 4));
    const bool ok = row0 + r < rows;
    cp_async16(tile + at<D>(r, c), ok ? src + (row0 + r) * D + c : src, ok);
  }
}

// the bias of item rows [n0, n0 + kBN) by cp.async, 0 past n_end
__device__ __forceinline__ void load_bias(float* bs, const float* __restrict__ bias, long long n0, long long n_end) {
  if (threadIdx.x < kBN) {
    const bool ok = n0 + threadIdx.x < n_end;
    cp_async4(&bs[threadIdx.x], ok ? bias + n0 + threadIdx.x : bias, ok);
  }
}

// an item tile and, for kLse, its bias by cp.async
template <int D, int F>
__device__ __forceinline__ void load_items(float* tile, float* bs, const float* __restrict__ items,
                                           const GradRows& in, long long n0, long long n_end) {
  load_tile<D, kBN>(tile, items, n0, n_end);
  if (F == kLse) load_bias(bs, in.bias, n0, n_end);
}

// Product 1, the logits of the tile pair: 128 x 64 over D. Warp w owns rows
// 32 (w >> 1) + [0, 32) and columns 32 (w & 1) + [0, 32): 2 x 4 fragments.
template <int D>
__device__ __forceinline__ void logits(const float* s_tile, const float* it, float acc[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int m_base = (warp >> 1) * 32, n_base = (warp & 1) * 32;
  // ldmatrix rows: block j = lane / 8 is rows + 8 (j & 1), columns + 4 (j >> 1)
  // of an A fragment; rows + 8 (j >> 1), columns + 4 (j & 1) of two B fragments
  const int blk = lane >> 3, row = lane & 7;
  const int a_row = m_base + row + 8 * (blk & 1), a_col = 4 * (blk >> 1);
  const int b_row = n_base + row + 8 * (blk >> 1), b_col = 4 * (blk & 1);
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < 4; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
  const auto load_a = [&](int mf, int k, uint32_t ah[4], uint32_t al[4]) {
    uint32_t raw[4];
    ldsm_x4(raw, &s_tile[at<D>(a_row + mf * 16, k + a_col)]);
#pragma unroll
    for (int e = 0; e < 4; ++e) split(__uint_as_float(raw[e]), ah[e], al[e]);
  };
  const auto load_b = [&](int k, uint32_t bh[4][2], uint32_t bl[4][2]) {
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t raw[4];
      ldsm_x4(raw, &it[at<D>(b_row + np * 16, k + b_col)]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nf = 2 * np + (e >> 1);  // blocks: fragment nf's b0, b1, then fragment nf + 1's
        split(__uint_as_float(raw[e]), bh[nf][e & 1], bl[nf][e & 1]);
      }
    }
  };
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += 16) mma_k16<2, 4>(acc, k0, load_a, load_b);
}

// The weighted probability tile from the logits in the accumulator
// fragments, by weighted_probs<F>'s formulas (0 past n_end and past M), into
// shared memory as its TF32 halves. zs, cs, ys: the session tile's row
// vectors; bs: the item tile's bias.
template <int F, class Label>
__device__ __forceinline__ void probs(uint32_t* p_hi, uint32_t* p_lo, const float* zs, const float* cs,
                                      const Label* ys, const float* bs, const float acc[2][4][4], long long row0,
                                      long long M, long long n0, long long n_end) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m_base = (warp >> 1) * 32, n_base = (warp & 1) * 32;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m_base + mf * 16 + g + 8 * h;
      const bool row_ok = row0 + r < M;
      const int label = F == kCE ? (int)(ys[r] - n0) : -1;  // its column in the tile
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        const int c = n_base + nf * 8 + 2 * t;
        uint32_t hi[2], lo[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const long long col = n0 + c + e;
          const float logit = acc[mf][nf][2 * h + e];
          float pw = 0.f;
          if (row_ok && col < n_end) {
            if (F == kLse) {
              pw = expf((logit + bs[c + e]) - zs[r]) * cs[r];
            } else {
              pw = expf(logit - zs[r]);
              if (F == kCE && c + e == label) pw -= cs[r];
            }
          }
          split(pw, hi[e], lo[e]);
        }
        *reinterpret_cast<uint2*>(&p_hi[at<kBN>(r, c)]) = make_uint2(hi[0], hi[1]);
        *reinterpret_cast<uint2*>(&p_lo[at<kBN>(r, c)]) = make_uint2(lo[0], lo[1]);
      }
    }
}

// Product 2, ds += P items: 128 x D over the 64 items. Warp w owns rows
// 64 (w >> 2) + [0, 64) and columns D/4 (w & 3) + [0, D/4): 4 x D/32
// fragments.
template <int D>
__device__ __forceinline__ void accumulate_ds(const uint32_t* p_hi, const uint32_t* p_lo, const float* it,
                                              float acc[4][D / 32][4]) {
  constexpr int kNF = D / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m_base = (warp >> 2) * 64, n_base = (warp & 3) * (D / 4);
  const int blk = lane >> 3;
  const int a_row = m_base + (lane & 7) + 8 * (blk & 1), a_col = 4 * (blk >> 1);
  const auto load_a = [&](int mf, int k, uint32_t ah[4], uint32_t al[4]) {
    ldsm_x4(ah, &p_hi[at<kBN>(a_row + mf * 16, k + a_col)]);
    ldsm_x4(al, &p_lo[at<kBN>(a_row + mf * 16, k + a_col)]);
  };
  const auto load_b = [&](int k, uint32_t bh[kNF][2], uint32_t bl[kNF][2]) {
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf) {
      const int n = n_base + nf * 8 + g;
      split(it[at<D>(k + t, n)], bh[nf][0], bl[nf][0]);
      split(it[at<D>(k + t + 4, n)], bh[nf][1], bl[nf][1]);
    }
  };
#pragma unroll 1
  for (int k0 = 0; k0 < kBN; k0 += 16) mma_k16<4, kNF>(acc, k0, load_a, load_b);
}

// Product 3, di += P^T s: 64 x D over the 128 sessions, P read transposed.
// Warp w owns item rows 32 (w >> 2) + [0, 32) and columns D/4 (w & 3) +
// [0, D/4): 2 x D/32 fragments.
template <int D>
__device__ __forceinline__ void accumulate_di(const uint32_t* p_hi, const uint32_t* p_lo, const float* s_tile,
                                              float acc[2][D / 32][4]) {
  constexpr int kNF = D / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int i_base = (warp >> 2) * 32, n_base = (warp & 3) * (D / 4);
  const auto load_a = [&](int mf, int k, uint32_t ah[4], uint32_t al[4]) {
    const int i = i_base + mf * 16 + g;
    const int idx[4] = {at<kBN>(k + t, i), at<kBN>(k + t, i + 8), at<kBN>(k + t + 4, i), at<kBN>(k + t + 4, i + 8)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ah[e] = p_hi[idx[e]];
      al[e] = p_lo[idx[e]];
    }
  };
  const auto load_b = [&](int k, uint32_t bh[kNF][2], uint32_t bl[kNF][2]) {
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf) {
      const int n = n_base + nf * 8 + g;
      split(s_tile[at<D>(k + t, n)], bh[nf][0], bl[nf][0]);
      split(s_tile[at<D>(k + t + 4, n)], bh[nf][1], bl[nf][1]);
    }
  };
#pragma unroll 1
  for (int k0 = 0; k0 < kBM; k0 += 16) mma_k16<2, kNF>(acc, k0, load_a, load_b);
}

}  // namespace tc

// lse_bwd_fused_kernel's grid and outputs on the tensor-core tile: block (x,
// y) owns item rows [x * chunk_rows, (x + 1) * chunk_rows) and 128-row
// session tiles [y * tiles_per_group, (y + 1) * tiles_per_group). Per
// (session tile, item tile) pair: the logits, the probability tile, ds += P
// items into registers and di += P^T s onto the di partial rows, which this
// thread alone reads and writes. D in {32, 64, 128}.
template <int D, int F>
__global__ void __launch_bounds__(tc::kThreads, 1)
    lse_bwd_fused_tc_kernel(const float* __restrict__ s, const float* __restrict__ items, GradRows in,
                            float* __restrict__ ds_part, float* __restrict__ di_part, long long M, long long N,
                            long long chunk_rows, long long tiles_per_group) {
  constexpr int kNF = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::Smem<D>& sh = *reinterpret_cast<tc::Smem<D>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long n_begin = (long long)blockIdx.x * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  const int n_tiles = (int)((n_end - n_begin + tc::kBN - 1) / tc::kBN);
  const long long m_tiles = (M + tc::kBM - 1) / tc::kBM;
  const long long t_begin = (long long)blockIdx.y * tiles_per_group;
  const long long t_end = t_begin + tiles_per_group < m_tiles ? t_begin + tiles_per_group : m_tiles;
  float* __restrict__ ds_mine = ds_part + (long long)blockIdx.x * M * D;
  float* __restrict__ di_mine = di_part + (long long)blockIdx.y * N * D;
  // the fragment rows and columns of products 2 (ds) and 3 (di)
  const int ds_row = (warp >> 2) * 64 + g, di_row = (warp >> 2) * 32 + g, col0 = (warp & 3) * (D / 4) + 2 * t;

  tc::load_tile<D, tc::kBM>(sh.s, s, t_begin * tc::kBM, M);
  tc::load_items<D, F>(sh.items[0], sh.bs[0], items, in, n_begin, n_end);
  tc::cp_commit();
  load_row_vectors<F, tc::kBM>(sh.zs, sh.cs, sh.ys, in, t_begin * tc::kBM, M);
  int stage = 0;
  for (long long tile = t_begin; tile < t_end; ++tile) {
    const long long row0 = tile * tc::kBM;
    float ds_acc[4][kNF][4];
#pragma unroll
    for (int mf = 0; mf < 4; ++mf)
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds_acc[mf][nf][e] = 0.f;
    for (int j = 0; j < n_tiles; ++j) {
      const long long n0 = n_begin + (long long)j * tc::kBN;
      tc::cp_wait<0>();
      __syncthreads();  // this stage's item tile (and the session tile) landed; the last pair's reads are done
      // the di partial rows of this item tile as the earlier session tiles
      // left them (this block alone writes them; the barriers since order
      // the writes before these reads), then the next item tile into the
      // other stage: tile j + 1, or tile 0 of the next session tile
      if (tile > t_begin) tc::load_tile<D, tc::kBN>(sh.di, di_mine, n0, n_end);
      tc::cp_commit();
      if (j + 1 < n_tiles)
        tc::load_items<D, F>(sh.items[stage ^ 1], sh.bs[stage ^ 1], items, in, n0 + tc::kBN, n_end);
      else if (tile + 1 < t_end)
        tc::load_items<D, F>(sh.items[stage ^ 1], sh.bs[stage ^ 1], items, in, n_begin, n_end);
      tc::cp_commit();
      {
        float acc[2][4][4];
        tc::logits<D>(sh.s, sh.items[stage], acc);
        tc::probs<F>(sh.p_hi, sh.p_lo, sh.zs, sh.cs, sh.ys, sh.bs[stage], acc, row0, M, n0, n_end);
      }
      tc::cp_wait<1>();  // the di rows landed (the item prefetch may still fly)
      __syncthreads();   // and the probability tile is complete
      tc::accumulate_ds<D>(sh.p_hi, sh.p_lo, sh.items[stage], ds_acc);
      float di_acc[2][kNF][4];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = di_row + mf * 16 + 8 * h;
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf) {
            float2 v = make_float2(0.f, 0.f);
            if (tile > t_begin) v = *reinterpret_cast<const float2*>(&sh.di[tc::at<D>(r, col0 + nf * 8)]);
            di_acc[mf][nf][2 * h] = v.x;
            di_acc[mf][nf][2 * h + 1] = v.y;
          }
        }
      tc::accumulate_di<D>(sh.p_hi, sh.p_lo, sh.s, di_acc);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const long long item = n0 + di_row + mf * 16 + 8 * h;
          if (item >= n_end) continue;
#pragma unroll
          for (int nf = 0; nf < kNF; ++nf)
            *reinterpret_cast<float2*>(di_mine + item * D + col0 + nf * 8) =
                make_float2(di_acc[mf][nf][2 * h], di_acc[mf][nf][2 * h + 1]);
        }
      stage ^= 1;
    }
    // the ds partial of (item chunk, session tile)
#pragma unroll
    for (int mf = 0; mf < 4; ++mf)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long row = row0 + ds_row + mf * 16 + 8 * h;
        if (row >= M) continue;
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf)
          *reinterpret_cast<float2*>(ds_mine + row * D + col0 + nf * 8) =
              make_float2(ds_acc[mf][nf][2 * h], ds_acc[mf][nf][2 * h + 1]);
      }
    if (tile + 1 < t_end) {
      __syncthreads();  // product 3 and the last probability tile are done with the session rows
      tc::load_tile<D, tc::kBM>(sh.s, s, row0 + tc::kBM, M);
      tc::cp_commit();
      load_row_vectors<F, tc::kBM>(sh.zs, sh.cs, sh.ys, in, row0 + tc::kBM, M);
    }
  }
}

// The split ds kernel on the tensor-core tile (D in {32, 64, 128}): block (x,
// y) owns the 128-row session tile x and the item rows [y * chunk_rows, (y +
// 1) * chunk_rows), walks the chunk's 64-row item tiles (a ring of two by
// cp.async) with products 1 (the logits) and 2 (ds += P items, in
// registers), and writes its rows of the ds partial y: ds_part is
// (gridDim.y, M, D), every element written.
template <int D, int F>
__global__ void __launch_bounds__(tc::kThreads, 1)
    grad_ds_tc_kernel(const float* __restrict__ s, const float* __restrict__ items, GradRows in,
                      float* __restrict__ ds_part, long long M, long long N, long long chunk_rows) {
  constexpr int kNF = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::SplitDsSmem<D>& sh = *reinterpret_cast<tc::SplitDsSmem<D>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * tc::kBM;
  const long long n_begin = (long long)blockIdx.y * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  const int n_tiles = (int)((n_end - n_begin + tc::kBN - 1) / tc::kBN);
  float* __restrict__ ds_mine = ds_part + (long long)blockIdx.y * M * D;
  const int ds_row = (warp >> 2) * 64 + g, col0 = (warp & 3) * (D / 4) + 2 * t;

  tc::load_tile<D, tc::kBM>(sh.s, s, row0, M);
  tc::load_items<D, F>(sh.items[0], sh.bs[0], items, in, n_begin, n_end);
  tc::cp_commit();
  load_row_vectors<F, tc::kBM>(sh.zs, sh.cs, sh.ys, in, row0, M);
  float ds_acc[4][kNF][4];
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds_acc[mf][nf][e] = 0.f;
  int stage = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const long long n0 = n_begin + (long long)j * tc::kBN;
    tc::cp_wait<0>();
    __syncthreads();  // item tile j (and the session tile) landed; the last pair's reads of P and of the other stage are done
    if (j + 1 < n_tiles) tc::load_items<D, F>(sh.items[stage ^ 1], sh.bs[stage ^ 1], items, in, n0 + tc::kBN, n_end);
    tc::cp_commit();
    {
      float acc[2][4][4];
      tc::logits<D>(sh.s, sh.items[stage], acc);
      tc::probs<F>(sh.p_hi, sh.p_lo, sh.zs, sh.cs, sh.ys, sh.bs[stage], acc, row0, M, n0, n_end);
    }
    __syncthreads();  // the probability tile is complete
    tc::accumulate_ds<D>(sh.p_hi, sh.p_lo, sh.items[stage], ds_acc);
    stage ^= 1;
  }
#pragma unroll
  for (int mf = 0; mf < 4; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + ds_row + mf * 16 + 8 * h;
      if (row >= M) continue;
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf)
        *reinterpret_cast<float2*>(ds_mine + row * D + col0 + nf * 8) =
            make_float2(ds_acc[mf][nf][2 * h], ds_acc[mf][nf][2 * h + 1]);
    }
}

// The split di kernel on the tensor-core tile (D in {32, 64, 128}): block x
// owns the 64-row item tile x, walks every 128-row session tile (a ring of
// two by cp.async, the row vectors refilled behind the probability tile)
// with products 1 (the logits) and 3 (di += P^T s, in registers), and writes
// its di rows.
template <int D, int F>
__global__ void __launch_bounds__(tc::kThreads, 1)
    grad_di_tc_kernel(const float* __restrict__ s, const float* __restrict__ items, GradRows in,
                      float* __restrict__ di, long long M, long long N) {
  constexpr int kNF = D / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  tc::SplitDiSmem<D>& sh = *reinterpret_cast<tc::SplitDiSmem<D>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long n0 = (long long)blockIdx.x * tc::kBN;
  const long long m_tiles = (M + tc::kBM - 1) / tc::kBM;
  const int di_row = (warp >> 2) * 32 + g, col0 = (warp & 3) * (D / 4) + 2 * t;

  tc::load_items<D, F>(sh.items, sh.bs, items, in, n0, N);
  tc::load_tile<D, tc::kBM>(sh.s[0], s, 0, M);
  tc::load_row_vectors_async<F>(sh.zs, sh.cs, sh.ys, in, 0, M);
  tc::cp_commit();
  float di_acc[2][kNF][4];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) di_acc[mf][nf][e] = 0.f;
  int stage = 0;
  for (long long tile = 0; tile < m_tiles; ++tile) {
    const long long row0 = tile * tc::kBM;
    tc::cp_wait<0>();
    __syncthreads();  // session tile `tile` and its row vectors landed; the last pair's reads of P and of the other stage are done
    if (tile + 1 < m_tiles) tc::load_tile<D, tc::kBM>(sh.s[stage ^ 1], s, row0 + tc::kBM, M);
    tc::cp_commit();
    {
      float acc[2][4][4];
      tc::logits<D>(sh.s[stage], sh.items, acc);
      tc::probs<F>(sh.p_hi, sh.p_lo, sh.zs, sh.cs, sh.ys, sh.bs, acc, row0, M, n0, N);
    }
    __syncthreads();  // the probability tile is complete and the row vectors are read
    if (tile + 1 < m_tiles) tc::load_row_vectors_async<F>(sh.zs, sh.cs, sh.ys, in, row0 + tc::kBM, M);
    tc::cp_commit();
    tc::accumulate_di<D>(sh.p_hi, sh.p_lo, sh.s[stage], di_acc);
    stage ^= 1;
  }
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long item = n0 + di_row + mf * 16 + 8 * h;
      if (item >= N) continue;
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf)
        *reinterpret_cast<float2*>(di + item * D + col0 + nf * 8) =
            make_float2(di_acc[mf][nf][2 * h], di_acc[mf][nf][2 * h + 1]);
    }
}

// Kernel 6's, 8's, 15's and 16's shared memory: the session tile, a ring of
// two item tiles with their bias (kernel 8) and warp column 1's row pairs for
// the merge at the end. 131,072 bytes of tiles at D = 128.
template <int D>
struct LseSmem {
  float s[tc::kBM * D];
  float items[2][tc::kBN * D];
  float bs[2][tc::kBN];
  float a_half[tc::kBM];
  float b_half[tc::kBM];
};

// What lse_partials_tc_kernel computes per row: each item chunk's (max, sum
// of exp) partials (kernels 6 and 8), lse through a cluster of blocks
// (kernel 15), or each item chunk's sums of the two shifted windows (kernel
// 16).
enum class LseMode { kPartials, kCluster, kShift };

// Kernels 6, 8, 15 and 16 on the tensor-core tile (D in {32, 64, 128}):
// block (x, y) owns the 128-row session tile x and item rows [y *
// chunk_rows, (y + 1) * chunk_rows), walks the chunk's 64-row item tiles
// (and, for kernel 8, their bias) through a ring of two by cp.async with
// product 1 (the logits, 3xTF32) and folds each tile into a pair per row for
// the four rows its accumulator fragments hold (columns past the chunk's end
// left out). At the end the four threads of a row merge theirs by shuffles
// and the two warp columns through shared memory; out_a and out_b are
// (gridDim.y, M), rows past M never written.
// - kPartials (kernels 6 and 8): the bias (kernel 8; 0 without one) added to
//   each logit, a running (max, sum of exp) from -1e30; out_a the chunk's
//   max, out_b its sum of exp(logit - max).
// - kCluster (kernel 15): the gridDim.y blocks of a session tile are one
//   cluster, y its rank and chunk_rows a rank's item rows; rank 0 merges the
//   ranks' (max, sum of exp) and writes lse (M,) to out_a; out_b is unused.
// - kShift (kernel 16): x = logit - shift[m] with the caller's per-row shift
//   (0 past M), out_a = sum exp(x) and out_b = sum exp(x + 64), plain sums in
//   a fixed order (each thread's columns tile by tile, the four threads of a
//   row, then warp column 0 plus column 1); no max, no bias.
template <int D, LseMode kMode = LseMode::kPartials>
__global__ void __launch_bounds__(tc::kThreads, 1)
    lse_partials_tc_kernel(const float* __restrict__ s, const float* __restrict__ items,
                           const float* __restrict__ shift, const float* __restrict__ bias,
                           float* __restrict__ out_a, float* __restrict__ out_b, long long M, long long N,
                           long long chunk_rows) {
  constexpr bool kShift = kMode == LseMode::kShift;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LseSmem<D>& sh = *reinterpret_cast<LseSmem<D>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const long long row0 = (long long)blockIdx.x * tc::kBM;
  const long long n_begin = (long long)blockIdx.y * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  const int n_tiles = (int)((n_end - n_begin + tc::kBN - 1) / tc::kBN);
  // the fragment rows (mf, h) and columns of product 1 (tc::logits)
  const int m_base = (warp >> 1) * 32, n_base = (warp & 1) * 32;

  tc::load_tile<D, tc::kBM>(sh.s, s, row0, M);
  tc::load_tile<D, tc::kBN>(sh.items[0], items, n_begin, n_end);
  if (bias != nullptr) tc::load_bias(sh.bs[0], bias, n_begin, n_end);
  tc::cp_commit();
  // per fragment row: (max, sum of exp), or kShift (sum of window 1, of window 2) and the row's shift
  float a_run[2][2], b_run[2][2], row_shift[2][2];
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long row = row0 + m_base + mf * 16 + g + 8 * h;
      row_shift[mf][h] = kShift && row < M ? shift[row] : 0.f;
      a_run[mf][h] = kShift ? 0.f : kNegBig;
      b_run[mf][h] = 0.f;
    }
  int stage = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const long long n0 = n_begin + (long long)j * tc::kBN;
    tc::cp_wait<0>();
    __syncthreads();  // item tile j (and the session tile) landed; every warp is done with the other stage
    if (j + 1 < n_tiles) {
      tc::load_tile<D, tc::kBN>(sh.items[stage ^ 1], items, n0 + tc::kBN, n_end);
      if (bias != nullptr) tc::load_bias(sh.bs[stage ^ 1], bias, n0 + tc::kBN, n_end);
    }
    tc::cp_commit();
    float acc[2][4][4];
    tc::logits<D>(sh.s, sh.items[stage], acc);
    if constexpr (kShift) {
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              if (n0 + n_base + nf * 8 + 2 * t + e >= n_end) continue;
              const float x = acc[mf][nf][2 * h + e] - row_shift[mf][h];
              a_run[mf][h] += expf(x);
              b_run[mf][h] += expf(x + kWindow2Offset);
            }
    } else {
      // kernel 8: the bias of this thread's eight columns onto both row blocks (+0 leaves a logit as it is)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bc = bias != nullptr ? sh.bs[stage][n_base + nf * 8 + 2 * t + e] : 0.f;
#pragma unroll
          for (int mf = 0; mf < 2; ++mf)
#pragma unroll
            for (int h = 0; h < 2; ++h) acc[mf][nf][2 * h + e] += bc;
        }
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float mx = a_run[mf][h];
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n0 + n_base + nf * 8 + 2 * t + e < n_end) mx = fmaxf(mx, acc[mf][nf][2 * h + e]);
          float l = b_run[mf][h] * expf(a_run[mf][h] - mx);
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (n0 + n_base + nf * 8 + 2 * t + e < n_end) l += expf(acc[mf][nf][2 * h + e] - mx);
          a_run[mf][h] = mx;
          b_run[mf][h] = l;
        }
    }
    stage ^= 1;
  }
  // merge: the four threads of a row (lanes 4g + t), then the two warp columns
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float a = a_run[mf][h], b = b_run[mf][h];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float a_o = __shfl_xor_sync(0xffffffffu, a, off);
        const float b_o = __shfl_xor_sync(0xffffffffu, b, off);
        if constexpr (kShift) {
          a += a_o;
          b += b_o;
        } else {
          const float m_new = fmaxf(a, a_o);
          b = b * expf(a - m_new) + b_o * expf(a_o - m_new);
          a = m_new;
        }
      }
      a_run[mf][h] = a;
      b_run[mf][h] = b;
      const int r = m_base + mf * 16 + g + 8 * h;
      if ((warp & 1) && t == 0) {
        sh.a_half[r] = a;
        sh.b_half[r] = b;
      }
    }
  __syncthreads();
  if constexpr (kMode == LseMode::kCluster) {
    // kernel 15: this rank's (max, sum of exp) per row into a_half / b_half,
    // then rank 0 merges the ranks' in rank order and writes lse (out_a)
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    if (!(warp & 1) && t == 0) {
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = m_base + mf * 16 + g + 8 * h;
          const float m = a_run[mf][h], l = b_run[mf][h], m_o = sh.a_half[r], l_o = sh.b_half[r];
          const float m_new = fmaxf(m, m_o);
          sh.a_half[r] = m_new;
          sh.b_half[r] = l * expf(m - m_new) + l_o * expf(m_o - m_new);
        }
    }
    cluster.sync();  // every rank's pairs are in its shared memory
    if (cluster.block_rank() == 0 && threadIdx.x < tc::kBM) {
      const int r = threadIdx.x;
      float m = sh.a_half[r], l = sh.b_half[r];
      for (unsigned q = 1; q < cluster.num_blocks(); ++q) {
        const float m_o = cluster.map_shared_rank(sh.a_half, q)[r];
        const float l_o = cluster.map_shared_rank(sh.b_half, q)[r];
        const float m_new = fmaxf(m, m_o);
        l = l * expf(m - m_new) + l_o * expf(m_o - m_new);
        m = m_new;
      }
      if (row0 + r < M) out_a[row0 + r] = m + logf(l);
    }
    cluster.sync();  // no rank exits while rank 0 reads its shared memory
    return;
  }
  if ((warp & 1) || t != 0) return;
  float* __restrict__ a_mine = out_a + (long long)blockIdx.y * M;
  float* __restrict__ b_mine = out_b + (long long)blockIdx.y * M;
#pragma unroll
  for (int mf = 0; mf < 2; ++mf)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m_base + mf * 16 + g + 8 * h;
      if (row0 + r >= M) continue;
      const float a = a_run[mf][h], b = b_run[mf][h], a_o = sh.a_half[r], b_o = sh.b_half[r];
      if constexpr (kShift) {
        a_mine[row0 + r] = a + a_o;
        b_mine[row0 + r] = b + b_o;
      } else {
        const float m_new = fmaxf(a, a_o);
        a_mine[row0 + r] = m_new;
        b_mine[row0 + r] = b * expf(a - m_new) + b_o * expf(a_o - m_new);
      }
    }
}

// Kernel 15's launch configuration on the tensor-core tile: grid (session
// tiles, cluster), one cluster of `cluster` blocks along y per session tile.
template <int D>
cudaLaunchConfig_t lse_cluster_config(long long M, int cluster, cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + tc::kBM - 1) / tc::kBM), (unsigned)cluster);
  cfg.blockDim = dim3(tc::kThreads);
  cfg.dynamicSmemBytes = sizeof(LseSmem<D>);
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = 1;
  attr->val.clusterDim.y = (unsigned)cluster;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Kernel 15: for D in {32, 64, 128} the tensor-core tile in clusters of
// `cluster` blocks, rank q walking item rows [q * rank_rows, (q + 1) *
// rank_rows); else the SIMT tile, one block per 64-row session tile walking
// the whole catalog.
template <int D>
int launch_lse(const float* s, const float* items, float* lse, long long M, long long N, int cluster,
               long long rank_rows, cudaStream_t stream) {
  constexpr bool kTensorCores = tensor_cores(D);
  if constexpr (kTensorCores) {
    cudaError_t err = cudaFuncSetAttribute(lse_partials_tc_kernel<D, LseMode::kCluster>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sizeof(LseSmem<D>));
    if (err != cudaSuccess) return (int)err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = lse_cluster_config<D>(M, cluster, stream, &attr);
    err = cudaLaunchKernelEx(&cfg, lse_partials_tc_kernel<D, LseMode::kCluster>, s, items, (const float*)nullptr,
                             (const float*)nullptr, lse, (float*)nullptr, M, N, rank_rows);
    if (err != cudaSuccess) return (int)err;
  } else {
    const int smem = 2 * 64 * (D + 1) * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(lse_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lse_kernel<D><<<(unsigned)((M + kBM - 1) / kBM), kThreads, smem, stream>>>(s, items, lse, M, N);
  }
  return (int)cudaGetLastError();
}


// Kernels 6, 8 (`bias` not null) and 16 (kShift, `shift` not null) on
// (session tile, item chunk) blocks: on the tensor-core tile for D in {32,
// 64, 128} (128-row session tiles), else on the SIMT tile (64-row session
// tiles).
template <int D, bool kShift>
int launch_chunks(const float* s, const float* items, const float* shift, const float* bias, float* out_a,
                  float* out_b, long long M, long long N, long long chunk_rows, cudaStream_t stream) {
  if constexpr (tensor_cores(D)) {
    constexpr LseMode kMode = kShift ? LseMode::kShift : LseMode::kPartials;
    const int smem = (int)sizeof(LseSmem<D>);
    cudaError_t err =
        cudaFuncSetAttribute(lse_partials_tc_kernel<D, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((M + tc::kBM - 1) / tc::kBM), (unsigned)((N + chunk_rows - 1) / chunk_rows));
    lse_partials_tc_kernel<D, kMode><<<grid, tc::kThreads, smem, stream>>>(s, items, shift, bias, out_a, out_b, M,
                                                                           N, chunk_rows);
  } else {
    const int smem = (2 * 64 * (D + 1) + kBN) * (int)sizeof(float);
    cudaError_t err =
        cudaFuncSetAttribute(lse_chunk_kernel<D, kShift>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + chunk_rows - 1) / chunk_rows));
    lse_chunk_kernel<D, kShift><<<grid, kThreads, smem, stream>>>(s, items, shift, bias, out_a, out_b, M, N,
                                                                  chunk_rows);
  }
  return (int)cudaGetLastError();
}

// The split ds kernel: the tensor-core tile for D in {32, 64, 128}, whose
// grid the caller plans (ops/softmax_lse.py `split_bwd_plan`) and whose
// ds_part it sizes by n_chunks item chunks of chunk_rows rows; the SIMT tile
// for D = 16 and 256, one block per 64-row session tile over the whole
// catalog, so n_chunks must be 1 there. Another count of chunks than
// chunk_rows gives is refused.
template <int D, int F>
int launch_ds(const float* s, const float* items, GradRows in, float* ds_part, long long M, long long N,
              long long chunk_rows, long long n_chunks, cudaStream_t stream) {
  if ((N + chunk_rows - 1) / chunk_rows != n_chunks) return (int)cudaErrorInvalidValue;
  if constexpr (tensor_cores(D)) {
    const int smem = (int)sizeof(tc::SplitDsSmem<D>);
    cudaError_t err =
        cudaFuncSetAttribute(grad_ds_tc_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((unsigned)((M + tc::kBM - 1) / tc::kBM), (unsigned)n_chunks);
    grad_ds_tc_kernel<D, F><<<grid, tc::kThreads, smem, stream>>>(s, items, in, ds_part, M, N, chunk_rows);
  } else {
    if (n_chunks != 1) return (int)cudaErrorInvalidValue;
    const int smem = grad_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(grad_ds_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    grad_ds_kernel<D, F><<<(unsigned)((M + kBM - 1) / kBM), kThreads, smem, stream>>>(s, items, in, ds_part, M, N);
  }
  return (int)cudaGetLastError();
}

// The split di kernel, one block per 64-row item tile on either tile.
template <int D, int F>
int launch_di(const float* s, const float* items, GradRows in, float* di, long long M, long long N,
              cudaStream_t stream) {
  if constexpr (tensor_cores(D)) {
    const int smem = (int)sizeof(tc::SplitDiSmem<D>);
    cudaError_t err =
        cudaFuncSetAttribute(grad_di_tc_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    grad_di_tc_kernel<D, F><<<(unsigned)((N + tc::kBN - 1) / tc::kBN), tc::kThreads, smem, stream>>>(s, items, in,
                                                                                                   di, M, N);
  } else {
    const int smem = grad_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(grad_di_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    grad_di_kernel<D, F><<<(unsigned)((N + kBN - 1) / kBN), kThreads, smem, stream>>>(s, items, in, di, M, N);
  }
  return (int)cudaGetLastError();
}

// The fused backward: the tensor-core tile for D in {32, 64, 128}, the SIMT
// tile for D = 16 (rows under the swizzle's 32 floats) and D = 256 (a 128 x
// 256 ds accumulator is 128 registers a thread). The caller plans the grid
// (ops/softmax_lse.py `_BWD_TILE`) and sizes di_part by its n_groups:
// another count of session groups than this tile gives is refused.
template <int D, int F>
int launch_fused(const float* s, const float* items, GradRows in, float* ds_part, float* di_part, long long M,
                 long long N, long long chunk_rows, long long tiles_per_group, long long n_groups,
                 cudaStream_t stream) {
  constexpr bool kTensorCores = tensor_cores(D);
  constexpr int kTileRows = kTensorCores ? tc::kBM : kBM;
  const long long m_tiles = (M + kTileRows - 1) / kTileRows;
  if ((m_tiles + tiles_per_group - 1) / tiles_per_group != n_groups) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((N + chunk_rows - 1) / chunk_rows), (unsigned)n_groups);
  if constexpr (kTensorCores) {
    const int smem = (int)sizeof(tc::Smem<D>);
    cudaError_t err =
        cudaFuncSetAttribute(lse_bwd_fused_tc_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lse_bwd_fused_tc_kernel<D, F><<<grid, tc::kThreads, smem, stream>>>(s, items, in, ds_part, di_part, M, N,
                                                                         chunk_rows, tiles_per_group);
  } else {
    const int smem = grad_smem_bytes<D>();
    cudaError_t err =
        cudaFuncSetAttribute(lse_bwd_fused_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    lse_bwd_fused_kernel<D, F><<<grid, kThreads, smem, stream>>>(s, items, in, ds_part, di_part, M, N, chunk_rows,
                                                                  tiles_per_group);
  }
  return (int)cudaGetLastError();
}

// `call<D>(args...)` for the runtime feature width
#define DISPATCH_D(D, CALL, ...)                          \
  switch (D) {                                            \
    case 16: return CALL(16, __VA_ARGS__);                \
    case 32: return CALL(32, __VA_ARGS__);                \
    case 64: return CALL(64, __VA_ARGS__);                \
    case 128: return CALL(128, __VA_ARGS__);              \
    case 256: return CALL(256, __VA_ARGS__);              \
    default: return (int)cudaErrorInvalidValue;           \
  }
#define CALL_LSE(D, ...) launch_lse<D>(__VA_ARGS__)
#define CALL_LSE_PARTIALS(D, ...) launch_chunks<D, false>(__VA_ARGS__)
#define CALL_LSE_SHIFT(D, ...) launch_chunks<D, true>(__VA_ARGS__)
#define CALL_CE_DS(D, ...) launch_ds<D, kCE>(__VA_ARGS__)
#define CALL_CE_DI(D, ...) launch_di<D, kCE>(__VA_ARGS__)
#define CALL_CE_FUSED(D, ...) launch_fused<D, kCE>(__VA_ARGS__)
#define CALL_LSE_DS(D, ...) launch_ds<D, kLse>(__VA_ARGS__)
#define CALL_LSE_DI(D, ...) launch_di<D, kLse>(__VA_ARGS__)
#define CALL_LSE_FUSED(D, ...) launch_fused<D, kLse>(__VA_ARGS__)
#define CALL_Z_DS(D, ...) launch_ds<D, kZ>(__VA_ARGS__)
#define CALL_Z_DI(D, ...) launch_di<D, kZ>(__VA_ARGS__)
#define CALL_Z_FUSED(D, ...) launch_fused<D, kZ>(__VA_ARGS__)

}  // namespace

// sessions (M, D) and items (N, D) row-major, 16-byte aligned; D in
// {16, 32, 64, 128, 256}. Each returns cudaGetLastError() after its launch
// (0 = launched).
//
// lse_f32 (kernel 15): lse (M,), one running (max, sum of exp) per row over
// the whole catalog. On the tensor-core tile (D in {32, 64, 128}) clusters of
// `cluster` (1-8) blocks share a session tile, rank q walking item rows [q *
// rank_rows, (q + 1) * rank_rows) (a multiple of 64; a rank past N adds
// nothing); the caller plans both from N (ops/softmax_lse.py
// `lse_cluster_plan`), and the SIMT tile (D = 16, 256) checks and ignores them.
extern "C" int lse_f32(const float* s, const float* items, float* lse, long long M, long long N, int D, int cluster,
                       long long rank_rows, cudaStream_t stream) {
  if (M <= 0) return 0;
  if (cluster < 1 || cluster > 8 || rank_rows <= 0 || rank_rows % kBN || cluster * rank_rows < N)
    return (int)cudaErrorInvalidValue;
  DISPATCH_D(D, CALL_LSE, s, items, lse, M, N, cluster, rank_rows, stream)
}

// m_part and l_part (ceil(N / chunk_rows), M): each item chunk's max logit and
// sum of exp(logit - max) per session row; chunk_rows a multiple of 64
extern "C" int lse_partials_f32(const float* s, const float* items, float* m_part, float* l_part, long long M,
                                long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  DISPATCH_D(D, CALL_LSE_PARTIALS, s, items, nullptr, nullptr, m_part, l_part, M, N, chunk_rows, stream)
}

// shift (M,); l_part and l2_part (ceil(N / chunk_rows), M): each item chunk's
// sum of exp(logit - shift) and of exp(logit - shift + 64) per session row
extern "C" int lse_shift_f32(const float* s, const float* items, const float* shift, float* l_part, float* l2_part,
                             long long M, long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  DISPATCH_D(D, CALL_LSE_SHIFT, s, items, shift, nullptr, l_part, l2_part, M, N, chunk_rows, stream)
}

// bias (N,); m_part and l_part as lse_partials_f32 gives them, with bias[n]
// added to each logit
extern "C" int lse_bias_f32(const float* s, const float* items, const float* bias, float* m_part, float* l_part,
                            long long M, long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  DISPATCH_D(D, CALL_LSE_PARTIALS, s, items, nullptr, bias, m_part, l_part, M, N, chunk_rows, stream)
}

// ds_part (n_chunks, M, D): the ds partial of each item chunk of chunk_rows
// rows (a multiple of 64), n_chunks = ceil(N / chunk_rows), and 1 for D = 16
// and 256, else cudaErrorInvalidValue; the caller sums them over the first
// axis
extern "C" int ce_ds_f32(const float* s, const float* items, const float* z, const long long* y, const float* coeff,
                         float* ds_part, long long M, long long N, int D, long long chunk_rows, long long n_chunks,
                         cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN || N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const GradRows in{z, coeff, y, nullptr};
  DISPATCH_D(D, CALL_CE_DS, s, items, in, ds_part, M, N, chunk_rows, n_chunks, stream)
}

extern "C" int ce_di_f32(const float* s, const float* items, const float* z, const long long* y, const float* coeff,
                         float* di, long long M, long long N, int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  if (N > 0x7fffffffLL) return (int)cudaErrorInvalidValue;  // the label's column in an item tile is an int
  const GradRows in{z, coeff, y, nullptr};
  DISPATCH_D(D, CALL_CE_DI, s, items, in, di, M, N, stream)
}

// ds_part (ceil(N / chunk_rows), M, D) and di_part (n_groups, N, D), as
// lse_bwd_fused_f32 gives them; the label term inside the probability tile
extern "C" int ce_fused_f32(const float* s, const float* items, const float* z, const long long* y, const float* coeff,
                            float* ds_part, float* di_part, long long M, long long N, int D, long long chunk_rows,
                            long long tiles_per_group, long long n_groups, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN || tiles_per_group <= 0 || N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const GradRows in{z, coeff, y, nullptr};
  DISPATCH_D(D, CALL_CE_FUSED, s, items, in, ds_part, di_part, M, N, chunk_rows, tiles_per_group, n_groups, stream)
}

// bias (N,), lse and dlse (M,); ds_part as ce_ds_f32 gives it
extern "C" int lse_bwd_ds_f32(const float* s, const float* items, const float* bias, const float* lse,
                              const float* dlse, float* ds_part, long long M, long long N, int D, long long chunk_rows,
                              long long n_chunks, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const GradRows in{lse, dlse, nullptr, bias};
  DISPATCH_D(D, CALL_LSE_DS, s, items, in, ds_part, M, N, chunk_rows, n_chunks, stream)
}

extern "C" int lse_bwd_di_f32(const float* s, const float* items, const float* bias, const float* lse,
                              const float* dlse, float* di, long long M, long long N, int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  const GradRows in{lse, dlse, nullptr, bias};
  DISPATCH_D(D, CALL_LSE_DI, s, items, in, di, M, N, stream)
}

// ds_part (ceil(N / chunk_rows), M, D) and di_part (n_groups, N, D) with
// n_groups = ceil(ceil(M / rows) / tiles_per_group), rows = 128 for D in {32,
// 64, 128} and 64 otherwise (the session tile), else cudaErrorInvalidValue;
// chunk_rows a multiple of 64
extern "C" int lse_bwd_fused_f32(const float* s, const float* items, const float* bias, const float* lse,
                                 const float* dlse, float* ds_part, float* di_part, long long M, long long N, int D,
                                 long long chunk_rows, long long tiles_per_group, long long n_groups,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN || tiles_per_group <= 0) return (int)cudaErrorInvalidValue;
  const GradRows in{lse, dlse, nullptr, bias};
  DISPATCH_D(D, CALL_LSE_FUSED, s, items, in, ds_part, di_part, M, N, chunk_rows, tiles_per_group, n_groups,
             stream)
}

// z (M,), +inf = ignore the row; the outputs as lse_bwd_ds_f32 / lse_bwd_di_f32 /
// lse_bwd_fused_f32 give theirs
extern "C" int grads_z_ds_f32(const float* s, const float* items, const float* z, float* ds_part, long long M,
                              long long N, int D, long long chunk_rows, long long n_chunks, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const GradRows in{z, nullptr, nullptr, nullptr};
  DISPATCH_D(D, CALL_Z_DS, s, items, in, ds_part, M, N, chunk_rows, n_chunks, stream)
}

extern "C" int grads_z_di_f32(const float* s, const float* items, const float* z, float* di, long long M, long long N,
                              int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  const GradRows in{z, nullptr, nullptr, nullptr};
  DISPATCH_D(D, CALL_Z_DI, s, items, in, di, M, N, stream)
}

extern "C" int grads_z_fused_f32(const float* s, const float* items, const float* z, float* ds_part, float* di_part,
                                 long long M, long long N, int D, long long chunk_rows, long long tiles_per_group,
                                 long long n_groups, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN || tiles_per_group <= 0) return (int)cudaErrorInvalidValue;
  const GradRows in{z, nullptr, nullptr, nullptr};
  DISPATCH_D(D, CALL_Z_FUSED, s, items, in, ds_part, di_part, M, N, chunk_rows, tiles_per_group, n_groups, stream)
}
