// The streaming logsumexp, its generic backward and the softmax gradients from
// z on bf16 towers: the forms of kernels 6 and 8 to 14 that mixed-precision
// training (compute_dtype="bfloat16") runs, without and with a process mesh
// and on catalogs of any size, and of the public lse op's other forwards 15
// and 16, on bf16 tensor-core products with f32 accumulation. Kernel 7's bf16
// forms (the softmax-CE gradients: `ce_fused_bf16`, `ce_ds_bf16`,
// `ce_di_bf16`) and kernel 12's (`grads_z_fused_bf16`, the engine without
// the label term) run on the `wgmma` engine of ce_grads_bf16.cu; the gradient
// kernels below keep its `kCE` form (the label term, the stepped ds
// partials), which no entry instantiates, beside the `kLse` and `kZ` forms
// that kernels 9, 10, 13 and 14 take: the one pass below is instantiated for
// kernel 9 alone.
//
// Replaces, for bf16 inputs:
// - rectools_tpu/ops/softmax_lse.py:169 `_lse_fwd_partials_kernel`
//   (`lse_partials_bf16`, kernel 6): per (item chunk, session tile) the
//   chunk's (max, sum of exp) of the f32 logits s . items^T, written to f32
//   (n_chunks, M) partials that the caller combines, as the f32 kernel's.
// - :99 `_lse_fwd_kernel` (`lse_bias_bf16`, kernel 8): kernel 6's kernel
//   with the f32 bias of each item row (0, or -1e30 for a row that only pads
//   a shard) added to each f32 logit (:116-124); a zero bias gives kernel 6's
//   bits. The mesh loss's forward.
// - :127 `_lse_fwd_tail_kernel` (`lse_bf16`, kernel 15, the public op with
//   `USE_PARTIALS_FWD` False): one running (max, sum of exp) of the f32
//   logits per row over the whole catalog, the tail masked, lse = m + log l
//   (:141-164, :414-425). Kernel 6's kernel in its `kCluster` mode, on the
//   f32 form's plan (ops/softmax_lse.py `lse_cluster_plan`): a thread-block
//   cluster of C = min(8, item tiles) blocks shares a 128-row session tile,
//   rank q walking item rows [q * rank_rows, (q + 1) * rank_rows), rank_rows
//   = ceil(tiles / C) * 64; each rank folds its tiles as kernel 6 does, then
//   rank 0 reads the ranks' (max, sum of exp) pairs through distributed
//   shared memory in rank order and writes lse. One block per session tile
//   would give 400 blocks at 51,200 rows, just past what the card holds at
//   once, so the last few would run alone; the clusters give kernel 6's 3,200
//   blocks (8 ranks of 31 tiles at 15,872 items).
// - :50 `_lse_shift_kernel` (`lse_shift_bf16`, kernel 16, the public op with
//   `bounded_shift=True`): kernel 6's kernel and grid in its `kShift` mode:
//   with the caller's f32 shift (computed on the widened towers,
//   :364-365), per item chunk and row the plain f32 sums l = sum exp(logit -
//   shift) and l2 = sum exp(logit - shift + 64) over the chunk's columns, the
//   tail masked (:92-96), in a fixed order (each thread's columns tile by
//   tile, the four threads of a row, warp column 0 plus column 1); the caller
//   sums the (n_chunks, M) partials over the chunks and picks the window.
// - :757 `_ds_z_kernel` (`grads_z_ds_bf16`, kernel 13): the same pw times the
//   item tiles, ds summed in f32 over every chunk, nothing rounded between
//   them (:770-771).
// - :774 `_di_z_kernel` (`grads_z_di_bf16`, kernel 14): di = pw^T s in f32,
//   pw rounded once (:786-790), unlike kernel 11.
// - :234 `_bwd_fused_kernel` (`lse_bwd_fused_bf16`, kernel 9): the one pass
//   below (`ce_fused_bf16_kernel`, the design kernels 7 and 12 had in bf16
//   before ce_grads_bf16.cu) in its `kLse` form: pw = exp((logit + bias) - lse) * dlse
//   in f32, dlse of either sign, rounded to bf16 once for both products
//   (:258), no label term, ds partials always f32 (:505; JAX's
//   `BF16_DS_PARTIALS` is not read on this route).
// - :205 `_dsessions_kernel` (`lse_bwd_ds_bf16`, kernel 10): the same bf16
//   pw times the item tiles, ds summed in f32 (:220-231).
// - :266 `_ditems_kernel` (`lse_bwd_di_bf16`, kernel 11), whose rounding
//   points differ from kernel 9's (:275-287): p = exp((logit + bias) - lse)
//   rounded to bf16 and s * dlse (f32 product) rounded to bf16, di =
//   p^T (s * dlse) summed in f32.
// In all of them item rows past N load as zeros and get P forced to 0 (the
// NaN rule of :636-640); session rows past M get z = lse = +inf and coeff =
// dlse = 0, so they contribute nothing; an item row biased -1e30 gets
// exp(-1e30 - lse) = 0, so its di row is 0. No float atomics: one writer per
// output row, every run the same bits.
//
// Products: `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`, one a
// 16-deep step (bf16_tile.cuh): a bf16 x bf16 product is exact in f32 and the
// tensor cores sum in f32, so the plain twins (f32 products of the bf16
// values, ops/softmax_lse.py) differ only in the order of their f32 sums.
//
// Tiles (D in {16, 32, 64, 128, 256}, the widths of ops/softmax_lse.py
// SUPPORTED_D): 256 threads, 8 warps; 64-row item tiles, and session tiles of
// 128 rows, or of 64 rows in the gradient kernels at D = 256 (`grad_bm`: a
// warp of the 4 x 2 split keeps its ds slice, rows x D / 2 in f32 registers,
// at 64 a thread either way, and kernel 11's tiles fit a block's 232,448
// bytes); staged row-major in shared memory at a pitch of D + 8 bf16 by
// 16-byte cp.async, through a ring of two where a block walks many tiles (the
// next loading while this one multiplies). The bias of an item tile is copied
// to shared memory beside it. At D = 16 a staged row is two 16-byte copies
// and product 1 is one 16-deep step; each warp's D / 2 columns of ds and di
// are one 8-column fragment. Shared memory at D = 16 / 128 / 256 (bytes):
// - Kernels 6, 8, 15 and 16: block (x, y) owns session tile x and item chunk
//   y (2,048 rows, ops/softmax_lse.py LSE_CHUNK; kernel 15: rank y of the
//   session tile's cluster), as the f32 kernel; warps 4 x 2 take 32 x 32 of
//   each 128 x 64 logits tile and fold it into running (max, sum of exp)
//   pairs of their rows (kernel 16: the two windows' sums), merged by
//   shuffles and then across the two warp columns through shared memory.
//   14,592 / 71,936 / 137,472.
// - Kernel 9: the f32 one pass's grid (ops/softmax_lse.py
//   `fused_bwd_plan`: block (x, y) owns item chunk x of 2,048 rows and group y
//   of session tiles, all blocks in one wave). Per (session tile, item tile)
//   pair: the logits (warps 4 x 2, BM / 4 x 32 each), the rounded probability
//   tile staged twice in shared memory ([session][item] as the A operand of
//   ds, [item][session] as the A operand of di), ds += P items into
//   registers (warps 4 x 2: BM / 4 rows x D / 2), di += P^T s (warps 4 x 2:
//   16 item rows x D / 2, at D = 256 in two passes of D / 4 columns so that
//   ds and di together stay 96 f32 registers a thread) read from and written
//   back to the block's own f32 di partial rows in device memory (each thread
//   its own entries, so no other thread and no other block touches them). The
//   B operands whose depth runs across rows (items for ds, sessions for di)
//   are read as two 16-bit values a register. 50,432 / 107,776 / 121,088.
// - Kernels 10 and 13: one kernel in two forms on the f32
//   split ds kernel's grid (ops/softmax_lse.py `split_bwd_plan`: block (x, y)
//   owns session tile x and item chunk y, 1 to 4 chunks), kernel 9's products
//   1 and 2 on each item tile of its chunk, ds in registers, written as the
//   f32 ds partial of (chunk, session tile) that the caller sums in order
//   (the `kCE` form's stepping, a step's sum rounded to bf16 and added to the
//   partial at each step's end, runs in none). 33,024 / 90,368 / 111,872.
// - Kernel 14: kernel 11's grid and ring (block x owns the
//   64-row item tile x, walks every session tile) without its staged s *
//   dlse tile: pw rounded once into [item][session], di += pw^T s in
//   registers, written once. 34,816 / 106,496 / 111,616.
// - Kernel 11: block x owns the 64-row item tile x and walks every session
//   tile through a ring of two: the logits (product 1), p rounded to bf16
//   into [item][session], the session tile times dlse rounded to bf16 into a
//   third tile, and di += p^T (s * dlse) (warps 4 x 2: 16 item rows x D / 2)
//   in registers; it writes its f32 di rows once. N / 64 blocks. 40,192 /
//   140,544 / 145,152 (with 128-row session tiles it would need 255,232 at D
//   = 256, over the block's limit).
// The session tile's size changes no sum: ds sums per row over item tiles,
// di per item row over session rows 16 at a time in order, as at 128 rows.
//
// Bound on an H100 at the training shape M = 51,200, N = 15,872, D = 128:
// kernels 6, 8 and 15 are one logit product, 2 M N D = 208 GFLOP, 0.21 ms at
// 989 TFLOP/s bf16 (their inputs, 17 MB, take 0.005 ms at 3.35 TB/s); kernel
// 16 the same (it takes two exps a logit, one a window, but the function needs
// one: window 2's term is e^64 times window 1's); kernel 9
// is three, 624 GFLOP, 0.63 ms, with 0.24 GB of inputs and partials
// (0.07 ms); kernels 10 and 11 two each, 0.42 ms, and so are kernels 13 and
// 14, at 196,608 items 5.2 ms each (2 x 2.58 TFLOP). At D = 256 each product doubles (0.42 ms a
// product). At D = 16 the products take 0.026 ms and the M N = 8.1e8 exps
// bound every form instead: 0.19 ms at the SFUs' 16 a clock a
// multiprocessor (132 x 16 x 1.98 GHz). At a (2, 2) mesh's shard (25,600 x
// 7,936) each is a quarter of that. What bounds them as written is issue and
// latency: `mma.sync` (not `wgmma`), one block of 8 warps per SM for the
// gradient kernels, the exps, the 16-bit reads of the transposed operands
// and kernel 9's di read-modify-write in device memory; chip_smoke.py's
// `bf16`, `bf16 mesh` and `bf16 wide` lines print their times beside these
// bounds.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "tc_tile.cuh"
#include "bf16_tile.cuh"

constexpr int kBM = 128;  // session rows per tile of kernels 6 and 8
constexpr int kBN = 64;   // item rows per tile
constexpr int kThreads = 256;
constexpr float kNegBig = -1e30f;
constexpr float kWindow2Offset = 64.f;  // kernel 16's second window (rectools_tpu/ops/softmax_lse.py:47)

// session rows per tile of the gradient kernels (7, 9-14) at width D: 64 at D =
// 256, where a warp's ds slice of 32 rows would take 128 f32 registers a thread
// and kernel 11's tiles 236,544 bytes of shared memory; 128 below
__host__ __device__ constexpr int grad_bm(int D) { return D > 128 ? 64 : 128; }

// ------------------------------------------------------- kernels 6, 8, 15 and 16

template <int D>
struct LseSmem {
  __nv_bfloat16 s[kBM * bt::pitch(D)];
  __nv_bfloat16 items[2][kBN * bt::pitch(D)];
  float red_m[2][kBM];
  float red_l[2][kBM];
  float bias[kBN];  // kernel 8: the bias of the item tile being multiplied
};

// the bias of item rows [n0, n0 + 64) into shared memory, 0 past n_end (those
// columns are forced to 0 or left out); threads 0..63 each copy one
__device__ __forceinline__ void load_bias(float* dst, const float* __restrict__ bias, long long n0, long long n_end) {
  if (threadIdx.x < kBN) dst[threadIdx.x] = n0 + threadIdx.x < n_end ? bias[n0 + threadIdx.x] : 0.f;
}

__device__ __forceinline__ void merge_pair(float& m, float& l, float m_o, float l_o) {
  const float m_new = fmaxf(m, m_o);
  l = l * expf(m - m_new) + l_o * expf(m_o - m_new);
  m = m_new;
}

// What lse_partials_bf16_kernel computes per row: each item chunk's (max, sum
// of exp) of the logits (kernel 6), of the logits plus the item rows' bias
// (kernel 8), each chunk's sums of the two shifted windows (kernel 16), or
// the lse through a cluster of blocks (kernel 15).
enum LseMode : int { kPartials = 0, kBias = 1, kShift = 2, kCluster = 3 };

// Block (x, y) owns the 128-row session tile x and item rows [y * chunk_rows,
// (y + 1) * chunk_rows), walks the chunk's 64-row item tiles and folds each
// into a pair per row for its thread's four rows (columns past the chunk's
// end left out); the four threads of a row merge theirs by shuffles, then the
// two warp columns through shared memory. out_a and out_b are (gridDim.y, M),
// rows past M never written.
// - kPartials (6) and kBias (8: `bias` added to each f32 logit): a running
//   (max, sum of exp) from -1e30; out_a the chunk's max, out_b its sum of
//   exp(logit - max).
// - kShift (16): x = logit - shift[m] with the caller's f32 shift (0 past M),
//   out_a = sum exp(x) and out_b = sum exp(x + 64), plain f32 sums in a fixed
//   order (each thread's columns tile by tile, the four threads of a row, then
//   warp column 0 plus column 1); no max.
// - kCluster (15): the gridDim.y blocks of a session tile are one cluster, y
//   its rank and chunk_rows a rank's item rows; rank 0 merges the ranks'
//   (max, sum of exp) in rank order through distributed shared memory and
//   writes lse = m + log l (M,) to out_a; out_b is unused.
template <int D, int kMode>
__global__ void __launch_bounds__(kThreads)
    lse_partials_bf16_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ items,
                             const float* __restrict__ bias, const float* __restrict__ shift,
                             float* __restrict__ m_part, float* __restrict__ l_part, long long M, long long N,
                             long long chunk_rows) {
  constexpr bool kBiased = kMode == kBias, kShifted = kMode == kShift;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  LseSmem<D>& sm = *reinterpret_cast<LseSmem<D>*>(smem_raw);
  constexpr int P = bt::pitch(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;  // warp rows 32 wr + [0, 32), item columns 32 wc + [0, 32)
  const long long row0 = (long long)blockIdx.x * kBM;
  const long long n_begin = (long long)blockIdx.y * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  const int n_tiles = (int)((n_end - n_begin + kBN - 1) / kBN);

  bt::stage_async<D, kBM, kThreads>(sm.s, s, D, row0, M);
  bt::stage_async<D, kBN, kThreads>(sm.items[0], items, D, n_begin, n_end);
  tc::cp_commit();

  // the thread's rows: 32 wr + 16 mf + g + 8 hh, as (mf, hh) -> 2 mf + hh; per
  // row (max, sum of exp), or under kShift the two windows' sums and the
  // row's shift
  float m_run[4], l_run[4], row_shift[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const long long row = row0 + 32 * wr + 16 * (r >> 1) + g + 8 * (r & 1);
    row_shift[r] = kShifted && row < M ? shift[row] : 0.f;
    m_run[r] = kShifted ? 0.f : kNegBig;
    l_run[r] = 0.f;
  }
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      bt::stage_async<D, kBN, kThreads>(sm.items[(it + 1) & 1], items, D, n_begin + (long long)(it + 1) * kBN, n_end);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    if (kBiased) load_bias(sm.bias, bias, n_begin + (long long)it * kBN, n_end);
    __syncthreads();
    const __nv_bfloat16* tile = sm.items[it & 1];
    float acc[2][4][4];
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mf = 0; mf < 2; ++mf) bt::frag_a<P>(sm.s, 32 * wr + 16 * mf, k, a[mf]);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) bt::frag_b<P>(tile, 32 * wc + 8 * nf, k, b[nf]);
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) bt::mma(acc[mf][nf], a[mf], b[nf]);
    }
    if (kBiased) {  // the f32 bias onto the f32 logits (rectools_tpu/ops/softmax_lse.py:116-124)
#pragma unroll
      for (int mf = 0; mf < 2; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mf][nf][e] += sm.bias[32 * wc + 8 * nf + 2 * t + (e & 1)];
    }
    const long long n0 = n_begin + (long long)it * kBN + 32 * wc + 2 * t;
#pragma unroll
    for (int mf = 0; mf < 2; ++mf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = 2 * mf + hh;
        if (kShifted) {  // the tail masked: a column past the chunk's end is left out (softmax_lse.py:92-96)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (n0 + 8 * nf + j >= n_end) continue;
              const float x = acc[mf][nf][2 * hh + j] - row_shift[r];
              m_run[r] += expf(x);
              l_run[r] += expf(x + kWindow2Offset);
            }
          continue;
        }
        float mx = m_run[r];
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n0 + 8 * nf + j < n_end) mx = fmaxf(mx, acc[mf][nf][2 * hh + j]);
        float l = l_run[r] * expf(m_run[r] - mx);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            if (n0 + 8 * nf + j < n_end) l += expf(acc[mf][nf][2 * hh + j] - mx);
        m_run[r] = mx;
        l_run[r] = l;
      }
    __syncthreads();  // this ring slot is consumed before the next prefetch overwrites it
  }
  // the four threads of a row (lanes 4 g + [0, 4)), then the two warp columns
#pragma unroll
  for (int r = 0; r < 4; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m_run[r], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l_run[r], off);
      if (kShifted) {
        m_run[r] += m_o;
        l_run[r] += l_o;
      } else {
        merge_pair(m_run[r], l_run[r], m_o, l_o);
      }
    }
    if (t == 0) {
      const int row = 32 * wr + 16 * (r >> 1) + g + 8 * (r & 1);
      sm.red_m[wc][row] = m_run[r];
      sm.red_l[wc][row] = l_run[r];
    }
  }
  __syncthreads();
  if constexpr (kMode == kCluster) {
    // kernel 15: this rank's (max, sum of exp) per row into red_m[0] / red_l[0],
    // then rank 0 merges the ranks' in rank order and writes lse (m_part)
    namespace cg = cooperative_groups;
    const cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x < kBM) {
      float m = sm.red_m[0][threadIdx.x], l = sm.red_l[0][threadIdx.x];
      merge_pair(m, l, sm.red_m[1][threadIdx.x], sm.red_l[1][threadIdx.x]);
      sm.red_m[0][threadIdx.x] = m;
      sm.red_l[0][threadIdx.x] = l;
    }
    cluster.sync();  // every rank's pairs are in its shared memory
    if (cluster.block_rank() == 0 && threadIdx.x < kBM) {
      float m = sm.red_m[0][threadIdx.x], l = sm.red_l[0][threadIdx.x];
      for (unsigned q = 1; q < cluster.num_blocks(); ++q)
        merge_pair(m, l, cluster.map_shared_rank(sm.red_m[0], q)[threadIdx.x],
                   cluster.map_shared_rank(sm.red_l[0], q)[threadIdx.x]);
      if (row0 + threadIdx.x < M) m_part[row0 + threadIdx.x] = m + logf(l);
    }
    cluster.sync();  // no rank exits while rank 0 reads its shared memory
    return;
  }
  if (threadIdx.x < kBM && row0 + threadIdx.x < M) {
    float m = sm.red_m[0][threadIdx.x], l = sm.red_l[0][threadIdx.x];
    if (kShifted) {
      m += sm.red_m[1][threadIdx.x];
      l += sm.red_l[1][threadIdx.x];
    } else {
      merge_pair(m, l, sm.red_m[1][threadIdx.x], sm.red_l[1][threadIdx.x]);
    }
    m_part[(long long)blockIdx.y * M + row0 + threadIdx.x] = m;
    l_part[(long long)blockIdx.y * M + row0 + threadIdx.x] = l;
  }
}

// ------------------------------------------------------- kernels 7 and 9

constexpr int kPP = bt::pitch(kBN);  // the probability tile [session][item]

// The forms of the gradient kernels. kCE (kernel 7; no entry instantiates it):
// z = row_a, coeff = row_b, labels y, pw = exp(logit - z) - coeff [item == y]. kLse (kernels 9
// and 10): lse = row_a, dlse = row_b, the item rows' bias, pw = exp((logit +
// bias) - lse) * dlse. kZ (kernels 13 and 14): z = row_a, pw = exp(logit - z).
enum Form : int { kCE = 0, kLse = 1, kZ = 2 };

// the f32 weight of one (session row, item) pair of form F, before its
// rounding to bf16; 0 for an item at or past n_end (the NaN rule)
template <int F>
__device__ __forceinline__ float weight(float logit, float a, float b, long long y, float bias, long long item,
                                        long long n_end) {
  float pw;
  if (F == kLse) {
    pw = expf((logit + bias) - a) * b;
  } else {
    pw = expf(logit - a);
    if (F == kCE && item == y) pw -= b;
  }
  return item >= n_end ? 0.f : pw;
}

// the row vectors of session rows [row0, row0 + BM) into shared memory,
// threads 0..BM-1 one row each: a row past M gets row_a = +inf and row_b = 0
// (it contributes nothing) and label -1; kZ reads no row_b, only kCE labels
template <int F, int BM>
__device__ __forceinline__ void load_rows(float* a_dst, float* b_dst, long long* y_dst, const float* __restrict__ row_a,
                                          const float* __restrict__ row_b, const long long* __restrict__ y,
                                          long long row0, long long M) {
  if (threadIdx.x < BM) {
    const long long row = row0 + threadIdx.x;
    const bool ok = row < M;
    a_dst[threadIdx.x] = ok ? row_a[row] : INFINITY;
    b_dst[threadIdx.x] = ok && F != kZ ? row_b[row] : 0.f;
    if (F == kCE) y_dst[threadIdx.x] = ok ? y[row] : -1;
  }
}

template <int D, int BM = grad_bm(D)>
struct CeSmem {
  __nv_bfloat16 s[BM * bt::pitch(D)];
  __nv_bfloat16 items[2][kBN * bt::pitch(D)];
  __nv_bfloat16 p[BM * kPP];
  __nv_bfloat16 pt[kBN * bt::pitch(BM)];  // the transpose [item][session]
  float z[BM];
  float coeff[BM];
  long long y[BM];
  float bias[kBN];
};

template <int D, int F>
__global__ void __launch_bounds__(kThreads, 1)
    ce_fused_bf16_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ items,
                         const float* __restrict__ z, const long long* __restrict__ y,
                         const float* __restrict__ coeff, const float* __restrict__ bias, float* __restrict__ ds_part,
                         float* __restrict__ di_part, long long M, long long N, long long chunk_rows,
                         long long tiles_per_group) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CeSmem<D>& sm = *reinterpret_cast<CeSmem<D>*>(smem_raw);
  constexpr int P = bt::pitch(D);
  constexpr int BM = grad_bm(D), PTP = bt::pitch(BM);
  constexpr int MF = BM / 64;  // 16-row fragments of a warp's BM / 4 session rows
  constexpr int kNF = D / 16;  // 8-column fragments of a warp's D / 2 columns of ds or di
  constexpr int kDiPasses = D > 128 ? 2 : 1;  // di's columns in passes, so that ds and di fit the registers
  constexpr int kDiNF = kNF / kDiPasses;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const long long n_begin = (long long)blockIdx.x * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  const int n_tiles = (int)((n_end - n_begin + kBN - 1) / kBN);
  const long long m_tiles = (M + BM - 1) / BM;
  const long long st_begin = (long long)blockIdx.y * tiles_per_group;
  const long long st_end = st_begin + tiles_per_group < m_tiles ? st_begin + tiles_per_group : m_tiles;
  float* __restrict__ di_mine = di_part + (long long)blockIdx.y * N * D;

  for (long long st = st_begin; st < st_end; ++st) {
    const long long row0 = st * BM;
    __syncthreads();  // the previous session tile's last pair is done with every tile
    bt::stage_async<D, BM, kThreads>(sm.s, s, D, row0, M);
    bt::stage_async<D, kBN, kThreads>(sm.items[0], items, D, n_begin, n_end);
    tc::cp_commit();
    load_rows<F, BM>(sm.z, sm.coeff, sm.y, z, coeff, y, row0, M);
    float ds[MF][kNF][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[mf][nf][e] = 0.f;

    for (int it = 0; it < n_tiles; ++it) {
      const long long item0 = n_begin + (long long)it * kBN;
      if (it + 1 < n_tiles) {
        bt::stage_async<D, kBN, kThreads>(sm.items[(it + 1) & 1], items, D, item0 + kBN, n_end);
        tc::cp_commit();
        tc::cp_wait<1>();
      } else {
        tc::cp_wait<0>();
      }
      if (F == kLse) load_bias(sm.bias, bias, item0, n_end);
      __syncthreads();
      const __nv_bfloat16* tile = sm.items[it & 1];

      // product 1: the logits of rows BM / 4 wr + [0, BM / 4), items 32 wc + [0, 32)
      float acc[MF][4][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
#pragma unroll
      for (int k = 0; k < D; k += 16) {
        uint32_t a[MF][4], b[4][2];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) bt::frag_a<P>(sm.s, (BM / 4) * wr + 16 * mf, k, a[mf]);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) bt::frag_b<P>(tile, 32 * wc + 8 * nf, k, b[nf]);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf)
#pragma unroll
          for (int nf = 0; nf < 4; ++nf) bt::mma(acc[mf][nf], a[mf], b[nf]);
      }
      // the probability tile in f32 (kCE: the label term; kLse: the bias and
      // the cotangent), the tail, then bf16
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = (BM / 4) * wr + 16 * mf + g + 8 * (e >> 1);
            const int c = 32 * wc + 8 * nf + 2 * t + (e & 1);
            const float pw = weight<F>(acc[mf][nf][e], sm.z[r], sm.coeff[r], F == kCE ? sm.y[r] : -1,
                                       F == kLse ? sm.bias[c] : 0.f, item0 + c, n_end);
            const __nv_bfloat16 pb = __float2bfloat16_rn(pw);
            sm.p[r * kPP + c] = pb;
            sm.pt[c * PTP + r] = pb;
          }
      __syncthreads();

      // product 2: ds (rows BM / 4 wr + [0, BM / 4), columns D / 2 wc + [0, D / 2)) += P items
#pragma unroll
      for (int k = 0; k < kBN; k += 16) {
        uint32_t a[MF][4];
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) bt::frag_a<kPP>(sm.p, (BM / 4) * wr + 16 * mf, k, a[mf]);
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf) {
          uint32_t b[2];
          bt::frag_b_t<P>(tile, k, (D / 2) * wc + 8 * nf, b);
#pragma unroll
          for (int mf = 0; mf < MF; ++mf) bt::mma(ds[mf][nf], a[mf], b);
        }
      }

      // product 3: di (item rows 16 wr + [0, 16), columns D / 2 wc + [0, D / 2), in kDiPasses passes) += P^T s,
      // onto the block's partial rows (first session tile of the group: from zero)
      const long long di_row = item0 + 16 * wr + g;
#pragma unroll
      for (int pass = 0; pass < kDiPasses; ++pass) {
        const int col0 = (D / 2) * wc + 8 * kDiNF * pass;
        float di[kDiNF][4];
#pragma unroll
        for (int nf = 0; nf < kDiNF; ++nf) {
          const int col = col0 + 8 * nf + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            float2 v = make_float2(0.f, 0.f);
            if (st != st_begin && di_row + 8 * hh < n_end)
              v = *reinterpret_cast<const float2*>(di_mine + (di_row + 8 * hh) * D + col);
            di[nf][2 * hh] = v.x;
            di[nf][2 * hh + 1] = v.y;
          }
        }
#pragma unroll
        for (int k = 0; k < BM; k += 16) {
          uint32_t a[4];
          bt::frag_a<PTP>(sm.pt, 16 * wr, k, a);
#pragma unroll
          for (int nf = 0; nf < kDiNF; ++nf) {
            uint32_t b[2];
            bt::frag_b_t<P>(sm.s, k, col0 + 8 * nf, b);
            bt::mma(di[nf], a, b);
          }
        }
#pragma unroll
        for (int nf = 0; nf < kDiNF; ++nf) {
          const int col = col0 + 8 * nf + 2 * t;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            if (di_row + 8 * hh < n_end)
              *reinterpret_cast<float2*>(di_mine + (di_row + 8 * hh) * D + col) =
                  make_float2(di[nf][2 * hh], di[nf][2 * hh + 1]);
        }
      }
      __syncthreads();  // P, P^T and this ring slot are consumed
    }

    // the f32 ds partial of (item chunk, session tile)
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = row0 + (BM / 4) * wr + 16 * mf + g + 8 * hh;
        if (row >= M) continue;
        const long long base = ((long long)blockIdx.x * M + row) * D;
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf) {
          const int col = (D / 2) * wc + 8 * nf + 2 * t;
          *reinterpret_cast<float2*>(ds_part + base + col) = make_float2(ds[mf][nf][2 * hh], ds[mf][nf][2 * hh + 1]);
        }
      }
  }
}

// ------------------------------------------- the split ds kernels: 10 and 13

template <int D, int BM = grad_bm(D)>
struct DsSmem {
  __nv_bfloat16 s[BM * bt::pitch(D)];
  __nv_bfloat16 items[2][kBN * bt::pitch(D)];
  __nv_bfloat16 p[BM * kPP];
  float row_a[BM];  // lse (kLse) or z
  float row_b[BM];  // dlse (kLse) or coeff (kCE)
  long long y[BM];  // kCE: the labels
  float bias[kBN];  // kLse: the bias of the item tile being multiplied
};

// Block (x, y) owns session tile x and item chunk y. With step_tiles > 0 the
// chunk is walked in steps of that many item tiles: each step's ds sum is
// rounded to bf16 and added to the partial in f32 (kernel 7's bf16 partials,
// one a 2,048-row step; the kCE form, which no entry takes); with 0 the
// chunk's ds is one f32 sum.
template <int D, int F>
__global__ void __launch_bounds__(kThreads, 1)
    split_ds_bf16_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ items,
                         const float* __restrict__ row_a, const long long* __restrict__ y,
                         const float* __restrict__ row_b, const float* __restrict__ bias,
                         float* __restrict__ ds_part, long long M, long long N, long long chunk_rows, int step_tiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DsSmem<D>& sm = *reinterpret_cast<DsSmem<D>*>(smem_raw);
  constexpr int P = bt::pitch(D);
  constexpr int BM = grad_bm(D);
  constexpr int MF = BM / 64;  // 16-row fragments of a warp's BM / 4 session rows
  constexpr int kNF = D / 16;  // 8-column fragments of a warp's D / 2 columns of ds
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const long long row0 = (long long)blockIdx.x * BM;
  const long long n_begin = (long long)blockIdx.y * chunk_rows;
  const long long n_end = n_begin + chunk_rows < N ? n_begin + chunk_rows : N;
  const int n_tiles = (int)((n_end - n_begin + kBN - 1) / kBN);

  bt::stage_async<D, BM, kThreads>(sm.s, s, D, row0, M);
  bt::stage_async<D, kBN, kThreads>(sm.items[0], items, D, n_begin, n_end);
  tc::cp_commit();
  load_rows<F, BM>(sm.row_a, sm.row_b, sm.y, row_a, row_b, y, row0, M);
  float ds[MF][kNF][4];
#pragma unroll
  for (int mf = 0; mf < MF; ++mf)
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[mf][nf][e] = 0.f;
  bool first_step = true;

  for (int it = 0; it < n_tiles; ++it) {
    const long long item0 = n_begin + (long long)it * kBN;
    if (it + 1 < n_tiles) {
      bt::stage_async<D, kBN, kThreads>(sm.items[(it + 1) & 1], items, D, item0 + kBN, n_end);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    if (F == kLse) load_bias(sm.bias, bias, item0, n_end);
    __syncthreads();
    const __nv_bfloat16* tile = sm.items[it & 1];

    // product 1: the logits of rows BM / 4 wr + [0, BM / 4), items 32 wc + [0, 32)
    float acc[MF][4][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      uint32_t a[MF][4], b[4][2];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) bt::frag_a<P>(sm.s, (BM / 4) * wr + 16 * mf, k, a[mf]);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) bt::frag_b<P>(tile, 32 * wc + 8 * nf, k, b[nf]);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) bt::mma(acc[mf][nf], a[mf], b[nf]);
    }
    // pw in f32, 0 past N, then bf16 (kLse: :220-231; kCE: :672-676; kZ: :770)
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (BM / 4) * wr + 16 * mf + g + 8 * (e >> 1);
          const int c = 32 * wc + 8 * nf + 2 * t + (e & 1);
          const float pw = weight<F>(acc[mf][nf][e], sm.row_a[r], sm.row_b[r], F == kCE ? sm.y[r] : -1,
                                     F == kLse ? sm.bias[c] : 0.f, item0 + c, n_end);
          sm.p[r * kPP + c] = __float2bfloat16_rn(pw);
        }
    __syncthreads();

    // product 2: ds (rows BM / 4 wr + [0, BM / 4), columns D / 2 wc + [0, D / 2)) += P items
#pragma unroll
    for (int k = 0; k < kBN; k += 16) {
      uint32_t a[MF][4];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) bt::frag_a<kPP>(sm.p, (BM / 4) * wr + 16 * mf, k, a[mf]);
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        uint32_t b[2];
        bt::frag_b_t<P>(tile, k, (D / 2) * wc + 8 * nf, b);
#pragma unroll
        for (int mf = 0; mf < MF; ++mf) bt::mma(ds[mf][nf], a[mf], b);
      }
    }
    __syncthreads();  // P and this ring slot are consumed

    // at a step's end (or the chunk's): the step's sum, rounded to bf16 when stepping, onto the f32 ds partial
    // of (item chunk, session tile), each thread its own entries
    if (it + 1 < n_tiles && (step_tiles == 0 || (it + 1) % step_tiles != 0)) continue;
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const long long row = row0 + (BM / 4) * wr + 16 * mf + g + 8 * hh;
        if (row >= M) continue;
        float* out = ds_part + ((long long)blockIdx.y * M + row) * D;
#pragma unroll
        for (int nf = 0; nf < kNF; ++nf) {
          const int col = (D / 2) * wc + 8 * nf + 2 * t;
          float2 v = make_float2(ds[mf][nf][2 * hh], ds[mf][nf][2 * hh + 1]);
          if (step_tiles > 0) v = make_float2(bt::round_bf16(v.x), bt::round_bf16(v.y));
          if (!first_step) {
            const float2 run = *reinterpret_cast<const float2*>(out + col);
            v = make_float2(run.x + v.x, run.y + v.y);
          }
          *reinterpret_cast<float2*>(out + col) = v;
        }
      }
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) ds[mf][nf][e] = 0.f;
    first_step = false;
  }
}

// ------------------------------------------- the split di kernel: 14

template <int D, int BM = grad_bm(D)>
struct ZDiSmem {
  __nv_bfloat16 items[kBN * bt::pitch(D)];
  __nv_bfloat16 s[2][BM * bt::pitch(D)];
  __nv_bfloat16 pt[kBN * bt::pitch(BM)];  // pw rounded to bf16, [item][session]
  float z[BM];
  float coeff[BM];
  long long y[BM];
};

// Block x owns the 64-row item tile x and walks every session tile
// through a ring of two: pw (form kCE or kZ) rounded to bf16 once, di += pw^T
// s in f32 registers, written once.
template <int D, int F>
__global__ void __launch_bounds__(kThreads, 1)
    split_di_bf16_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ items,
                         const float* __restrict__ z, const long long* __restrict__ y,
                         const float* __restrict__ coeff, float* __restrict__ di_out, long long M, long long N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ZDiSmem<D>& sm = *reinterpret_cast<ZDiSmem<D>*>(smem_raw);
  constexpr int P = bt::pitch(D);
  constexpr int BM = grad_bm(D), PTP = bt::pitch(BM);
  constexpr int MF = BM / 64;  // 16-row fragments of a warp's BM / 4 session rows
  constexpr int kNF = D / 16;  // 8-column fragments of a warp's D / 2 columns of di
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const long long item0 = (long long)blockIdx.x * kBN;
  const long long m_tiles = (M + BM - 1) / BM;

  bt::stage_async<D, kBN, kThreads>(sm.items, items, D, item0, N);
  bt::stage_async<D, BM, kThreads>(sm.s[0], s, D, 0, M);
  tc::cp_commit();
  float di[kNF][4];
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) di[nf][e] = 0.f;

  for (long long st = 0; st < m_tiles; ++st) {
    const long long row0 = st * BM;
    if (st + 1 < m_tiles) {
      bt::stage_async<D, BM, kThreads>(sm.s[(st + 1) & 1], s, D, row0 + BM, M);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    load_rows<F, BM>(sm.z, sm.coeff, sm.y, z, coeff, y, row0, M);
    __syncthreads();
    const __nv_bfloat16* tile = sm.s[st & 1];

    // product 1: the logits of session rows BM / 4 wr + [0, BM / 4), items 32 wc + [0, 32)
    float acc[MF][4][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      uint32_t a[MF][4], b[4][2];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) bt::frag_a<P>(tile, (BM / 4) * wr + 16 * mf, k, a[mf]);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) bt::frag_b<P>(sm.items, 32 * wc + 8 * nf, k, b[nf]);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) bt::mma(acc[mf][nf], a[mf], b[nf]);
    }
    // pw in f32 (kCE: the label term inside the tile), 0 past N, rounded to bf16 once (:672-676, :786), as
    // [item][session]
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (BM / 4) * wr + 16 * mf + g + 8 * (e >> 1);
          const int c = 32 * wc + 8 * nf + 2 * t + (e & 1);
          const float pw = weight<F>(acc[mf][nf][e], sm.z[r], sm.coeff[r], F == kCE ? sm.y[r] : -1, 0.f,
                                     item0 + c, N);
          sm.pt[c * PTP + r] = __float2bfloat16_rn(pw);
        }
    __syncthreads();

    // product 3: di (item rows 16 wr + [0, 16), columns D / 2 wc + [0, D / 2)) += pw^T s
#pragma unroll
    for (int k = 0; k < BM; k += 16) {
      uint32_t a[4];
      bt::frag_a<PTP>(sm.pt, 16 * wr, k, a);
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        uint32_t b[2];
        bt::frag_b_t<P>(tile, k, (D / 2) * wc + 8 * nf, b);
        bt::mma(di[nf], a, b);
      }
    }
    __syncthreads();  // pw, the row vectors and this ring slot are consumed
  }

  const long long di_row = item0 + 16 * wr + g;
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf) {
    const int col = (D / 2) * wc + 8 * nf + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (di_row + 8 * hh < N)
        *reinterpret_cast<float2*>(di_out + (di_row + 8 * hh) * D + col) = make_float2(di[nf][2 * hh],
                                                                                        di[nf][2 * hh + 1]);
  }
}

// ------------------------------------------------------------ kernel 11

template <int D, int BM = grad_bm(D)>
struct DiSmem {
  __nv_bfloat16 items[kBN * bt::pitch(D)];
  __nv_bfloat16 s[2][BM * bt::pitch(D)];
  __nv_bfloat16 ws[BM * bt::pitch(D)];     // the session tile times dlse, rounded to bf16
  __nv_bfloat16 pt[kBN * bt::pitch(BM)];  // p rounded to bf16, [item][session]
  float lse[BM];
  float dlse[BM];
  float bias[kBN];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    lse_bwd_di_bf16_kernel(const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ items,
                           const float* __restrict__ bias, const float* __restrict__ lse,
                           const float* __restrict__ dlse, float* __restrict__ di_out, long long M, long long N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DiSmem<D>& sm = *reinterpret_cast<DiSmem<D>*>(smem_raw);
  constexpr int P = bt::pitch(D);
  constexpr int BM = grad_bm(D), PTP = bt::pitch(BM);
  constexpr int MF = BM / 64;  // 16-row fragments of a warp's BM / 4 session rows
  constexpr int kNF = D / 16;  // 8-column fragments of a warp's D / 2 columns of di
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wr = warp >> 1, wc = warp & 1;
  const long long item0 = (long long)blockIdx.x * kBN;
  const long long m_tiles = (M + BM - 1) / BM;

  bt::stage_async<D, kBN, kThreads>(sm.items, items, D, item0, N);
  bt::stage_async<D, BM, kThreads>(sm.s[0], s, D, 0, M);
  tc::cp_commit();
  load_bias(sm.bias, bias, item0, N);  // read after the first barrier
  float di[kNF][4];
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) di[nf][e] = 0.f;

  for (long long st = 0; st < m_tiles; ++st) {
    const long long row0 = st * BM;
    if (st + 1 < m_tiles) {
      bt::stage_async<D, BM, kThreads>(sm.s[(st + 1) & 1], s, D, row0 + BM, M);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    if (threadIdx.x < BM) {
      const long long row = row0 + threadIdx.x;
      sm.lse[threadIdx.x] = row < M ? lse[row] : INFINITY;
      sm.dlse[threadIdx.x] = row < M ? dlse[row] : 0.f;
    }
    __syncthreads();
    const __nv_bfloat16* tile = sm.s[st & 1];

    // s * dlse in f32, rounded to bf16 (:281-282); rows past M are zeros times 0
    for (int idx = threadIdx.x; idx < BM * (D / 2); idx += kThreads) {
      const int r = idx / (D / 2);
      const int c = 2 * (idx - r * (D / 2));
      const uint32_t v = bt::ld2(tile + r * P + c);
      const float x0 = __bfloat162float(__ushort_as_bfloat16((unsigned short)(v & 0xffffu)));
      const float x1 = __bfloat162float(__ushort_as_bfloat16((unsigned short)(v >> 16)));
      *reinterpret_cast<uint32_t*>(sm.ws + r * P + c) = bt::pack(x0 * sm.dlse[r], x1 * sm.dlse[r]);
    }

    // product 1: the logits of session rows BM / 4 wr + [0, BM / 4), items 32 wc + [0, 32)
    float acc[MF][4][4];
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mf][nf][e] = 0.f;
#pragma unroll
    for (int k = 0; k < D; k += 16) {
      uint32_t a[MF][4], b[4][2];
#pragma unroll
      for (int mf = 0; mf < MF; ++mf) bt::frag_a<P>(tile, (BM / 4) * wr + 16 * mf, k, a[mf]);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) bt::frag_b<P>(sm.items, 32 * wc + 8 * nf, k, b[nf]);
#pragma unroll
      for (int mf = 0; mf < MF; ++mf)
#pragma unroll
        for (int nf = 0; nf < 4; ++nf) bt::mma(acc[mf][nf], a[mf], b[nf]);
    }
    // p = exp((logit + bias) - lse) in f32, 0 past N, then bf16 (:279-280), as [item][session]
#pragma unroll
    for (int mf = 0; mf < MF; ++mf)
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = (BM / 4) * wr + 16 * mf + g + 8 * (e >> 1);
          const int c = 32 * wc + 8 * nf + 2 * t + (e & 1);
          float p = expf((acc[mf][nf][e] + sm.bias[c]) - sm.lse[r]);
          if (item0 + c >= N) p = 0.f;
          sm.pt[c * PTP + r] = __float2bfloat16_rn(p);
        }
    __syncthreads();

    // product 3: di (item rows 16 wr + [0, 16), columns D / 2 wc + [0, D / 2)) += p^T (s * dlse)
#pragma unroll
    for (int k = 0; k < BM; k += 16) {
      uint32_t a[4];
      bt::frag_a<PTP>(sm.pt, 16 * wr, k, a);
#pragma unroll
      for (int nf = 0; nf < kNF; ++nf) {
        uint32_t b[2];
        bt::frag_b_t<P>(sm.ws, k, (D / 2) * wc + 8 * nf, b);
        bt::mma(di[nf], a, b);
      }
    }
    __syncthreads();  // p, s * dlse, the row vectors and this ring slot are consumed
  }

  const long long di_row = item0 + 16 * wr + g;
#pragma unroll
  for (int nf = 0; nf < kNF; ++nf) {
    const int col = (D / 2) * wc + 8 * nf + 2 * t;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
      if (di_row + 8 * hh < N)
        *reinterpret_cast<float2*>(di_out + (di_row + 8 * hh) * D + col) = make_float2(di[nf][2 * hh],
                                                                                        di[nf][2 * hh + 1]);
  }
}

// ---------------------------------------------------------------- launches

// fn(std::integral_constant<int, D>{}) for D in {16, 32, 64, 128, 256}, else cudaErrorInvalidValue
template <class Fn>
int by_width(int D, Fn fn) {
  switch (D) {
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// kernels 6, 8 and 16: one block per (session tile, item chunk); kernel 15
// (kCluster): grid (session tiles, cluster), one cluster of `cluster` blocks
// along y per session tile, chunk_rows a rank's item rows
template <int D, int kMode>
int launch_lse(const __nv_bfloat16* s, const __nv_bfloat16* items, const float* bias, const float* shift,
               float* m_part, float* l_part, long long M, long long N, long long chunk_rows, int cluster,
               cudaStream_t stream) {
  const int smem = (int)sizeof(LseSmem<D>);
  cudaError_t err =
      cudaFuncSetAttribute(lse_partials_bf16_kernel<D, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const unsigned m_tiles = (unsigned)((M + kBM - 1) / kBM);
  if constexpr (kMode != kCluster) {
    const dim3 grid(m_tiles, (unsigned)((N + chunk_rows - 1) / chunk_rows));
    lse_partials_bf16_kernel<D, kMode><<<grid, kThreads, smem, stream>>>(s, items, bias, shift, m_part, l_part, M,
                                                                          N, chunk_rows);
    return (int)cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(m_tiles, (unsigned)cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = (unsigned)cluster;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, lse_partials_bf16_kernel<D, kMode>, s, items, bias, shift, m_part, l_part, M, N,
                           chunk_rows);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int D, int F>
int launch_ce(const __nv_bfloat16* s, const __nv_bfloat16* items, const float* z, const long long* y,
              const float* coeff, const float* bias, float* ds_part, float* di_part, long long M, long long N,
              long long chunk_rows, long long tiles_per_group, long long n_groups, cudaStream_t stream) {
  const long long m_tiles = (M + grad_bm(D) - 1) / grad_bm(D);
  if (tiles_per_group <= 0 || (m_tiles + tiles_per_group - 1) / tiles_per_group != n_groups)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(CeSmem<D>);
  cudaError_t err =
      cudaFuncSetAttribute(ce_fused_bf16_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((N + chunk_rows - 1) / chunk_rows), (unsigned)n_groups);
  ce_fused_bf16_kernel<D, F><<<grid, kThreads, smem, stream>>>(s, items, z, y, coeff, bias, ds_part, di_part, M, N,
                                                               chunk_rows, tiles_per_group);
  return (int)cudaGetLastError();
}

template <int D, int F>
int launch_ds(const __nv_bfloat16* s, const __nv_bfloat16* items, const float* row_a, const long long* y,
              const float* row_b, const float* bias, float* ds_part, long long M, long long N, long long chunk_rows,
              long long n_chunks, int step_tiles, cudaStream_t stream) {
  if ((N + chunk_rows - 1) / chunk_rows != n_chunks) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(DsSmem<D>);
  cudaError_t err =
      cudaFuncSetAttribute(split_ds_bf16_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + grad_bm(D) - 1) / grad_bm(D)), (unsigned)n_chunks);
  split_ds_bf16_kernel<D, F><<<grid, kThreads, smem, stream>>>(s, items, row_a, y, row_b, bias, ds_part, M, N,
                                                               chunk_rows, step_tiles);
  return (int)cudaGetLastError();
}

template <int D, int F>
int launch_split_di(const __nv_bfloat16* s, const __nv_bfloat16* items, const float* z, const long long* y,
                    const float* coeff, float* di, long long M, long long N, cudaStream_t stream) {
  const int smem = (int)sizeof(ZDiSmem<D>);
  cudaError_t err =
      cudaFuncSetAttribute(split_di_bf16_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  split_di_bf16_kernel<D, F><<<(unsigned)((N + kBN - 1) / kBN), kThreads, smem, stream>>>(s, items, z, y, coeff, di,
                                                                                           M, N);
  return (int)cudaGetLastError();
}

template <int D>
int launch_di(const __nv_bfloat16* s, const __nv_bfloat16* items, const float* bias, const float* lse,
              const float* dlse, float* di, long long M, long long N, cudaStream_t stream) {
  const int smem = (int)sizeof(DiSmem<D>);
  cudaError_t err =
      cudaFuncSetAttribute(lse_bwd_di_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lse_bwd_di_bf16_kernel<D><<<(unsigned)((N + kBN - 1) / kBN), kThreads, smem, stream>>>(s, items, bias, lse, dlse,
                                                                                         di, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// Kernel 6 on bf16 (M, D) sessions and (N, D) items: f32 (n_chunks, M) max
// and sum-of-exp partials per item chunk of chunk_rows rows (a multiple of
// 64). D in {16, 32, 64, 128, 256}, rows 16-byte aligned (checked by the Python
// wrapper). Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int lse_partials_bf16(const void* s, const void* items, float* m_part, float* l_part, long long M,
                                 long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_lse<decltype(w)::value, kPartials>(sb, ib, nullptr, nullptr, m_part, l_part, M, N, chunk_rows, 1,
                                                      stream);
  });
}

// Kernel 8: kernel 6 with the f32 (N,) bias added to each logit; the same
// partials.
extern "C" int lse_bias_bf16(const void* s, const void* items, const float* bias, float* m_part, float* l_part,
                             long long M, long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_lse<decltype(w)::value, kBias>(sb, ib, bias, nullptr, m_part, l_part, M, N, chunk_rows, 1,
                                                  stream);
  });
}

// Kernel 16 on bf16 towers: the caller's f32 shift (M,); l_part and l2_part
// (ceil(N / chunk_rows), M): each item chunk's f32 sum of exp(logit - shift)
// and of exp(logit - shift + 64) per session row.
extern "C" int lse_shift_bf16(const void* s, const void* items, const float* shift, float* l_part, float* l2_part,
                              long long M, long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_lse<decltype(w)::value, kShift>(sb, ib, nullptr, shift, l_part, l2_part, M, N, chunk_rows, 1,
                                                   stream);
  });
}

// Kernel 15 on bf16 towers: lse (M,) in f32, one running (max, sum of exp) per
// row over the whole catalog, in clusters of `cluster` (1-8) blocks per
// session tile, rank q walking item rows [q * rank_rows, (q + 1) * rank_rows)
// (a multiple of 64; a rank past N adds nothing); the caller plans both from
// N (ops/softmax_lse.py `lse_cluster_plan`).
extern "C" int lse_bf16(const void* s, const void* items, float* lse, long long M, long long N, int D, int cluster,
                        long long rank_rows, cudaStream_t stream) {
  if (M <= 0) return 0;
  if (cluster < 1 || cluster > 8 || rank_rows <= 0 || rank_rows % kBN || cluster * rank_rows < N)
    return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_lse<decltype(w)::value, kCluster>(sb, ib, nullptr, nullptr, lse, nullptr, M, N, rank_rows, cluster,
                                                     stream);
  });
}

// Kernel 9: the generic lse backward in one pass, on the f32 one pass's grid: f32 ds
// partials (n_chunks, M, D) and f32 di partials (n_groups, N, D). bias f32
// (N,), lse and dlse f32 (M,).
extern "C" int lse_bwd_fused_bf16(const void* s, const void* items, const float* bias, const float* lse,
                                  const float* dlse, float* ds_part, float* di_part, long long M, long long N, int D,
                                  long long chunk_rows, long long tiles_per_group, long long n_groups,
                                  cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_ce<decltype(w)::value, kLse>(sb, ib, lse, nullptr, dlse, bias, ds_part, di_part, M, N, chunk_rows,
                                               tiles_per_group, n_groups, stream);
  });
}

// Kernel 10: f32 ds partials (n_chunks, M, D), one per item chunk of
// chunk_rows rows (a multiple of 64) of ops/softmax_lse.py `split_bwd_plan`;
// another n_chunks returns cudaErrorInvalidValue.
extern "C" int lse_bwd_ds_bf16(const void* s, const void* items, const float* bias, const float* lse,
                               const float* dlse, float* ds_part, long long M, long long N, int D,
                               long long chunk_rows, long long n_chunks, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_ds<decltype(w)::value, kLse>(sb, ib, lse, nullptr, dlse, bias, ds_part, M, N, chunk_rows,
                                               n_chunks, 0, stream);
  });
}

// Kernel 11: f32 di (N, D), each 64-row item tile written once by its block.
extern "C" int lse_bwd_di_bf16(const void* s, const void* items, const float* bias, const float* lse,
                               const float* dlse, float* di, long long M, long long N, int D, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_di<decltype(w)::value>(sb, ib, bias, lse, dlse, di, M, N, stream);
  });
}

// Kernel 13: f32 ds partials (n_chunks, M, D) of P items, P = exp(logit - z)
// rounded to bf16, each chunk one f32 sum (no bf16 partial), on the grid of
// `split_bwd_plan`.
extern "C" int grads_z_ds_bf16(const void* s, const void* items, const float* z, float* ds_part, long long M,
                               long long N, int D, long long chunk_rows, long long n_chunks, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_ds<decltype(w)::value, kZ>(sb, ib, z, nullptr, nullptr, nullptr, ds_part, M, N, chunk_rows,
                                             n_chunks, 0, stream);
  });
}

// Kernel 14: f32 di (N, D) = P^T s with the same rounded P.
extern "C" int grads_z_di_bf16(const void* s, const void* items, const float* z, float* di, long long M, long long N,
                               int D, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  const auto* sb = static_cast<const __nv_bfloat16*>(s);
  const auto* ib = static_cast<const __nv_bfloat16*>(items);
  return by_width(D, [&](auto w) {
    return launch_split_di<decltype(w)::value, kZ>(sb, ib, z, nullptr, nullptr, di, M, N, stream);
  });
}

// Bytes of dynamic shared memory a block of each bf16 loss kernel takes at
// width D: kernel 0 = kernels 6 / 8 / 15 / 16, 1 = 9 (the one pass), 2 = 10 / 13,
// 3 = 14, 4 = 11; -1 for another kernel, and cudaErrorInvalidValue (1) for another D
// (kernels 7 and 12 in bf16: ce_grads_bf16.cu `ce_grads_bf16_smem_bytes`).
extern "C" int lse_bf16_smem_bytes(int kernel, int D) {
  return by_width(D, [&](auto w) {
    constexpr int W = decltype(w)::value;
    switch (kernel) {
      case 0: return (int)sizeof(LseSmem<W>);
      case 1: return (int)sizeof(CeSmem<W>);
      case 2: return (int)sizeof(DsSmem<W>);
      case 3: return (int)sizeof(ZDiSmem<W>);
      case 4: return (int)sizeof(DiSmem<W>);
      default: return -1;
    }
  });
}
