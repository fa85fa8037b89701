// Streaming logsumexp over an item table and the softmax gradients that go
// with it, float32, without the (M, N) logits ever reaching device memory.
//
// Replaces:
// - rectools_tpu/ops/softmax_lse.py:169 `_lse_fwd_partials_kernel`
//   (`lse_partials_f32`, the default forward): per (item chunk, session tile)
//   the chunk's (max, sum of exp) of s . items^T, written to (n_chunks, M)
//   partials that the caller combines (max over chunks, then
//   sum l * exp(m - max), then max + log).
// - rectools_tpu/ops/softmax_lse.py:127 `_lse_fwd_tail_kernel` (`lse_f32`,
//   the carried-max forward, `USE_PARTIALS_FWD = False`): lse[m] =
//   logsumexp_n(s[m] . items[n]) with one running (max, sum of exp) per row.
// - rectools_tpu/ops/softmax_lse.py:50 `_lse_shift_kernel` (`lse_shift_f32`,
//   `bounded_shift=True`): with a per-row shift >= every logit of the row
//   (computed by the caller), l = sum exp(logit - shift) and
//   l2 = sum exp(logit - shift + 64) per (item chunk, session tile), no max;
//   the caller sums the chunks and picks a window per row.
// - rectools_tpu/ops/softmax_lse.py:643 `_ce_grads_z_fused_kernel`
//   (`ce_ds_f32` and `ce_di_f32`): with P = exp(s items^T - z) and
//   D = coeff * onehot(y), ds = (P - D) items and di = (P - D)^T s.
// - rectools_tpu/ops/softmax_lse.py:591 `_grads_z_fused_kernel`
//   (`grads_z_fused_f32`), :757 `_ds_z_kernel` (`grads_z_ds_f32`) and :774
//   `_di_z_kernel` (`grads_z_di_f32`): ds = P items and di = P^T s, the
//   nonnegative-cotangent softmax backward, no label term; the softmax-CE
//   loss takes it above the partials budget of its fused kernel and applies
//   the label term outside (softmax_lse.py:748-754).
//
// Bound on an H100: f32 operations. At the training shape M = 512 * 100 =
// 51,200 sessions, N = 15,872 items, D = 128, one logit pass is
// 2 * M * N * D = 208 GFLOP, 3.10 ms at 67 TFLOP/s (non-tensor FP32); the CE
// gradients are three such products (logits, ds, di), 624 GFLOP, 9.31 ms.
// The JAX reference is exact f32, so these are f32 FMA SIMT tiles, not TF32
// tensor-core tiles (a tensor-core design with its own tolerance is later
// work). No fast-math: subnormals reach the edge of the shift windows.
//
// Design, all kernels: 256 threads in a 16 x 16 grid; a block holds a
// 64-row session tile and a 64-row item tile whole in shared memory (rows
// padded to D + 1 floats so the per-thread row reads are conflict-free) and
// forms their 64 x 64 logits, each thread a 4 x 4 micro-tile (rows ty + 16a,
// columns tx + 16b). Ragged edges are masked by index: item rows past N and
// session rows past M load as zeros, their columns are left out of the
// max/sum, and their probabilities are forced to 0 (the NaN rule of
// softmax_lse.py:636-640: garbage times 0 can be NaN).
//
// - lse_f32 (kernel 15): a block owns a session tile and streams every item
//   tile, each thread keeping a running (max, sum of exp) for its rows over
//   the columns it sees; the 16 threads that share a row merge theirs with
//   shuffles at the end. One pass, no partials buffer. At the training shape
//   that is 800 blocks of 66 KB of shared memory, 3 or 2 resident per SM:
//   2.02 or 3.03 waves on 132 SMs, the last wave 8 blocks.
// - lse_partials_f32 (kernel 6) and lse_shift_f32 (kernel 16): a block owns
//   (session tile, item chunk of `chunk_rows` rows, 2,048 from the wrapper)
//   and writes one partial per row; blockIdx.x runs over the session tiles,
//   so the blocks in flight share an item chunk (1 MB at D = 128) in L2.
//   2,048 rows: 8 chunks at N = 15,872, so 6,400 blocks, 16.2 waves at 3
//   blocks per SM (24.2 at 2): the partial last wave costs under a sixteenth
//   of the time instead of a third. Each chunk holds at least one valid
//   column, so no max partial is empty; the partials are 2 * 8 * M floats.
//   Kernel 16's sums add in a fixed order (columns in tile order, then the
//   16 lanes by a butterfly, then the chunks in the caller).
// - The CE gradients need a sum over items (ds) and a sum over sessions (di).
//   On the TPU one fused pass wrote ds as per-chunk partials and carried di
//   across its sequential grid (softmax_lse.py:655-660, 725-745). GPU blocks
//   run in no order, so one fused pass would need float atomics or an
//   (M-tiles, N, D) partials buffer for one of the two. The choice here:
//   two kernels launched back to back, each owning its output. `ce_ds_f32`:
//   a block owns a session tile, streams every item tile, recomputes the
//   logits, forms the corrected probability tile P - D in shared memory and
//   accumulates ds += (P - D) items in registers. `ce_di_f32`: a block owns an
//   item tile, streams every session tile and accumulates di += (P - D)^T s.
//   Deterministic, no atomics, no partials; the price is a second logit pass,
//   8 * M * N * D operations against the function's 6 * M * N * D.
// Rows with z = +inf (PAD targets, coeff = 0) contribute nothing.
//
// The biased lse and its generic VJP (the row-sharded loss of mesh training:
// each rank holds a slice of the item table, a bias of 0 / -1e30 marks rows
// that only pad the slice):
// - rectools_tpu/ops/softmax_lse.py:99 `_lse_fwd_kernel` (`lse_bias_f32`):
//   lse[m] = logsumexp_n(s[m] . items[n] + bias[n]). `lse_f32`'s kernel with
//   the bias added to each logit column before the max. The running max
//   starts at -1e30, not -inf, so a slice whose every row is invalid gives
//   -1e30 + log(count), never NaN or inf.
// - rectools_tpu/ops/softmax_lse.py:205 `_dsessions_kernel` (`lse_bwd_ds_f32`)
//   and :266 `_ditems_kernel` (`lse_bwd_di_f32`): the two CE gradient kernels
//   with pw = exp((logit + bias[n]) - lse[m]) * dlse[m] in place of
//   exp(logit - z[m]) and no label term; dlse may have any sign. Both form pw
//   (probability times dlse) and multiply it into the item rows or the plain
//   session rows; the TPU `_ditems_kernel` scales the session rows by dlse
//   instead, which differs in rounding only.
// - rectools_tpu/ops/softmax_lse.py:234 `_bwd_fused_kernel`
//   (`lse_bwd_fused_f32`): one logit pass for both gradients. A block owns an
//   item chunk (2,048 rows by default, 32 tiles) and a group of session tiles.
//   For each of its session tiles it walks the chunk's item tiles, forms each
//   pw tile once, adds pw items into a register accumulator that becomes the
//   ds partial of (chunk, session tile), and adds pw^T s into the block's own
//   slice of a di partial buffer in device memory, with plain loads and stores:
//   the block is that slice's only writer. Partials: ds (n_chunks, M, D) and di
//   (n_groups, N, D); the caller sums each over its first axis in a fixed
//   order. No float atomics, so a second run gives the same bits. 6 * M * N * D
//   operations against the split pair's 8 * M * N * D, paid for with the
//   read-modify-write of a 64 x D block per tile pair.
// In these three, session rows past M and item rows past N have their pw
// forced to 0; an invalid row inside the slice (bias -1e30) gets
// exp(-1e30 - lse) = 0 by arithmetic, so its di row is exactly 0.
//
// The z form (kernels 12-14) is the same three kernels with pw = exp(logit -
// z[m]): no bias, no multiplier, no label term (`Form::kZ` below). Kernel 12
// keeps kernel 9's grid (one wave, ds partials per item chunk, di partials
// per session group by read-modify-write with one writer per row).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBM = 64;  // session rows per tile
constexpr int kBN = 64;  // item rows per tile
constexpr int kThreads = 256;
constexpr float kNegBig = -1e30f;

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

// kBias: add bias[n] to every logit column (lse_bias_f32); the bias tile sits
// behind the item tile in shared memory
template <int D, bool kBias>
__global__ void __launch_bounds__(kThreads)
    lse_kernel(const float* __restrict__ s, const float* __restrict__ items, const float* __restrict__ bias,
               float* __restrict__ lse, long long M, long long N) {
  extern __shared__ float smem[];
  float* s_tile = smem;
  float* i_tile = smem + kBM * (D + 1);
  float* bs = i_tile + kBN * (D + 1);
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
    if (kBias && threadIdx.x < kBN) bs[threadIdx.x] = n0 + threadIdx.x < N ? bias[n0 + threadIdx.x] : 0.f;
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(s_tile, i_tile, ty, tx, acc);
    if (kBias) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) acc[a][b] += bs[tx + 16 * b];
    }
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
// out_b = sum exp(logit - shift[m] + 64). Otherwise (kernel 6): out_a = the
// chunk's max logit, out_b = sum exp(logit - max).
template <int D, bool kShift>
__global__ void __launch_bounds__(kThreads)
    lse_chunk_kernel(const float* __restrict__ s, const float* __restrict__ items, const float* __restrict__ shift,
                     float* __restrict__ out_a, float* __restrict__ out_b, long long M, long long N,
                     long long chunk_rows) {
  extern __shared__ float smem[];
  float* s_tile = smem;
  float* i_tile = smem + kBM * (D + 1);
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
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(s_tile, i_tile, ty, tx, acc);
    if (kShift) {
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          if (n0 + tx + 16 * b >= n_end) continue;
          const float x = acc[a][b] - sh[a];
          a_run[a] += expf(x);
          b_run[a] += expf(x + 64.f);
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

// row vectors of session rows [row0, row0 + 64); rows past M get row_a = +inf
// and row_b = 0, so their probabilities and label terms vanish
template <int F>
__device__ __forceinline__ void load_rows(const GradSmem& sh, const GradRows& in, long long row0, long long M) {
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const bool ok = row0 + r < M;
    sh.zs[r] = ok ? in.row_a[row0 + r] : INFINITY;
    if (F != kZ) sh.cs[r] = ok ? in.row_b[row0 + r] : 0.f;
    if (F == kCE) sh.ys[r] = ok ? in.y[row0 + r] : -1;
  }
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

template <int D, bool kBias>
int launch_lse(const float* s, const float* items, const float* bias, float* lse, long long M, long long N,
               cudaStream_t stream) {
  const int smem = (2 * 64 * (D + 1) + kBN) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lse_kernel<D, kBias>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lse_kernel<D, kBias><<<(unsigned)((M + kBM - 1) / kBM), kThreads, smem, stream>>>(s, items, bias, lse, M, N);
  return (int)cudaGetLastError();
}

template <int D, bool kShift>
int launch_chunks(const float* s, const float* items, const float* shift, float* out_a, float* out_b, long long M,
                  long long N, long long chunk_rows, cudaStream_t stream) {
  const int smem = 2 * 64 * (D + 1) * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(lse_chunk_kernel<D, kShift>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((M + kBM - 1) / kBM), (unsigned)((N + chunk_rows - 1) / chunk_rows));
  lse_chunk_kernel<D, kShift><<<grid, kThreads, smem, stream>>>(s, items, shift, out_a, out_b, M, N, chunk_rows);
  return (int)cudaGetLastError();
}

template <int D, int F>
int launch_ds(const float* s, const float* items, GradRows in, float* ds, long long M, long long N,
              cudaStream_t stream) {
  const int smem = grad_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(grad_ds_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  grad_ds_kernel<D, F><<<(unsigned)((M + kBM - 1) / kBM), kThreads, smem, stream>>>(s, items, in, ds, M, N);
  return (int)cudaGetLastError();
}

template <int D, int F>
int launch_di(const float* s, const float* items, GradRows in, float* di, long long M, long long N,
              cudaStream_t stream) {
  const int smem = grad_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(grad_di_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  grad_di_kernel<D, F><<<(unsigned)((N + kBN - 1) / kBN), kThreads, smem, stream>>>(s, items, in, di, M, N);
  return (int)cudaGetLastError();
}

template <int D, int F>
int launch_fused(const float* s, const float* items, GradRows in, float* ds_part, float* di_part, long long M,
                 long long N, long long chunk_rows, long long tiles_per_group, cudaStream_t stream) {
  const int smem = grad_smem_bytes<D>();
  cudaError_t err =
      cudaFuncSetAttribute(lse_bwd_fused_kernel<D, F>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long m_tiles = (M + kBM - 1) / kBM;
  const dim3 grid((unsigned)((N + chunk_rows - 1) / chunk_rows),
                  (unsigned)((m_tiles + tiles_per_group - 1) / tiles_per_group));
  lse_bwd_fused_kernel<D, F><<<grid, kThreads, smem, stream>>>(s, items, in, ds_part, di_part, M, N, chunk_rows,
                                                                tiles_per_group);
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
#define CALL_LSE(D, ...) launch_lse<D, false>(__VA_ARGS__)
#define CALL_LSE_BIAS(D, ...) launch_lse<D, true>(__VA_ARGS__)
#define CALL_LSE_PARTIALS(D, ...) launch_chunks<D, false>(__VA_ARGS__)
#define CALL_LSE_SHIFT(D, ...) launch_chunks<D, true>(__VA_ARGS__)
#define CALL_CE_DS(D, ...) launch_ds<D, kCE>(__VA_ARGS__)
#define CALL_CE_DI(D, ...) launch_di<D, kCE>(__VA_ARGS__)
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
extern "C" int lse_f32(const float* s, const float* items, float* lse, long long M, long long N, int D,
                       cudaStream_t stream) {
  if (M <= 0) return 0;
  DISPATCH_D(D, CALL_LSE, s, items, nullptr, lse, M, N, stream)
}

// m_part and l_part (ceil(N / chunk_rows), M): each item chunk's max logit and
// sum of exp(logit - max) per session row; chunk_rows a multiple of 64
extern "C" int lse_partials_f32(const float* s, const float* items, float* m_part, float* l_part, long long M,
                                long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  DISPATCH_D(D, CALL_LSE_PARTIALS, s, items, nullptr, m_part, l_part, M, N, chunk_rows, stream)
}

// shift (M,); l_part and l2_part (ceil(N / chunk_rows), M): each item chunk's
// sum of exp(logit - shift) and of exp(logit - shift + 64) per session row
extern "C" int lse_shift_f32(const float* s, const float* items, const float* shift, float* l_part, float* l2_part,
                             long long M, long long N, int D, long long chunk_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN) return (int)cudaErrorInvalidValue;
  DISPATCH_D(D, CALL_LSE_SHIFT, s, items, shift, l_part, l2_part, M, N, chunk_rows, stream)
}

extern "C" int lse_bias_f32(const float* s, const float* items, const float* bias, float* lse, long long M,
                            long long N, int D, cudaStream_t stream) {
  if (M <= 0) return 0;
  DISPATCH_D(D, CALL_LSE_BIAS, s, items, bias, lse, M, N, stream)
}

extern "C" int ce_ds_f32(const float* s, const float* items, const float* z, const long long* y, const float* coeff,
                         float* ds, long long M, long long N, int D, cudaStream_t stream) {
  if (M <= 0) return 0;
  const GradRows in{z, coeff, y, nullptr};
  DISPATCH_D(D, CALL_CE_DS, s, items, in, ds, M, N, stream)
}

extern "C" int ce_di_f32(const float* s, const float* items, const float* z, const long long* y, const float* coeff,
                         float* di, long long M, long long N, int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  const GradRows in{z, coeff, y, nullptr};
  DISPATCH_D(D, CALL_CE_DI, s, items, in, di, M, N, stream)
}

// bias (N,), lse and dlse (M,)
extern "C" int lse_bwd_ds_f32(const float* s, const float* items, const float* bias, const float* lse,
                              const float* dlse, float* ds, long long M, long long N, int D, cudaStream_t stream) {
  if (M <= 0) return 0;
  const GradRows in{lse, dlse, nullptr, bias};
  DISPATCH_D(D, CALL_LSE_DS, s, items, in, ds, M, N, stream)
}

extern "C" int lse_bwd_di_f32(const float* s, const float* items, const float* bias, const float* lse,
                              const float* dlse, float* di, long long M, long long N, int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  const GradRows in{lse, dlse, nullptr, bias};
  DISPATCH_D(D, CALL_LSE_DI, s, items, in, di, M, N, stream)
}

// ds_part (ceil(N / chunk_rows), M, D) and di_part (ceil(ceil(M / 64) /
// tiles_per_group), N, D); chunk_rows a multiple of 64
extern "C" int lse_bwd_fused_f32(const float* s, const float* items, const float* bias, const float* lse,
                                 const float* dlse, float* ds_part, float* di_part, long long M, long long N, int D,
                                 long long chunk_rows, long long tiles_per_group, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN || tiles_per_group <= 0) return (int)cudaErrorInvalidValue;
  const GradRows in{lse, dlse, nullptr, bias};
  DISPATCH_D(D, CALL_LSE_FUSED, s, items, in, ds_part, di_part, M, N, chunk_rows, tiles_per_group, stream)
}

// z (M,), +inf = ignore the row; the outputs as lse_bwd_ds_f32 / lse_bwd_di_f32 /
// lse_bwd_fused_f32 give theirs
extern "C" int grads_z_ds_f32(const float* s, const float* items, const float* z, float* ds, long long M, long long N,
                              int D, cudaStream_t stream) {
  if (M <= 0) return 0;
  const GradRows in{z, nullptr, nullptr, nullptr};
  DISPATCH_D(D, CALL_Z_DS, s, items, in, ds, M, N, stream)
}

extern "C" int grads_z_di_f32(const float* s, const float* items, const float* z, float* di, long long M, long long N,
                              int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  const GradRows in{z, nullptr, nullptr, nullptr};
  DISPATCH_D(D, CALL_Z_DI, s, items, in, di, M, N, stream)
}

extern "C" int grads_z_fused_f32(const float* s, const float* items, const float* z, float* ds_part, float* di_part,
                                 long long M, long long N, int D, long long chunk_rows, long long tiles_per_group,
                                 cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (chunk_rows <= 0 || chunk_rows % kBN || tiles_per_group <= 0) return (int)cudaErrorInvalidValue;
  const GradRows in{z, nullptr, nullptr, nullptr};
  DISPATCH_D(D, CALL_Z_FUSED, s, items, in, ds_part, di_part, M, N, chunk_rows, tiles_per_group, stream)
}
