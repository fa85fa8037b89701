// Streaming logsumexp over an item table and the fused softmax-CE gradients,
// float32, without the (M, N) logits ever reaching device memory.
//
// Replaces:
// - rectools_tpu/ops/softmax_lse.py:169 `_lse_fwd_partials_kernel` (`lse_f32`):
//   lse[m] = logsumexp_n(s[m] . items[n]);
// - rectools_tpu/ops/softmax_lse.py:643 `_ce_grads_z_fused_kernel`
//   (`ce_ds_f32` and `ce_di_f32`): with P = exp(s items^T - z) and
//   D = coeff * onehot(y), ds = (P - D) items and di = (P - D)^T s.
//
// Bound on an H100: f32 operations. At the training shape M = 512 * 100 =
// 51,200 sessions, N = 15,872 items, D = 128, one logit pass is
// 2 * M * N * D = 208 GFLOP, 3.10 ms at 67 TFLOP/s (non-tensor FP32); the CE
// gradients are three such products (logits, ds, di), 624 GFLOP, 9.31 ms.
// The JAX reference is exact f32, so these are f32 FMA SIMT tiles, not TF32
// tensor-core tiles (a tensor-core design with its own tolerance is later
// work).
//
// Design, all three kernels: 256 threads in a 16 x 16 grid; a block holds a
// 64-row session tile and a 64-row item tile whole in shared memory (rows
// padded to D + 1 floats so the per-thread row reads are conflict-free) and
// forms their 64 x 64 logits, each thread a 4 x 4 micro-tile (rows ty + 16a,
// columns tx + 16b). Ragged edges are masked by index: item rows past N and
// session rows past M load as zeros, their columns are left out of the
// max/sum, and their probabilities are forced to 0 (the NaN rule of
// softmax_lse.py:636-640: garbage times 0 can be NaN).
//
// - lse_f32: a block owns a session tile and streams every item tile, each
//   thread keeping a running (max, sum of exp) for its rows over the columns
//   it sees; the 16 threads that share a row merge theirs with shuffles at
//   the end. One pass, no partials buffer.
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
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float mx = m_run[a];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (n0 + tx + 16 * b < N) mx = fmaxf(mx, acc[a][b]);
      float l = l_run[a] * expf(m_run[a] - mx);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (n0 + tx + 16 * b < N) l += expf(acc[a][b] - mx);
      m_run[a] = mx;
      l_run[a] = l;
    }
  }
  // merge the 16 threads of a row (lanes tx = 0..15 of one half warp)
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    float m = m_run[a], l = l_run[a];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m, off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l, off);
      const float m_new = fmaxf(m, m_o);
      l = l * expf(m - m_new) + l_o * expf(m_o - m_new);
      m = m_new;
    }
    const long long row = row0 + ty + 16 * a;
    if (tx == 0 && row < M) lse[row] = m + logf(l);
  }
}

// Shared layout of the gradient kernels: session tile, item tile, the
// corrected probability tile [64][65], then z, coeff and y of the session tile.
template <int D>
constexpr int grad_smem_bytes() {
  return (2 * 64 * (D + 1) + kBM * (kBN + 1) + 2 * kBM) * (int)sizeof(float) + kBM * (int)sizeof(long long);
}

// z, coeff and y of session rows [row0, row0 + 64); rows past M get z = +inf
// and coeff = 0, so their probabilities and label terms vanish
__device__ __forceinline__ void load_rows(float* zs, float* cs, long long* ys, const float* __restrict__ z,
                                          const float* __restrict__ coeff, const long long* __restrict__ y,
                                          long long row0, long long M) {
  for (int r = threadIdx.x; r < kBM; r += kThreads) {
    const bool ok = row0 + r < M;
    zs[r] = ok ? z[row0 + r] : INFINITY;
    cs[r] = ok ? coeff[row0 + r] : 0.f;
    ys[r] = ok ? y[row0 + r] : -1;
  }
}

// p_tile[a_row][b_col] = exp(logit - z) - coeff * [col == y], 0 past N
template <int D>
__device__ __forceinline__ void corrected_probs(const float acc[4][4], float* p_tile, const float* zs,
                                                const float* cs, const long long* ys, long long n0, long long N,
                                                int ty, int tx) {
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = ty + 16 * a;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int c = tx + 16 * b;
      const long long col = n0 + c;
      float pw = 0.f;
      if (col < N) {
        pw = expf(acc[a][b] - zs[r]);
        if (col == ys[r]) pw -= cs[r];
      }
      p_tile[r * (kBN + 1) + c] = pw;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    ce_ds_kernel(const float* __restrict__ s, const float* __restrict__ items, const float* __restrict__ z,
                 const long long* __restrict__ y, const float* __restrict__ coeff, float* __restrict__ ds,
                 long long M, long long N) {
  extern __shared__ float smem[];
  float* s_tile = smem;
  float* i_tile = s_tile + kBM * (D + 1);
  float* p_tile = i_tile + kBN * (D + 1);
  float* zs = p_tile + kBM * (kBN + 1);
  float* cs = zs + kBM;
  long long* ys = reinterpret_cast<long long*>(cs + kBM);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long row0 = (long long)blockIdx.x * kBM;
  load_tile<D>(s_tile, s, row0, M);
  load_rows(zs, cs, ys, z, coeff, y, row0, M);

  constexpr int kC = (D + 15) / 16;
  float out[4][kC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) out[a][c] = 0.f;

  for (long long n0 = 0; n0 < N; n0 += kBN) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<D>(i_tile, items, n0, N);
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(s_tile, i_tile, ty, tx, acc);
    corrected_probs<D>(acc, p_tile, zs, cs, ys, n0, N, ty, tx);
    __syncthreads();
#pragma unroll 2
    for (int n = 0; n < kBN; ++n) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_tile[(ty + 16 * a) * (kBN + 1) + n];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tx + 16 * c;
        const float iv = col < D ? i_tile[n * (D + 1) + col] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) out[a][c] = fmaf(pa[a], iv, out[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long row = row0 + ty + 16 * a;
    if (row >= M) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) ds[row * D + col] = out[a][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    ce_di_kernel(const float* __restrict__ s, const float* __restrict__ items, const float* __restrict__ z,
                 const long long* __restrict__ y, const float* __restrict__ coeff, float* __restrict__ di,
                 long long M, long long N) {
  extern __shared__ float smem[];
  float* s_tile = smem;
  float* i_tile = s_tile + kBM * (D + 1);
  float* p_tile = i_tile + kBN * (D + 1);
  float* zs = p_tile + kBM * (kBN + 1);
  float* cs = zs + kBM;
  long long* ys = reinterpret_cast<long long*>(cs + kBM);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const long long n0 = (long long)blockIdx.x * kBN;
  load_tile<D>(i_tile, items, n0, N);

  constexpr int kC = (D + 15) / 16;
  float out[4][kC];  // items ty + 16a, dims tx + 16c
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kC; ++c) out[a][c] = 0.f;

  for (long long row0 = 0; row0 < M; row0 += kBM) {
    __syncthreads();  // the previous tiles are consumed
    load_tile<D>(s_tile, s, row0, M);
    load_rows(zs, cs, ys, z, coeff, y, row0, M);
    __syncthreads();
    float acc[4][4];
    tile_logits<D>(s_tile, i_tile, ty, tx, acc);
    corrected_probs<D>(acc, p_tile, zs, cs, ys, n0, N, ty, tx);
    __syncthreads();
#pragma unroll 2
    for (int m = 0; m < kBM; ++m) {
      float pa[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pa[a] = p_tile[m * (kBN + 1) + ty + 16 * a];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const int col = tx + 16 * c;
        const float sv = col < D ? s_tile[m * (D + 1) + col] : 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a) out[a][c] = fmaf(pa[a], sv, out[a][c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const long long item = n0 + ty + 16 * a;
    if (item >= N) continue;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const int col = tx + 16 * c;
      if (col < D) di[item * D + col] = out[a][c];
    }
  }
}

template <int D>
int launch_lse(const float* s, const float* items, float* lse, long long M, long long N, cudaStream_t stream) {
  const int smem = 2 * 64 * (D + 1) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(lse_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  lse_kernel<D><<<(unsigned)((M + kBM - 1) / kBM), kThreads, smem, stream>>>(s, items, lse, M, N);
  return (int)cudaGetLastError();
}

template <int D>
int launch_ds(const float* s, const float* items, const float* z, const long long* y, const float* coeff, float* ds,
              long long M, long long N, cudaStream_t stream) {
  const int smem = grad_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(ce_ds_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ce_ds_kernel<D><<<(unsigned)((M + kBM - 1) / kBM), kThreads, smem, stream>>>(s, items, z, y, coeff, ds, M, N);
  return (int)cudaGetLastError();
}

template <int D>
int launch_di(const float* s, const float* items, const float* z, const long long* y, const float* coeff, float* di,
              long long M, long long N, cudaStream_t stream) {
  const int smem = grad_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(ce_di_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ce_di_kernel<D><<<(unsigned)((N + kBN - 1) / kBN), kThreads, smem, stream>>>(s, items, z, y, coeff, di, M, N);
  return (int)cudaGetLastError();
}

}  // namespace

// sessions (M, D) and items (N, D) row-major, 16-byte aligned; D in
// {16, 32, 64, 128, 256}. Each returns cudaGetLastError() after its launch
// (0 = launched).
extern "C" int lse_f32(const float* s, const float* items, float* lse, long long M, long long N, int D,
                       cudaStream_t stream) {
  if (M <= 0) return 0;
  switch (D) {
    case 16: return launch_lse<16>(s, items, lse, M, N, stream);
    case 32: return launch_lse<32>(s, items, lse, M, N, stream);
    case 64: return launch_lse<64>(s, items, lse, M, N, stream);
    case 128: return launch_lse<128>(s, items, lse, M, N, stream);
    case 256: return launch_lse<256>(s, items, lse, M, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ce_ds_f32(const float* s, const float* items, const float* z, const long long* y, const float* coeff,
                         float* ds, long long M, long long N, int D, cudaStream_t stream) {
  if (M <= 0) return 0;
  switch (D) {
    case 16: return launch_ds<16>(s, items, z, y, coeff, ds, M, N, stream);
    case 32: return launch_ds<32>(s, items, z, y, coeff, ds, M, N, stream);
    case 64: return launch_ds<64>(s, items, z, y, coeff, ds, M, N, stream);
    case 128: return launch_ds<128>(s, items, z, y, coeff, ds, M, N, stream);
    case 256: return launch_ds<256>(s, items, z, y, coeff, ds, M, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ce_di_f32(const float* s, const float* items, const float* z, const long long* y, const float* coeff,
                         float* di, long long M, long long N, int D, cudaStream_t stream) {
  if (N <= 0) return 0;
  switch (D) {
    case 16: return launch_di<16>(s, items, z, y, coeff, di, M, N, stream);
    case 32: return launch_di<32>(s, items, z, y, coeff, di, M, N, stream);
    case 64: return launch_di<64>(s, items, z, y, coeff, di, M, N, stream);
    case 128: return launch_di<128>(s, items, z, y, coeff, di, M, N, stream);
    case 256: return launch_di<256>(s, items, z, y, coeff, di, M, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
