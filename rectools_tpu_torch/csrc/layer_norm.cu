// LayerNorm over the last axis of an (M, D) matrix: forward, and the
// backward that gives dx, dgamma and dbeta; float32, or bf16 in and out.
//
// Replaces: rectools_tpu/ops/layer_norm.py:27 `_fwd_kernel` (`ln_fwd_f32`, and
// `ln_fwd_bf16` for bf16 x) and rectools_tpu/ops/layer_norm.py:36 `_bwd_kernel`
// (`ln_bwd_f32`, and `ln_bwd_bf16`) (Pallas; one (block_m, D) VMEM tile per
// program, row statistics in f32, y and dx stored in x's dtype (:33, :58),
// dgamma and dbeta summed in f32 and cast to gamma's dtype (:133)).
//
// The bf16 forms are the f32 kernels instantiated on the element type T of x,
// y, dy and dx (`__nv_bfloat16`) and a second type G of gamma and beta (bf16
// when mixed-precision training casts the parameters, else float), with the
// same f32 arithmetic, lane layout and order of every sum: a loaded value is
// widened (exact), and each output is rounded once to nearest even
// (`__float2bfloat16_rn`), where JAX rounds it. So a bf16 call gives, bit for
// bit, what the f32 kernels give on the widened operands once rounded; a card
// test holds that. The f32 instantiations (T = G = float) are the f32 kernels
// as they were. dgamma and dbeta keep the f32 (n_blocks, 2, D) partials, the
// integer ticket and the last block's fixed-order sum; that block writes them
// in G, one rounding. Loads stay one element a lane a step (column lane + 32
// j): a bf16x2 or 16-byte load would sum each row in another order.
//
// Bound on an H100: bytes, both directions. The forward reads x once and
// writes y once (gamma and beta are D floats); at the serving shape
// M = 4096 * 100, D = 128 that is 420 MB, 0.125 ms at 3.35 TB/s. The backward
// reads x and dy and writes dx: at the training shape M = 512 * 100, D = 128,
// 3 * 26.2 MB, 0.023 ms. In bf16 every (M, D) array is half the bytes: at
// 51,200 x 128 the forward moves 26.2 MB, 0.0078 ms, and the backward 39.3 MB,
// 0.0117 ms. Arithmetic is a few operations per byte, far below the FP32
// ridge.
//
// Forward design: one warp per row, eight rows per 256-thread block. A lane
// keeps its ceil(D/32) values in registers (column lane + 32*j, so each load
// step is a coalesced 128-byte warp access), so x is read from device memory
// exactly once. Mean, then the centred sum of squares (flax's two-pass
// formula), are warp-shuffle reductions in f32. A ragged last block simply has
// idle warps.
//
// Backward design: one launch. The TPU kernel sums dgamma/dbeta in an output
// block that its sequential grid revisits; GPU blocks run in no order, and the
// port has no float atomics, so the sums go through per-block partials that
// the same launch adds up in a fixed order:
// - Partition: block b owns rows [b * rows_per_block, (b + 1) *
//   rows_per_block), with n_blocks and rows_per_block a function of M only
//   (ops/layer_norm.py `bwd_partition`: at most 128 blocks of at least 128
//   rows; 128 x 400 at the training shape, one block per SM, one wave), so
//   the bits are the same on every card. A block has 16 warps for D <= 256,
//   else 8 (`bwd_warps`). Warp w takes the block's rows w, w + W, w + 2W,
//   ..., kRows of them at a time (`kBwdRows`): a lane holds 2 x kRows rows of
//   x and dy in flight, 4 at D <= 128, at least two but for D > 256.
// - Per row, the reference's arithmetic in the forward kernel's lane layout
//   (column lane + 32 j, coalesced 4-byte loads), so the recomputed row
//   statistics are the forward's to the bit: mean, then the centred sum of
//   squares (two-pass), rsqrtf(var + eps), xhat, the two means of dxhat and
//   dxhat * xhat, dx; the kRows rows' warp reductions interleave. Each lane
//   adds dy * xhat and dy of its columns onto registers, row after row.
//   16-byte loads (lane q holding columns 4q..4q+3) sum each row in another
//   order: the backward's statistics then differ from the forward's in their
//   last bits, and a second path for D % 4 != 0 or unaligned pointers gives
//   other bits for the same values (PERF.md section 6).
// - Sums: the W warps' sums meet in shared memory and are added in warp order
//   into the block's (2, D) row of the (n_blocks, 2, D) partials. The block
//   then fences its row (__threadfence) and takes a ticket with an integer
//   atomicAdd; the block that draws the last ticket sums the partial rows in
//   block order: warp g adds the rows of blocks [g * per, (g + 1) * per), per
//   = ceil(n_blocks / W), all 32 lanes across the columns (reads past L1), and
//   the W group sums are added in group order in shared memory into dgamma
//   and dbeta. Integer atomics only: the same bits on a rerun.
// - The ticket counter: one unsigned int per (device, stream), allocated and
//   zeroed once by the wrapper, reset to 0 by the last block after its
//   reads. Stream order then hands the next launch on that stream a zero
//   counter with no memset on the stream (a per-call cudaMemsetAsync would
//   add a device operation and a gap before every launch); a call on another
//   stream has its own counter, so launches that may overlap never share one.
// - Measured at 51,200 x 128 (NVIDIA H100 80GB HBM3, 700 W; PERF.md section
//   6): 0.0350-0.0352 ms on the device (torch.profiler), 67% of the byte
//   bound; with 16-byte loads 0.0341-0.0342 in the same run, and 0.0355
//   with 256 blocks of 8 warps; the two launches it replaced (a second
//   kernel summed 1,024 partial rows on one SM) 0.0311 + 0.0251.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kRowsPerBlock = 8;

// an element as f32 (a bf16 widens exactly), and an f32 value stored as T
// (bf16: rounded to nearest even, once)
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }
template <class T>
__device__ __forceinline__ T narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// values per lane: D <= 32 * VPL; x and y of type T, gamma and beta of type G
template <int VPL, class T, class G>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    ln_fwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma, const G* __restrict__ beta,
                  T* __restrict__ y, long long m, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warp leaves together
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float v[VPL];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    v[j] = col < d ? widen(xr[col]) : 0.f;
    sum += v[j];
  }
  const float inv_d = 1.f / (float)d;
  const float mean = warp_sum(sum) * inv_d;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    const float c = col < d ? v[j] - mean : 0.f;
    sq += c * c;
  }
  const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    if (col < d) yr[col] = narrow<T>((v[j] - mean) * rstd * widen(gamma[col]) + widen(beta[col]));
  }
}

template <int VPL, class T, class G>
int launch(const T* x, const G* gamma, const G* beta, T* y, long long m, int d, float eps, cudaStream_t stream) {
  const long long blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<VPL, T, G><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(x, gamma, beta, y, m, d, eps);
  return (int)cudaGetLastError();
}


// warps a backward block: 16 where a lane holds at most 8 values of a row
// (d <= 256), else 8
constexpr int bwd_warps(int d) { return d <= 256 ? 16 : 8; }

// rows a warp of the backward holds in flight: a lane keeps 2 * rows * VPL
// values of x and dy
template <int VPL>
constexpr int kBwdRows = VPL <= 4 ? 4 : VPL <= 8 ? 2 : 1;

// kRows sums across the warp at once (interleaved shuffles, one tree each, in
// warp_sum's order)
template <int R>
__device__ __forceinline__ void warp_sum_rows(float (&v)[R]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] += __shfl_xor_sync(0xffffffffu, v[i], off);
}

// Block b: rows [b * rows_per_block, min(m, (b + 1) * rows_per_block)); dx for
// each, its (2, d) row of `partials`, and, in the block that finishes last,
// dgamma and dbeta (csrc header: the order of every sum). A lane holds the
// columns lane + 32 j of a row, as in ln_fwd_kernel. x, dy and dx of type T,
// gamma, dgamma and dbeta of type G; the partials f32. Dynamic shared memory:
// warps x 2d floats.
template <int VPL, class T, class G>
__global__ void __launch_bounds__(VPL <= 8 ? 512 : 256, 1)
    ln_bwd_kernel(const T* __restrict__ x, const G* __restrict__ gamma, const T* __restrict__ dy,
                  T* __restrict__ dx, float* __restrict__ partials, unsigned* __restrict__ counter,
                  G* __restrict__ dgamma, G* __restrict__ dbeta, long long m, int d, long long rows_per_block,
                  float eps) {
  constexpr int R = kBwdRows<VPL>;
  extern __shared__ float red[];  // [warps][2 d]
  __shared__ unsigned ticket;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  const float inv_d = 1.f / (float)d;
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = r0 + rows_per_block < m ? r0 + rows_per_block : m;

  float g[VPL], dg[VPL], db[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    g[j] = col < d ? widen(gamma[col]) : 0.f;
    dg[j] = 0.f;
    db[j] = 0.f;
  }
  for (long long base = r0 + warp; base < r1; base += (long long)warps * R) {
    float v[R][VPL], dyv[R][VPL];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long row = base + (long long)i * warps;
      const long long src = row < r1 ? row : base;  // a row past the block's end repeats `base`, never kept
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int col = lane + 32 * j;
        v[i][j] = col < d ? widen(x[src * d + col]) : 0.f;
        dyv[i][j] = col < d ? widen(dy[src * d + col]) : 0.f;
      }
    }
    float mean[R], rstd[R], s1[R], s2[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mean[i] = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) mean[i] += v[i][j];
    }
    warp_sum_rows(mean);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      mean[i] *= inv_d;
      rstd[i] = 0.f;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const float c = lane + 32 * j < d ? v[i][j] - mean[i] : 0.f;
        rstd[i] += c * c;
      }
    }
    warp_sum_rows(rstd);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      rstd[i] = rsqrtf(rstd[i] * inv_d + eps);
      s1[i] = 0.f;
      s2[i] = 0.f;
      const bool kept = base + (long long)i * warps < r1;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        v[i][j] = lane + 32 * j < d ? (v[i][j] - mean[i]) * rstd[i] : 0.f;  // xhat
        const float dxhat = dyv[i][j] * g[j];
        s1[i] += dxhat;
        s2[i] += dxhat * v[i][j];
        if (kept) {
          dg[j] += dyv[i][j] * v[i][j];
          db[j] += dyv[i][j];
        }
      }
    }
    warp_sum_rows(s1);
    warp_sum_rows(s2);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const long long row = base + (long long)i * warps;
      if (row >= r1) continue;
      const float m1 = s1[i] * inv_d, m2 = s2[i] * inv_d;
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int col = lane + 32 * j;
        if (col < d) dx[row * d + col] = narrow<T>(rstd[i] * (dyv[i][j] * g[j] - m1 - v[i][j] * m2));
      }
    }
  }

  // the block's row of partials: the warps' sums added in warp order
  const int width = 2 * d;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    if (col < d) {
      red[warp * width + col] = dg[j];
      red[warp * width + d + col] = db[j];
    }
  }
  __syncthreads();
  float* __restrict__ mine = partials + (long long)blockIdx.x * width;
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float p = red[c];
    for (int w = 1; w < warps; ++w) p += red[w * width + c];
    mine[c] = p;
  }
  __threadfence();  // this block's row is visible to the block that draws the last ticket
  __syncthreads();
  if (threadIdx.x == 0) ticket = atomicAdd(counter, 1u);
  __syncthreads();
  if (ticket != gridDim.x - 1) return;
  __threadfence();

  // the last block: warp g sums the rows of blocks [g * per, (g + 1) * per) in
  // block order, then the groups are added in group order
  const int per = (gridDim.x + warps - 1) / warps;
  const int b0 = warp * per, b1 = b0 + per < (int)gridDim.x ? b0 + per : (int)gridDim.x;
  for (int c = lane; c < width; c += 32) {
    float acc = 0.f;
#pragma unroll 8
    for (int b = b0; b < b1; ++b) acc += __ldcg(partials + (long long)b * width + c);
    red[warp * width + c] = acc;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < width; c += blockDim.x) {
    float total = red[c];
    for (int w = 1; w < warps; ++w) total += red[w * width + c];
    if (c < d) dgamma[c] = narrow<G>(total);
    else dbeta[c - d] = narrow<G>(total);
  }
  if (threadIdx.x == 0) *counter = 0u;  // every block has drawn its ticket: ready for the next launch
}

template <int VPL, class T, class G>
int launch_bwd(const T* x, const G* gamma, const T* dy, T* dx, float* partials, unsigned* counter, G* dgamma,
               G* dbeta, long long m, int d, float eps, int n_blocks, long long rows_per_block, cudaStream_t stream) {
  const int warps = bwd_warps(d);
  const int smem = warps * 2 * d * (int)sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(ln_bwd_kernel<VPL, T, G>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  ln_bwd_kernel<VPL, T, G><<<n_blocks, 32 * warps, smem, stream>>>(x, gamma, dy, dx, partials, counter, dgamma,
                                                                   dbeta, m, d, rows_per_block, eps);
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, VPL>{}) for the values per lane of width d
// (1 <= d <= 1024): 1, 2, 4, 8, 16 or 32
template <class Fn>
int by_vpl(int d, Fn fn) {
  const int vpl = (d + 31) / 32;
  if (vpl <= 1) return fn(std::integral_constant<int, 1>{});
  if (vpl <= 2) return fn(std::integral_constant<int, 2>{});
  if (vpl <= 4) return fn(std::integral_constant<int, 4>{});
  if (vpl <= 8) return fn(std::integral_constant<int, 8>{});
  if (vpl <= 16) return fn(std::integral_constant<int, 16>{});
  return fn(std::integral_constant<int, 32>{});
}

template <class T, class G>
int forward(const void* x, const void* gamma, const void* beta, void* y, long long m, int d, float eps,
            cudaStream_t stream) {
  if (m <= 0) return 0;
  if (d < 1 || d > 1024) return (int)cudaErrorInvalidValue;
  return by_vpl(d, [&](auto w) {
    return launch<decltype(w)::value>(static_cast<const T*>(x), static_cast<const G*>(gamma),
                                      static_cast<const G*>(beta), static_cast<T*>(y), m, d, eps, stream);
  });
}

template <class T, class G>
int backward(const void* x, const void* gamma, const void* dy, void* dx, float* partials, unsigned* counter,
             void* dgamma, void* dbeta, long long m, int d, float eps, int n_blocks, long long rows_per_block,
             cudaStream_t stream) {
  if (d < 1 || d > 1024 || m < 0 || n_blocks < 1 || rows_per_block < 1) return (int)cudaErrorInvalidValue;
  if ((long long)n_blocks * rows_per_block < m || (m > 0 ? (long long)(n_blocks - 1) * rows_per_block >= m
                                                         : n_blocks != 1))
    return (int)cudaErrorInvalidValue;
  return by_vpl(d, [&](auto w) {
    return launch_bwd<decltype(w)::value>(static_cast<const T*>(x), static_cast<const G*>(gamma),
                                          static_cast<const T*>(dy), static_cast<T*>(dx), partials, counter,
                                          static_cast<G*>(dgamma), static_cast<G*>(dbeta), m, d, eps, n_blocks,
                                          rows_per_block, stream);
  });
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). 1 <= d <= 1024.
extern "C" int ln_fwd_f32(const float* x, const float* gamma, const float* beta, float* y, long long m, int d,
                          float eps, cudaStream_t stream) {
  return forward<float, float>(x, gamma, beta, y, m, d, eps, stream);
}

// Backward: dx (M, D), dgamma and dbeta (D,), in one launch on `stream`
// through a (n_blocks, 2, D) float scratch buffer of partials and a zeroed
// ticket counter that no launch on another stream uses (left at 0). Block b
// owns rows [b * rows_per_block, (b + 1) * rows_per_block); the caller's
// partition must cover M with no empty block (one block for M = 0). Returns
// cudaGetLastError() after the launch (0 = launched). 1 <= d <= 1024.
extern "C" int ln_bwd_f32(const float* x, const float* gamma, const float* dy, float* dx, float* partials,
                          unsigned* counter, float* dgamma, float* dbeta, long long m, int d, float eps, int n_blocks,
                          long long rows_per_block, cudaStream_t stream) {
  return backward<float, float>(x, gamma, dy, dx, partials, counter, dgamma, dbeta, m, d, eps, n_blocks,
                                rows_per_block, stream);
}

// ln_fwd_f32 on bf16 x and y; gamma and beta bf16 when `gamma_bf16`, else
// float.
extern "C" int ln_fwd_bf16(const void* x, const void* gamma, const void* beta, void* y, long long m, int d,
                           float eps, int gamma_bf16, cudaStream_t stream) {
  if (gamma_bf16) return forward<__nv_bfloat16, __nv_bfloat16>(x, gamma, beta, y, m, d, eps, stream);
  return forward<__nv_bfloat16, float>(x, gamma, beta, y, m, d, eps, stream);
}

// ln_bwd_f32 on bf16 x, dy and dx, the same f32 partials; gamma, dgamma and
// dbeta bf16 when `gamma_bf16`, else float.
extern "C" int ln_bwd_bf16(const void* x, const void* gamma, const void* dy, void* dx, float* partials,
                           unsigned* counter, void* dgamma, void* dbeta, long long m, int d, float eps, int n_blocks,
                           long long rows_per_block, int gamma_bf16, cudaStream_t stream) {
  if (gamma_bf16)
    return backward<__nv_bfloat16, __nv_bfloat16>(x, gamma, dy, dx, partials, counter, dgamma, dbeta, m, d, eps,
                                                  n_blocks, rows_per_block, stream);
  return backward<__nv_bfloat16, float>(x, gamma, dy, dx, partials, counter, dgamma, dbeta, m, d, eps, n_blocks,
                                        rows_per_block, stream);
}
