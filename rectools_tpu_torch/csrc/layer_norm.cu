// LayerNorm over the last axis of an (M, D) float32 matrix: forward, and the
// backward that gives dx, dgamma and dbeta.
//
// Replaces: rectools_tpu/ops/layer_norm.py:27 `_fwd_kernel` (`ln_fwd_f32`) and
// rectools_tpu/ops/layer_norm.py:36 `_bwd_kernel` (`ln_bwd_f32`) (Pallas; one
// (block_m, D) VMEM tile per program, row statistics in f32).
//
// Bound on an H100: bytes, both directions. The forward reads x once and
// writes y once (gamma and beta are D floats); at the serving shape
// M = 4096 * 100, D = 128 that is 420 MB, 0.125 ms at 3.35 TB/s. The backward
// reads x and dy and writes dx: at the training shape M = 512 * 100, D = 128,
// 3 * 26.2 MB, 0.023 ms. Arithmetic is a few operations per byte, far below
// the FP32 ridge.
//
// Forward design: one warp per row, eight rows per 256-thread block. A lane
// keeps its ceil(D/32) values in registers (column lane + 32*j, so each load
// step is a coalesced 128-byte warp access), so x is read from device memory
// exactly once. Mean, then the centred sum of squares (flax's two-pass
// formula), are warp-shuffle reductions in f32. A ragged last block simply has
// idle warps.
//
// Backward design: the TPU kernel sums dgamma/dbeta in an output block that
// its sequential grid revisits; GPU blocks run in no order, so that does not
// carry over. Here the grid has a fixed number of blocks (a function of M
// only), each warp walks rows with a grid stride as in the forward:
// recompute mean and rstd, write dx, and keep the warp's dgamma/dbeta sums in
// registers. The block adds its warps' sums in warp order in shared memory and
// writes one (2, D) row of a (n_blocks, 2, D) scratch buffer; a second small
// kernel sums that buffer over blocks in block order. No float atomics: the
// result has the same bits run after run.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int VPL>  // values per lane: D <= 32 * VPL
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    ln_fwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ beta,
                  float* __restrict__ y, long long m, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= m) return;  // whole warp leaves together
  const float* xr = x + row * d;
  float* yr = y + row * d;

  float v[VPL];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    v[j] = col < d ? xr[col] : 0.f;
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
    if (col < d) yr[col] = (v[j] - mean) * rstd * gamma[col] + beta[col];
  }
}

template <int VPL>
void launch(const float* x, const float* gamma, const float* beta, float* y, long long m, int d, float eps,
            cudaStream_t stream) {
  const long long blocks = (m + kRowsPerBlock - 1) / kRowsPerBlock;
  ln_fwd_kernel<VPL><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, stream>>>(x, gamma, beta, y, m, d, eps);
}

template <int VPL>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
    ln_bwd_kernel(const float* __restrict__ x, const float* __restrict__ gamma, const float* __restrict__ dy,
                  float* __restrict__ dx, float* __restrict__ partials, long long m, int d, float eps) {
  __shared__ float block_sums[2][32 * VPL];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float inv_d = 1.f / (float)d;

  float g[VPL], dg[VPL], db[VPL];
#pragma unroll
  for (int j = 0; j < VPL; ++j) {
    const int col = lane + 32 * j;
    g[j] = col < d ? gamma[col] : 0.f;
    dg[j] = 0.f;
    db[j] = 0.f;
  }
  const long long stride = (long long)gridDim.x * kRowsPerBlock;
  for (long long row = (long long)blockIdx.x * kRowsPerBlock + warp; row < m; row += stride) {
    const float* xr = x + row * d;
    const float* dyr = dy + row * d;
    float v[VPL], dyv[VPL];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int col = lane + 32 * j;
      v[j] = col < d ? xr[col] : 0.f;
      dyv[j] = col < d ? dyr[col] : 0.f;
      sum += v[j];
    }
    const float mean = warp_sum(sum) * inv_d;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int col = lane + 32 * j;
      const float c = col < d ? v[j] - mean : 0.f;
      sq += c * c;
    }
    const float rstd = rsqrtf(warp_sum(sq) * inv_d + eps);
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int col = lane + 32 * j;
      v[j] = col < d ? (v[j] - mean) * rstd : 0.f;  // xhat
      const float dxhat = dyv[j] * g[j];
      s1 += dxhat;
      s2 += dxhat * v[j];
      dg[j] += dyv[j] * v[j];
      db[j] += dyv[j];
    }
    const float m1 = warp_sum(s1) * inv_d;
    const float m2 = warp_sum(s2) * inv_d;
    float* dxr = dx + row * d;
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      const int col = lane + 32 * j;
      if (col < d) dxr[col] = rstd * (dyv[j] * g[j] - m1 - v[j] * m2);
    }
  }
  // the block's sums, added warp by warp in a fixed order
  for (int w = 0; w < kRowsPerBlock; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) {
        const int col = lane + 32 * j;
        if (col < d) {
          block_sums[0][col] = w == 0 ? dg[j] : block_sums[0][col] + dg[j];
          block_sums[1][col] = w == 0 ? db[j] : block_sums[1][col] + db[j];
        }
      }
    }
    __syncthreads();
  }
  float* out = partials + (long long)blockIdx.x * 2 * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    out[c] = block_sums[0][c];
    out[d + c] = block_sums[1][c];
  }
}

// dgamma, dbeta = the (n_blocks, 2, D) partials summed over blocks, in block order.
__global__ void ln_bwd_reduce_kernel(const float* __restrict__ partials, float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int n_blocks, int d) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= 2 * d) return;
  float acc = 0.f;
  for (int b = 0; b < n_blocks; ++b) acc += partials[(long long)b * 2 * d + idx];
  if (idx < d) dgamma[idx] = acc;
  else dbeta[idx - d] = acc;
}

template <int VPL>
void launch_bwd(const float* x, const float* gamma, const float* dy, float* dx, float* partials, long long m, int d,
                float eps, int n_blocks, cudaStream_t stream) {
  ln_bwd_kernel<VPL><<<n_blocks, 32 * kRowsPerBlock, 0, stream>>>(x, gamma, dy, dx, partials, m, d, eps);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 = launched). 1 <= d <= 1024.
extern "C" int ln_fwd_f32(const float* x, const float* gamma, const float* beta, float* y, long long m, int d,
                          float eps, cudaStream_t stream) {
  if (m <= 0) return 0;
  if (d < 1 || d > 1024) return (int)cudaErrorInvalidValue;
  const int vpl = (d + 31) / 32;
  if (vpl <= 1) launch<1>(x, gamma, beta, y, m, d, eps, stream);
  else if (vpl <= 2) launch<2>(x, gamma, beta, y, m, d, eps, stream);
  else if (vpl <= 4) launch<4>(x, gamma, beta, y, m, d, eps, stream);
  else if (vpl <= 8) launch<8>(x, gamma, beta, y, m, d, eps, stream);
  else if (vpl <= 16) launch<16>(x, gamma, beta, y, m, d, eps, stream);
  else launch<32>(x, gamma, beta, y, m, d, eps, stream);
  return (int)cudaGetLastError();
}

// Backward: dx (M, D), dgamma and dbeta (D,), through a (n_blocks, 2, D) float
// scratch buffer. Two launches on `stream`; returns cudaGetLastError() after
// them (0 = launched). 1 <= d <= 1024, 1 <= n_blocks.
extern "C" int ln_bwd_f32(const float* x, const float* gamma, const float* dy, float* dx, float* partials,
                          float* dgamma, float* dbeta, long long m, int d, float eps, int n_blocks,
                          cudaStream_t stream) {
  if (d < 1 || d > 1024 || n_blocks < 1) return (int)cudaErrorInvalidValue;
  const int vpl = (d + 31) / 32;
  if (vpl <= 1) launch_bwd<1>(x, gamma, dy, dx, partials, m, d, eps, n_blocks, stream);
  else if (vpl <= 2) launch_bwd<2>(x, gamma, dy, dx, partials, m, d, eps, n_blocks, stream);
  else if (vpl <= 4) launch_bwd<4>(x, gamma, dy, dx, partials, m, d, eps, n_blocks, stream);
  else if (vpl <= 8) launch_bwd<8>(x, gamma, dy, dx, partials, m, d, eps, n_blocks, stream);
  else if (vpl <= 16) launch_bwd<16>(x, gamma, dy, dx, partials, m, d, eps, n_blocks, stream);
  else launch_bwd<32>(x, gamma, dy, dx, partials, m, d, eps, n_blocks, stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ln_bwd_reduce_kernel<<<(2 * d + 255) / 256, 256, 0, stream>>>(partials, dgamma, dbeta, n_blocks, d);
  return (int)cudaGetLastError();
}
