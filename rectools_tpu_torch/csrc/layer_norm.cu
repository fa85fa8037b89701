// LayerNorm forward over the last axis of an (M, D) float32 matrix.
//
// Replaces: rectools_tpu/ops/layer_norm.py:27 `_fwd_kernel` (Pallas; one
// (block_m, D) VMEM tile per program, row mean and variance in f32).
//
// Bound on an H100: bytes. The work reads x once and writes y once (gamma and
// beta are D floats); at the serving shape M = 4096 * 100, D = 128 that is
// 2 * 409,600 * 128 * 4 B = 420 MB, 0.125 ms at 3.35 TB/s. Arithmetic is a
// few operations per byte, far below the FP32 ridge.
//
// Design: one warp per row, eight rows per 256-thread block. A lane keeps its
// ceil(D/32) values in registers (column lane + 32*j, so each load step is a
// coalesced 128-byte warp access), so x is read from device memory exactly
// once. Mean, then the centred sum of squares (flax's two-pass formula), are
// warp-shuffle reductions in f32; nothing goes through shared memory and no
// block-level barrier is needed. A ragged last block simply has idle warps.

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
