// Grouped top-m selection: for every 128-column group of every score row,
// the m largest values and their lane ids (0..127), ties toward the lowest
// lane, in descending order.
//
// Replaces: rectools_tpu/ops/topk_select.py:49 `_group_topm_kernel` (Pallas;
// m rounds of lane-max + first-occurrence argmax + mask on a VMEM tile).
//
// Bound on an H100: bytes. The scores are read once and the candidates written
// once: at the serving shape B = 4096 rows of 124 groups and m = 12 that is
// 4096 * 15,872 * 4 B = 260 MB in plus 4096 * 124 * 12 * 8 B = 49 MB out,
// 0.092 ms at 3.35 TB/s.
//
// Design: one warp per (row, group). Each lane loads 4 neighbouring values
// with one float4 load (a warp reads the group's 512 contiguous bytes in one
// access). Each of the m rounds takes the lane-local best, then a butterfly
// of warp shuffles over (value, column) pairs that prefers the larger value
// and, on equal values, the lower column: the same lowest-lane-first rule as
// the TPU kernel's float max over (w-1-lane). The lane that owns the winner
// masks it to -inf. A group that is all -inf yields lane 0 every round, as
// on the TPU. Round j's result is parked in lane j % 32 and stored in
// coalesced runs of up to 32, so the scores never leave registers between
// rounds and are read from device memory exactly once.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroupW = 128;
constexpr int kWarpsPerBlock = 8;

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
    group_topm_kernel(const float* __restrict__ x, long long n_rows, int n_groups, long long row_stride, int m,
                      float* __restrict__ vals, int* __restrict__ idx) {
  const int lane = threadIdx.x & 31;
  const long long w = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (w >= n_rows * n_groups) return;  // whole warp leaves together
  const long long row = w / n_groups;
  const int g = (int)(w - row * n_groups);

  const float4 t = reinterpret_cast<const float4*>(x + row * row_stride + (long long)g * kGroupW)[lane];
  float v[4] = {t.x, t.y, t.z, t.w};
  float* out_v = vals + w * m;
  int* out_i = idx + w * m;

  float keep_v = 0.f;
  int keep_i = 0;
  for (int j = 0; j < m; ++j) {
    float bv = v[0];
    int bc = 4 * lane;
#pragma unroll
    for (int i = 1; i < 4; ++i) {
      if (v[i] > bv) {
        bv = v[i];
        bc = 4 * lane + i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
      const int oc = __shfl_xor_sync(0xffffffffu, bc, off);
      if (ov > bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if ((bc >> 2) == lane) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if ((bc & 3) == i) v[i] = -INFINITY;
      }
    }
    const int slot = j & 31;
    if (lane == slot) {
      keep_v = bv;
      keep_i = bc;
    }
    if (slot == 31 || j == m - 1) {
      const int base = j - slot;
      if (lane <= slot) {
        out_v[base + lane] = keep_v;
        out_i[base + lane] = keep_i;
      }
    }
  }
}

}  // namespace

// x: n_rows rows of n_groups * 128 floats, row stride `row_stride` elements
// (a multiple of 4; x 16-byte aligned). vals/idx: (n_rows, n_groups, m)
// contiguous. 1 <= m <= 128. Returns cudaGetLastError() after the launch.
extern "C" int group_topm_f32(const float* x, long long n_rows, int n_groups, long long row_stride, int m,
                              float* vals, int* idx, cudaStream_t stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  if (m < 1 || m > kGroupW) return (int)cudaErrorInvalidValue;
  const long long warps = n_rows * n_groups;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  group_topm_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(x, n_rows, n_groups, row_stride, m, vals,
                                                                          idx);
  return (int)cudaGetLastError();
}
