// Grouped top-m selection: for every 128-column group of every score row,
// the m largest values and their lane ids (0..127), ties toward the lowest
// lane, in descending order; every slot past a group's values above -inf
// gives (-inf, lane 0).
//
// Replaces: rectools_tpu/ops/topk_select.py:49 `_group_topm_kernel` (Pallas;
// m rounds of lane-max + first-occurrence argmax + mask on a VMEM tile). Its
// rule for the slots past the finite values: a taken lane is masked to -inf
// and the first maximal lane wins, so once only -inf is left every round
// gives lane 0.
//
// Bound on an H100: bytes. The scores are read once and the candidates written
// once: at the serving shape B = 4096 rows of 124 groups and m = 12 that is
// 4096 * 15,872 * 4 B = 260 MB in plus 4096 * 124 * 12 * 8 B = 49 MB out,
// 0.092 ms at 3.35 TB/s.
//
// m <= kSelectMaxM (16; the serving path's m is 12): `group_topm_select_kernel`,
// one thread per group, a block of kSelectGroups groups. The warp-per-group
// kernel below spent m rounds of a 5-step shuffle butterfly on every group
// (about 600 warp instructions a group at m = 12, 0.68 ms at the serving
// shape on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6): bound by
// instruction issue. Here a thread does about 3,000 instructions for its
// group, so a warp spends about 95 a group:
// 1. The block's groups are staged by 16-byte cp.async, coalesced, into a
//    [group][128] tile whose 16-byte chunks are swizzled by the row (chunk c
//    of row r at c ^ (r & 7)), so the threads' float4 reads of their own rows
//    hit distinct banks.
// 2. A threshold: the m-th largest of the group's 32 chunk maxima (a bitonic
//    network in registers). m chunks hold an element at or above it, so no
//    element below it is in the top m.
// 3. The candidates, the elements at or above the threshold and above -inf
//    (about 14 of 128 at m = 12 on N(0, 1) scores), are listed by lane in
//    shared memory, in lane order.
// 4. Each candidate is inserted into a sorted list of M >= m (value, lane)
//    pairs in registers by an unrolled compare-select chain: it goes above
//    the first entry it is strictly greater than, so an equal value that came
//    earlier (a lower lane) stays above it. The list starts as (-inf, 0):
//    slots that no candidate reaches keep the TPU's (-inf, lane 0). The warp
//    runs the chain as often as its busiest thread has candidates (about 18
//    at m = 12), never once per element.
// 5. The first m entries go through shared memory to coalesced stores.
//
// m > kSelectMaxM (up to 128): `group_topm_kernel`, one warp per (row,
// group). Each lane loads 4 neighbouring values with one float4 load (a warp
// reads the group's 512 contiguous bytes in one access). Each of the m rounds
// takes the lane-local best, then a butterfly of warp shuffles over (value,
// column) pairs that prefers the larger value and, on equal values, the
// lower column: the same lowest-lane-first rule as the TPU kernel's float max
// over (w-1-lane). The lane that owns the winner masks it to -inf. A group
// that is all -inf yields lane 0 every round, as on the TPU. Round j's result
// is parked in lane j % 32 and stored in coalesced runs of up to 32, so the
// scores never leave registers between rounds and are read from device
// memory exactly once.
//
// NaN scores are outside the contract (the model's scores are finite or
// -inf).

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "tc_tile.cuh"

constexpr int kGroupW = 128;
constexpr int kWarpsPerBlock = 8;
// the thread-per-group kernel: groups per block (= threads), the largest m it
// serves, the 16-byte chunks of a group
constexpr int kSelectGroups = 64;
constexpr int kSelectMaxM = 16;
constexpr int kChunks = kGroupW / 4;

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

// float offset of 16-byte chunk c of row r in the swizzled [group][128] tile
__device__ __forceinline__ int chunk_at(int r, int c) { return r * kGroupW + 4 * (c ^ (r & 7)); }

// a[0..N) sorted descending in place: a bitonic network whose every index is
// a template argument, so the values stay in registers (a loop nest left the
// array in local memory)
template <int N, int K, int J, int I = 0>
__device__ __forceinline__ void bitonic_pass(float a[N]) {
  if constexpr (I < N) {
    constexpr int l = I ^ J;
    if constexpr (l > I) {
      const float hi = fmaxf(a[I], a[l]), lo = fminf(a[I], a[l]);
      a[I] = (I & K) == 0 ? hi : lo;  // descending within blocks of K whose bit K is clear
      a[l] = (I & K) == 0 ? lo : hi;
    }
    bitonic_pass<N, K, J, I + 1>(a);
  }
}

template <int N, int K, int J>
__device__ __forceinline__ void bitonic_merge(float a[N]) {
  if constexpr (J > 0) {
    bitonic_pass<N, K, J>(a);
    bitonic_merge<N, K, J / 2>(a);
  }
}

template <int N, int K = 2>
__device__ __forceinline__ void sort_desc(float a[N]) {
  if constexpr (K <= N) {
    bitonic_merge<N, K, K / 2>(a);
    sort_desc<N, K * 2>(a);
  }
}

// the dynamic shared memory of group_topm_select_kernel: the score tile, then
// the candidates' lanes [candidate][group]
constexpr int kSelectSmem = kSelectGroups * kGroupW * (int)sizeof(float) + kGroupW * kSelectGroups;

// m <= M <= kSelectMaxM: thread t of block x owns group w = 64 x + t (row w /
// n_groups, group w % n_groups) and writes its m results, as the header says.
template <int M>
__global__ void __launch_bounds__(kSelectGroups)
    group_topm_select_kernel(const float* __restrict__ x, long long n_rows, int n_groups, long long row_stride, int m,
                             float* __restrict__ vals, int* __restrict__ idx) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* tile = reinterpret_cast<float*>(smem_raw);  // [group][128], chunks swizzled
  unsigned char* cand = smem_raw + kSelectGroups * kGroupW * sizeof(float);  // [candidate][group]
  const int t = threadIdx.x;
  const long long w0 = (long long)blockIdx.x * kSelectGroups;
  const int n_here = (int)min((long long)kSelectGroups, n_rows * n_groups - w0);

  // 1. thread t copies chunk t % 32 of groups t / 32 + 2 i, i = 0..31
  {
    const int c = t & (kChunks - 1);
    const long long w = w0 + t / kChunks;
    long long row = w / n_groups;
    int gi = (int)(w - row * n_groups);
    for (int r = t / kChunks; r < kSelectGroups; r += kSelectGroups / kChunks) {
      const bool ok = r < n_here;
      tc::cp_async16(tile + chunk_at(r, c), ok ? x + row * row_stride + (long long)gi * kGroupW + 4 * c : x, ok);
      gi += kSelectGroups / kChunks;
      while (gi >= n_groups) {
        gi -= n_groups;
        ++row;
      }
    }
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
  }

  float lv[M];  // the sorted list: values descending, ties lane ascending
  int ll[M];
#pragma unroll
  for (int j = 0; j < M; ++j) {
    lv[j] = -INFINITY;
    ll[j] = 0;
  }
  if (t < n_here) {
    // 2. the threshold: the m-th largest chunk maximum, raised to -FLT_MAX so that -inf is never a candidate
    float cm[kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(tile + chunk_at(t, c));
      cm[c] = fmaxf(fmaxf(v.x, v.y), fmaxf(v.z, v.w));
    }
    sort_desc<kChunks>(cm);
    float thr = cm[0];  // the smallest of the first m: a running minimum, as picking cm[m - 1] by a
#pragma unroll          // select became an indexed read of an array in local memory
    for (int j = 1; j < M; ++j) thr = j < m ? fminf(thr, cm[j]) : thr;
    thr = fmaxf(thr, -FLT_MAX);

    // 3. the candidates' lanes, in lane order
    int n_cand = 0;
#pragma unroll 4
    for (int c = 0; c < kChunks; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(tile + chunk_at(t, c));
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (e[i] >= thr) cand[(n_cand++) * kSelectGroups + t] = (unsigned char)(4 * c + i);
    }

    // 4. each candidate into the sorted list
    for (int k = 0; k < n_cand; ++k) {
      const int lane_id = cand[k * kSelectGroups + t];
      float cv = tile[chunk_at(t, lane_id >> 2) + (lane_id & 3)];
      int cl = lane_id;
      bool shift = false;  // the candidate is placed; the entries below move down one slot
#pragma unroll
      for (int j = 0; j < M; ++j) {
        const bool take = shift || cv > lv[j];
        const float ov = lv[j];
        const int ol = ll[j];
        lv[j] = take ? cv : ov;
        ll[j] = take ? cl : ol;
        cv = take ? ov : cv;
        cl = take ? ol : cl;
        shift = take;
      }
    }
  }

  // 5. through shared memory (an odd pitch: the threads' row writes hit distinct banks) to coalesced stores
  constexpr int P = M | 1;
  __syncthreads();  // every thread is done with the tile
  int* itile = reinterpret_cast<int*>(tile) + kSelectGroups * P;
  if (t < n_here) {
#pragma unroll
    for (int j = 0; j < M; ++j)
      if (j < m) {
        tile[t * P + j] = lv[j];
        itile[t * P + j] = ll[j];
      }
  }
  __syncthreads();
  float* out_v = vals + w0 * m;
  int* out_i = idx + w0 * m;
  for (int i = t; i < n_here * m; i += kSelectGroups) {
    const int r = i / m, j = i - r * m;
    out_v[i] = tile[r * P + j];
    out_i[i] = itile[r * P + j];
  }
}

template <int M>
int launch_select(const float* x, long long n_rows, int n_groups, long long row_stride, int m, float* vals, int* idx,
                  cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(group_topm_select_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSelectSmem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (n_rows * n_groups + kSelectGroups - 1) / kSelectGroups;
  group_topm_select_kernel<M><<<(unsigned)blocks, kSelectGroups, kSelectSmem, stream>>>(x, n_rows, n_groups,
                                                                                         row_stride, m, vals, idx);
  return (int)cudaGetLastError();
}

}  // namespace

// x: n_rows rows of n_groups * 128 floats, row stride `row_stride` elements
// (a multiple of 4; x 16-byte aligned). vals/idx: (n_rows, n_groups, m)
// contiguous. 1 <= m <= 128: the thread-per-group kernel for m <= 16 (a list
// of 4, 8, 12 or 16 entries), the warp-per-group kernel above. Returns
// cudaGetLastError() after the launch.
extern "C" int group_topm_f32(const float* x, long long n_rows, int n_groups, long long row_stride, int m,
                              float* vals, int* idx, cudaStream_t stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  if (m < 1 || m > kGroupW) return (int)cudaErrorInvalidValue;
  if (m <= 4) return launch_select<4>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  if (m <= 8) return launch_select<8>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  if (m <= 12) return launch_select<12>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  if (m <= kSelectMaxM) return launch_select<kSelectMaxM>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  const long long warps = n_rows * n_groups;
  const long long blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  group_topm_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, stream>>>(x, n_rows, n_groups, row_stride, m, vals,
                                                                          idx);
  return (int)cudaGetLastError();
}
