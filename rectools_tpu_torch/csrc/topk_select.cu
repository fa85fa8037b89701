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
// one thread per group, a block of kSelectGroups groups. The first port, a
// warp per group, spent m rounds of a 5-step shuffle butterfly on every group
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
// kSelectMaxM < m <= 128 (ItemKNN's truncation keeps m = min(K, 128); small
// catalogs take m > 16 for k > 12 G): `group_topm_sort_kernel`. The first
// port's butterfly costs m rounds, about 2,000 warp instructions a group at m
// = 50 (2.70 ms for a 4,096 x 15,872 block of co-counts, against a byte bound
// of 0.138 ms: 260 MB in, 4,096 * 124 * 50 * 8 B = 203 MB out; 0.233 ms at m
// = 128). The threshold of the m <= 16 kernel does not exist past 32 chunk
// maxima and its register list does not scale to m = 128, so this kernel
// sorts: its work grows with the group's 128 elements and not with m, and m
// = 128 (a full ordering) costs what m = 17 does.
// 1. Eight lanes own a group, four groups a warp, 32 a block: lane l of a
//    group loads chunks l + 8 i (i = 0..3) by 16-byte loads, so each load of
//    the warp reads four runs of 128 contiguous bytes. A thread keeps 16
//    (value, lane) pairs in registers.
// 2. A bitonic network (28 stages of 64 compare-exchanges) sorts the group's
//    128 pairs by value descending, then lane ascending: a total order, since
//    lanes differ, so the result is the reference's whatever the network,
//    however many values tie at the m-th slot (the co-counts end in runs of
//    tied zeros). Position p = 16 l + s is register s of lane l: the 22 stages
//    whose partner is p ^ J with J < 16 compare two registers of a thread,
//    the 6 with J >= 16 the same register of two lanes by shuffles. The
//    compare is a float compare (-0 and +0 tie, as in the reference) and
//    costs three instructions and four selects a pair: about 550 warp
//    instructions a group, 0.3 ms for the block above at the card's issue
//    rate (132 SMs x 4 schedulers x 1.755 GHz), twice the byte bound.
// 3. The sorted runs go through shared memory (a lane's 16 at a pitch of 17:
//    the warp's 32 writes of one register hit distinct banks) to coalesced
//    stores of each group's first m. A -inf entry is stored with lane 0: the
//    TPU's (-inf, lane 0) for the slots past a group's values above -inf.
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
// the sorting kernel (m > kSelectMaxM): lanes a group, (value, lane) pairs a
// thread, groups a warp, warps a block, and a group's staged entries (a
// lane's run of kSortPerLane at a pitch of kSortPitch)
constexpr int kSortLanes = 8;
constexpr int kSortPerLane = kGroupW / kSortLanes;
constexpr int kSortGroupsPerWarp = 32 / kSortLanes;
constexpr int kSortWarps = 8;
constexpr int kSortPitch = kSortPerLane + 1;
constexpr int kSortStage = kSortLanes * kSortPitch;
// the thread-per-group kernel: groups per block (= threads), the largest m it
// serves, the 16-byte chunks of a group
constexpr int kSelectGroups = 64;
constexpr int kSelectMaxM = 16;
constexpr int kChunks = kGroupW / 4;

// whether (va, ia) comes before (vb, ib) in the output's order: the larger
// value, then the lower lane (a float compare: -0 and +0 tie, as on the TPU)
__device__ __forceinline__ bool before(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// One bitonic stage (K, J) over the positions p = kSortPerLane l + s of a
// group, l = lane % kSortLanes, s = 0..kSortPerLane-1: p and p ^ J compare,
// the lower position keeping the earlier entry where p & K is clear
// (descending blocks) and the later one where it is set. J < kSortPerLane
// pairs two registers of a thread; larger J pairs the same register of lanes
// l and l ^ (J / kSortPerLane) of the group by shuffles.
template <int K, int J>
__device__ __forceinline__ void sort_stage(float (&v)[kSortPerLane], int (&id)[kSortPerLane], int l) {
  if constexpr (J < kSortPerLane) {
    // descending where bit K of p is clear: bit K of s below kSortPerLane, of l up to 64, always at 128
    const bool lane_desc = K < kSortPerLane || K == kGroupW || (l & (K / kSortPerLane)) == 0;
#pragma unroll
    for (int s = 0; s < kSortPerLane; ++s) {
      if (s & J) continue;
      const bool desc = K < kSortPerLane ? (s & K) == 0 : lane_desc;
      const bool swap = before(v[s + J], id[s + J], v[s], id[s]) == desc;
      const float va = v[s], vb = v[s + J];
      const int ia = id[s], ib = id[s + J];
      v[s] = swap ? vb : va;
      id[s] = swap ? ib : ia;
      v[s + J] = swap ? va : vb;
      id[s + J] = swap ? ia : ib;
    }
  } else {
    constexpr int kMask = J / kSortPerLane;
    const bool lower = (l & kMask) == 0;
    const bool desc = K == kGroupW || (l & (K / kSortPerLane)) == 0;
    const bool keep_first = lower == desc;  // this lane keeps the earlier entry of each pair
#pragma unroll
    for (int s = 0; s < kSortPerLane; ++s) {
      const float ov = __shfl_xor_sync(0xffffffffu, v[s], kMask);
      const int oi = __shfl_xor_sync(0xffffffffu, id[s], kMask);
      const bool take = before(ov, oi, v[s], id[s]) == keep_first;
      v[s] = take ? ov : v[s];
      id[s] = take ? oi : id[s];
    }
  }
}

template <int K, int J = K / 2>
__device__ __forceinline__ void sort_merge(float (&v)[kSortPerLane], int (&id)[kSortPerLane], int l) {
  if constexpr (J > 0) {
    sort_stage<K, J>(v, id, l);
    sort_merge<K, J / 2>(v, id, l);
  }
}

template <int K = 2>
__device__ __forceinline__ void sort_group(float (&v)[kSortPerLane], int (&id)[kSortPerLane], int l) {
  if constexpr (K <= kGroupW) {
    sort_merge<K>(v, id, l);
    sort_group<K * 2>(v, id, l);
  }
}

// kSelectMaxM < m <= 128: warp w of block x owns groups 4 (8 x + w) + q, q =
// 0..3, lanes 8 q .. 8 q + 7 a group, as the header says.
__global__ void __launch_bounds__(32 * kSortWarps)
    group_topm_sort_kernel(const float* __restrict__ x, long long n_rows, int n_groups, long long row_stride, int m,
                           float* __restrict__ vals, int* __restrict__ idx) {
  __shared__ float stage_v[kSortWarps][kSortGroupsPerWarp][kSortStage];
  __shared__ int stage_i[kSortWarps][kSortGroupsPerWarp][kSortStage];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int q = lane / kSortLanes, l = lane % kSortLanes;
  const long long total = n_rows * n_groups;
  const long long w0 = ((long long)blockIdx.x * kSortWarps + warp) * kSortGroupsPerWarp;  // the warp's first group
  const long long w = w0 + q;

  // 1. chunk l + 8 i (columns 4 (l + 8 i) .. + 3) of the group into registers 4 i .. 4 i + 3
  float v[kSortPerLane];
  int id[kSortPerLane];
  if (w < total) {
    const long long row = w / n_groups;
    const float4* src = reinterpret_cast<const float4*>(x + row * row_stride + (w - row * n_groups) * kGroupW);
#pragma unroll
    for (int i = 0; i < kSortPerLane / 4; ++i) {
      const float4 t = __ldg(src + l + kSortLanes * i);
      v[4 * i] = t.x;
      v[4 * i + 1] = t.y;
      v[4 * i + 2] = t.z;
      v[4 * i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kSortPerLane; ++s) v[s] = -INFINITY;
  }
#pragma unroll
  for (int s = 0; s < kSortPerLane; ++s) id[s] = 4 * (l + kSortLanes * (s / 4)) + s % 4;

  // 2. the whole group in the output's order: position p holds the entry of rank p
  sort_group(v, id, l);

  // 3. through shared memory (a lane's 16 at a pitch of 17: the 32 lanes' writes hit distinct banks) to coalesced
  // stores of the first m; a -inf slot gives lane 0
  float* sv = stage_v[warp][q];
  int* si = stage_i[warp][q];
#pragma unroll
  for (int s = 0; s < kSortPerLane; ++s) {
    sv[kSortPitch * l + s] = v[s];
    si[kSortPitch * l + s] = id[s];
  }
  __syncwarp();
#pragma unroll
  for (int g = 0; g < kSortGroupsPerWarp; ++g) {
    if (w0 + g >= total) break;
    float* out_v = vals + (w0 + g) * m;
    int* out_i = idx + (w0 + g) * m;
    for (int j = lane; j < m; j += 32) {
      const int at = kSortPitch * (j / kSortPerLane) + j % kSortPerLane;
      const float value = stage_v[warp][g][at];
      out_v[j] = value;
      out_i[j] = value == -INFINITY ? 0 : stage_i[warp][g][at];
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
// of 4, 8, 12 or 16 entries), the sorting kernel above. Returns
// cudaGetLastError() after the launch.
extern "C" int group_topm_f32(const float* x, long long n_rows, int n_groups, long long row_stride, int m,
                              float* vals, int* idx, cudaStream_t stream) {
  if (n_rows <= 0 || n_groups <= 0) return 0;
  if (m < 1 || m > kGroupW) return (int)cudaErrorInvalidValue;
  if (m <= 4) return launch_select<4>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  if (m <= 8) return launch_select<8>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  if (m <= 12) return launch_select<12>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  if (m <= kSelectMaxM) return launch_select<kSelectMaxM>(x, n_rows, n_groups, row_stride, m, vals, idx, stream);
  constexpr int kGroupsPerBlock = kSortWarps * kSortGroupsPerWarp;
  const long long blocks = (n_rows * n_groups + kGroupsPerBlock - 1) / kGroupsPerBlock;
  group_topm_sort_kernel<<<(unsigned)blocks, 32 * kSortWarps, 0, stream>>>(x, n_rows, n_groups, row_stride, m, vals,
                                                                           idx);
  return (int)cudaGetLastError();
}
