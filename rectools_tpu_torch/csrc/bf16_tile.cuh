// The bf16 tensor-core tile's building blocks, shared by softmax_lse_bf16.cu
// (kernels 6-14 in bf16), attention_bf16.cu (kernels 2 and 5 in bf16) and
// stu_attention_bf16.cu (kernels 17-19 in bf16):
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` (one product per 16
// deep, no hi/lo split: a product of two bf16 values is exact in f32, and the
// sum is the tensor cores' f32 accumulation), the packing of its fragments and
// the rounding of a float to bf16, by the conversion intrinsics only. Included
// inside each source's anonymous namespace, after <cuda_bf16.h>,
// <cuda_runtime.h> and <stdint.h>.
//
// m16n8k16 bf16 fragments (g = lane / 4, t = lane % 4; each 32-bit register
// holds two bf16, the lower column or depth in its low half): A a0 (g, 2t and
// 2t + 1), a1 (g + 8, 2t and 2t + 1), a2 (g, 2t + 8 and 2t + 9), a3 (g + 8,
// 2t + 8 and 2t + 9); B b0 (k = 2t and 2t + 1, n = g), b1 (k = 2t + 8 and
// 2t + 9, n = g); C c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1).
// These are not the m16n8k8 TF32 layouts of tc_tile.cuh.
//
// Depth 8 (a head dim of 8, contracted in q k^T and dout v^T): one
// `mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32`, whose A is a0 and a1
// above and whose B is b0 above, with C as above. It is as exact as the
// 16-deep product: each of the 8 products of two bf16 values is exact in f32
// and the sum is the same f32 accumulation, with no zero-padded half and no
// hi/lo split. `Depth<D>`, `frags_a` and `mma_depth` pick the 16-deep steps or
// this one by D; a loop of D / 16 steps is never instantiated at D = 8 (a
// static_assert guards it), where it would run no step and leave every score
// 0.
//
// Staged tiles are row-major bf16 with a pitch of `pitch(row length)`: the
// 32-bit fragment reads (8 rows x 4 words) then hit 32 distinct banks at
// every width these kernels take, and rows stay 16-byte aligned.

namespace bt {

// row + 8 (row / 2 + 4 words: 8 rows of 4 words fall on 32 banks); a row of 8
// takes 24 (12 words), where 16 (8 words) would put rows g and g + 4 on one
// bank
__host__ __device__ constexpr int pitch(int row) { return row == 8 ? 24 : row + 8; }

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b over a depth of 8 (m16n8k8: A two registers, B one)
__device__ __forceinline__ void mma_k8(float c[4], const uint32_t a[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// x rounded to the nearest bf16 (ties to even), as a float
__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// two floats as one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return (uint32_t)__bfloat16_as_ushort(v.x) | ((uint32_t)__bfloat16_as_ushort(v.y) << 16);
}

// two adjacent bf16 of a tile as one register
__device__ __forceinline__ uint32_t ld2(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// two bf16 of one column, rows `p` and `p + row_stride`, as one register (a
// B fragment read across rows)
__device__ __forceinline__ uint32_t ld2_rows(const __nv_bfloat16* p, int row_stride) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[row_stride]) << 16);
}

// A fragment of rows r0 + [0, 16), depth [k, k + 16) of a tile of pitch P
// whose rows run along the depth
template <int P>
__device__ __forceinline__ void frag_a(const __nv_bfloat16* tile, int r0, int k, uint32_t a[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* x = tile + (r0 + g) * P + k + 2 * t;
  a[0] = ld2(x);
  a[1] = ld2(x + 8 * P);
  a[2] = ld2(x + 8);
  a[3] = ld2(x + 8 * P + 8);
}

// B fragment of columns n0 + [0, 8), depth [k, k + 16), B(k, n) = tile[n][k]:
// a tile of pitch P whose rows run along the depth
template <int P>
__device__ __forceinline__ void frag_b(const __nv_bfloat16* tile, int n0, int k, uint32_t b[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* x = tile + (n0 + g) * P + k + 2 * t;
  b[0] = ld2(x);
  b[1] = ld2(x + 8);
}

// B fragment of columns n0 + [0, 8), depth [k, k + 16), B(k, n) = tile[k][n]:
// a tile of pitch P whose rows run along the depth index k (two 16-bit reads
// a register)
template <int P>
__device__ __forceinline__ void frag_b_t(const __nv_bfloat16* tile, int k, int n0, uint32_t b[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* x = tile + (k + 2 * t) * P + n0 + g;
  b[0] = ld2_rows(x, P);
  b[1] = ld2_rows(x + 8 * P, P);
}

// Products over a depth D (a head dim): D / 16 m16n8k16 steps, or at D = 8
// one m16n8k8 step. kFrags A fragments of four registers hold a warp's 16 rows
// over the depth; at D = 8 the first two registers of the one fragment hold
// the m16n8k8 A.
template <int D>
struct Depth {
  static_assert(D == 8 || (D >= 16 && D % 16 == 0), "a depth of 8 or a multiple of 16");
  static constexpr int kFrags = D == 8 ? 1 : D / 16;
};

// the warp's A fragments of rows r0 + [0, 16), depth [0, D), of a tile of
// pitch P whose rows run along the depth
template <int D, int P>
__device__ __forceinline__ void frags_a(const __nv_bfloat16* tile, int r0, uint32_t a[Depth<D>::kFrags][4]) {
  if constexpr (D == 8) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const __nv_bfloat16* x = tile + (r0 + g) * P + 2 * t;
    a[0][0] = ld2(x);
    a[0][1] = ld2(x + 8 * P);
  } else {
    static_assert(D >= 16 && D % 16 == 0, "16-deep fragments need a depth of 16 or more");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) frag_a<P>(tile, r0, 16 * kk, a[kk]);
  }
}

// c (16 rows x 8 columns) += a (frags_a over depth D) times B(k, n) = tile[n0
// + n][k], n in [0, 8): a tile of pitch P whose rows run along the depth
template <int D, int P>
__device__ __forceinline__ void mma_depth(float c[4], const uint32_t a[Depth<D>::kFrags][4],
                                          const __nv_bfloat16* tile, int n0) {
  if constexpr (D == 8) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    mma_k8(c, a[0], ld2(tile + (n0 + g) * P + 2 * t));
  } else {
    static_assert(D >= 16 && D % 16 == 0, "16-deep steps need a depth of 16 or more");
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[2];
      frag_b<P>(tile, n0, 16 * kk, b);
      mma(c, a[kk], b);
    }
  }
}

// A fragment (16 rows, depth 16) from two 16 x 8 accumulator fragments, c0
// the depth [0, 8) and c1 the depth [8, 16): the values stay in their threads
__device__ __forceinline__ void frag_a_from_c(const float c0[4], const float c1[4], uint32_t a[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// rows [row0, row0 + kRows) of an (R, W) row-major bf16 matrix with row
// stride `ld` elements into a tile of pitch W + 8 by 16-byte cp.async, zeros
// past R, by a block of kThreads threads
template <int W, int kRows, int kThreads>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* src, long long ld,
                                            long long row0, long long rows) {
  for (int idx = threadIdx.x; idx < kRows * (W / 8); idx += kThreads) {
    const int r = idx / (W / 8);
    const int c = 8 * (idx - r * (W / 8));
    const bool ok = row0 + r < rows;
    tc::cp_async16(dst + r * pitch(W) + c, ok ? src + (row0 + r) * ld + c : src, ok);
  }
}

}  // namespace bt
