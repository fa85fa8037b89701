// The 3xTF32 tensor-core tile's building blocks, shared by the kernels of
// softmax_lse.cu (the gradient kernels, kernels 6 and 8), stu_attention.cu
// (kernels 17-19) and attention.cu (kernels 2 and 5; topk_select.cu takes
// its cp.async helpers): TF32 rounding and
// the hi/lo split, `mma.sync` m16n8k8 with a fresh fragment per 16 k,
// `ldmatrix`, `cp.async`, the swizzle of a staged tile, and (at the end) the
// row tiles of the attention kernels: rows of one (b, h) staged at a pitch
// of d + 4, the products over their head dim, and accumulator fragments fed
// back as the next product's A operand. Included inside each source's
// anonymous namespace, after <cuda_runtime.h> and <stdint.h>; the source adds
// its own tile shapes to `namespace tc` or beside it.
//
// m16n8k8 fragments (g = lane / 4, t = lane % 4): A a0 (g, t), a1 (g + 8,
// t), a2 (g, t + 4), a3 (g + 8, t + 4); B b0 (k = t, n = g), b1 (k = t + 4,
// n = g); C c0, c1 (g, 2t and 2t + 1), c2, c3 (g + 8, 2t and 2t + 1).

namespace tc {

// Element (r, c) of a row-major tile whose rows hold a multiple of 32
// floats sits at column c ^ swz(r): bits 2-4 of the column flipped by the
// row. The m16n8k8 fragments read 8 rows x 4 columns (rows g, columns t) or
// 4 rows x 8 columns (rows t, columns g) of a tile, and both patterns then
// hit 32 distinct banks. Four-float groups stay whole, so 16-byte copies
// land in place.
__device__ __forceinline__ int swz(int r) { return ((r & 3) << 3) | (r & 4); }

template <int W>
__device__ __forceinline__ int at(int r, int c) {
  return r * W + (c ^ swz(r));
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, at 10 mantissa
// bits) in two integer operations: half a TF32 ulp added to the magnitude
// bits, the 13 low bits cleared. The same bits as the conversion
// instruction, which is a conversion at 16 results a clock per SM: with it
// kernel 7 took 16.1-16.2 ms at the training shape, with this 13.4-13.7
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6).
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }

// x = hi + lo + O(2^-22 |x|): hi and lo are TF32 values
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One fragment of a 16-deep product in 3xTF32: ah / al hold the A
// fragments of the two 8-deep steps, bh / bl the B fragments. The six
// products go into a fresh fragment that a rounded f32 add then puts onto c
// (why: mma_k16 below).
__device__ __forceinline__ void mma3_k16(float c[4], const uint32_t ah[2][4], const uint32_t al[2][4],
                                         const uint32_t bh[2][2], const uint32_t bl[2][2]) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    mma(t, al[ks], bh[ks]);
    mma(t, ah[ks], bl[ks]);
    mma(t, ah[ks], bh[ks]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

// The same sum with the four small products of both 8-deep steps first and
// the two hi * hi products last: the tensor cores' truncations then fall on
// small partial sums but for those two. In a model with one truncation a
// `mma` (tools/tf32_order_model.py) its rms error is 2.9e-8 of sum |terms|
// at depth 32, against 4.2e-8 for mma3_k16's order and 2.8e-8 for f32 FMA;
// on an H100 it took the attention kernels' largest errors against float64
// 14-23% lower at no measurable cost (PERF.md §6). The attention kernels
// take it (`hi_last`); the others keep mma3_k16's order, and their bits.
__device__ __forceinline__ void mma3_k16_hi_last(float c[4], const uint32_t ah[2][4], const uint32_t al[2][4],
                                                 const uint32_t bh[2][2], const uint32_t bl[2][2]) {
  float t[4] = {};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    mma(t, al[ks], bh[ks]);
    mma(t, ah[ks], bl[ks]);
  }
  mma(t, ah[0], bh[0]);
  mma(t, ah[1], bh[1]);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = c[e] + t[e];
}

// One 16-deep fragment in the order `hi_last` picks
template <bool hi_last>
__device__ __forceinline__ void mma3_k16_in(float c[4], const uint32_t ah[2][4], const uint32_t al[2][4],
                                            const uint32_t bh[2][2], const uint32_t bl[2][2]) {
  if constexpr (hi_last) mma3_k16_hi_last(c, ah, al, bh, bl);
  else mma3_k16(c, ah, al, bh, bl);
}

// c[mf][nf] += sum over k in [k0, k0 + 16) of a(mf, k) b(k, nf) in 3xTF32:
// per 8-deep step the two small terms first, then hi * hi (lo * lo, ~2^-22
// relative, is dropped). The tensor cores' f32 accumulation truncates, so
// the six products of the 16 k go into a fresh fragment that a rounded f32
// add then puts onto c: accumulated straight onto c over the 768 steps of a
// 2,048-item chunk they drifted by 3e-5 of the largest entry on an H100, and
// 3 train steps there left the CPU run's parameters by 1.7e-4. load_b(k, bh,
// bl) gives the B fragments of all kNF columns at depth k, load_a(mf, k, ah,
// al) the A fragment of row block mf; B for both depths stays in registers
// while the row blocks pass.
template <int kMF, int kNF, class LoadA, class LoadB>
__device__ __forceinline__ void mma_k16(float c[kMF][kNF][4], int k0, LoadA load_a, LoadB load_b) {
  uint32_t bh[2][kNF][2], bl[2][kNF][2];
  load_b(k0, bh[0], bl[0]);
  load_b(k0 + 8, bh[1], bl[1]);
#pragma unroll
  for (int mf = 0; mf < kMF; ++mf) {
    uint32_t ah[2][4], al[2][4];
    load_a(mf, k0, ah[0], al[0]);
    load_a(mf, k0 + 8, ah[1], al[1]);
#pragma unroll
    for (int nf = 0; nf < kNF; ++nf) {
      const uint32_t bh_nf[2][2] = {{bh[0][nf][0], bh[0][nf][1]}, {bh[1][nf][0], bh[1][nf][1]}};
      const uint32_t bl_nf[2][2] = {{bl[0][nf][0], bl[0][nf][1]}, {bl[1][nf][0], bl[1][nf][1]}};
      mma3_k16(c[mf][nf], ah, al, bh_nf, bl_nf);
    }
  }
}

// Four 8 x 4 blocks of 32-bit words from shared memory: lane l gives the
// address of row l % 8 of block l / 8 (16 bytes), and gets word l % 4 of row
// l / 4 of block j in r[j]: an m16n8k8 A fragment (blocks: rows 0-7 and 8-15
// of columns 0-3, then of columns 4-7) or two B fragments, in one instruction
__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// 16 bytes global -> shared, asynchronously; zeros when !ok (nothing is read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool ok) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(d), "l"(src), "r"(ok ? 8 : 0));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;"); }
// wait until at most `kPending` of this thread's latest copy groups are in flight
template <int kPending>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// ------------------------------------------------------------------ row tiles
//
// Tiles of whole rows of one (b, h) (q, k, v, dout), products over their
// head dim, and accumulator fragments fed back as the A operand of the next
// product: the attention kernels of attention.cu (kernels 2 and 5) and of
// stu_attention.cu (kernels 17-19). A warp's rows are 16 w + [0, 16) of
// its block's tile.

// Staged row tiles have a pitch of d + 4 floats: the m16n8k8 fragment reads
// (8 rows x 4 columns, and 4 rows two apart x 8 columns) then hit 32
// distinct banks, and rows stay 16-byte aligned for cp.async.
template <int D>
constexpr int kPitch = D + 4;

// rows [row0, row0 + kRows) of one (b, h) into a tile of pitch D + 4 by
// cp.async, zeros past L, by a block of kThreads threads
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void stage_rows_async(float* dst, const float* base, long long sl, int row0, int L) {
  for (int idx = threadIdx.x; idx < kRows * (D / 4); idx += kThreads) {
    const int r = idx / (D / 4);
    const int c = 4 * (idx - r * (D / 4));
    const bool ok = row0 + r < L;
    cp_async16(dst + r * kPitch<D> + c, ok ? base + (row0 + r) * sl + c : base, ok);
  }
}

// A fragments of rows r0 + [0, 16) of a tile of pitch P, depth [k, k + 16),
// as TF32 halves
template <int P>
__device__ __forceinline__ void frag_a(const float* tile, int r0, int k, uint32_t ah[2][4], uint32_t al[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* x = tile + (r0 + g) * P + k + 8 * ks + t;
    split(x[0], ah[ks][0], al[ks][0]);
    split(x[8 * P], ah[ks][1], al[ks][1]);
    split(x[4], ah[ks][2], al[ks][2]);
    split(x[8 * P + 4], ah[ks][3], al[ks][3]);
  }
}

// B fragments of one 8-column block with B(k, n) = tile[n0 + n][k]: rows
// n0 + [0, 8) of a tile of pitch P, depth [k, k + 16)
template <int P>
__device__ __forceinline__ void frag_b_rows(const float* tile, int n0, int k, uint32_t bh[2][2], uint32_t bl[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* x = tile + (n0 + g) * P + k + 8 * ks + t;
    split(x[0], bh[ks][0], bl[ks][0]);
    split(x[4], bh[ks][1], bl[ks][1]);
  }
}

// A product whose A comes from accumulator fragments (frag_a_from_c) takes
// its depth in the order of the accumulator's columns: within each 8-deep
// step, depth t is column 2t and depth t + 4 column 2t + 1. These are the
// matching B fragments, B(k, n) = tile[k][n0 + n]: rows k + [0, 16) of a
// tile of pitch P in that order, columns n0 + [0, 8).
template <int P>
__device__ __forceinline__ void frag_b_cols(const float* tile, int k, int n0, uint32_t bh[2][2], uint32_t bl[2][2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* x = tile + (k + 8 * ks + 2 * t) * P + n0 + g;
    split(x[0], bh[ks][0], bl[ks][0]);
    split(x[P], bh[ks][1], bl[ks][1]);
  }
}

// A fragments (16 rows, depth 16 in frag_b_cols' order) from two 16 x 8
// accumulator fragments, c0 then c1: the values stay in their threads
__device__ __forceinline__ void frag_a_from_c(const float c0[4], const float c1[4], uint32_t ah[2][4],
                                              uint32_t al[2][4]) {
  const float* c[2] = {c0, c1};
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    split(c[ks][0], ah[ks][0], al[ks][0]);  // (g, depth t) = column 2t
    split(c[ks][2], ah[ks][1], al[ks][1]);  // (g + 8, depth t)
    split(c[ks][1], ah[ks][2], al[ks][2]);  // (g, depth t + 4) = column 2t + 1
    split(c[ks][3], ah[ks][3], al[ks][3]);  // (g + 8, depth t + 4)
  }
}

// The same A fragments read from a row-major tile of pitch P (rows r0 + [0,
// 16), depth [k, k + 16) in frag_b_cols' order): one float2 per row and
// 8-deep step. With P = 8 (mod 32) the reads of a half warp hit 32 banks.
template <int P>
__device__ __forceinline__ void frag_a_pairs(const float* tile, int r0, int k, uint32_t ah[2][4], uint32_t al[2][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    const float* x = tile + (r0 + g) * P + k + 8 * ks + 2 * t;
    const float2 top = *reinterpret_cast<const float2*>(x);
    const float2 bottom = *reinterpret_cast<const float2*>(x + 8 * P);
    split(top.x, ah[ks][0], al[ks][0]);     // (g, depth t) = column 2t
    split(bottom.x, ah[ks][1], al[ks][1]);  // (g + 8, depth t)
    split(top.y, ah[ks][2], al[ks][2]);     // (g, depth t + 4) = column 2t + 1
    split(bottom.y, ah[ks][3], al[ks][3]);  // (g + 8, depth t + 4)
  }
}

// out[nf] (16 rows x 32 columns, four 8-column blocks) = rows r0 of `a`
// times rows c0 + [0, 32) of `b`, transposed, over depth D: the scores or
// the dout-v products of a 16 x 32 block (3xTF32 in `hi_last`'s order)
template <int D, bool hi_last = false>
__device__ __forceinline__ void product_rows(const float* a, int r0, const float* b, int c0, float out[4][4]) {
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) out[nf][e] = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    uint32_t ah[2][4], al[2][4];
    frag_a<kPitch<D>>(a, r0, k, ah, al);
#pragma unroll
    for (int nf = 0; nf < 4; ++nf) {
      uint32_t bh[2][2], bl[2][2];
      frag_b_rows<kPitch<D>>(b, c0 + nf * 8, k, bh, bl);
      mma3_k16_in<hi_last>(out[nf], ah, al, bh, bl);
    }
  }
}

// acc (16 rows x D) += w (16 rows x 32, accumulator fragments) times rows
// r0 + [0, 32) of `b` (pitch D + 4): dv, dk or dq
template <int D, bool hi_last = false>
__device__ __forceinline__ void accumulate_rows(float acc[D / 8][4], const float w[4][4], const float* b, int r0) {
#pragma unroll
  for (int kg = 0; kg < 2; ++kg) {
    uint32_t ah[2][4], al[2][4];
    frag_a_from_c(w[2 * kg], w[2 * kg + 1], ah, al);
#pragma unroll
    for (int nf = 0; nf < D / 8; ++nf) {
      uint32_t bh[2][2], bl[2][2];
      frag_b_cols<kPitch<D>>(b, r0 + 16 * kg, nf * 8, bh, bl);
      mma3_k16_in<hi_last>(acc[nf], ah, al, bh, bl);
    }
  }
}

// rows row0 + r (local r = 16 w + g, + 8; below L) of a strided (b, h)
// output <- acc, the accumulator fragments of 16 rows x D
template <int D>
__device__ __forceinline__ void store_frags(float* base, long long sl, int row0, int L, const float acc[D / 8][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + warp * 16 + g + 8 * hh;
    if (row >= L) continue;
#pragma unroll
    for (int nf = 0; nf < D / 8; ++nf)
      *reinterpret_cast<float2*>(base + row * sl + nf * 8 + 2 * t) = make_float2(acc[nf][2 * hh], acc[nf][2 * hh + 1]);
  }
}

}  // namespace tc
