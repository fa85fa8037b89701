// The 3xTF32 tensor-core tile's building blocks, shared by the kernels of
// softmax_lse.cu (the gradient kernels and kernel 6) and stu_attention.cu
// (kernel 18): TF32 rounding and the hi/lo split, `mma.sync` m16n8k8 with a
// fresh fragment per 16 k, `ldmatrix`, `cp.async`, and the swizzle of a
// staged tile. Included inside each source's anonymous namespace, after
// <cuda_runtime.h> and <stdint.h>; the source adds its own tile shapes to
// `namespace tc`.
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

}  // namespace tc
