// STU (HSTU) attention on bf16 q, k, v and dout: the forms of kernels 17, 18
// and 19 that mixed-precision training (compute_dtype="bfloat16") runs, on
// bf16 tensor-core products with f32 accumulation.
//
// Replaces, for bf16 inputs, rectools_tpu/ops/stu_attention.py:90
// `_stu_kernel` (`stu_fwd_bf16`, kernel 17), :274 `_stu_bwd_kernel`
// (`stu_bwd_bf16` for dk and dv and `stu_bwd_dq_bf16` for dq, kernel 18) and
// :316 `_stu_ds_kernel` (`stu_ds_bf16`, kernel 19). The rounding points are
// those of the JAX package's XLA route (`_stu_reference` :218-255 and its
// autodiff), which its TPU users train on whenever the (B, H, L, L) scores
// fit 1 GiB, as XLA on the CPU evaluates it on bf16 inputs (ROADMAP §3 has
// the other two routes' gaps). R(x) is x rounded to bf16, Lb = R(L):
// - forward: s = q k^T + bias (f32 products of the bf16 values, f32 sum, the
//   f32 bias added), sb = R(s), sig = R(1 / R(1 + R(exp(-sb)))), a =
//   R(R(R(sb sig) / Lb) * mask), out = R(sum_k a v) in f32 over the whole row.
// - backward: sb, sig and a again; da = R(dout v^T); dsi = R(R(da mask) /
//   Lb); ds = R(dsi sig) + R(R(dsi sb) R(sig R(1 - sig))) in f32, not rounded
//   (XLA keeps that last sum in f32 before the convert to the f32 score); dq =
//   R(sum_k ds k), dk = R(sum_q ds^T q), dv = R(sum_q a^T dout), each summed
//   in f32 over the whole row by the one block that owns those rows, then
//   rounded once (the Pallas route sums dk and dv in bf16 a 128-query block
//   at a time; the port keeps the XLA route's single rounding).
// - score gradient: ds of every head as above, summed over the heads in head
//   order in f32; with the time buckets each block also writes the sums of
//   its tile by bucket (one row of partials), as stu_ds_f32 does.
// mask = allowed * tl_q * tl_k (f32, that order). bias, allowed and timeline
// are f32, (B|1, L, L) with a batch stride of 0 when shared, and (B, L).
// Every f32 step above is one rounded operation (`__fadd_rn`, `__fmul_rn`,
// `__fdiv_rn`, `__frcp_rn`), never fused, so the kernels differ from the
// plain twins (ops/stu_attention.py) only in the order of the products' f32
// sums and in expf's last bit.
//
// Products: `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
// (bf16_tile.cuh); at a dim of 8 the products over it (q k^T over ad, dout
// v^T over lh) take one `mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32`
// each (`bt::mma_depth`), as exact as the 16-deep step, and the products
// whose columns run over a dim (a v, ds k, ds^T q, a^T dout) take one
// 8-column fragment, as at every dim. ds is an f32 sum of two bf16 values
// and no bf16 value itself, so the products that take it (dq, dk) take it as
// two bf16 operands, hi = R(ds) and lo = R(ds - hi), whose sum is ds (the sum
// of two bf16 values leaves a residue of at most 8 significant bits): two
// products each.
//
// Tiles (attention and hidden dims ad, lh in {8, 16, 32, 64}, each pair):
// 128 threads, 4 warps; 64-row tiles of one (b, h) staged in shared memory at
// a pitch of `bt::pitch(d)` bf16 (d + 8; 24 at d = 8) by 16-byte cp.async, the
// (query, key) tiles of bias and allowed at 72 floats a query row (68 in the
// dk/dv launch, whose reads run down the query axis), the timeline entries of
// both tiles. Warp w owns rows 16 w + [0, 16) of its block's own tile; each
// step is one 16 x 64 unit.
// - Before a tile of the other axis is staged, its timeline is read from
//   device memory (a barrier); a tile of padding alone is skipped, and a
//   block whose own rows are padding writes zeros. A warp whose 16 x 64 unit
//   the masks zero everywhere skips its products (a warp vote). Pairs past L
//   meet zero masks (the staged tiles hold zeros there); nothing is padded in
//   device memory. A fully padded row gives zeros, not NaN.
// - Forward: block (b, 64-query tile, h), h fastest; q fragments in
//   registers; per key tile s into accumulator fragments, a in place, then a
//   v with a as the A operand (v read across rows, two 16-bit values a
//   register).
// - dk/dv: block (b, 64-key tile, h); k and v fragments in registers; per
//   query tile s^T and da^T (keys x queries), then dv += a^T dout and dk +=
//   ds^T q (hi and lo) from those fragments.
// - dq: block (b, 64-query tile, h); q and dout fragments in registers; per
//   key tile s and da, then dq += ds k (hi and lo).
// - Score gradient: block (b, 64-key tile, 64-query tile) walks the heads in
//   order, staging the four row tiles of each head, and keeps the head sum in
//   registers; it writes its (query, key) tile of ds and, with buckets, its
//   row of partials (index (b * key tiles + key tile) * query tiles + query
//   tile), every bucket outside the tile's range 0. No float atomics: the
//   same inputs give the same bits.
//
// Bound on an H100 at the HSTU training shape (B = 512, H = 4, L = 100, ad =
// lh = 32, the (B, L, L) f32 bias): the forward reads q, k, v (39 MB) and
// the bias (20 MB) and writes out (13 MB), 0.022 ms at 3.35 TB/s; the
// backward reads q, k, v, dout and the bias and writes dq, dk, dv (112 MB,
// 0.033 ms); the score gradient reads q, k, v, dout, the bias and the buckets
// and writes ds (113 MB, 0.034 ms). Their products are 1.3-3.3 GFLOP over
// the pairs the causal mask lets through, under 0.004 ms at 989 TFLOP/s bf16:
// all three are bound by bytes. As written they are latency-bound: one
// cp.async stage per step, small blocks, every step behind a barrier. At ad =
// lh = 8 q, k, v and dout shrink fourfold and the (B, L, L) tensors (the f32
// bias, the buckets, ds) dominate: the forward moves 34 MB (0.010 ms), the
// backward 43 MB (0.013 ms), the score gradient 75 MB (0.022 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "tc_tile.cuh"
#include "bf16_tile.cuh"

typedef __nv_bfloat16 bf16;

constexpr int kT = 64;  // rows of every tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPMQ = 72;  // pitch of a [query][key] f32 tile read as float2 by (query g, key 2t)
constexpr int kPMK = 68;  // pitch of a [query][key] f32 tile read by (key g, query 2t)

struct Strides {
  long long sb, sh, sl;  // batch, head, position, in elements; the last stride is 1
};

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  bf16* out;  // the forward's out, or dq
  bf16* dk;
  bf16* dv;
  float* ds;  // (B, L, L)
  const int* buckets;  // (B, L, L) or null
  float* bucket_partials;
  int n_entries;
  const float* bias;      // (B|1, L, L), rows of L contiguous floats
  const float* allowed;   // (B|1, L, L), multiplicative
  const float* timeline;  // (B, L) contiguous, multiplicative
  long long bias_sb, allowed_sb;  // 0: shared by the batch; else L * L
  int B, H, L;
  Strides qs, ks, vs, dos, os, dks, dvs;
};

// the row tiles of one step and the (query, key) mask tiles; `dout` holds one
// tile only where a kernel reads dout
template <int AD, int LH, int PM, bool kDout>
struct Smem {
  bf16 q[kT * bt::pitch(AD)];
  bf16 k[kT * bt::pitch(AD)];
  bf16 v[kT * bt::pitch(LH)];
  bf16 dout[kDout ? kT * bt::pitch(LH) : 8];
  float bias[kT * PM];  // [query][key]
  float allowed[kT * PM];
  float tlq[kT];
  float tlk[kT];
};

// the (query, key) tile [q0, q0 + 64) x [k0, k0 + 64) of a (L, L) f32 matrix
// into a [query][key] tile of pitch PM by cp.async, zeros outside (L, L)
template <int PM>
__device__ __forceinline__ void stage_mask(float* dst, const float* base, int q0, int k0, int L, bool vec) {
  if (vec) {
    for (int idx = threadIdx.x; idx < kT * (kT / 4); idx += kThreads) {
      const int r = idx / (kT / 4), c = 4 * (idx % (kT / 4));
      const bool ok = q0 + r < L && k0 + c < L;
      tc::cp_async16(dst + r * PM + c, ok ? base + (long long)(q0 + r) * L + k0 + c : base, ok);
    }
  } else {
    for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
      const int r = idx / kT, c = idx % kT;
      const bool ok = q0 + r < L && k0 + c < L;
      tc::cp_async4(dst + r * PM + c, ok ? base + (long long)(q0 + r) * L + k0 + c : base, ok);
    }
  }
}

// entries [i0, i0 + 64) of a (L,) timeline row by cp.async, zeros past L
__device__ __forceinline__ void stage_timeline(float* dst, const float* tl, int i0, int L) {
  if (threadIdx.x < kT) {
    const bool ok = i0 + (int)threadIdx.x < L;
    tc::cp_async4(dst + threadIdx.x, ok ? tl + i0 + threadIdx.x : tl, ok);
  }
}

// rows [row0, row0 + 64) of one (b, h) of a strided bf16 tensor into a tile
// of pitch W + 8 by cp.async, zeros past L
template <int W>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* base, long long sl, int row0, int L) {
  bt::stage_async<W, kT, kThreads>(dst, base, sl, row0, L);
}

// Whether any of entries [i0, i0 + 64) of a (L,) timeline row is nonzero,
// read from device memory before anything of that tile is staged. A barrier:
// every thread of the block gets the answer.
__device__ __forceinline__ bool timeline_live(const float* tl, int i0, int L) {
  const int i = i0 + (int)threadIdx.x;
  return __syncthreads_or(threadIdx.x < kT && i < L && tl[i] != 0.f) != 0;
}

// The mask of a warp's unit at the accumulator's coordinates, rows queries qr
// + [0, 16) and columns the tile's 64 keys; whether any entry of the warp's
// unit is nonzero (every lane gets the answer)
__device__ __forceinline__ bool mask_by_query(float mask[8][4], const float* allowed, const float* tlq,
                                              const float* tlk, int qr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bool any = false;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = qr + g + 8 * (e >> 1), key = 8 * nf + 2 * t + (e & 1);
      mask[nf][e] = __fmul_rn(__fmul_rn(allowed[query * kPMQ + key], tlq[query]), tlk[key]);
      any |= mask[nf][e] != 0.f;
    }
  return __any_sync(0xffffffffu, any);
}

// the same with rows keys kr + [0, 16) and columns the tile's 64 queries
__device__ __forceinline__ bool mask_by_key(float mask[8][4], const float* allowed, const float* tlq,
                                            const float* tlk, int kr) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bool any = false;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kr + g + 8 * (e >> 1), query = 8 * nf + 2 * t + (e & 1);
      mask[nf][e] = __fmul_rn(__fmul_rn(allowed[query * kPMK + key], tlq[query]), tlk[key]);
      any |= mask[nf][e] != 0.f;
    }
  return __any_sync(0xffffffffu, any);
}

// sb = R(s + bias) and sig = R(1 / R(1 + R(exp(-sb)))) of one score from the raw product s = q . k
__device__ __forceinline__ void sigmoid(float s, float bias, float& sb, float& sig) {
  sb = bt::round_bf16(__fadd_rn(s, bias));
  const float den = bt::round_bf16(__fadd_rn(1.f, bt::round_bf16(expf(-sb))));
  sig = bt::round_bf16(__frcp_rn(den));
}

// a = R(R(R(sb sig) / Lb) * mask)
__device__ __forceinline__ float activation(float sb, float sig, float mask, float Lb) {
  const float a0 = bt::round_bf16(__fdiv_rn(bt::round_bf16(__fmul_rn(sb, sig)), Lb));
  return bt::round_bf16(__fmul_rn(a0, mask));
}

// ds of one score from the raw product da = dout . v, an f32 sum of two bf16 terms
__device__ __forceinline__ float score_grad(float da, float mask, float Lb, float sb, float sig) {
  const float dsi = bt::round_bf16(__fdiv_rn(bt::round_bf16(__fmul_rn(bt::round_bf16(da), mask)), Lb));
  const float d1 = bt::round_bf16(__fmul_rn(dsi, sig));
  const float slope = bt::round_bf16(__fmul_rn(sig, bt::round_bf16(__fsub_rn(1.f, sig))));
  const float d2 = bt::round_bf16(__fmul_rn(bt::round_bf16(__fmul_rn(dsi, sb)), slope));
  return __fadd_rn(d1, d2);
}

// A fragments (16 rows, depth 16) of f32 values from two 16 x 8 accumulator
// fragments as hi = R(x) and lo = R(x - hi)
__device__ __forceinline__ void frag_a_split(const float c0[4], const float c1[4], uint32_t hi[4], uint32_t lo[4]) {
  const float x[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
  float h[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[i] = bt::round_bf16(x[i]);
    l[i] = __fsub_rn(x[i], h[i]);
  }
  hi[0] = bt::pack(h[0], h[1]);
  hi[1] = bt::pack(h[2], h[3]);
  hi[2] = bt::pack(h[4], h[5]);
  hi[3] = bt::pack(h[6], h[7]);
  lo[0] = bt::pack(l[0], l[1]);
  lo[1] = bt::pack(l[2], l[3]);
  lo[2] = bt::pack(l[4], l[5]);
  lo[3] = bt::pack(l[6], l[7]);
}

// acc (16 rows x 64 columns) = a (the warp's A fragments over depth D) times
// rows [0, 64) of `b` (pitch bt::pitch(D)), transposed
template <int D>
__device__ __forceinline__ void product_64(const uint32_t a[bt::Depth<D>::kFrags][4], const bf16* b,
                                           float acc[8][4]) {
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nf][e] = 0.f;
    bt::mma_depth<D, bt::pitch(D)>(acc[nf], a, b, 8 * nf);
  }
}

// the warp's A fragments of rows r0 + [0, 16) of a tile of pitch bt::pitch(D)
template <int D>
__device__ __forceinline__ void frags_a(const bf16* tile, int r0, uint32_t a[bt::Depth<D>::kFrags][4]) {
  bt::frags_a<D, bt::pitch(D)>(tile, r0, a);
}

// out (16 rows x W) += the warp's 16 x 64 unit `x` (a in bf16 values, as one
// operand; ds as hi and lo, when kSplit) times rows [0, 64) of `b` (pitch W +
// 8, read across rows)
template <int W, bool kSplit>
__device__ __forceinline__ void accumulate_64(float out[W / 8][4], const float x[8][4], const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < kT / 16; ++kk) {
    uint32_t hi[4], lo[4] = {0u, 0u, 0u, 0u};
    if constexpr (kSplit) {
      frag_a_split(x[2 * kk], x[2 * kk + 1], hi, lo);
    } else {
      bt::frag_a_from_c(x[2 * kk], x[2 * kk + 1], hi);
    }
#pragma unroll
    for (int nf = 0; nf < W / 8; ++nf) {
      uint32_t bb[2];
      bt::frag_b_t<bt::pitch(W)>(b, 16 * kk, 8 * nf, bb);
      bt::mma(out[nf], hi, bb);
      if constexpr (kSplit) bt::mma(out[nf], lo, bb);
    }
  }
}

template <int W>
__device__ __forceinline__ void zero_frags(float x[W / 8][4]) {
#pragma unroll
  for (int nf = 0; nf < W / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[nf][e] = 0.f;
}

// rows row0 + [0, 16) (the warp's) of a strided bf16 tensor from f32 fragments,
// rounded once; rows past L are not written
template <int W>
__device__ __forceinline__ void store_frags(bf16* base, long long sl, int row0, int L, const float x[W / 8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + g + 8 * hh;
    if (row >= L) continue;
#pragma unroll
    for (int nf = 0; nf < W / 8; ++nf)
      *reinterpret_cast<uint32_t*>(base + row * sl + 8 * nf + 2 * t) = bt::pack(x[nf][2 * hh], x[nf][2 * hh + 1]);
  }
}

// both mask rows 16-byte aligned for 16-byte copies
__device__ __forceinline__ bool vec_masks(const float* bias, const float* allowed, int L) {
  return (L & 3) == 0 && ((reinterpret_cast<uintptr_t>(bias) | reinterpret_cast<uintptr_t>(allowed)) & 15) == 0;
}

// ------------------------------------------------------------------ kernel 17, forward

template <int AD, int LH>
__global__ void __launch_bounds__(kThreads) stu_fwd_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<AD, LH, kPMQ, false>& sh = *reinterpret_cast<Smem<AD, LH, kPMQ, false>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int L = p.L;
  const float Lb = bt::round_bf16((float)L);
  const int n_tiles = (L + kT - 1) / kT;
  const int h = blockIdx.x % p.H;
  const int q0 = (blockIdx.x / p.H % n_tiles) * kT;
  const int b = blockIdx.x / p.H / n_tiles;
  const float* bbase = p.bias + b * p.bias_sb;
  const float* abase = p.allowed + b * p.allowed_sb;
  const float* tl = p.timeline + (long long)b * L;
  const bool vec = vec_masks(bbase, abase, L);
  const int qr = 16 * warp;

  float o[LH / 8][4];
  zero_frags<LH>(o);
  uint32_t qa[bt::Depth<AD>::kFrags][4];
  bool have_q = false;
  const bool queries_live = timeline_live(tl, q0, L);
  if (queries_live) {
    stage_rows<AD>(sh.q, p.q + b * p.qs.sb + h * p.qs.sh, p.qs.sl, q0, L);
    stage_timeline(sh.tlq, tl, q0, L);
    tc::cp_commit();
  }
  for (int k0 = 0; queries_live && k0 < L; k0 += kT) {
    if (!timeline_live(tl, k0, L)) continue;  // also the barrier after which the previous key tile is consumed
    stage_rows<AD>(sh.k, p.k + b * p.ks.sb + h * p.ks.sh, p.ks.sl, k0, L);
    stage_rows<LH>(sh.v, p.v + b * p.vs.sb + h * p.vs.sh, p.vs.sl, k0, L);
    stage_mask<kPMQ>(sh.bias, bbase, q0, k0, L, vec);
    stage_mask<kPMQ>(sh.allowed, abase, q0, k0, L, vec);
    stage_timeline(sh.tlk, tl, k0, L);
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
    if (!have_q) {
      frags_a<AD>(sh.q, qr, qa);
      have_q = true;
    }
    float mask[8][4];
    if (!mask_by_query(mask, sh.allowed, sh.tlq, sh.tlk, qr)) continue;
    float s[8][4];
    product_64<AD>(qa, sh.k, s);
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int query = qr + g + 8 * hh, key = 8 * nf + 2 * t;
        const float2 bias = *reinterpret_cast<const float2*>(&sh.bias[query * kPMQ + key]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * hh + j;
          if (mask[nf][e] == 0.f) {
            s[nf][e] = 0.f;
            continue;
          }
          float sb, sig;
          sigmoid(s[nf][e], j ? bias.y : bias.x, sb, sig);
          s[nf][e] = activation(sb, sig, mask[nf][e], Lb);
        }
      }
    accumulate_64<LH, false>(o, s, sh.v);
  }
  tc::cp_wait<0>();  // no copy outlives the block, though every key tile was skipped
  store_frags<LH>(p.out + b * p.os.sb + h * p.os.sh, p.os.sl, q0 + qr, L, o);
}

// ------------------------------------------------------------------ kernel 18, dk and dv

template <int AD, int LH>
__global__ void __launch_bounds__(kThreads) stu_dkdv_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<AD, LH, kPMK, true>& sh = *reinterpret_cast<Smem<AD, LH, kPMK, true>*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int L = p.L;
  const float Lb = bt::round_bf16((float)L);
  const int n_tiles = (L + kT - 1) / kT;
  const int h = blockIdx.x % p.H;
  const int k0 = (blockIdx.x / p.H % n_tiles) * kT;
  const int b = blockIdx.x / p.H / n_tiles;
  const float* bbase = p.bias + b * p.bias_sb;
  const float* abase = p.allowed + b * p.allowed_sb;
  const float* tl = p.timeline + (long long)b * L;
  const bool vec = vec_masks(bbase, abase, L);
  const int kr = 16 * warp;

  float dk[AD / 8][4], dv[LH / 8][4];
  zero_frags<AD>(dk);
  zero_frags<LH>(dv);
  uint32_t ka[bt::Depth<AD>::kFrags][4], va[bt::Depth<LH>::kFrags][4];
  bool have_kv = false;
  const bool keys_live = timeline_live(tl, k0, L);
  if (keys_live) {
    stage_rows<AD>(sh.k, p.k + b * p.ks.sb + h * p.ks.sh, p.ks.sl, k0, L);
    stage_rows<LH>(sh.v, p.v + b * p.vs.sb + h * p.vs.sh, p.vs.sl, k0, L);
    stage_timeline(sh.tlk, tl, k0, L);
    tc::cp_commit();
  }
  for (int q0 = 0; keys_live && q0 < L; q0 += kT) {
    if (!timeline_live(tl, q0, L)) continue;  // also the barrier after which the previous query tile is consumed
    stage_rows<AD>(sh.q, p.q + b * p.qs.sb + h * p.qs.sh, p.qs.sl, q0, L);
    stage_rows<LH>(sh.dout, p.dout + b * p.dos.sb + h * p.dos.sh, p.dos.sl, q0, L);
    stage_mask<kPMK>(sh.bias, bbase, q0, k0, L, vec);
    stage_mask<kPMK>(sh.allowed, abase, q0, k0, L, vec);
    stage_timeline(sh.tlq, tl, q0, L);
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
    if (!have_kv) {
      frags_a<AD>(sh.k, kr, ka);
      frags_a<LH>(sh.v, kr, va);
      have_kv = true;
    }
    float mask[8][4];
    if (!mask_by_key(mask, sh.allowed, sh.tlq, sh.tlk, kr)) continue;
    float st[8][4], dt[8][4];  // s^T and da^T: keys kr + [0, 16) x the tile's 64 queries
    product_64<AD>(ka, sh.q, st);
    product_64<LH>(va, sh.dout, dt);
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kr + g + 8 * (e >> 1), query = 8 * nf + 2 * t + (e & 1);
        if (mask[nf][e] == 0.f) {
          st[nf][e] = dt[nf][e] = 0.f;
          continue;
        }
        float sb, sig;
        sigmoid(st[nf][e], sh.bias[query * kPMK + key], sb, sig);
        st[nf][e] = activation(sb, sig, mask[nf][e], Lb);
        dt[nf][e] = score_grad(dt[nf][e], mask[nf][e], Lb, sb, sig);
      }
    accumulate_64<LH, false>(dv, st, sh.dout);
    accumulate_64<AD, true>(dk, dt, sh.q);
  }
  tc::cp_wait<0>();
  store_frags<AD>(p.dk + b * p.dks.sb + h * p.dks.sh, p.dks.sl, k0 + kr, L, dk);
  store_frags<LH>(p.dv + b * p.dvs.sb + h * p.dvs.sh, p.dvs.sl, k0 + kr, L, dv);
}

// ------------------------------------------------------------------ kernel 18, dq

// s and da of the warp's 16 queries x the staged key tile's 64 keys, turned
// into ds in `da` (zeros where the mask is); the bias at [query][key], pitch kPMQ
__device__ __forceinline__ void ds_by_query(float s[8][4], float da[8][4], const float mask[8][4], const float* bias,
                                            int qr, float Lb) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int query = qr + g + 8 * hh, key = 8 * nf + 2 * t;
      const float2 bb = *reinterpret_cast<const float2*>(&bias[query * kPMQ + key]);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int e = 2 * hh + j;
        if (mask[nf][e] == 0.f) {
          da[nf][e] = 0.f;
          continue;
        }
        float sb, sig;
        sigmoid(s[nf][e], j ? bb.y : bb.x, sb, sig);
        da[nf][e] = score_grad(da[nf][e], mask[nf][e], Lb, sb, sig);
      }
    }
}

template <int AD, int LH>
__global__ void __launch_bounds__(kThreads) stu_dq_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<AD, LH, kPMQ, true>& sh = *reinterpret_cast<Smem<AD, LH, kPMQ, true>*>(smem_raw);
  const int warp = threadIdx.x >> 5;
  const int L = p.L;
  const float Lb = bt::round_bf16((float)L);
  const int n_tiles = (L + kT - 1) / kT;
  const int h = blockIdx.x % p.H;
  const int q0 = (blockIdx.x / p.H % n_tiles) * kT;
  const int b = blockIdx.x / p.H / n_tiles;
  const float* bbase = p.bias + b * p.bias_sb;
  const float* abase = p.allowed + b * p.allowed_sb;
  const float* tl = p.timeline + (long long)b * L;
  const bool vec = vec_masks(bbase, abase, L);
  const int qr = 16 * warp;

  float dq[AD / 8][4];
  zero_frags<AD>(dq);
  uint32_t qa[bt::Depth<AD>::kFrags][4], doa[bt::Depth<LH>::kFrags][4];
  bool have_q = false;
  const bool queries_live = timeline_live(tl, q0, L);
  if (queries_live) {
    stage_rows<AD>(sh.q, p.q + b * p.qs.sb + h * p.qs.sh, p.qs.sl, q0, L);
    stage_rows<LH>(sh.dout, p.dout + b * p.dos.sb + h * p.dos.sh, p.dos.sl, q0, L);
    stage_timeline(sh.tlq, tl, q0, L);
    tc::cp_commit();
  }
  for (int k0 = 0; queries_live && k0 < L; k0 += kT) {
    if (!timeline_live(tl, k0, L)) continue;  // also the barrier after which the previous key tile is consumed
    stage_rows<AD>(sh.k, p.k + b * p.ks.sb + h * p.ks.sh, p.ks.sl, k0, L);
    stage_rows<LH>(sh.v, p.v + b * p.vs.sb + h * p.vs.sh, p.vs.sl, k0, L);
    stage_mask<kPMQ>(sh.bias, bbase, q0, k0, L, vec);
    stage_mask<kPMQ>(sh.allowed, abase, q0, k0, L, vec);
    stage_timeline(sh.tlk, tl, k0, L);
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
    if (!have_q) {
      frags_a<AD>(sh.q, qr, qa);
      frags_a<LH>(sh.dout, qr, doa);
      have_q = true;
    }
    float mask[8][4];
    if (!mask_by_query(mask, sh.allowed, sh.tlq, sh.tlk, qr)) continue;
    float s[8][4], da[8][4];
    product_64<AD>(qa, sh.k, s);
    product_64<LH>(doa, sh.v, da);
    ds_by_query(s, da, mask, sh.bias, qr, Lb);
    accumulate_64<AD, true>(dq, da, sh.k);
  }
  tc::cp_wait<0>();
  store_frags<AD>(p.out + b * p.os.sb + h * p.os.sh, p.os.sl, q0 + qr, L, dq);
}

// ------------------------------------------------------------------ kernel 19, the score gradient

template <int AD, int LH>
struct DsSmem {
  Smem<AD, LH, kPMQ, true> tiles;
  float bucket_sums[kWarps][32];  // each warp's sums of a batch of 32 buckets
  int bucket_range[kWarps][2];
};

template <int AD, int LH>
__global__ void __launch_bounds__(kThreads) stu_ds_bf16_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DsSmem<AD, LH>& shared = *reinterpret_cast<DsSmem<AD, LH>*>(smem_raw);
  Smem<AD, LH, kPMQ, true>& sh = shared.tiles;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int L = p.L;
  const float Lb = bt::round_bf16((float)L);
  const int b = blockIdx.x, k0 = blockIdx.y * kT, q0 = blockIdx.z * kT;
  const float* bbase = p.bias + b * p.bias_sb;
  const float* abase = p.allowed + b * p.allowed_sb;
  const float* tl = p.timeline + (long long)b * L;
  const bool vec = vec_masks(bbase, abase, L);
  const int qr = 16 * warp;

  float acc[8][4];  // ds summed over the heads: queries qr + [0, 16) x the tile's 64 keys
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nf][e] = 0.f;
  // tiles of padding alone, tested from device memory (barriers), then the masks
  const bool queries_live = timeline_live(tl, q0, L);
  const bool keys_live = timeline_live(tl, k0, L);
  bool live = false;
  if (queries_live && keys_live) {
    stage_mask<kPMQ>(sh.bias, bbase, q0, k0, L, vec);
    stage_mask<kPMQ>(sh.allowed, abase, q0, k0, L, vec);
    stage_timeline(sh.tlq, tl, q0, L);
    stage_timeline(sh.tlk, tl, k0, L);
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
    float mask[8][4];
    live = mask_by_query(mask, sh.allowed, sh.tlq, sh.tlk, qr);
  }
  const bool block_live = __syncthreads_or(live) != 0;

#pragma unroll 1
  for (int h = 0; block_live && h < p.H; ++h) {
    __syncthreads();  // every warp is done with the previous head's tiles
    stage_rows<AD>(sh.q, p.q + b * p.qs.sb + h * p.qs.sh, p.qs.sl, q0, L);
    stage_rows<LH>(sh.dout, p.dout + b * p.dos.sb + h * p.dos.sh, p.dos.sl, q0, L);
    stage_rows<AD>(sh.k, p.k + b * p.ks.sb + h * p.ks.sh, p.ks.sl, k0, L);
    stage_rows<LH>(sh.v, p.v + b * p.vs.sb + h * p.vs.sh, p.vs.sl, k0, L);
    tc::cp_commit();
    tc::cp_wait<0>();
    __syncthreads();
    if (!live) continue;
    uint32_t qa[bt::Depth<AD>::kFrags][4], doa[bt::Depth<LH>::kFrags][4];
    frags_a<AD>(sh.q, qr, qa);
    frags_a<LH>(sh.dout, qr, doa);
    float mask[8][4];
    mask_by_query(mask, sh.allowed, sh.tlq, sh.tlk, qr);
    float s[8][4], da[8][4];
    product_64<AD>(qa, sh.k, s);
    product_64<LH>(doa, sh.v, da);
    ds_by_query(s, da, mask, sh.bias, qr, Lb);
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[nf][e] = __fadd_rn(acc[nf][e], da[nf][e]);
  }

  // the tile of ds, (query, key) entries inside (L, L)
  float* out = p.ds + (long long)b * L * L;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = q0 + qr + g + 8 * (e >> 1), key = k0 + 8 * nf + 2 * t + (e & 1);
      if (query < L && key < L) out[(long long)query * L + key] = acc[nf][e];
    }
  if (p.buckets == nullptr) return;

  // the tile summed by bucket
  float* partial =
      p.bucket_partials + ((long long)(b * gridDim.y + blockIdx.y) * gridDim.z + blockIdx.z) * p.n_entries;
  const int* bk_base = p.buckets + (long long)b * L * L;
  int bk[8][4];  // the buckets of acc's entries, -1 outside (L, L) and in a dead tile
  int lo = p.n_entries, hi = -1;
#pragma unroll
  for (int nf = 0; nf < 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int query = q0 + qr + g + 8 * (e >> 1), key = k0 + 8 * nf + 2 * t + (e & 1);
      const int j = block_live && query < L && key < L ? bk_base[(long long)query * L + key] : -1;
      bk[nf][e] = j;
      if (j >= 0) {
        lo = min(lo, j);
        hi = max(hi, j);
      }
    }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    shared.bucket_range[warp][0] = lo;
    shared.bucket_range[warp][1] = hi;
  }
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    lo = min(lo, shared.bucket_range[w][0]);
    hi = max(hi, shared.bucket_range[w][1]);
  }
  hi = min(hi, p.n_entries - 1);
  for (int e = threadIdx.x; e < p.n_entries; e += kThreads)
    if (e < lo || e > hi) partial[e] = 0.f;
  // per batch of 32 buckets: lane j of each warp keeps the warp's sum of bucket base + j
#pragma unroll 1
  for (int base = lo; base <= hi; base += 32) {
    float mine = 0.f;
#pragma unroll 1
    for (int j = 0; j < 32 && base + j <= hi; ++j) {
      float x = 0.f;
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) x += bk[nf][e] == base + j ? acc[nf][e] : 0.f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == j) mine = x;
    }
    shared.bucket_sums[warp][lane] = mine;
    __syncthreads();
    if (threadIdx.x < 32 && base + (int)threadIdx.x <= hi) {
      float s = shared.bucket_sums[0][threadIdx.x];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s += shared.bucket_sums[w][threadIdx.x];
      partial[base + threadIdx.x] = s;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------------ launches

enum class Kind { kFwd, kDkdv, kDq, kDs };

template <int AD, int LH, Kind K>
int launch(const Params& p, long long n_partials, cudaStream_t stream) {
  const int n_tiles = (p.L + kT - 1) / kT;
  const long long row_blocks = (long long)p.B * p.H * n_tiles;
  cudaError_t err = cudaSuccess;
  if constexpr (K == Kind::kFwd) {
    const int smem = (int)sizeof(Smem<AD, LH, kPMQ, false>);
    err = cudaFuncSetAttribute(stu_fwd_bf16_kernel<AD, LH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    stu_fwd_bf16_kernel<AD, LH><<<(unsigned)row_blocks, kThreads, smem, stream>>>(p);
  } else if constexpr (K == Kind::kDkdv) {
    const int smem = (int)sizeof(Smem<AD, LH, kPMK, true>);
    err = cudaFuncSetAttribute(stu_dkdv_bf16_kernel<AD, LH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    stu_dkdv_bf16_kernel<AD, LH><<<(unsigned)row_blocks, kThreads, smem, stream>>>(p);
  } else if constexpr (K == Kind::kDq) {
    const int smem = (int)sizeof(Smem<AD, LH, kPMQ, true>);
    err = cudaFuncSetAttribute(stu_dq_bf16_kernel<AD, LH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    stu_dq_bf16_kernel<AD, LH><<<(unsigned)row_blocks, kThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((unsigned)p.B, (unsigned)n_tiles, (unsigned)n_tiles);
    if (p.buckets != nullptr && n_partials != (long long)grid.x * grid.y * grid.z) return (int)cudaErrorInvalidValue;
    const int smem = (int)sizeof(DsSmem<AD, LH>);
    err = cudaFuncSetAttribute(stu_ds_bf16_kernel<AD, LH>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    stu_ds_bf16_kernel<AD, LH><<<grid, kThreads, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int AD, Kind K>
int dispatch_lh(int lh, const Params& p, long long n_partials, cudaStream_t stream) {
  switch (lh) {
    case 8: return launch<AD, 8, K>(p, n_partials, stream);
    case 16: return launch<AD, 16, K>(p, n_partials, stream);
    case 32: return launch<AD, 32, K>(p, n_partials, stream);
    case 64: return launch<AD, 64, K>(p, n_partials, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// attention dim `ad` (q, k) and hidden dim `lh` (v, dout) each from {8, 16, 32, 64}
template <Kind K>
int dispatch(int ad, int lh, const Params& p, long long n_partials, cudaStream_t stream) {
  if (p.B <= 0 || p.H <= 0 || p.L <= 0) return 0;
  switch (ad) {
    case 8: return dispatch_lh<8, K>(lh, p, n_partials, stream);
    case 16: return dispatch_lh<16, K>(lh, p, n_partials, stream);
    case 32: return dispatch_lh<32, K>(lh, p, n_partials, stream);
    case 64: return dispatch_lh<64, K>(lh, p, n_partials, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v, const void* dout, const float* bias,
                   const float* allowed, const float* timeline, long long bias_sb, long long allowed_sb, int B, int H,
                   int L) {
  Params p{};
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.bias = bias;
  p.allowed = allowed;
  p.timeline = timeline;
  p.bias_sb = bias_sb;
  p.allowed_sb = allowed_sb;
  p.B = B;
  p.H = H;
  p.L = L;
  return p;
}

}  // namespace

// Strides are in elements; the last stride of q, k, v, dout and the outputs is
// 1 and every row start is 16-byte aligned (checked by the Python wrapper).
// q, k, v, dout and the gradients are bf16; `bias` and `allowed` are (B or 1,
// L, L) f32 contiguous with the given batch stride (0 when shared by the
// batch), `timeline` is (B, L) f32 contiguous. Each function returns
// cudaGetLastError() after its launch (0 = launched).
extern "C" int stu_fwd_bf16(const void* q, const void* k, const void* v, const float* bias, const float* allowed,
                            const float* timeline, void* out, int B, int H, int L, int ad, int lh, long long q_sb,
                            long long q_sh, long long q_sl, long long k_sb, long long k_sh, long long k_sl,
                            long long v_sb, long long v_sh, long long v_sl, long long o_sb, long long o_sh,
                            long long o_sl, long long bias_sb, long long allowed_sb, cudaStream_t stream) {
  Params p = make_params(q, k, v, nullptr, bias, allowed, timeline, bias_sb, allowed_sb, B, H, L);
  p.out = static_cast<bf16*>(out);
  p.qs = Strides{q_sb, q_sh, q_sl};
  p.ks = Strides{k_sb, k_sh, k_sl};
  p.vs = Strides{v_sb, v_sh, v_sl};
  p.os = Strides{o_sb, o_sh, o_sl};
  return dispatch<Kind::kFwd>(ad, lh, p, 0, stream);
}

// dk (strided like q) and dv (strided like v): kernel 18's first launch.
extern "C" int stu_bwd_bf16(const void* q, const void* k, const void* v, const void* dout, const float* bias,
                            const float* allowed, const float* timeline, void* dk, void* dv, int B, int H, int L,
                            int ad, int lh, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                            long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                            long long do_sb, long long do_sh, long long do_sl, long long dk_sb, long long dk_sh,
                            long long dk_sl, long long dv_sb, long long dv_sh, long long dv_sl, long long bias_sb,
                            long long allowed_sb, cudaStream_t stream) {
  Params p = make_params(q, k, v, dout, bias, allowed, timeline, bias_sb, allowed_sb, B, H, L);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.qs = Strides{q_sb, q_sh, q_sl};
  p.ks = Strides{k_sb, k_sh, k_sl};
  p.vs = Strides{v_sb, v_sh, v_sl};
  p.dos = Strides{do_sb, do_sh, do_sl};
  p.dks = Strides{dk_sb, dk_sh, dk_sl};
  p.dvs = Strides{dv_sb, dv_sh, dv_sl};
  return dispatch<Kind::kDkdv>(ad, lh, p, 0, stream);
}

// dq (strided like q): kernel 18's second launch.
extern "C" int stu_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout, const float* bias,
                               const float* allowed, const float* timeline, void* dq, int B, int H, int L, int ad,
                               int lh, long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                               long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long do_sb,
                               long long do_sh, long long do_sl, long long dq_sb, long long dq_sh, long long dq_sl,
                               long long bias_sb, long long allowed_sb, cudaStream_t stream) {
  Params p = make_params(q, k, v, dout, bias, allowed, timeline, bias_sb, allowed_sb, B, H, L);
  p.out = static_cast<bf16*>(dq);
  p.qs = Strides{q_sb, q_sh, q_sl};
  p.ks = Strides{k_sb, k_sh, k_sl};
  p.vs = Strides{v_sb, v_sh, v_sl};
  p.dos = Strides{do_sb, do_sh, do_sl};
  p.os = Strides{dq_sb, dq_sh, dq_sl};
  return dispatch<Kind::kDq>(ad, lh, p, 0, stream);
}

// ds (B, L, L) f32 contiguous: the gradient of the score q k^T + bias, summed
// over the heads in head order. With `buckets` ((B, L, L) int32 in [0,
// n_entries), may be null) each block also writes its tile's sums by bucket
// into its row of `bucket_partials` (n_partials, n_entries); n_partials must
// be B * ceil(L / 64)^2 (else cudaErrorInvalidValue).
extern "C" int stu_ds_bf16(const void* q, const void* k, const void* v, const void* dout, const float* bias,
                           const float* allowed, const float* timeline, float* ds, int B, int H, int L, int ad, int lh,
                           long long q_sb, long long q_sh, long long q_sl, long long k_sb, long long k_sh,
                           long long k_sl, long long v_sb, long long v_sh, long long v_sl, long long do_sb,
                           long long do_sh, long long do_sl, long long bias_sb, long long allowed_sb,
                           const int* buckets, float* bucket_partials, int n_entries, long long n_partials,
                           cudaStream_t stream) {
  if (buckets != nullptr && (bucket_partials == nullptr || n_entries <= 0)) return (int)cudaErrorInvalidValue;
  Params p = make_params(q, k, v, dout, bias, allowed, timeline, bias_sb, allowed_sb, B, H, L);
  p.ds = ds;
  p.buckets = buckets;
  p.bucket_partials = bucket_partials;
  p.n_entries = n_entries;
  p.qs = Strides{q_sb, q_sh, q_sl};
  p.ks = Strides{k_sb, k_sh, k_sl};
  p.vs = Strides{v_sb, v_sh, v_sl};
  p.dos = Strides{do_sb, do_sh, do_sl};
  return dispatch<Kind::kDs>(ad, lh, p, n_partials, stream);
}
