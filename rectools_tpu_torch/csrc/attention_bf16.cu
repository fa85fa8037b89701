// Attention on bf16 q, k, v: the forms of kernels 2 and 5 that
// mixed-precision training (compute_dtype="bfloat16") runs, on bf16
// tensor-core products with f32 accumulation.
//
// Replaces, for bf16 inputs, rectools_tpu/ops/attention.py:104
// `_attn_fwd_kernel` (`attn_fwd_bf16`, kernel 2) and :256 `_attn_bwd_kernel`
// (`attn_bwd_bf16`, kernel 5), with the rounding points of the route the JAX
// package takes below L = 256 (`_reference_attention` :441-456 and
// `_xla_bwd_math` :529-545), at every L:
// - forward: s = bf16(q k^T * scale + bias) (f32 product, scale and bias in
//   f32, then rounded), lse = logsumexp of s in f32, p = bf16(exp(s - lse)),
//   with dropout p = bf16(p * bf16(1 / (1 - rate))) or 0, out = bf16(p v)
//   (f32 sum); lse (f32) goes to the backward.
// - backward: s and p again, dp = bf16(dout v^T), with dropout p_drop =
//   bf16(p * bf16(keep scale)) and dp = bf16(dp * bf16(keep scale)) or 0,
//   ds = bf16(p (dp - delta)) in f32, dq = bf16((ds k) * scale), dk =
//   bf16((ds^T q) * scale), dv = bf16(p_drop^T dout), each product summed in
//   f32 over the whole row before it is scaled and rounded.
// JAX's Pallas route (L >= 256) keeps p and the scores in f32 and sums dv in
// bf16 a query block at a time; the port keeps the rounding points above at
// every L (ROADMAP §3). The dropout bits are the f32 kernels' counter hash:
// keep (bh, row, col) when mix32_fast((row * L + col) * 0x9E3779B9 + (seed +
// bh * 40503) * 0x01000193) >= threshold, bh the global b * H + h (so a mesh
// data shard's shifted seed gives its rows the whole batch's bits). A fully
// masked row (every bias at MASK_VALUE) gets p = 1 on every key, the sum of v,
// as in that route.
//
// Products: `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
// (bf16_tile.cuh); at a head dim of 8 the two products over the head dim (q
// k^T, and dout v^T in the backward) take one
// `mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32` each (`bt::mma_depth`),
// as exact as the 16-deep step, and the products whose columns run over the
// head dim (p v, ds k, ds^T q, p_drop^T dout) take one 8-column fragment, as
// at every width. Scale and bias are applied with rounded f32 operations
// (`__fmul_rn`, `__fadd_rn`), never fused, so each rounding point sees the
// twin's f32 value up to the order of the product's sums.
//
// Bound on an H100 at the training shape (B = 512, H = 4, L = 100, dh = 32):
// the forward reads q, k, v and writes out, 52 MB, 0.016 ms at 3.35 TB/s
// (BERT4Rec's (B, 1, L, L) f32 bias adds 20 MB); its products over every
// (query, key) pair are 2.6 GFLOP, 0.003 ms at 989 TFLOP/s bf16; the backward
// moves 105 MB (0.031 ms). Both are bound by bytes. At dh = 8 the forward
// moves 14 MB (0.004 ms), the backward 25 MB (0.007 ms). Below the bytes
// lies the forward's work per score, the same at every head dim: a scale, a
// bias, two roundings, two exps (the row's sum and p) and, with dropout, a
// hash, 20.5 M scores at the training shape; the design pays each once.
//
// Forward (`attn_fwd_onepass_bf16_kernel`): one kernel, two modes by L; every
// score formed once (one q k^T product per (query, key) pair), each tile
// staged by 16-byte cp.async, q and k fragments by `ldmatrix`, v's by
// `ldmatrix.trans` from its row-major tile, p taken as the A operand of p v
// straight from registers. `mma.sync`, not `wgmma`: a warp's 16 query rows
// against all keys is the m16 tile, the products are a fifth of the bound,
// and the rows' elementwise work stays in the warp that holds them.
// - Rows (L <= kRegKeys = 128): block (b, group of up to kHeadsPerBlock = 4
//   heads), ceil(L / 16) warps, warp w the query rows 16 w + [0, 16) of
//   each head. The bias rows (L x L f32, pitch bias_pitch(L)) are staged
//   once a block and serve its heads (a bias of head stride 0 is read once
//   per b; a per-head bias makes a block of one head). The heads' q, k and v
//   pass through a ring of two slots: head j + 1 loads while head j
//   computes, and each (b, h)'s q, k and v are read from device memory once.
//   A warp keeps its rows' rounded scores over every key as packed bf16 pairs
//   in 32 registers, takes each row's max from them (bf16x2 max), sums
//   exp(s - max) in column order and then over the row's 4 lanes, and forms p
//   from the finished lse.
// - Tiles (L > 128): block (b h, 64 query rows), 4 warps; key tiles of 64
//   (k, v and the tile's bias rows) through a ring of two. Sweep 1 forms each
//   score once, keeps the rounded row in shared memory (32 KB a warp at
//   kSmemKeys = 1,024 keys) and the rows' running (max, sum of exp) a tile at
//   a time; sweep 2 reads the scores back for p and adds p v. A longer row
//   outgrows shared memory, and sweep 2 forms its scores again from k. The
//   query blocks of one (b, h) each read its k and v.
//
// Backward: block (bh), 128 threads, 4 warps, tiles of 64 rows of one (b, h)
// staged in shared memory at a pitch of `bt::pitch(dh)` bf16 (dh + 8; 24 at
// dh = 8), transposed copies at a pitch of 72; warp w owns keys 16 w + [0,
// 16) of each 64-key tile; for each query tile it forms s^T and dp^T (keys x
// queries), dv and dk into registers from those fragments, ds through shared
// memory ([query][key]) for dq += ds k, whose f32 sums over the key tiles
// wait in a scratch (B, H, L, dh) buffer that only this block touches, each
// thread its own entries (no atomics), until the last key tile scales and
// rounds them. As written it is a latency-bound walk of small tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "tc_tile.cuh"
#include "bf16_tile.cuh"

constexpr int kT = 64;  // rows of the backward's key and query tiles
constexpr int kThreads = 128;
constexpr int kTP = bt::pitch(kT);  // transposed tiles [dh][row]
constexpr float kNegBig = -1e30f;
constexpr unsigned kGolden = 0x9E3779B9u;

__device__ __forceinline__ unsigned mix32_fast(unsigned h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h;
}

struct Dropout {
  int on;              // 0: no dropout (selects the kernels without the hash)
  unsigned threshold;  // keep when the hash is >= threshold
  float keep_scale;    // 1 / (1 - rate), rounded to bf16 where it is used
  int seed;
};

__device__ __forceinline__ unsigned salt_of(const Dropout& dr, int bh) {
  return ((unsigned)dr.seed + (unsigned)bh * 40503u) * 0x01000193u;
}

__device__ __forceinline__ bool keep(const Dropout& dr, unsigned salt, int row, int col, int L) {
  return mix32_fast(((unsigned)row * (unsigned)L + (unsigned)col) * kGolden + salt) >= dr.threshold;
}

// bf16(acc * scale + bias[row][col]) with both f32 operations rounded
__device__ __forceinline__ float score(float acc, float scale, const float* bias, int row, int col, int L) {
  float x = __fmul_rn(acc, scale);
  if (bias != nullptr) x = __fadd_rn(x, bias[(long long)row * L + col]);
  return bt::round_bf16(x);
}

// rows [row0, row0 + 64) of one (b, h) of a strided bf16 tensor into a tile
// of pitch W + 8, zeros past L
template <int W>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* base, long long sl, int row0,
                                          int L) {
  for (int idx = threadIdx.x; idx < kT * (W / 8); idx += kThreads) {
    const int r = idx / (W / 8);
    const int c = 8 * (idx - r * (W / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) v = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * sl + c);
    *reinterpret_cast<uint4*>(dst + r * bt::pitch(W) + c) = v;
  }
}

// the same rows transposed: dst[c][r], pitch 72
template <int W>
__device__ __forceinline__ void load_rows_t(__nv_bfloat16* dst, const __nv_bfloat16* base, long long sl, int row0,
                                            int L) {
  for (int idx = threadIdx.x; idx < kT * (W / 8); idx += kThreads) {
    const int r = idx / (W / 8);
    const int c = 8 * (idx - r * (W / 8));
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) v = *reinterpret_cast<const uint4*>(base + (long long)(row0 + r) * sl + c);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kTP + r] = e[j];
  }
}

// acc (16 rows x 64 columns, eight 8-column fragments) = the warp's A
// fragments over the head dim (bt::frags_a) times rows [0, 64) of `b` (pitch
// bt::pitch(DH)), transposed
template <int DH>
__device__ __forceinline__ void product_64(const uint32_t a[bt::Depth<DH>::kFrags][4], const __nv_bfloat16* b,
                                           float acc[8][4]) {
#pragma unroll
  for (int nf = 0; nf < 8; ++nf) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nf][e] = 0.f;
    bt::mma_depth<DH, bt::pitch(DH)>(acc[nf], a, b, 8 * nf);
  }
}

// ------------------------------------------------------------------ forward

constexpr int kRegKeys = 128;      // rows mode: the longest row whose rounded scores a warp keeps in registers
constexpr int kHeadsPerBlock = 4;  // rows mode: the heads of one b a block walks when they share the bias
constexpr int kFwdTile = 64;       // tiles mode: the query rows of a block and the keys of a staged tile
constexpr int kFwdTileThreads = 128;
constexpr int kSmemKeys = 1024;    // tiles mode: the longest row whose rounded scores stay in shared memory
constexpr int kFwdMaxThreads = 32 * kRegKeys / 16;
constexpr int kMaxDevices = 64;  // devices whose shared-memory attribute a launch remembers
constexpr int kBiasTilePitch = 72;  // floats; a float2 read of 8 rows x 4 lanes falls on distinct banks (72 = 8 mod 32)
constexpr float kLog2e = 1.4426950408889634f;
// the rows mode's ring of q, k, v slots: two (the next head loads under this one's products) where two blocks of L
// = 100 still fit an SM with them, else one (at dh = 64; then the SM's two blocks overlap each other's loads)
__host__ __device__ constexpr int ring_slots(int dh) { return dh == 64 ? 1 : 2; }

enum FwdMode { kRows = 0, kTiles = 1 };

struct FwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;  // may be null
  __nv_bfloat16* out;
  float* lse;  // (B, H, L) contiguous
  int B, H, L;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long bias_sb, bias_sh;  // bias rows are L contiguous floats
  float scale;
  Dropout dr;
  int heads_per_block;  // rows mode: set by the launch
};

// the rows mode's bias pitch in floats: the row rounded up to 16, plus 8 (= 8 or 24 mod 32: a float2 read of 8
// rows x 4 lanes falls on distinct banks in each half warp)
__host__ __device__ constexpr int bias_pitch(int L) { return (L + 15) / 16 * 16 + 8; }

__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }
__device__ __forceinline__ float lo_of(uint32_t s) { return __uint_as_float(s << 16); }
__device__ __forceinline__ float hi_of(uint32_t s) { return __uint_as_float(s & 0xffff0000u); }
// exp(x) as the SFU's ex2 of x log2 e (subnormal results flush to 0); exp(0) = 1 exactly, so the fully masked row
// keeps p = 1. expf, the function of the twin and of the backward, takes the largest error from the twin down by up
// to four times where ex2's roundings set it (heads of 8 and 16), but costs 12-23% of a call at heads of 32 with
// dropout and 14-16% at heads of 64 (tools/attention_bf16_variants.py, variant `expf`); both stay inside the limit
__device__ __forceinline__ float exp_of(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(__fmul_rn(x, kLog2e)));
  return y;
}

__device__ __forceinline__ void ldsm_x2(uint32_t r[2], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_t(uint32_t r[2], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];" : "=r"(r[0]), "=r"(r[1]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const void* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// rows [row0, row0 + n) of one (b, h) of a strided bf16 tensor into a tile of pitch bt::pitch(DH) by 16-byte
// cp.async, zeros past L, by `threads` threads, this one `tid`
template <int DH>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, long long sl, int row0, int n,
                                           int L, int tid, int threads) {
  constexpr int C = DH / 8;
  for (int idx = tid; idx < n * C; idx += threads) {
    const int r = idx / C, c = 8 * (idx - r * C);
    const bool ok = row0 + r < L;
    tc::cp_async16(dst + r * bt::pitch(DH) + c, ok ? src + (long long)(row0 + r) * sl + c : src, ok);
  }
}

// rows [r0, r0 + nr) x columns [c0, c0 + nc) of an (L, L) f32 bias into a tile of pitch P floats by cp.async,
// coalesced (16 bytes a thread where the rows allow it, else 4), by `threads` threads, this one `tid`; rows and
// columns past L stay unwritten (those scores are masked, those rows never stored)
__device__ __forceinline__ void stage_bias(float* dst, int P, const float* src, int L, int r0, int nr, int c0, int nc,
                                           int tid, int threads) {
  const int rows = min(nr, L - r0), cols = min(nc, L - c0);
  if (((L | c0) & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int chunks = cols / 4;
    for (int idx = tid; idx < rows * chunks; idx += threads) {
      const int r = idx / chunks, c = 4 * (idx - r * chunks);
      tc::cp_async16(dst + r * P + c, src + (long long)(r0 + r) * L + c0 + c, true);
    }
  } else {
    for (int idx = tid; idx < rows * cols; idx += threads) {
      const int r = idx / cols, c = idx - r * cols;
      tc::cp_async4(dst + r * P + c, src + (long long)(r0 + r) * L + c0 + c, true);
    }
  }
}

// the warp's q fragments, rows r0 + [0, 16) of a tile of pitch bt::pitch(DH), by ldmatrix
template <int DH>
__device__ __forceinline__ void q_frags(const __nv_bfloat16* tile, int r0, uint32_t a[bt::Depth<DH>::kFrags][4]) {
  const int lane = threadIdx.x & 31;
  const __nv_bfloat16* row = tile + (r0 + (lane & 15)) * bt::pitch(DH);
  if constexpr (DH == 8) {
    ldsm_x2(a[0], row);  // m16n8k8: rows g and g + 8
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) tc::ldsm_x4(a[kk], row + 16 * kk + 8 * (lane >> 4));
  }
}

// acc[f] (the warp's 16 rows x keys k0 + 8 f + [0, 8)) = q k^T over the head dim, keys k0 + [0, 16) of the
// row-major key tile `ks` (pitch bt::pitch(DH)) taken as the B operand by ldmatrix
template <int DH>
__device__ __forceinline__ void score_product(const uint32_t qa[bt::Depth<DH>::kFrags][4], const __nv_bfloat16* ks,
                                              int k0, float acc[2][4]) {
  constexpr int PD = bt::pitch(DH);
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[f][e] = 0.f;
  if constexpr (DH == 8) {
    uint32_t b[2];
    ldsm_x2(b, ks + (k0 + (lane & 15)) * PD);
    bt::mma_k8(acc[0], qa[0], b[0]);
    bt::mma_k8(acc[1], qa[0], b[1]);
  } else {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t b[4];
      tc::ldsm_x4(b, ks + (k0 + 8 * (lane >> 4) + (lane & 7)) * PD + 16 * kk + 8 * ((lane >> 3) & 1));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      bt::mma(acc[0], qa[kk], b0);
      bt::mma(acc[1], qa[kk], b1);
    }
  }
}

// the rounded scores of keys (key, key + 1) of one row: bf16(acc * scale + bias) with both f32 operations
// rounded, the bias from `brow[col]` (a staged row, or none); kNegBig past L (checked only on a tail group)
__device__ __forceinline__ __nv_bfloat162 score_pair(float a0, float a1, float scale, const float* brow, int col,
                                                     int key, int L, bool tail) {
  float x0 = __fmul_rn(a0, scale), x1 = __fmul_rn(a1, scale);
  if (brow != nullptr) {
    const float2 bb = *reinterpret_cast<const float2*>(brow + col);
    x0 = __fadd_rn(x0, bb.x);
    x1 = __fadd_rn(x1, bb.y);
  }
  if (tail) {
    if (key >= L) x0 = kNegBig;
    if (key + 1 >= L) x1 = kNegBig;
  }
  return __floats2bfloat162_rn(x0, x1);
}

// p = bf16(exp(s - lse)) of one register of two rounded scores (keys key, key + 1 of a row whose hash starts at
// `hrow`), with dropout bf16(p * bf16(keep scale)) or 0: one register of the A operand of p v
template <bool kDropout>
__device__ __forceinline__ uint32_t prob_pair(uint32_t s, float lse, const Dropout& dr, unsigned hrow, int key,
                                              __nv_bfloat162 sk2) {
  __nv_bfloat162 pp = __floats2bfloat162_rn(exp_of(__fsub_rn(lo_of(s), lse)), exp_of(__fsub_rn(hi_of(s), lse)));
  if constexpr (kDropout) {
    pp = __hmul2(pp, sk2);  // the product of two bf16 is exact in f32: one rounding, as round_bf16(p * sk)
    const unsigned h0 = hrow + (unsigned)key * kGolden;
    const uint32_t keep = (mix32_fast(h0) >= dr.threshold ? 0x0000ffffu : 0u) |
                          (mix32_fast(h0 + kGolden) >= dr.threshold ? 0xffff0000u : 0u);
    return as_u32(pp) & keep;
  }
  return as_u32(pp);
}

// o (16 rows x the head dim) += a (p of keys k0 + [0, 16)) times rows k0 + [0, 16) of the row-major value tile
// `vs`, its B fragments by ldmatrix.trans
template <int DH>
__device__ __forceinline__ void pv_step(const uint32_t a[4], const __nv_bfloat16* vs, int k0, float o[DH / 8][4]) {
  constexpr int PD = bt::pitch(DH);
  const int lane = threadIdx.x & 31;
  if constexpr (DH == 8) {
    uint32_t b[2];
    ldsm_x2_t(b, vs + (k0 + (lane & 15)) * PD);
    bt::mma(o[0], a, b);
  } else {
#pragma unroll
    for (int np = 0; np < DH / 16; ++np) {
      uint32_t b[4];
      ldsm_x4_t(b, vs + (k0 + 8 * ((lane >> 3) & 1) + (lane & 7)) * PD + 16 * np + 8 * (lane >> 4));
      const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
      bt::mma(o[2 * np], a, b0);
      bt::mma(o[2 * np + 1], a, b1);
    }
  }
}

// the warp's 16 rows of out (bf16) and lse, rows row0 + [0, 16): out through the warp's own rows of a staged tile
// (`rows`, pitch bt::pitch(DH); only this warp reads them), then 16-byte stores of whole rows; lse by lanes 0-15
template <int DH>
__device__ __forceinline__ void store_rows(const FwdParams& p, int b, int h, int row0, __nv_bfloat16* rows,
                                           const float o[DH / 8][4], const float lse[2]) {
  constexpr int PD = bt::pitch(DH), C = DH / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  __syncwarp();  // every lane is done reading the tile's rows
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int nf = 0; nf < C; ++nf)
      *reinterpret_cast<uint32_t*>(rows + (g + 8 * hh) * PD + 8 * nf + 2 * t) = bt::pack(o[nf][2 * hh], o[nf][2 * hh + 1]);
  __syncwarp();
  __nv_bfloat16* ob = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int idx = lane; idx < 16 * C; idx += 32) {
    const int r = idx / C, c = 8 * (idx - r * C);
    if (row0 + r < p.L)
      *reinterpret_cast<uint4*>(ob + (long long)(row0 + r) * p.o_sl + c) = *reinterpret_cast<const uint4*>(rows + r * PD + c);
  }
  const float lo = __shfl_sync(0xffffffffu, lse[0], 4 * (lane & 7));  // row g of lane 4 g
  const float hi = __shfl_sync(0xffffffffu, lse[1], 4 * (lane & 7));  // row g + 8
  if (lane < 16 && row0 + lane < p.L) p.lse[(long long)(b * p.H + h) * p.L + row0 + lane] = lane < 8 ? lo : hi;
}

// Rows mode: block (b, group of heads), warp w the query rows 16 w + [0, 16) of each head; the heads' q, k, v
// through a ring of ring_slots(DH) slots, staged by every thread of the block
template <int DH, bool kDropout>
__device__ __forceinline__ void fwd_rows(const FwdParams& p, unsigned char* smem) {
  constexpr int PD = bt::pitch(DH), S = ring_slots(DH);
  const int L = p.L, rows = blockDim.x / 2;  // 16 rows a warp
  const int G = p.heads_per_block, groups = (p.H + G - 1) / G;
  const int b = blockIdx.x / groups, h0 = (blockIdx.x - b * groups) * G, hn = min(G, p.H - h0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int BP = bias_pitch(L);
  float* bias_s = reinterpret_cast<float*>(smem);
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(smem + (p.bias != nullptr ? L * BP * 4 : 0));
  const int slot_elems = 3 * rows * PD;  // q, k, v of one head
  auto stage_head = [&](int j) {
    const int h = h0 + j;
    __nv_bfloat16* s = slots + (j % S) * slot_elems;
    stage_rows<DH>(s, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, 0, rows, L, threadIdx.x, blockDim.x);
    stage_rows<DH>(s + rows * PD, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, 0, rows, L, threadIdx.x, blockDim.x);
    stage_rows<DH>(s + 2 * rows * PD, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, 0, rows, L, threadIdx.x, blockDim.x);
  };
  // one bias for the block's heads: their head stride is 0, or the block owns one head
  if (p.bias != nullptr)
    stage_bias(bias_s, BP, p.bias + b * p.bias_sb + h0 * p.bias_sh, L, 0, L, 0, L, threadIdx.x, blockDim.x);
  for (int j = 0; j < S && j < hn; ++j) {
    stage_head(j);
    tc::cp_commit();
  }
  const int r0 = 16 * warp, nk = (L + 15) / 16;
  const int rows_of[2] = {r0 + g, r0 + g + 8};
  const float* brow[2] = {nullptr, nullptr};
  if (p.bias != nullptr)  // a row past L reads row L - 1 (its values are never stored)
    for (int hh = 0; hh < 2; ++hh) brow[hh] = bias_s + min(rows_of[hh], L - 1) * BP;
  const __nv_bfloat162 sk2 = __float2bfloat162_rn(p.dr.keep_scale);
  const __nv_bfloat162 neg2 = __float2bfloat162_rn(kNegBig);

  for (int j = 0; j < hn; ++j) {
    if (min(j + S, hn) - 1 > j)  // head j + 1 is in flight too
      tc::cp_wait<1>();
    else
      tc::cp_wait<0>();
    __syncthreads();  // head j's q, k, v (and the bias) are in shared memory
    const int h = h0 + j;
    const __nv_bfloat16* qs = slots + (j % S) * slot_elems;
    const __nv_bfloat16* ks = qs + rows * PD;
    const __nv_bfloat16* vs = ks + rows * PD;
    uint32_t qa[bt::Depth<DH>::kFrags][4];
    q_frags<DH>(qs, r0, qa);

    // every score of the warp's rows, once: rounded, packed, in registers
    uint32_t sc[kRegKeys / 8][2];
    __nv_bfloat162 mx[2][2] = {{neg2, neg2}, {neg2, neg2}};
#pragma unroll
    for (int jg = 0; jg < kRegKeys / 16; ++jg) {
      if (jg < nk) {
        float acc[2][4];
        score_product<DH>(qa, ks, 16 * jg, acc);
        const bool tail = 16 * jg + 16 > L;
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int col = 16 * jg + 8 * f + 2 * t;
            const __nv_bfloat162 s2 =
                score_pair(acc[f][2 * hh], acc[f][2 * hh + 1], p.scale, brow[hh], col, col, L, tail);
            mx[hh][jg & 1] = __hmax2(mx[hh][jg & 1], s2);
            sc[2 * jg + f][hh] = as_u32(s2);
          }
      }
    }
    // lse: the row's max, then its sum of exp(s - max) in four column-strided partial sums and over its 4 lanes
    float lse[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const __nv_bfloat162 m2 = __hmax2(mx[hh][0], mx[hh][1]);
      float m = fmaxf(__low2float(m2), __high2float(m2));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
      float l4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int nf = 0; nf < kRegKeys / 8; ++nf)
        if (nf < 2 * nk)
          l4[nf & 3] += exp_of(__fsub_rn(lo_of(sc[nf][hh]), m)) + exp_of(__fsub_rn(hi_of(sc[nf][hh]), m));
      float l = (l4[0] + l4[1]) + (l4[2] + l4[3]);
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      lse[hh] = m + logf(l);
    }
    // p from the finished lse, straight into the A operand of p v
    const unsigned salt = salt_of(p.dr, b * p.H + h);
    const unsigned hrow[2] = {(unsigned)rows_of[0] * (unsigned)L * kGolden + salt,
                              (unsigned)rows_of[1] * (unsigned)L * kGolden + salt};
    float o[DH / 8][4];
#pragma unroll
    for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kRegKeys / 16; ++kk) {
      if (kk < nk) {
        uint32_t a[4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            a[2 * f + hh] = prob_pair<kDropout>(sc[2 * kk + f][hh], lse[hh], p.dr, hrow[hh], 16 * kk + 8 * f + 2 * t, sk2);
        pv_step<DH>(a, vs, 16 * kk, o);
      }
    }
    store_rows<DH>(p, b, h, r0, const_cast<__nv_bfloat16*>(qs) + r0 * PD, o, lse);
    if (j + S < hn) {
      __syncthreads();  // every warp is done with this slot
      stage_head(j + S);
      tc::cp_commit();
    }
  }
}

// Tiles mode: block (b h, 64 query rows), warp w the rows 16 w + [0, 16); key tiles of 64 in a ring of two
template <int DH, bool kDropout>
__device__ __forceinline__ void fwd_tiles(const FwdParams& p, unsigned char* smem) {
  constexpr int PD = bt::pitch(DH), T = kFwdTile, BPT = kBiasTilePitch;
  const int L = p.L, bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H, q0 = blockIdx.y * T;
  const int nt = (L + T - 1) / T;
  const bool stored = nt * T <= kSmemKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bool has_bias = p.bias != nullptr;
  // shared memory: q tile, two slots of (k tile, v tile, bias tile), then each warp's scores
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int slot_bytes = 2 * T * PD * 2 + (has_bias ? T * BPT * 4 : 0);
  unsigned char* slot0 = smem + T * PD * 2;
  uint32_t* scores = reinterpret_cast<uint32_t*>(slot0 + 2 * slot_bytes) + warp * (nt * 4) * 128;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* biasb = has_bias ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  auto k_tile = [&](int s) { return reinterpret_cast<__nv_bfloat16*>(slot0 + s * slot_bytes); };
  auto v_tile = [&](int s) { return k_tile(s) + T * PD; };
  auto b_tile = [&](int s) { return reinterpret_cast<float*>(slot0 + s * slot_bytes + 2 * T * PD * 2); };
  auto stage = [&](int kt, bool keys, bool values) {
    const int s = kt & 1;
    if (keys) {
      stage_rows<DH>(k_tile(s), kb, p.k_sl, kt * T, T, L, threadIdx.x, blockDim.x);
      if (has_bias) stage_bias(b_tile(s), BPT, biasb, L, q0, T, kt * T, T, threadIdx.x, blockDim.x);
    }
    if (values) stage_rows<DH>(v_tile(s), vb, p.v_sl, kt * T, T, L, threadIdx.x, blockDim.x);
  };
  const int rows_of[2] = {q0 + 16 * warp + g, q0 + 16 * warp + g + 8};
  const int brow_local[2] = {(16 * warp + g) * BPT, (16 * warp + g + 8) * BPT};
  const __nv_bfloat162 sk2 = __float2bfloat162_rn(p.dr.keep_scale);
  uint32_t qa[bt::Depth<DH>::kFrags][4];
  // the scores of keys kt * 64 + 16 jg + [0, 16) of the warp's rows, from slot kt & 1
  auto scores_of = [&](int kt, int jg, uint32_t sc[2][2]) {
    float acc[2][4];
    score_product<DH>(qa, k_tile(kt & 1), 16 * jg, acc);
    const bool tail = kt * T + 16 * jg + 16 > L;
    const float* bt_ = b_tile(kt & 1);
#pragma unroll
    for (int f = 0; f < 2; ++f)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int col = 16 * jg + 8 * f + 2 * t;
        sc[f][hh] = as_u32(score_pair(acc[f][2 * hh], acc[f][2 * hh + 1], p.scale,
                                      has_bias ? bt_ + brow_local[hh] : nullptr, col, kt * T + col, L, tail));
      }
  };

  // sweep 1: every score once (kept in shared memory while the row fits), the rows' running (max, sum of exp)
  stage_rows<DH>(qs, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, T, L, threadIdx.x, blockDim.x);
  stage(0, true, false);
  tc::cp_commit();
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) {
      stage(kt + 1, true, false);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
    if (kt == 0) q_frags<DH>(qs, 16 * warp, qa);
    uint32_t sc[4][2][2];
#pragma unroll
    for (int jg = 0; jg < 4; ++jg) {
      if (kt * T + 16 * jg < L) {
        scores_of(kt, jg, sc[jg]);
        if (stored)
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) scores[(kt * 4 + jg) * 128 + (2 * f + hh) * 32 + lane] = sc[jg][f][hh];
      }
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = m[hh];
#pragma unroll
      for (int jg = 0; jg < 4; ++jg)
        if (kt * T + 16 * jg < L)
#pragma unroll
          for (int f = 0; f < 2; ++f) mx = fmaxf(mx, fmaxf(lo_of(sc[jg][f][hh]), hi_of(sc[jg][f][hh])));
      float sum = l[hh] * exp_of(__fsub_rn(m[hh], mx));
#pragma unroll
      for (int jg = 0; jg < 4; ++jg)
        if (kt * T + 16 * jg < L)
#pragma unroll
          for (int f = 0; f < 2; ++f)
            sum += exp_of(__fsub_rn(lo_of(sc[jg][f][hh]), mx)) + exp_of(__fsub_rn(hi_of(sc[jg][f][hh]), mx));
      m[hh] = mx;
      l[hh] = sum;
    }
    __syncthreads();  // every warp is done with this slot
  }
  float lse[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[hh], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[hh], off);
      const float m_new = fmaxf(m[hh], m_o);
      l[hh] = l[hh] * exp_of(__fsub_rn(m[hh], m_new)) + l_o * exp_of(__fsub_rn(m_o, m_new));
      m[hh] = m_new;
    }
    lse[hh] = m[hh] + logf(l[hh]);
  }

  // sweep 2: p from the finished lse (scores read back, or past kSmemKeys formed again), out += p v
  const unsigned salt = salt_of(p.dr, bh);
  const unsigned hrow[2] = {(unsigned)rows_of[0] * (unsigned)L * kGolden + salt,
                            (unsigned)rows_of[1] * (unsigned)L * kGolden + salt};
  float o[DH / 8][4];
#pragma unroll
  for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
  stage(0, !stored, true);
  tc::cp_commit();
  for (int kt = 0; kt < nt; ++kt) {
    if (kt + 1 < nt) {
      stage(kt + 1, !stored, true);
      tc::cp_commit();
      tc::cp_wait<1>();
    } else {
      tc::cp_wait<0>();
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kt * T + 16 * kk < L) {
        uint32_t sc[2][2];
        if (stored) {
#pragma unroll
          for (int f = 0; f < 2; ++f)
#pragma unroll
            for (int hh = 0; hh < 2; ++hh) sc[f][hh] = scores[(kt * 4 + kk) * 128 + (2 * f + hh) * 32 + lane];
        } else {
          scores_of(kt, kk, sc);
        }
        uint32_t a[4];
#pragma unroll
        for (int f = 0; f < 2; ++f)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            a[2 * f + hh] =
                prob_pair<kDropout>(sc[f][hh], lse[hh], p.dr, hrow[hh], kt * T + 16 * kk + 8 * f + 2 * t, sk2);
        pv_step<DH>(a, v_tile(kt & 1), 16 * kk, o);
      }
    }
    __syncthreads();  // every warp is done with this slot
  }
  store_rows<DH>(p, b, h, q0 + 16 * warp, qs + 16 * warp * PD, o, lse);
}

// One kernel, two modes: rows (L <= kRegKeys) and tiles (longer rows)
template <int DH, bool kDropout, int kMode>
__global__ void __launch_bounds__(kFwdMaxThreads, kMode == kRows ? 2 : 1)
    attn_fwd_onepass_bf16_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  if constexpr (kMode == kRows)
    fwd_rows<DH, kDropout>(p, smem_raw);
  else
    fwd_tiles<DH, kDropout>(p, smem_raw);
}

// shared memory of a forward block
template <int DH>
int fwd_smem_bytes(int mode, int L, bool bias, int heads_per_block) {
  constexpr int PD = bt::pitch(DH);
  if (mode == kRows) {
    const int rows = (L + 15) / 16 * 16;
    const int slots = heads_per_block < ring_slots(DH) ? heads_per_block : ring_slots(DH);
    return (bias ? L * bias_pitch(L) * 4 : 0) + slots * 3 * rows * PD * 2;
  }
  const int nt = (L + kFwdTile - 1) / kFwdTile;
  const int slot = 2 * kFwdTile * PD * 2 + (bias ? kFwdTile * kBiasTilePitch * 4 : 0);
  const int scores = nt * kFwdTile <= kSmemKeys ? (kFwdTileThreads / 32) * nt * 4 * 128 * 4 : 0;
  return kFwdTile * PD * 2 + 2 * slot + scores;
}

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* bias;   // may be null
  const float* lse;    // (B, H, L) contiguous
  const float* delta;  // (B, H, L) contiguous: sum(dout * out, -1) in f32
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* dq_acc;  // (B, H, L, dh) contiguous f32 scratch; null when L <= 64
  int B, H, L;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long do_sb, do_sh, do_sl;
  long long dq_sb, dq_sh, dq_sl;
  long long dk_sb, dk_sh, dk_sl;
  long long dv_sb, dv_sh, dv_sl;
  long long bias_sb, bias_sh;
  float scale;
  Dropout dr;
};

template <int DH>
struct BwdSmem {
  __nv_bfloat16 k[kT * bt::pitch(DH)];
  __nv_bfloat16 v[kT * bt::pitch(DH)];
  __nv_bfloat16 q[kT * bt::pitch(DH)];
  __nv_bfloat16 dout[kT * bt::pitch(DH)];
  __nv_bfloat16 kt[DH * kTP];
  __nv_bfloat16 qt[DH * kTP];
  __nv_bfloat16 doutt[DH * kTP];
  __nv_bfloat16 ds[kT * kTP];  // [query][key]
  float lse[kT];
  float delta[kT];
};

template <int DH, bool kDropout>
__global__ void __launch_bounds__(kThreads) attn_bwd_bf16_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DH>& sm = *reinterpret_cast<BwdSmem<DH>*>(smem_raw);
  constexpr int PD = bt::pitch(DH);
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int L = p.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const __nv_bfloat16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const float* bias = p.bias != nullptr ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const float* lse = p.lse + (long long)bh * L;
  const float* delta = p.delta + (long long)bh * L;
  float* dq_acc = p.dq_acc != nullptr ? p.dq_acc + (long long)bh * L * DH : nullptr;
  const unsigned salt = salt_of(p.dr, bh);
  const float sk = bt::round_bf16(p.dr.keep_scale);
  const int n_tiles = (L + kT - 1) / kT;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int key0 = kt * kT;
    __syncthreads();  // the previous key tile's last pair is done with every tile
    load_rows<DH>(sm.k, kb, p.k_sl, key0, L);
    load_rows<DH>(sm.v, vb, p.v_sl, key0, L);
    load_rows_t<DH>(sm.kt, kb, p.k_sl, key0, L);
    uint32_t ak[bt::Depth<DH>::kFrags][4], av[bt::Depth<DH>::kFrags][4];
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nf][e] = dv[nf][e] = 0.f;
    int keys[2];
    keys[0] = key0 + 16 * warp + g;
    keys[1] = keys[0] + 8;

    for (int qt = 0; qt < n_tiles; ++qt) {
      const int q0 = qt * kT;
      __syncthreads();  // the previous pair is done with the query tiles and ds
      load_rows<DH>(sm.q, qb, p.q_sl, q0, L);
      load_rows_t<DH>(sm.qt, qb, p.q_sl, q0, L);
      load_rows<DH>(sm.dout, dob, p.do_sl, q0, L);
      load_rows_t<DH>(sm.doutt, dob, p.do_sl, q0, L);
      if (threadIdx.x < kT) {
        const int row = q0 + threadIdx.x;
        sm.lse[threadIdx.x] = row < L ? lse[row] : INFINITY;
        sm.delta[threadIdx.x] = row < L ? delta[row] : 0.f;
      }
      __syncthreads();
      if (qt == 0) {
        bt::frags_a<DH, PD>(sm.k, 16 * warp, ak);
        bt::frags_a<DH, PD>(sm.v, 16 * warp, av);
      }
      // s^T and dp^T: the warp's 16 keys x the tile's 64 queries
      float st[8][4], dpt[8][4];
      product_64<DH>(ak, sm.q, st);
      product_64<DH>(av, sm.dout, dpt);
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = keys[e >> 1];
          const int ql = 8 * nf + 2 * t + (e & 1);
          const int query = q0 + ql;
          float pd = 0.f, ds = 0.f;
          if (key < L && query < L) {
            const float pr = bt::round_bf16(expf(score(st[nf][e], p.scale, bias, query, key, L) - sm.lse[ql]));
            float dp = bt::round_bf16(dpt[nf][e]);
            pd = pr;
            if (kDropout) {
              const bool kept = keep(p.dr, salt, query, key, L);
              pd = kept ? bt::round_bf16(pr * sk) : 0.f;
              dp = kept ? bt::round_bf16(dp * sk) : 0.f;
            }
            ds = bt::round_bf16(__fmul_rn(pr, __fsub_rn(dp, sm.delta[ql])));
          }
          st[nf][e] = pd;
          dpt[nf][e] = ds;
          sm.ds[ql * kTP + 16 * warp + g + 8 * (e >> 1)] = __float2bfloat16_rn(ds);
        }
      // dv += p_drop^T dout and dk += ds^T q (the keys' rows, depth over the queries)
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t ap[4], as[4];
        bt::frag_a_from_c(st[2 * kk], st[2 * kk + 1], ap);
        bt::frag_a_from_c(dpt[2 * kk], dpt[2 * kk + 1], as);
#pragma unroll
        for (int nf = 0; nf < DH / 8; ++nf) {
          uint32_t bd[2], bq[2];
          bt::frag_b<kTP>(sm.doutt, 8 * nf, 16 * kk, bd);
          bt::frag_b<kTP>(sm.qt, 8 * nf, 16 * kk, bq);
          bt::mma(dv[nf], ap, bd);
          bt::mma(dk[nf], as, bq);
        }
      }
      __syncthreads();  // ds is complete
      // dq (queries 16 w + [0, 16) of the tile) += ds k, summed in f32 over the key tiles
      float dq[DH / 8][4];
      int qrows[2];
      qrows[0] = q0 + 16 * warp + g;
      qrows[1] = qrows[0] + 8;
#pragma unroll
      for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          float2 v = make_float2(0.f, 0.f);
          if (kt > 0 && qrows[hh] < L)
            v = *reinterpret_cast<const float2*>(dq_acc + (long long)qrows[hh] * DH + 8 * nf + 2 * t);
          dq[nf][2 * hh] = v.x;
          dq[nf][2 * hh + 1] = v.y;
        }
#pragma unroll
      for (int kk = 0; kk < kT / 16; ++kk) {
        uint32_t a[4];
        bt::frag_a<kTP>(sm.ds, 16 * warp, 16 * kk, a);
#pragma unroll
        for (int nf = 0; nf < DH / 8; ++nf) {
          uint32_t bb[2];
          bt::frag_b<kTP>(sm.kt, 8 * nf, 16 * kk, bb);
          bt::mma(dq[nf], a, bb);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        if (qrows[hh] >= L) continue;
#pragma unroll
        for (int nf = 0; nf < DH / 8; ++nf) {
          const int col = 8 * nf + 2 * t;
          if (kt == n_tiles - 1)
            *reinterpret_cast<uint32_t*>(p.dq + b * p.dq_sb + h * p.dq_sh + qrows[hh] * p.dq_sl + col) =
                bt::pack(__fmul_rn(dq[nf][2 * hh], p.scale), __fmul_rn(dq[nf][2 * hh + 1], p.scale));
          else
            *reinterpret_cast<float2*>(dq_acc + (long long)qrows[hh] * DH + col) =
                make_float2(dq[nf][2 * hh], dq[nf][2 * hh + 1]);
        }
      }
    }
    // dk and dv of the warp's keys
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = keys[hh];
      if (key >= L) continue;
#pragma unroll
      for (int nf = 0; nf < DH / 8; ++nf) {
        const int col = 8 * nf + 2 * t;
        *reinterpret_cast<uint32_t*>(p.dk + b * p.dk_sb + h * p.dk_sh + key * p.dk_sl + col) =
            bt::pack(__fmul_rn(dk[nf][2 * hh], p.scale), __fmul_rn(dk[nf][2 * hh + 1], p.scale));
        *reinterpret_cast<uint32_t*>(p.dv + b * p.dv_sb + h * p.dv_sh + key * p.dv_sl + col) =
            bt::pack(dv[nf][2 * hh], dv[nf][2 * hh + 1]);
      }
    }
  }
}

// the launch of a forward: mode, heads a block walks, grid, threads and shared memory of a block
struct FwdPlan {
  int mode, heads_per_block;
  dim3 grid;
  int threads, smem;
};

template <int DH>
FwdPlan plan_fwd(const FwdParams& p) {
  const bool bias = p.bias != nullptr;
  if (p.L <= kRegKeys) {
    // heads that share the bias (or have none) go kHeadsPerBlock to a block; a per-head bias, one
    const int heads = !bias || p.bias_sh == 0 ? (p.H < kHeadsPerBlock ? p.H : kHeadsPerBlock) : 1;
    return FwdPlan{kRows, heads, dim3((unsigned)(p.B * ((p.H + heads - 1) / heads))), 32 * ((p.L + 15) / 16),
                   fwd_smem_bytes<DH>(kRows, p.L, bias, heads)};
  }
  return FwdPlan{kTiles, 1, dim3((unsigned)(p.B * p.H), (unsigned)((p.L + kFwdTile - 1) / kFwdTile)),
                 kFwdTileThreads, fwd_smem_bytes<DH>(kTiles, p.L, bias, 1)};
}

// lets a form take `smem` bytes of dynamic shared memory on the current device, with the SM's whole shared
// memory carved out for it (two blocks of the rows mode need more than half); remembered per device
template <int DH, bool kDropout, int kMode>
cudaError_t allow_smem(int smem) {
  static int allowed[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess || (device < kMaxDevices && smem <= allowed[device])) return err;
  err = cudaFuncSetAttribute(attn_fwd_onepass_bf16_kernel<DH, kDropout, kMode>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(attn_fwd_onepass_bf16_kernel<DH, kDropout, kMode>,
                               cudaFuncAttributePreferredSharedMemoryCarveout, cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && device < kMaxDevices) allowed[device] = smem;
  return err;
}

template <int DH, bool kDropout, int kMode>
int launch_plan(const FwdParams& p, const FwdPlan& plan, cudaStream_t stream) {
  const cudaError_t err = allow_smem<DH, kDropout, kMode>(plan.smem);
  if (err != cudaSuccess) return (int)err;
  attn_fwd_onepass_bf16_kernel<DH, kDropout, kMode><<<plan.grid, plan.threads, plan.smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH, bool kDropout>
int launch_fwd(FwdParams p, cudaStream_t stream) {
  const FwdPlan plan = plan_fwd<DH>(p);
  p.heads_per_block = plan.heads_per_block;
  return plan.mode == kRows ? launch_plan<DH, kDropout, kRows>(p, plan, stream)
                            : launch_plan<DH, kDropout, kTiles>(p, plan, stream);
}

template <int DH>
int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  return p.dr.on ? launch_fwd<DH, true>(p, stream) : launch_fwd<DH, false>(p, stream);
}

template <int DH, bool kDropout>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  const int smem = (int)sizeof(BwdSmem<DH>);
  cudaError_t err =
      cudaFuncSetAttribute(attn_bwd_bf16_kernel<DH, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_bf16_kernel<DH, kDropout><<<(unsigned)(p.B * p.H), kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int DH>
int launch_bwd(const BwdParams& p, cudaStream_t stream) {
  return p.dr.on ? launch_bwd<DH, true>(p, stream) : launch_bwd<DH, false>(p, stream);
}

Dropout make_dropout(int seed, int dropout, unsigned threshold, float keep_scale) {
  return Dropout{dropout, threshold, keep_scale, seed};
}

}  // namespace

// Strides are in elements; the head-dim stride of q, k, v and out is 1 and
// every row start is 16-byte aligned (checked by the Python wrapper). q, k,
// v and out are bf16, bias (may be null) and lse f32. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int attn_fwd_bf16(const void* q, const void* k, const void* v, const float* bias, void* out, float* lse,
                             int B, int H, int L, int dh, long long q_sb, long long q_sh, long long q_sl,
                             long long k_sb, long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                             long long v_sl, long long o_sb, long long o_sh, long long o_sl, long long bias_sb,
                             long long bias_sh, float scale, int seed, int dropout, unsigned threshold,
                             float keep_scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return 0;
  const FwdParams p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v), bias, static_cast<__nv_bfloat16*>(out), lse, B, H, L,
                    q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, bias_sb, bias_sh, scale,
                    make_dropout(seed, dropout, threshold, keep_scale)};
  switch (dh) {
    case 8: return launch_fwd<8>(p, stream);
    case 16: return launch_fwd<16>(p, stream);
    case 32: return launch_fwd<32>(p, stream);
    case 64: return launch_fwd<64>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Backward: bf16 dq, dk, dv (strided like q) from bf16 q, k, v, dout, the
// forward's f32 lse, f32 delta = sum(dout * out, -1) and an f32 (B, H, L, dh)
// scratch for dq's sums over key tiles (null when L <= 64), with the
// forward's bias and dropout arguments. Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int attn_bwd_bf16(const void* q, const void* k, const void* v, const float* bias, const float* lse,
                             const float* delta, const void* dout, void* dq, void* dk, void* dv, float* dq_acc,
                             int B, int H, int L, int dh, long long q_sb, long long q_sh, long long q_sl,
                             long long k_sb, long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                             long long v_sl, long long do_sb, long long do_sh, long long do_sl, long long dq_sb,
                             long long dq_sh, long long dq_sl, long long dk_sb, long long dk_sh, long long dk_sl,
                             long long dv_sb, long long dv_sh, long long dv_sl, long long bias_sb,
                             long long bias_sh, float scale, int seed, int dropout, unsigned threshold,
                             float keep_scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return 0;
  if (L > kT && dq_acc == nullptr) return (int)cudaErrorInvalidValue;
  const BwdParams p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                    static_cast<const __nv_bfloat16*>(v), bias, lse, delta,
                    static_cast<const __nv_bfloat16*>(dout), static_cast<__nv_bfloat16*>(dq),
                    static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), dq_acc, B, H, L,
                    q_sb, q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, do_sb, do_sh, do_sl, dq_sb, dq_sh, dq_sl,
                    dk_sb, dk_sh, dk_sl, dv_sb, dv_sh, dv_sl, bias_sb, bias_sh, scale,
                    make_dropout(seed, dropout, threshold, keep_scale)};
  switch (dh) {
    case 8: return launch_bwd<8>(p, stream);
    case 16: return launch_bwd<16>(p, stream);
    case 32: return launch_bwd<32>(p, stream);
    case 64: return launch_bwd<64>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
