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
// bh * 40503) * 0x01000193) >= threshold. A fully masked row (every bias at
// MASK_VALUE) gets p = 1 on every key, the sum of v, as in that route.
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
// Tiles (head dims 8, 16, 32 and 64): 128 threads, 4 warps, tiles of 64 rows
// of one (b, h) staged in shared memory at a pitch of `bt::pitch(dh)` bf16
// (dh + 8; 24 at dh = 8), transposed copies at a pitch of 72.
// - Forward: block (bh, 64-query tile), warp w owns queries 16 w + [0, 16),
//   its q fragments in registers. Pass 1 walks the 64-key tiles for the rows'
//   running (max, sum of exp) of the rounded scores; pass 2 walks them again,
//   forms p from the finished lse (the rounding of p needs it) and adds p v,
//   with p taken from the scores' accumulator fragments as the A operand.
// - Backward: block (bh), warp w owns keys 16 w + [0, 16) of each 64-key
//   tile; for each query tile it forms s^T and dp^T (keys x queries), dv and
//   dk into registers from those fragments, ds through shared memory
//   ([query][key]) for dq += ds k, whose f32 sums over the key tiles wait in
//   a scratch (B, H, L, dh) buffer that only this block touches, each thread
//   its own entries (no atomics), until the last key tile scales and rounds
//   them.
//
// Bound on an H100 at the training shape (B = 512, H = 4, L = 100, dh = 32):
// the forward reads q, k, v and writes out, 52 MB, 0.016 ms at 3.35 TB/s;
// its products over every (query, key) pair are 2.6 GFLOP, 0.003 ms at 989
// TFLOP/s bf16; the backward moves 105 MB (0.031 ms). Both are bound by
// bytes; as written they are latency-bound small blocks (two passes of the
// score product in the forward). At dh = 8 (the same B, H, L) the forward
// moves 14 MB (0.004 ms) and the backward 25 MB (0.007 ms), bound by bytes
// too; the blocks do a quarter of the products for the same walk over the
// tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "tc_tile.cuh"
#include "bf16_tile.cuh"

constexpr int kT = 64;  // rows of every tile: queries of a forward block, keys and queries of the backward's tiles
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
};

template <int DH, bool kDropout>
__global__ void __launch_bounds__(kThreads) attn_fwd_bf16_kernel(const FwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int PD = bt::pitch(DH);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][DH + 8]
  __nv_bfloat16* ks = qs + kT * PD;                                 // [64][DH + 8]
  __nv_bfloat16* vt = ks + kT * PD;                                 // [DH][72]
  const int bh = blockIdx.x, b = bh / p.H, h = bh - b * p.H;
  const int q0 = blockIdx.y * kT, L = p.L;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* bias = p.bias != nullptr ? p.bias + b * p.bias_sb + h * p.bias_sh : nullptr;
  const unsigned salt = salt_of(p.dr, bh);
  const float sk = bt::round_bf16(p.dr.keep_scale);
  const int n_tiles = (L + kT - 1) / kT;
  int rows[2];
  rows[0] = q0 + 16 * warp + g;
  rows[1] = rows[0] + 8;
  // a row past L reads the bias of row 0 (its values are never written)
  const int brow[2] = {rows[0] < L ? rows[0] : 0, rows[1] < L ? rows[1] : 0};

  load_rows<DH>(qs, qb, p.q_sl, q0, L);
  __syncthreads();
  uint32_t qa[bt::Depth<DH>::kFrags][4];
  bt::frags_a<DH, PD>(qs, 16 * warp, qa);

  // pass 1: the rows' running (max, sum of exp) of the rounded scores
  float m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_rows<DH>(ks, kb, p.k_sl, kt * kT, L);
    __syncthreads();
    float acc[8][4];
    product_64<DH>(qa, ks, acc);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float x[8][2];
      float mx = m[hh];
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int key = kt * kT + 8 * nf + 2 * t + j;
          x[nf][j] = key < L ? score(acc[nf][2 * hh + j], p.scale, bias, brow[hh], key, L) : kNegBig;
          mx = fmaxf(mx, x[nf][j]);
        }
      float sum = l[hh] * expf(m[hh] - mx);
#pragma unroll
      for (int nf = 0; nf < 8; ++nf)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          if (kt * kT + 8 * nf + 2 * t + j < L) sum += expf(x[nf][j] - mx);
      m[hh] = mx;
      l[hh] = sum;
    }
  }
  float lse[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[hh], off);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[hh], off);
      const float m_new = fmaxf(m[hh], m_o);
      l[hh] = l[hh] * expf(m[hh] - m_new) + l_o * expf(m_o - m_new);
      m[hh] = m_new;
    }
    lse[hh] = m[hh] + logf(l[hh]);
  }

  // pass 2: p = bf16(exp(s - lse)), dropout, out += p v
  float o[DH / 8][4];
#pragma unroll
  for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[nf][e] = 0.f;
  for (int kt = 0; kt < n_tiles; ++kt) {
    __syncthreads();
    load_rows<DH>(ks, kb, p.k_sl, kt * kT, L);
    load_rows_t<DH>(vt, vb, p.v_sl, kt * kT, L);
    __syncthreads();
    float acc[8][4];
    product_64<DH>(qa, ks, acc);
#pragma unroll
    for (int nf = 0; nf < 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1;
        const int key = kt * kT + 8 * nf + 2 * t + (e & 1);
        float pr = 0.f;
        if (key < L) {
          pr = bt::round_bf16(expf(score(acc[nf][e], p.scale, bias, brow[hh], key, L) - lse[hh]));
          if (kDropout) pr = keep(p.dr, salt, rows[hh], key, L) ? bt::round_bf16(pr * sk) : 0.f;
        }
        acc[nf][e] = pr;
      }
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {
      uint32_t a[4];
      bt::frag_a_from_c(acc[2 * kk], acc[2 * kk + 1], a);
#pragma unroll
      for (int nf = 0; nf < DH / 8; ++nf) {
        uint32_t bb[2];
        bt::frag_b<kTP>(vt, 8 * nf, 16 * kk, bb);
        bt::mma(o[nf], a, bb);
      }
    }
  }
  __nv_bfloat16* ob = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = rows[hh];
    if (row >= L) continue;
#pragma unroll
    for (int nf = 0; nf < DH / 8; ++nf)
      *reinterpret_cast<uint32_t*>(ob + row * p.o_sl + 8 * nf + 2 * t) = bt::pack(o[nf][2 * hh], o[nf][2 * hh + 1]);
    if (t == 0) p.lse[(long long)bh * L + row] = lse[hh];
  }
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

template <int DH, bool kDropout>
int launch_fwd(const FwdParams& p, cudaStream_t stream) {
  const int smem = (2 * kT * bt::pitch(DH) + DH * kTP) * (int)sizeof(__nv_bfloat16);
  cudaError_t err =
      cudaFuncSetAttribute(attn_fwd_bf16_kernel<DH, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.L + kT - 1) / kT));
  attn_fwd_bf16_kernel<DH, kDropout><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
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
