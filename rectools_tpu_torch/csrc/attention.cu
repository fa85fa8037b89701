// Attention in float32: the forward out = dropout(softmax(q k^T * scale +
// bias)) v with the pre-dropout row logsumexp, and the backward that gives
// dq, dk and dv from it.
//
// Replaces: rectools_tpu/ops/attention.py:104 `_attn_fwd_kernel`
// (`attn_fwd_f32`) and rectools_tpu/ops/attention.py:256 `_attn_bwd_kernel`
// (`attn_bwd_f32`), both with the counter-hash dropout of `dropout_keep_mask`
// (attention.py:78-101): the keep bit of (batch*head bh, query row, key col) is
// mix32_fast((row * L + col) * 0x9E3779B9 + (seed + bh * 40503) * 0x01000193)
// >= round(rate * 2^32), in uint32, so forward, backward and the plain twins
// draw one mask, bit for bit the JAX one for the same int32 seed.
//
// Bound on an H100. The forward's two products are 4 * L*L*dh operations
// per (b, h), the backward's five (s, dp, dv, dk, dq) 10 * L*L*dh. At the
// SASRec training shape (B = 512, H = 4, L = 100, dh = 32) the forward is
// 2.6 GFLOP, the backward 6.6: in 3xTF32 (three TF32 products per f32
// product at 495 TFLOP/s) 0.016 and 0.040 ms, under their bytes (q, k, v,
// out, lse in or out: 0.032 ms; the backward's seven (B, L, H, dh) tensors
// 0.055 ms); in FP32 FMA (67 TFLOP/s) 0.039 and 0.098 ms. So both are bound
// by their bytes on the tensor cores and by their operations off them.
//
// Head dims 32 and 64 (`attn_tensor_cores`) run every product on the tensor
// cores in 3xTF32 (tc_tile.cuh: `mma.sync` m16n8k8, each f32 operand split
// into TF32 halves, lo * lo dropped, a fresh fragment per 16 k): about f32
// accuracy at these depths (the JAX reference is exact f32; plain TF32 would
// keep three digits). Head dims 8 and 16 keep the SIMT kernels in f32 FMA.
//
// The normalisation: both forwards scale a row's sum of exp(s - max) v by
// exp(max - lse), with lse = max + log(sum of exp(s - max)) in f32, which is
// the twin's p = exp(s - lse) and, but for lse's rounding, 1 / sum. On a row
// whose keys are all masked lse rounds to the max (about -1e9) and each p is
// 1, as in the JAX package's XLA path (the one it takes below L = 256) and in
// both packages' backward; the JAX Pallas forward divides by the sum there.
//
// Tensor-core forward (`attn_fwd_tc_kernel`): one block of 4 warps per
// (batch*head, 64 queries), the only writer of those out rows and lse
// entries; the query tile is fastest in the block index, so the blocks of a
// row read its k and v one after another. The q tile is staged once, then
// the key tiles of 64 pass through a cp.async ring of two (rows at a pitch
// of dh + 4). Warp w takes queries 16 w + [0, 16) and, per 32-key unit, forms
// s (16 x 32, `product_rows`), adds scale and bias, keeps its rows' online
// softmax in registers (a row's columns lie across the 4 lanes of a quad:
// the row max is two shuffles), corrects its share of the running sum and
// its output fragments, adds p to the sum before dropout, applies the keep
// bit of each fragment entry's (row, col), and adds p_drop v with p_drop as
// the A operand straight from the accumulator (`accumulate_rows`). The
// epilogue sums each row over its quad and stores through `store_frags`.
//
// Tensor-core backward (`attn_bwd_tc_kernel`): the TPU kernel accumulates dk
// and dv in output blocks that consecutive q-block programs revisit
// (attention.py:275-281); GPU blocks run in no order, so one block of 8 warps
// owns a whole (b, h) row and writes its dq, dk and dv: no atomics, no second
// launch, five products. Per key tile of 128 (one at L = 100), k and v are
// staged by cp.async and warp w owns keys 16 w + [0, 16) with their dk and
// dv fragments in registers; the query tiles of 32 pass through a ring of two
// (q, dout, lse, delta). Per query tile each warp forms s^T and dp^T (16 keys
// x 32 queries), turns them in the accumulator fragments into p_drop^T and
// ds^T = (p (dp keep - delta))^T, adds p_drop^T dout into dv and ds^T q into
// dk with those fragments as A, and parks ds^T in a shared [query][key] tile
// (pitch 136: the dq step's float2 fragment reads hit 32 banks). After a
// barrier the block forms the tile's dq = ds k over the key tile, warp w
// the rows of block w % 2 and the 8-column blocks w / 2 + 4 j, and writes it
// (first key tile) or adds it (later ones), each entry by one thread.
//
// Skipped work, both kernels: the bias is read at fragment coordinates from
// device memory (the causal (1, 1, L, L) bias, 40 KB at L = 100, is shared by
// every block and sits in L2). A warp's 16 x 32 unit whose bias entries are
// all at or below MASK_VALUE / 2 adds exact zeros (finite inputs) when every
// one of its rows already has a running max (forward) or lse (backward)
// above MASK_VALUE / 2, and is skipped; a fully masked row is never skipped.
// The causal mask skips the units above the diagonal; keys and queries past
// L are masked by index (their rows are staged as zeros).
//
// Products, both kernels: 3xTF32 in mma3_k16_hi_last's order (`kHiLast`:
// the four small products of a 16-deep step before its two hi * hi, so the
// tensor cores' truncations fall on small partial sums), which took the
// largest errors against float64 at the training shape 14-23% below
// mma3_k16's order, to 1.4e-6 (out) and 3.1-3.6e-6 (dq, dk, dv), under the
// SIMT kernels' 1.5e-6 and 4.1-4.7e-6, at no measurable cost.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6;
// tools/attention_check.py, medians of 8 turns): at B = 512, L = 100, 4
// heads of 32, causal bias, dropout 0.2, the forward 0.132 ms (SIMT 0.265,
// SDPA 0.293; bound 0.032, bytes) and the backward 0.442 (SIMT 0.588,
// autograd of SDPA 0.595; bound 0.055, bytes); the forward at the serving
// batch (B = 4,096, no dropout) 0.833 (SIMT 1.583, SDPA 2.176; bound 0.252).
// Registers (ptxas -v): forward 128 at head dim 32 (capped for 4 blocks an
// SM; 46 KB of shared memory a block), 211-212 at 64 (87 KB, 2 blocks);
// backward 218-219 at 32 (73 KB), 255 at 64 with 12 bytes of spills (122
// KB), so one block (8 warps) an SM. What holds the backward at 8x its
// byte bound: that occupancy, and the causal mask's load on its warps at L =
// 100 (warp 0, keys 0-15, is live on all 4 query tiles, warps 6-7 on one or
// none: 19 live units of 32, 4 on the critical path).
//
// SIMT forward (head dims 8, 16): one block per (batch*head, tile of BQ
// queries), one thread per query row. The thread keeps its q row and output
// accumulator in registers; the block walks the keys in tiles of BK rows
// staged in shared memory, all threads reading the same key row (a
// broadcast, no bank conflicts), and keeps an online softmax (running max and
// sum), so any L works and the (L, L) score matrix never reaches device
// memory. The dropout bit scales each probability on its way into the value
// product; the running sum, and so the logsumexp, stays pre-dropout.
//
// SIMT backward (head dims 8, 16): one block owns a whole (b, h) row. Thread
// t owns key j = kt + t of a tile of KT keys: k and v rows in shared memory
// (rows padded to DH + 1 floats, so thread-per-row reads are conflict-free)
// and its dk and dv sums in registers. The block walks the query rows in
// tiles of TQ: each thread computes its column of s, p (from the saved
// logsumexp), dp and ds = p * (dp - delta) for the tile, adds into dk and
// dv, and parks ds in shared memory; then the block forms the tile's dq = ds
// k over the key tile and adds it into dq in device memory (written on the
// first key tile, added on later ones, by the same thread).
//
// q, k, v, out and their gradients are read and written through (batch, head,
// position) strides, so the (B, L, H, dh) layout of the projections needs no
// transpose. The additive bias is read through broadcast strides: a stride of
// 0 serves a (1, ...) batch or head dimension; a null bias means none. Masks
// are finite (-1e9), never -inf.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

#include "tc_tile.cuh"

// SIMT kernels (head dims 8 and 16)
constexpr int kBQ = 128;  // forward: queries per block = threads per block
constexpr int kBK = 32;   // forward: keys per shared-memory tile
constexpr int kKT = 128;  // backward: keys per tile = threads per block
constexpr int kTQ = 16;   // backward: query rows per step
// tensor-core kernels (head dims 32 and 64): the forward's block owns 64
// queries (4 warps of 16) and walks the keys in tiles of 64; the backward's
// block owns a (b, h) row and walks the keys in tiles of 128 (8 warps of 16)
// and, per key tile, the queries in tiles of 32
constexpr int kFwdTile = 64;
constexpr int kFwdThreads = 128;
constexpr int kBwdKeys = 128;
constexpr int kBwdQueries = 32;
constexpr int kBwdThreads = 256;
constexpr int kDsPitch = kBwdKeys + 8;  // the backward's ds tile [query][key]: 8 (mod 32), see frag_a_pairs
constexpr float kMaskHalf = -5e8f;      // MASK_VALUE / 2: a bias at or below it masks its pair
constexpr bool kHiLast = true;          // 3xTF32 products in mma3_k16_hi_last's order (tc_tile.cuh)
constexpr unsigned kGolden = 0x9E3779B9u;

// Which head dims take the tensor-core kernels: 32 and 64; 8 and 16 keep the
// SIMT kernels.
constexpr bool attn_tensor_cores(int dh) { return dh == 32 || dh == 64; }

__device__ __forceinline__ unsigned mix32_fast(unsigned h) {
  h ^= h >> 16;
  h *= 0x7FEB352Du;
  h ^= h >> 15;
  return h;
}

struct Dropout {
  int on;              // 0: no dropout (selects the kernels without the hash)
  unsigned threshold;  // keep when the hash is >= threshold
  float keep_scale;    // 1 / (1 - rate)
  int seed;
};

// (seed + bh * 40503) * 0x01000193 in uint32: the per-(b, h) half of the hash input
__device__ __forceinline__ unsigned salt_of(const Dropout& dr, int bh) {
  return ((unsigned)dr.seed + (unsigned)bh * 40503u) * 0x01000193u;
}

__device__ __forceinline__ bool keep(const Dropout& dr, unsigned salt, int row, int col, int L) {
  return mix32_fast(((unsigned)row * (unsigned)L + (unsigned)col) * kGolden + salt) >= dr.threshold;
}

struct AttnParams {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;  // may be null
  float* out;
  float* lse;  // (B, H, L) contiguous
  int B, H, L;
  long long q_sb, q_sh, q_sl;
  long long k_sb, k_sh, k_sl;
  long long v_sb, v_sh, v_sl;
  long long o_sb, o_sh, o_sl;
  long long bias_sb, bias_sh;  // bias rows are L contiguous floats, row stride L
  float scale;
  Dropout dr;
};

template <int DH, bool kDropout>
__global__ void __launch_bounds__(kBQ) attn_fwd_kernel(const AttnParams p) {
  __shared__ __align__(16) float ks[kBK][DH];
  __shared__ __align__(16) float vs[kBK][DH];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int qi = blockIdx.y * kBQ + threadIdx.x;
  const bool active = qi < p.L;
  const unsigned salt = salt_of(p.dr, bh);

  const float* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + h * p.v_sh;
  const float* brow = nullptr;
  if (p.bias != nullptr && active) brow = p.bias + b * p.bias_sb + h * p.bias_sh + (long long)qi * p.L;

  float q[DH];
  float acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) acc[d] = 0.f;
  if (active) {
    const float4* qrow = reinterpret_cast<const float4*>(p.q + b * p.q_sb + h * p.q_sh + qi * p.q_sl);
#pragma unroll
    for (int d4 = 0; d4 < DH / 4; ++d4) {
      const float4 t = qrow[d4];
      q[4 * d4] = t.x;
      q[4 * d4 + 1] = t.y;
      q[4 * d4 + 2] = t.z;
      q[4 * d4 + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int d = 0; d < DH; ++d) q[d] = 0.f;
  }

  float m_run = -INFINITY;
  float l_run = 0.f;
  for (int kt = 0; kt < p.L; kt += kBK) {
    __syncthreads();  // previous tile fully consumed
    for (int idx = threadIdx.x; idx < kBK * (DH / 4); idx += kBQ) {
      const int r = idx / (DH / 4);
      const int c4 = idx - r * (DH / 4);
      const int key = kt + r;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f);
      float4 vv = kv;
      if (key < p.L) {
        kv = reinterpret_cast<const float4*>(kbase + key * p.k_sl)[c4];
        vv = reinterpret_cast<const float4*>(vbase + key * p.v_sl)[c4];
      }
      reinterpret_cast<float4*>(&ks[r][0])[c4] = kv;
      reinterpret_cast<float4*>(&vs[r][0])[c4] = vv;
    }
    __syncthreads();
    if (!active) continue;

    float s[kBK];
    float tile_max = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const int key = kt + j;
      float sj = -INFINITY;
      if (key < p.L) {
        const float4* krow = reinterpret_cast<const float4*>(&ks[j][0]);
        float dot = 0.f;
#pragma unroll
        for (int d4 = 0; d4 < DH / 4; ++d4) {
          const float4 t = krow[d4];
          dot = fmaf(q[4 * d4], t.x, dot);
          dot = fmaf(q[4 * d4 + 1], t.y, dot);
          dot = fmaf(q[4 * d4 + 2], t.z, dot);
          dot = fmaf(q[4 * d4 + 3], t.w, dot);
        }
        sj = dot * p.scale;
        if (brow != nullptr) sj += brow[key];
      }
      s[j] = sj;
      tile_max = fmaxf(tile_max, sj);
    }
    const float m_new = fmaxf(m_run, tile_max);  // finite: key kt is always in range
    const float corr = expf(m_run - m_new);
    l_run *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll
    for (int j = 0; j < kBK; ++j) {
      const float pj = expf(s[j] - m_new);  // 0 for keys past L
      l_run += pj;
      float pv = pj;
      if (kDropout) pv = (kt + j < p.L && keep(p.dr, salt, qi, kt + j, p.L)) ? pj * p.dr.keep_scale : 0.f;
      const float4* vrow = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 t = vrow[d4];
        acc[4 * d4] = fmaf(pv, t.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(pv, t.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pv, t.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pv, t.w, acc[4 * d4 + 3]);
      }
    }
    m_run = m_new;
  }

  if (!active) return;
  const float lse = m_run + logf(l_run);
  const float norm = expf(m_run - lse);  // 1 / l_run, as the twin rounds it (see the header)
  float4* orow = reinterpret_cast<float4*>(p.out + b * p.o_sb + h * p.o_sh + qi * p.o_sl);
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    orow[d4] = make_float4(acc[4 * d4] * norm, acc[4 * d4 + 1] * norm, acc[4 * d4 + 2] * norm,
                           acc[4 * d4 + 3] * norm);
  }
  p.lse[(long long)bh * p.L + qi] = lse;
}

template <int DH>
struct FwdSmem {
  float q[kFwdTile * tc::kPitch<DH>];             // the block's query rows
  float kv[2][2 * kFwdTile * tc::kPitch<DH>];     // ring of two key tiles: k rows, then v rows
};

// the key tile at k0 (k rows, then v rows) into one stage of the ring
template <int DH>
__device__ __forceinline__ void stage_keys_async(float* st, const float* kbase, long long k_sl, const float* vbase,
                                                 long long v_sl, int k0, int L) {
  tc::stage_rows_async<DH, kFwdTile, kFwdThreads>(st, kbase, k_sl, k0, L);
  tc::stage_rows_async<DH, kFwdTile, kFwdThreads>(st + kFwdTile * tc::kPitch<DH>, vbase, v_sl, k0, L);
}

// The forward on the tensor cores (head dims 32, 64): block x owns queries
// 64 (x % n_tiles) + [0, 64) of batch*head row x / n_tiles, and no other
// block writes their out rows and lse entries. Warp w takes queries 16 w +
// [0, 16); per 32-key unit of each key tile it forms s (16 x 32, 3xTF32),
// adds scale and bias, keeps the online softmax of its rows in registers (a
// row's 32 columns lie across the 4 lanes of a quad), and adds p_drop v into
// its output fragments with p_drop as the A operand, straight from the
// accumulator.
template <int DH, bool kDropout>
// head dim 32: 4 blocks an SM (128 registers a thread; left to itself ptxas
// took 163 in the no-dropout kernel, and 3 blocks ran 7% slower at serving)
__global__ void __launch_bounds__(kFwdThreads, DH == 32 ? 4 : 2) attn_fwd_tc_kernel(const AttnParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem<DH>& sh = *reinterpret_cast<FwdSmem<DH>*>(smem_raw);
  constexpr int P = tc::kPitch<DH>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int L = p.L;
  const int n_tiles = (L + kFwdTile - 1) / kFwdTile;  // query tiles a row, and key tiles
  const int bh = blockIdx.x / n_tiles;
  const int q0 = (blockIdx.x - bh * n_tiles) * kFwdTile;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const unsigned salt = salt_of(p.dr, bh);
  const float* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + h * p.v_sh;
  const float* bbase = p.bias == nullptr ? nullptr : p.bias + b * p.bias_sb + h * p.bias_sh;
  const int qr = warp * 16;                             // the warp's query rows, local
  const int rows[2] = {q0 + qr + g, q0 + qr + g + 8};  // the thread's two rows
  const bool warp_live = q0 + qr < L;

  tc::stage_rows_async<DH, kFwdTile, kFwdThreads>(sh.q, p.q + b * p.q_sb + h * p.q_sh, p.q_sl, q0, L);
  stage_keys_async<DH>(sh.kv[0], kbase, p.k_sl, vbase, p.v_sl, 0, L);
  tc::cp_commit();

  float acc[DH / 8][4];
#pragma unroll
  for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nf][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // running max of each row
  float l_run[2] = {0.f, 0.f};              // the thread's share of each row's running sum

  for (int kt = 0; kt < n_tiles; ++kt) {
    tc::cp_wait<0>();
    __syncthreads();  // key tile kt landed; every warp is done with the other stage
    if (kt + 1 < n_tiles)
      stage_keys_async<DH>(sh.kv[(kt + 1) & 1], kbase, p.k_sl, vbase, p.v_sl, (kt + 1) * kFwdTile, L);
    tc::cp_commit();
    if (!warp_live) continue;
    const float* ks = sh.kv[kt & 1];
    const float* vs = ks + kFwdTile * P;
#pragma unroll 1
    for (int u = 0; u < kFwdTile; u += 32) {
      const int kc = kt * kFwdTile + u;  // the unit's first key
      if (kc >= L) break;
      // the unit's bias at fragment coordinates; it adds exact zeros (finite
      // inputs) when every pair is masked and every row already has a max
      // above MASK_VALUE / 2
      float bias[4][4];
      bool live = (rows[0] < L && m_run[0] <= kMaskHalf) || (rows[1] < L && m_run[1] <= kMaskHalf);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = rows[e >> 1], key = kc + nf * 8 + 2 * t + (e & 1);
          const bool valid = row < L && key < L;
          bias[nf][e] = bbase != nullptr && valid ? bbase[(long long)row * L + key] : 0.f;
          live |= valid && bias[nf][e] > kMaskHalf;
        }
      if (!__any_sync(0xffffffffu, live)) continue;

      float s[4][4];  // queries qr + [0, 16) x keys u + [0, 32) of the tile
      tc::product_rows<DH, kHiLast>(sh.q, qr, ks, u, s);
      float tile_max[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = kc + nf * 8 + 2 * t + (e & 1);
          s[nf][e] = key < L ? s[nf][e] * p.scale + bias[nf][e] : -INFINITY;
          tile_max[e >> 1] = fmaxf(tile_max[e >> 1], s[nf][e]);
        }
      float corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(0xffffffffu, tile_max[hh], 1));
        tile_max[hh] = fmaxf(tile_max[hh], __shfl_xor_sync(0xffffffffu, tile_max[hh], 2));
        const float m_new = fmaxf(m_run[hh], tile_max[hh]);  // finite: key kc is in range
        corr[hh] = expf(m_run[hh] - m_new);
        m_run[hh] = m_new;
        l_run[hh] *= corr[hh];
      }
#pragma unroll
      for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nf][e] *= corr[e >> 1];
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pr = expf(s[nf][e] - m_run[e >> 1]);  // 0 for keys past L
          l_run[e >> 1] += pr;
          if (kDropout) {
            const int key = kc + nf * 8 + 2 * t + (e & 1);
            s[nf][e] = key < L && keep(p.dr, salt, rows[e >> 1], key, L) ? pr * p.dr.keep_scale : 0.f;
          } else {
            s[nf][e] = pr;
          }
        }
      tc::accumulate_rows<DH, kHiLast>(acc, s, vs, u);
    }
  }
  tc::cp_wait<0>();
  if (!warp_live) return;

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 1);
    l_run[hh] += __shfl_xor_sync(0xffffffffu, l_run[hh], 2);
    const float lse = m_run[hh] + logf(l_run[hh]);
    const float norm = expf(m_run[hh] - lse);  // 1 / l, as the twin rounds it (see the header)
    if (t == 0 && rows[hh] < L) p.lse[(long long)bh * L + rows[hh]] = lse;
#pragma unroll
    for (int nf = 0; nf < DH / 8; ++nf) {
      acc[nf][2 * hh] *= norm;
      acc[nf][2 * hh + 1] *= norm;
    }
    // A row whose keys are all masked (the model's masks make none) has p =
    // exp(s - lse) = 1 for every key: its output is a sum of v, not an
    // average, and 3xTF32 with the tensor cores' truncating accumulation
    // leaves f32's accuracy there (1.2e-5 at L = 257). Its entries are
    // recomputed in f32 FMA, as the twin computes them.
    if (rows[hh] < L && m_run[hh] <= kMaskHalf) {
      const float* qrow = sh.q + (qr + g + 8 * hh) * P;
      float o[DH / 8][2];
#pragma unroll
      for (int nf = 0; nf < DH / 8; ++nf) o[nf][0] = o[nf][1] = 0.f;
      for (int key = 0; key < L; ++key) {
        const float* krow = kbase + key * p.k_sl;
        const float* vrow = vbase + key * p.v_sl;
        float dot = 0.f;
        for (int d = 0; d < DH; ++d) dot = fmaf(qrow[d], krow[d], dot);
        const float bias = bbase != nullptr ? bbase[(long long)rows[hh] * L + key] : 0.f;
        float pr = expf(dot * p.scale + bias - lse);
        if (kDropout) pr = keep(p.dr, salt, rows[hh], key, L) ? pr * p.dr.keep_scale : 0.f;
#pragma unroll
        for (int nf = 0; nf < DH / 8; ++nf) {
          o[nf][0] = fmaf(pr, vrow[nf * 8 + 2 * t], o[nf][0]);
          o[nf][1] = fmaf(pr, vrow[nf * 8 + 2 * t + 1], o[nf][1]);
        }
      }
#pragma unroll
      for (int nf = 0; nf < DH / 8; ++nf) {
        acc[nf][2 * hh] = o[nf][0];
        acc[nf][2 * hh + 1] = o[nf][1];
      }
    }
  }
  tc::store_frags<DH>(p.out + b * p.o_sb + h * p.o_sh, p.o_sl, q0, L, acc);
}

struct AttnBwdParams {
  const float* q;
  const float* k;
  const float* v;
  const float* bias;   // may be null
  const float* lse;    // (B, H, L) contiguous, pre-dropout
  const float* delta;  // (B, H, L) contiguous, sum(dout * out)
  const float* dout;
  float* dq;
  float* dk;
  float* dv;
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
constexpr int bwd_smem_floats() {
  return 2 * kKT * (DH + 1) + 2 * kTQ * DH + kTQ * kKT + 2 * kTQ;
}

template <int DH, bool kDropout>
__global__ void __launch_bounds__(kKT) attn_bwd_kernel(const AttnBwdParams p) {
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;                  // [kKT][DH + 1]
  float* vs = ks + kKT * (DH + 1);   // [kKT][DH + 1]
  float* qs = vs + kKT * (DH + 1);   // [kTQ][DH]
  float* dos = qs + kTQ * DH;        // [kTQ][DH]
  float* dss = dos + kTQ * DH;       // [kTQ][kKT]
  float* lse_s = dss + kTQ * kKT;    // [kTQ]
  float* delta_s = lse_s + kTQ;      // [kTQ]

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int t = threadIdx.x;
  const int L = p.L;
  const unsigned salt = salt_of(p.dr, bh);
  const float* qbase = p.q + b * p.q_sb + h * p.q_sh;
  const float* kbase = p.k + b * p.k_sb + h * p.k_sh;
  const float* vbase = p.v + b * p.v_sb + h * p.v_sh;
  const float* dobase = p.dout + b * p.do_sb + h * p.do_sh;
  float* dqbase = p.dq + b * p.dq_sb + h * p.dq_sh;
  const float* bbase = p.bias == nullptr ? nullptr : p.bias + b * p.bias_sb + h * p.bias_sh;
  const float* lse_row = p.lse + (long long)bh * L;
  const float* delta_row = p.delta + (long long)bh * L;

  for (int kt = 0; kt < L; kt += kKT) {
    const int j = kt + t;
    const bool kvalid = j < L;
    __syncthreads();  // the previous key tile's dq step is done with ks
    float* krow = ks + t * (DH + 1);
    float* vrow = vs + t * (DH + 1);
    if (kvalid) {
      const float4* kg = reinterpret_cast<const float4*>(kbase + j * p.k_sl);
      const float4* vg = reinterpret_cast<const float4*>(vbase + j * p.v_sl);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 a = kg[d4];
        const float4 c = vg[d4];
        krow[4 * d4] = a.x; krow[4 * d4 + 1] = a.y; krow[4 * d4 + 2] = a.z; krow[4 * d4 + 3] = a.w;
        vrow[4 * d4] = c.x; vrow[4 * d4 + 1] = c.y; vrow[4 * d4 + 2] = c.z; vrow[4 * d4 + 3] = c.w;
      }
    } else {
#pragma unroll
      for (int d = 0; d < DH; ++d) {
        krow[d] = 0.f;
        vrow[d] = 0.f;
      }
    }
    float dk[DH], dv[DH];
#pragma unroll
    for (int d = 0; d < DH; ++d) {
      dk[d] = 0.f;
      dv[d] = 0.f;
    }

    for (int qt = 0; qt < L; qt += kTQ) {
      __syncthreads();  // the previous query tile is fully consumed
      for (int idx = t; idx < kTQ * (DH / 4); idx += kKT) {
        const int r = idx / (DH / 4);
        const int c4 = idx - r * (DH / 4);
        const int row = qt + r;
        float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 dov = qv;
        if (row < L) {
          qv = reinterpret_cast<const float4*>(qbase + row * p.q_sl)[c4];
          dov = reinterpret_cast<const float4*>(dobase + row * p.do_sl)[c4];
        }
        reinterpret_cast<float4*>(qs + r * DH)[c4] = qv;
        reinterpret_cast<float4*>(dos + r * DH)[c4] = dov;
      }
      if (t < kTQ) {
        const int row = qt + t;
        lse_s[t] = row < L ? lse_row[row] : 0.f;
        delta_s[t] = row < L ? delta_row[row] : 0.f;
      }
      __syncthreads();

#pragma unroll 1
      for (int ii = 0; ii < kTQ; ++ii) {
        const int row = qt + ii;
        float ds = 0.f;
        if (kvalid && row < L) {
          const float* qr = qs + ii * DH;
          const float* dor = dos + ii * DH;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            s = fmaf(qr[d], krow[d], s);
            dp = fmaf(dor[d], vrow[d], dp);
          }
          s *= p.scale;
          if (bbase != nullptr) s += bbase[(long long)row * L + j];
          const float pr = expf(s - lse_s[ii]);
          float pd = pr;
          if (kDropout) {
            const bool kept = keep(p.dr, salt, row, j, L);
            pd = kept ? pr * p.dr.keep_scale : 0.f;
            dp = kept ? dp * p.dr.keep_scale : 0.f;
          }
          ds = pr * (dp - delta_s[ii]);
#pragma unroll
          for (int d = 0; d < DH; ++d) {
            dv[d] = fmaf(pd, dor[d], dv[d]);
            dk[d] = fmaf(ds, qr[d], dk[d]);
          }
        }
        dss[ii * kKT + t] = ds;
      }
      __syncthreads();

      for (int idx = t; idx < kTQ * DH; idx += kKT) {
        const int ii = idx / DH;
        const int d = idx - ii * DH;
        const int row = qt + ii;
        if (row >= L) continue;
        float acc = 0.f;
        const float* dsr = dss + ii * kKT;
#pragma unroll 8
        for (int tt = 0; tt < kKT; ++tt) acc = fmaf(dsr[tt], ks[tt * (DH + 1) + d], acc);
        float* dqp = dqbase + row * p.dq_sl + d;
        *dqp = (kt == 0 ? 0.f : *dqp) + acc * p.scale;
      }
    }

    if (kvalid) {
      float4* dkg = reinterpret_cast<float4*>(p.dk + b * p.dk_sb + h * p.dk_sh + j * p.dk_sl);
      float4* dvg = reinterpret_cast<float4*>(p.dv + b * p.dv_sb + h * p.dv_sh + j * p.dv_sl);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        dkg[d4] = make_float4(dk[4 * d4] * p.scale, dk[4 * d4 + 1] * p.scale, dk[4 * d4 + 2] * p.scale,
                              dk[4 * d4 + 3] * p.scale);
        dvg[d4] = make_float4(dv[4 * d4], dv[4 * d4 + 1], dv[4 * d4 + 2], dv[4 * d4 + 3]);
      }
    }
  }
}

template <int DH>
struct BwdSmem {
  float k[kBwdKeys * tc::kPitch<DH>];  // the key tile
  float v[kBwdKeys * tc::kPitch<DH>];
  float rows[2][2 * kBwdQueries * tc::kPitch<DH>];  // ring of two query tiles: q rows, then dout rows
  float lse[2][kBwdQueries];
  float delta[2][kBwdQueries];
  float ds[kBwdQueries * kDsPitch];  // the query tile's ds [query][key]
};

// the query tile at q0 (q and dout rows, lse and delta) into one stage of the ring
template <int DH>
__device__ __forceinline__ void stage_queries_async(BwdSmem<DH>& sh, int stage, const float* qbase, long long q_sl,
                                                    const float* dobase, long long do_sl, const float* lse_row,
                                                    const float* delta_row, int q0, int L) {
  float* st = sh.rows[stage];
  tc::stage_rows_async<DH, kBwdQueries, kBwdThreads>(st, qbase, q_sl, q0, L);
  tc::stage_rows_async<DH, kBwdQueries, kBwdThreads>(st + kBwdQueries * tc::kPitch<DH>, dobase, do_sl, q0, L);
  const int i = threadIdx.x & (kBwdQueries - 1);
  const bool ok = q0 + i < L;
  if (threadIdx.x < kBwdQueries) tc::cp_async4(&sh.lse[stage][i], ok ? lse_row + q0 + i : lse_row, ok);
  else if (threadIdx.x < 2 * kBwdQueries) tc::cp_async4(&sh.delta[stage][i], ok ? delta_row + q0 + i : delta_row, ok);
}

// The backward on the tensor cores (head dims 32, 64): block x owns row (b,
// h) = (x / H, x % H), and no other block writes its dq, dk or dv. Per key
// tile of 128, warp w owns keys 16 w + [0, 16) with their dk and dv
// fragments in registers, and the block walks the query tiles of 32 in
// order (q, dout, lse, delta in a cp.async ring of two). Per query tile each
// warp forms s^T and dp^T (16 keys x 32 queries, 3xTF32), turns them into
// p_drop^T and ds^T in the accumulator fragments, adds p_drop^T dout into dv
// and ds^T q into dk with those fragments as A, and parks ds^T in the shared
// [query][key] tile; after a barrier the block forms the tile's dq = ds k
// over the key tile (warp w: row block w % 2, column blocks w / 2 + 4 j),
// written on the first key tile and added on later ones by the same thread.
template <int DH, bool kDropout>
__global__ void __launch_bounds__(kBwdThreads) attn_bwd_tc_kernel(const AttnBwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  BwdSmem<DH>& sh = *reinterpret_cast<BwdSmem<DH>*>(smem_raw);
  constexpr int P = tc::kPitch<DH>;
  constexpr int kNB = DH / 32;  // dq: 8-column blocks a warp
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int L = p.L;
  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const unsigned salt = salt_of(p.dr, bh);
  const float* qbase = p.q + b * p.q_sb + h * p.q_sh;
  const float* dobase = p.dout + b * p.do_sb + h * p.do_sh;
  const float* bbase = p.bias == nullptr ? nullptr : p.bias + b * p.bias_sb + h * p.bias_sh;
  const float* lse_row = p.lse + (long long)bh * L;
  const float* delta_row = p.delta + (long long)bh * L;
  float* dqbase = p.dq + b * p.dq_sb + h * p.dq_sh;
  const int kr = warp * 16;  // the warp's keys, local
  const int n_query_tiles = (L + kBwdQueries - 1) / kBwdQueries;

  for (int k0 = 0; k0 < L; k0 += kBwdKeys) {
    __syncthreads();  // the previous key tile's dq steps are done with sh.k and the ring
    tc::stage_rows_async<DH, kBwdKeys, kBwdThreads>(sh.k, p.k + b * p.k_sb + h * p.k_sh, p.k_sl, k0, L);
    tc::stage_rows_async<DH, kBwdKeys, kBwdThreads>(sh.v, p.v + b * p.v_sb + h * p.v_sh, p.v_sl, k0, L);
    stage_queries_async<DH>(sh, 0, qbase, p.q_sl, dobase, p.do_sl, lse_row, delta_row, 0, L);
    tc::cp_commit();
    float dk[DH / 8][4], dv[DH / 8][4];
#pragma unroll
    for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        dk[nf][e] = 0.f;
        dv[nf][e] = 0.f;
      }

    for (int qi = 0; qi < n_query_tiles; ++qi) {
      tc::cp_wait<0>();
      __syncthreads();  // query tile qi landed; every warp is done with the other stage and with sh.ds
      if (qi + 1 < n_query_tiles)
        stage_queries_async<DH>(sh, (qi + 1) & 1, qbase, p.q_sl, dobase, p.do_sl, lse_row, delta_row,
                                (qi + 1) * kBwdQueries, L);
      tc::cp_commit();
      const int q0 = qi * kBwdQueries;
      const float* qs = sh.rows[qi & 1];
      const float* dos = qs + kBwdQueries * P;
      const float* lse_s = sh.lse[qi & 1];
      const float* delta_s = sh.delta[qi & 1];

      // the warp's unit: keys k0 + kr + [0, 16) x queries q0 + [0, 32). Its
      // bias at fragment coordinates; it adds exact zeros (finite inputs)
      // when every pair is masked and every query's lse is above
      // MASK_VALUE / 2 (a fully masked row's lse is about MASK_VALUE, and its
      // p is not 0)
      float bias[4][4];
      bool live = false;
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + kr + g + 8 * (e >> 1), ql = nf * 8 + 2 * t + (e & 1);
          const bool valid = key < L && q0 + ql < L;
          bias[nf][e] = bbase != nullptr && valid ? bbase[(long long)(q0 + ql) * L + key] : 0.f;
          live |= valid && (bias[nf][e] > kMaskHalf || lse_s[ql] <= kMaskHalf);
        }
      float st[4][4], dt[4][4];  // s^T and dp^T, then p_drop^T and ds^T
      if (__any_sync(0xffffffffu, live)) {
        tc::product_rows<DH, kHiLast>(sh.k, kr, qs, 0, st);
        tc::product_rows<DH, kHiLast>(sh.v, kr, dos, 0, dt);
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + kr + g + 8 * (e >> 1), ql = nf * 8 + 2 * t + (e & 1);
            float pd = 0.f, ds = 0.f;
            if (key < L && q0 + ql < L) {
              const float pr = expf(st[nf][e] * p.scale + bias[nf][e] - lse_s[ql]);
              float dp = dt[nf][e];
              pd = pr;
              if (kDropout) {
                const bool kept = keep(p.dr, salt, q0 + ql, key, L);
                pd = kept ? pr * p.dr.keep_scale : 0.f;
                dp = kept ? dp * p.dr.keep_scale : 0.f;
              }
              ds = pr * (dp - delta_s[ql]);
            }
            st[nf][e] = pd;
            dt[nf][e] = ds;
          }
        tc::accumulate_rows<DH, kHiLast>(dv, st, dos, 0);
        tc::accumulate_rows<DH, kHiLast>(dk, dt, qs, 0);
      } else {
#pragma unroll
        for (int nf = 0; nf < 4; ++nf)
#pragma unroll
          for (int e = 0; e < 4; ++e) dt[nf][e] = 0.f;
      }
#pragma unroll
      for (int nf = 0; nf < 4; ++nf)
#pragma unroll
        for (int e = 0; e < 4; ++e) sh.ds[(nf * 8 + 2 * t + (e & 1)) * kDsPitch + kr + g + 8 * (e >> 1)] = dt[nf][e];
      __syncthreads();  // the tile's ds is whole

      // dq of the query tile: ds (32 queries x the tile's keys) k, over the
      // keys below L (ds and k are zero past them)
      const int rb = (warp & 1) * 16;
      float dq[kNB][4];
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
      const int n_keys = min(kBwdKeys, L - k0);
#pragma unroll 1
      for (int k = 0; k < n_keys; k += 16) {
        uint32_t ah[2][4], al[2][4];
        tc::frag_a_pairs<kDsPitch>(sh.ds, rb, k, ah, al);
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          uint32_t bh_[2][2], bl_[2][2];
          tc::frag_b_cols<P>(sh.k, k, ((warp >> 1) + 4 * j) * 8, bh_, bl_);
          tc::mma3_k16_in<kHiLast>(dq[j], ah, al, bh_, bl_);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = q0 + rb + g + 8 * hh;
        if (row >= L) continue;
#pragma unroll
        for (int j = 0; j < kNB; ++j) {
          float2* out = reinterpret_cast<float2*>(dqbase + row * p.dq_sl + ((warp >> 1) + 4 * j) * 8 + 2 * t);
          float2 val = make_float2(dq[j][2 * hh] * p.scale, dq[j][2 * hh + 1] * p.scale);
          if (k0 > 0) {
            const float2 prev = *out;
            val.x += prev.x;
            val.y += prev.y;
          }
          *out = val;
        }
      }
    }

#pragma unroll
    for (int nf = 0; nf < DH / 8; ++nf)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[nf][e] *= p.scale;
    tc::store_frags<DH>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sl, k0, L, dk);
    tc::store_frags<DH>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sl, k0, L, dv);
  }
  tc::cp_wait<0>();
}

// one kernel, (b, h) blocks: the tensor-core kernel at head dims 32 and 64,
// the SIMT one at 8 and 16
template <int DH, bool kDropout>
int launch_bwd(const AttnBwdParams& p, cudaStream_t stream) {
  if constexpr (attn_tensor_cores(DH)) {
    const int smem = (int)sizeof(BwdSmem<DH>);
    cudaError_t err =
        cudaFuncSetAttribute(attn_bwd_tc_kernel<DH, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_tc_kernel<DH, kDropout><<<(unsigned)(p.B * p.H), kBwdThreads, smem, stream>>>(p);
  } else {
    const int smem = bwd_smem_floats<DH>() * (int)sizeof(float);
    cudaError_t err =
        cudaFuncSetAttribute(attn_bwd_kernel<DH, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_kernel<DH, kDropout><<<(unsigned)(p.B * p.H), kKT, smem, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// the dropout-free instantiations carry no hash code at all
template <int DH>
int launch_bwd(const AttnBwdParams& p, cudaStream_t stream) {
  return p.dr.on ? launch_bwd<DH, true>(p, stream) : launch_bwd<DH, false>(p, stream);
}

// one kernel: the tensor-core kernel at head dims 32 and 64, blocks of
// (batch*head, 64-query tile) with the query tile fastest, so the blocks of
// one row read its k and v one after another; the SIMT one at 8 and 16, a
// (batch*head, 128-query tile) grid
template <int DH, bool kDropout>
int launch_fwd(const AttnParams& p, cudaStream_t stream) {
  if constexpr (attn_tensor_cores(DH)) {
    const int smem = (int)sizeof(FwdSmem<DH>);
    cudaError_t err =
        cudaFuncSetAttribute(attn_fwd_tc_kernel<DH, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = (long long)p.B * p.H * ((p.L + kFwdTile - 1) / kFwdTile);
    attn_fwd_tc_kernel<DH, kDropout><<<(unsigned)blocks, kFwdThreads, smem, stream>>>(p);
  } else {
    const dim3 grid((unsigned)(p.B * p.H), (unsigned)((p.L + kBQ - 1) / kBQ));
    attn_fwd_kernel<DH, kDropout><<<grid, kBQ, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int DH>
int launch_fwd(const AttnParams& p, cudaStream_t stream) {
  return p.dr.on ? launch_fwd<DH, true>(p, stream) : launch_fwd<DH, false>(p, stream);
}

Dropout make_dropout(int seed, int dropout, unsigned threshold, float keep_scale) {
  return Dropout{dropout, threshold, keep_scale, seed};
}

}  // namespace

// Strides are in elements; the head-dim stride of q, k, v and out is 1 and
// every row start is 16-byte aligned (checked by the Python wrapper).
// `dropout` != 0 turns the counter-hash dropout on with the given uint32
// threshold and keep scale. Returns cudaGetLastError() after the launch
// (0 = launched).
extern "C" int attn_fwd_f32(const float* q, const float* k, const float* v, const float* bias, float* out,
                            float* lse, int B, int H, int L, int dh, long long q_sb, long long q_sh, long long q_sl,
                            long long k_sb, long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                            long long v_sl, long long o_sb, long long o_sh, long long o_sl, long long bias_sb,
                            long long bias_sh, float scale, int seed, int dropout, unsigned threshold,
                            float keep_scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return 0;
  const AttnParams p{q,    k,    v,    bias, out,  lse,  B,       H,       L,     q_sb,
                     q_sh, q_sl, k_sb, k_sh, k_sl, v_sb, v_sh,    v_sl,    o_sb,  o_sh,
                     o_sl, bias_sb, bias_sh, scale, make_dropout(seed, dropout, threshold, keep_scale)};
  switch (dh) {
    case 8: return launch_fwd<8>(p, stream);
    case 16: return launch_fwd<16>(p, stream);
    case 32: return launch_fwd<32>(p, stream);
    case 64: return launch_fwd<64>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Backward: dq, dk, dv (strided like q) from q, k, v, the forward's lse and
// delta = sum(dout * out, -1), with the forward's bias and dropout arguments.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int attn_bwd_f32(const float* q, const float* k, const float* v, const float* bias, const float* lse,
                            const float* delta, const float* dout, float* dq, float* dk, float* dv, int B, int H,
                            int L, int dh, long long q_sb, long long q_sh, long long q_sl, long long k_sb,
                            long long k_sh, long long k_sl, long long v_sb, long long v_sh, long long v_sl,
                            long long do_sb, long long do_sh, long long do_sl, long long dq_sb, long long dq_sh,
                            long long dq_sl, long long dk_sb, long long dk_sh, long long dk_sl, long long dv_sb,
                            long long dv_sh, long long dv_sl, long long bias_sb, long long bias_sh, float scale,
                            int seed, int dropout, unsigned threshold, float keep_scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return 0;
  const AttnBwdParams p{q,     k,     v,     bias,  lse,   delta, dout,  dq,    dk,      dv,      B,     H,
                        L,     q_sb,  q_sh,  q_sl,  k_sb,  k_sh,  k_sl,  v_sb,  v_sh,    v_sl,    do_sb, do_sh,
                        do_sl, dq_sb, dq_sh, dq_sl, dk_sb, dk_sh, dk_sl, dv_sb, dv_sh,   dv_sl,   bias_sb,
                        bias_sh, scale, make_dropout(seed, dropout, threshold, keep_scale)};
  switch (dh) {
    case 8: return launch_bwd<8>(p, stream);
    case 16: return launch_bwd<16>(p, stream);
    case 32: return launch_bwd<32>(p, stream);
    case 64: return launch_bwd<64>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
