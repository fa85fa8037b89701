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
// Bound on an H100: f32 operations. The forward's two products are
// 4 * L*L*dh per (b, h): at the training shape B = 512, H = 4, L = 100,
// dh = 32, 2.6 GFLOP, 0.039 ms at 67 TFLOP/s (non-tensor FP32); the backward's
// five (s, dp, dv, dk, dq) are 10 * L*L*dh per (b, h), 6.6 GFLOP, 0.098 ms.
// The JAX reference is exact f32, so the kernels use f32 FMA and not TF32 (a
// tensor-core design with its own tolerance is later work).
//
// Forward design: one block per (batch*head, tile of BQ queries), one thread
// per query row. The thread keeps its q row and output accumulator in
// registers; the block walks the keys in tiles of BK rows staged in shared
// memory, all threads reading the same key row (a broadcast, no bank
// conflicts), and keeps an online softmax (running max and sum), so any L
// works and the (L, L) score matrix never reaches device memory. The dropout
// bit scales each probability on its way into the value product; the running
// sum, and so the logsumexp, stays pre-dropout.
//
// Backward design: the TPU kernel accumulates dk and dv in output blocks that
// consecutive q-block programs revisit (attention.py:275-281); GPU blocks run
// in no order, so here one block owns a whole (b, h) row and no other block
// writes its dq, dk or dv: no atomics. Thread t owns key j = kt + t of a tile
// of KT keys: k and v rows in shared memory (rows padded to DH + 1 floats, so
// thread-per-row reads are conflict-free) and its dk and dv sums in registers.
// The block walks the query rows in tiles of TQ: each thread computes its
// column of s, p (from the saved logsumexp), dp and ds = p * (dp - delta) for
// the tile, adds into dk and dv, and parks ds in shared memory; then the block
// forms the tile's dq = ds k over the key tile and adds it into dq in device
// memory (written on the first key tile, added on later ones, by the same
// thread). For L <= KT, as at L = 100, there is one key tile.
//
// q, k, v, out and their gradients are read and written through (batch, head,
// position) strides, so the (B, L, H, dh) layout of the projections needs no
// transpose. The additive bias is read through broadcast strides: a stride of
// 0 serves a (1, ...) batch or head dimension; a null bias means none. Masks
// are finite (-1e9), never -inf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 128;  // forward: queries per block = threads per block
constexpr int kBK = 32;   // forward: keys per shared-memory tile
constexpr int kKT = 128;  // backward: keys per tile = threads per block
constexpr int kTQ = 16;   // backward: query rows per step
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
  const float inv_l = 1.f / l_run;
  float4* orow = reinterpret_cast<float4*>(p.out + b * p.o_sb + h * p.o_sh + qi * p.o_sl);
#pragma unroll
  for (int d4 = 0; d4 < DH / 4; ++d4) {
    orow[d4] = make_float4(acc[4 * d4] * inv_l, acc[4 * d4 + 1] * inv_l, acc[4 * d4 + 2] * inv_l,
                           acc[4 * d4 + 3] * inv_l);
  }
  p.lse[(long long)bh * p.L + qi] = m_run + logf(l_run);
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

template <int DH, bool kDropout>
int launch_bwd(const AttnBwdParams& p, cudaStream_t stream) {
  const int smem = bwd_smem_floats<DH>() * (int)sizeof(float);
  cudaError_t err =
      cudaFuncSetAttribute(attn_bwd_kernel<DH, kDropout>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  attn_bwd_kernel<DH, kDropout><<<(unsigned)(p.B * p.H), kKT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// the dropout-free instantiations carry no hash code at all
template <int DH>
int launch_bwd(const AttnBwdParams& p, cudaStream_t stream) {
  return p.dr.on ? launch_bwd<DH, true>(p, stream) : launch_bwd<DH, false>(p, stream);
}

template <int DH>
void launch_fwd(const AttnParams& p, dim3 grid, cudaStream_t stream) {
  if (p.dr.on) attn_fwd_kernel<DH, true><<<grid, kBQ, 0, stream>>>(p);
  else attn_fwd_kernel<DH, false><<<grid, kBQ, 0, stream>>>(p);
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
  const dim3 grid((unsigned)(B * H), (unsigned)((L + kBQ - 1) / kBQ));
  switch (dh) {
    case 8: launch_fwd<8>(p, grid, stream); break;
    case 16: launch_fwd<16>(p, grid, stream); break;
    case 32: launch_fwd<32>(p, grid, stream); break;
    case 64: launch_fwd<64>(p, grid, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
