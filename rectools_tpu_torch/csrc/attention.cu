// Attention forward: out = softmax(q k^T * scale + bias) v, plus the row
// logsumexp, in float32, without dropout.
//
// Replaces: rectools_tpu/ops/attention.py:104 `_attn_fwd_kernel` (Pallas; the
// forward without its counter-hash dropout, which comes with the training
// slice together with the backward kernel).
//
// Bound on an H100: f32 operations. At the serving shape B = 4096, H = 4,
// L = 100, dh = 32 the two products are 4 * B*H*L*L*dh = 21 GFLOP of f32
// FMA work, 0.31 ms at 67 TFLOP/s (non-tensor FP32), against 0.85 GB of
// q, k, v, out and lse, 0.25 ms at 3.35 TB/s. The JAX reference is exact f32,
// so the kernel uses f32 FMA and not TF32 (a tensor-core design with its own
// tolerance is later work).
//
// Design: one block per (batch*head, tile of BQ queries), one thread per
// query row. The thread keeps its q row and output accumulator in registers;
// the block walks the keys in tiles of BK rows staged in shared memory, all
// threads reading the same key row (a broadcast, no bank conflicts), and
// keeps an online softmax (running max and sum), so any L works and the
// (L, L) score matrix never reaches device memory. q, k, v and out are read
// and written through (batch, head, position) strides, so the (B, L, H, dh)
// layout of the projections needs no transpose. The additive bias is read
// through broadcast strides: a stride of 0 serves a (1, ...) batch or head
// dimension; a null bias means none. Masks are finite (-1e9), never -inf.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 128;  // queries per block = threads per block
constexpr int kBK = 32;   // keys per shared-memory tile

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
};

template <int DH>
__global__ void __launch_bounds__(kBQ) attn_fwd_kernel(const AttnParams p) {
  __shared__ __align__(16) float ks[kBK][DH];
  __shared__ __align__(16) float vs[kBK][DH];

  const int bh = blockIdx.x;
  const int b = bh / p.H;
  const int h = bh - b * p.H;
  const int qi = blockIdx.y * kBQ + threadIdx.x;
  const bool active = qi < p.L;

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
      const float4* vrow = reinterpret_cast<const float4*>(&vs[j][0]);
#pragma unroll
      for (int d4 = 0; d4 < DH / 4; ++d4) {
        const float4 t = vrow[d4];
        acc[4 * d4] = fmaf(pj, t.x, acc[4 * d4]);
        acc[4 * d4 + 1] = fmaf(pj, t.y, acc[4 * d4 + 1]);
        acc[4 * d4 + 2] = fmaf(pj, t.z, acc[4 * d4 + 2]);
        acc[4 * d4 + 3] = fmaf(pj, t.w, acc[4 * d4 + 3]);
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

}  // namespace

// Strides are in elements; the head-dim stride of q, k, v and out is 1 and
// every row start is 16-byte aligned (checked by the Python wrapper).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int attn_fwd_f32(const float* q, const float* k, const float* v, const float* bias, float* out,
                            float* lse, int B, int H, int L, int dh, long long q_sb, long long q_sh, long long q_sl,
                            long long k_sb, long long k_sh, long long k_sl, long long v_sb, long long v_sh,
                            long long v_sl, long long o_sb, long long o_sh, long long o_sl, long long bias_sb,
                            long long bias_sh, float scale, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || L <= 0) return 0;
  const AttnParams p{q,    k,    v,    bias, out,  lse,  B,    H,       L,       q_sb, q_sh, q_sl,
                     k_sb, k_sh, k_sl, v_sb, v_sh, v_sl, o_sb, o_sh, o_sl, bias_sb, bias_sh, scale};
  const dim3 grid((unsigned)(B * H), (unsigned)((L + kBQ - 1) / kBQ));
  switch (dh) {
    case 8: attn_fwd_kernel<8><<<grid, kBQ, 0, stream>>>(p); break;
    case 16: attn_fwd_kernel<16><<<grid, kBQ, 0, stream>>>(p); break;
    case 32: attn_fwd_kernel<32><<<grid, kBQ, 0, stream>>>(p); break;
    case 64: attn_fwd_kernel<64><<<grid, kBQ, 0, stream>>>(p); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
