// The softmax-CE gradients on bf16 towers (kernel 7's bf16 forms) on Hopper's
// warpgroup products: one engine of two roles, a ds walk and a di walk, each
// keeping its accumulator and its probability tile in registers for its whole
// walk, fed by TMA through a ring of shared-memory stages.
//
// Replaces, for bf16 inputs: rectools_tpu/ops/softmax_lse.py:643
// `_ce_grads_z_fused_kernel` (kernel 7): with the f32 logits s . items^T, P =
// exp(logit - z) and D = coeff * onehot(y) in f32, the probability operand
// (P - D) rounded to bf16 (ties to even) before both products (:672-693), ds =
// (P - D) items and di = (P - D)^T s summed in f32. Its two port forms:
// - `ce_fused_bf16` (the one pass, launch key `ce_grads_fused_bf16`): one
//   launch of both roles. The ds units write one ds partial per 2,048-row item
//   chunk (ops/softmax_lse.py FUSED_BWD_CHUNK), the chunk's f32 sum rounded
//   to bf16 once (JAX's BF16_DS_PARTIALS, :456-473; f32 when off), which the
//   caller sums in f32 in chunk order; the di units write di whole in f32.
// - `ce_ds_bf16` + `ce_di_bf16` (its two launches, JAX has no such form):
//   each ds unit walks one item chunk of ops/softmax_lse.py `split_bwd_plan`
//   (a whole number of 2,048-row steps), rounds each step's f32 sum to bf16
//   and adds it to the chunk's f32 partial in device memory (its own entries);
//   the caller sums the chunks in order. `ce_di_bf16` is the di role alone.
// And :591 `_grads_z_fused_kernel` (kernel 12; JAX's kernel 7 is kernel 12
// with the label correction fused in): `grads_z_fused_bf16` (launch key of
// the same name) is the one pass without the label term (kLabel false): P =
// exp(logit - z) in f32 rounded to bf16 once before both products, the same
// ds partials (:818-820) and di whole in f32. The form drops coeff and the
// labels from the ds role's registers and from the di role's staged row
// vectors (z alone, 256 bytes a stage); with coeff = 0 kernel 7's form gives
// its bits. It replaced softmax_lse_bf16.cu's one pass (`mma.sync`, di
// partials per group of session tiles summed by the caller): 16.23 / 6.10 /
// 2.18 ms at D = 256 / 128 / 16 at 51,200 x 15,872 on an NVIDIA H100 80GB
// HBM3 at 700 W (PERF.md section 6).
// Rows past the towers load as zeros. In the ds role item columns past N get
// P forced to 0 (the NaN rule of :636-640) and session rows past M get z =
// +inf and coeff = 0; in the di role an item row past N is never written (its
// weights reach only its own row) and a session row past M loads with z =
// coeff = 0, so each of its terms is P times a zero row. No float atomics:
// one writer per output entry, every run the same bits.
//
// The roles. A block is two consumer warpgroups and one producer warpgroup
// (384 threads, one block per multiprocessor). Each consumer warpgroup owns 64
// resident rows (a 64-row tile staged once) and walks the block's streamed
// 64-row tiles:
// - ds unit (block = 128 session rows x an item range): resident sessions,
//   streamed item tiles. Product 1 logits (64 x 64) = s items^T, A and B read
//   K-major from shared memory; the weights (P - D) with the rows' z, coeff,
//   label in registers; product 2 ds (64 x D) += (P - D) items, A the bf16
//   weights in registers, B the same item tile read MN-major.
// - di unit (block = 128 item rows, every session tile): resident items,
//   streamed session tiles with their z, coeff and labels staged beside
//   them. Product 1 logits^T = items s^T; product 3 di (64 x D) += (P - D)^T
//   s, B the same session tile read MN-major.
// Each logit is thus computed twice, in transposed orientations; were its f32
// sums to part in the last bit, a bf16 (P - D) could round apart between the
// roles. tools/ce_grads_bf16_variants.py's `probe` variant writes both roles'
// (P - D): at 51,200 x 15,872 they agree in every entry (PERF.md section 6).
// In a `wgmma` m64nNk16 accumulator, thread (warp w of its warpgroup, lane =
// 4 g + t) holds d[4 j + 2 h + e] at row 16 w + g + 8 h, column 8 j + 2 t + e;
// its bf16 A fragment of depth step kk packs d[8 kk + 0 .. 8 kk + 7] pairwise,
// so the weights never leave the thread.
//
// Staging: tiles are bf16, 64 rows, in column blocks of min(128, 2 D) bytes a
// row (the TMA box and the swizzle span: 128-byte swizzle at D >= 64, 64-byte
// at 32, 32-byte at 16), each block 1,024-byte aligned, as `wgmma` reads the
// same swizzle. Rows past the tensor load as zeros (TMA's out-of-bounds fill).
// One thread of the producer warpgroup issues the loads on `mbarrier`s (a
// full and an empty barrier per stage, four stages); `setmaxnreg` moves
// registers from the producer warpgroup (24 a thread) to the consumers (240,
// the most the launch's 168 a thread allow): at D = 256 a consumer holds 128
// accumulator, 32 logit and 16 weight registers. Without it ptxas holds every
// thread at 168 and spills about 1.8 kilobytes at D = 256. The ds role is the
// tight one: its rows' z, coeff and label stay in registers, so its row
// indices are 32-bit (TMA's coordinates are too), the unit is worked out
// after `setmaxnreg` (nothing live across it) and its first rounded step is
// told by the tile index, not a flag: with these, and 240 registers, ptxas
// keeps 0 bytes of stack and no spill at every D (at 232, or with 64-bit
// rows, it spilled 108-294 bytes at D = 256; tools/ce_grads_bf16_variants.py
// prints each build's stack and spill).
// Shared memory a block at D = 16 / 128 / 256: 17,408 / 103,424 / 201,728 bytes.
//
// Bound on an H100 at 51,200 x 15,872, D = 256: the function is three
// products, 3 x 2 M N D = 1.25 TFLOP, 1.26 ms at 989 TFLOP/s bf16; this design
// does four (product 1 in each role), 1.68 ms, and each exp twice (2 x 8.1e8
// at the SFUs' 4.18e12/s, 0.39 ms, which at D = 16 bounds it). In exchange no
// accumulator is spilled to device memory and no probability tile is staged.
// chip_smoke.py's `bf16` and `bf16 wide` lines print the times beside both
// bounds and the library call.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

#include "tc_tile.cuh"
#include "bf16_tile.cuh"

constexpr int kTileRows = 64;  // rows of every tile: a consumer's resident rows, a streamed tile
constexpr int kConsumers = 2;  // consumer warpgroups a block
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup, one thread of which loads
constexpr int kStages = 4;
// setmaxnreg: the registers a thread of the producer warpgroup keeps and a
// consumer takes, from the 168 a thread at launch (65,536 / 384)
constexpr int kLaunchRegs = 168, kProducerRegs = 24, kConsumerRegs = 240;
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= kThreads * kLaunchRegs,
              "setmaxnreg moves registers within the block's launch allocation");
// a producer's wait longer than this many clocks (about 10 s) is a fault: trap, never hang
constexpr long long kHangClocks = 20000000000LL;

// a tile of width D as staged: column blocks of kRowBytes a row
template <int D>
struct Geo {
  static constexpr int kRowBytes = 2 * D < 128 ? 2 * D : 128;
  static constexpr int kColBlocks = 2 * D / kRowBytes;
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBlockBytes = kTileRows * kRowBytes;
  static constexpr int kTileBytes = kTileRows * 2 * D;
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;  // wgmma's swizzle code
};

// the streamed session tile's row vectors (the di role), by TMA beside it:
// zeros past M, where the tile's session rows are zeros too. kLabel: z,
// coeff and labels (kernel 7); else z alone (kernel 12)
template <bool kLabel>
struct RowVec {
  float z[kTileRows];
  float coeff[kTileRows];
  long long y[kTileRows];
};
template <>
struct RowVec<false> {
  float z[kTileRows];
};

template <int D, bool kLabel>
struct alignas(1024) Smem {
  __nv_bfloat16 resident[kConsumers][kTileRows * D];
  __nv_bfloat16 stream[kStages][kTileRows * D];
  RowVec<kLabel> vec[kStages];
  uint64_t full[kStages];
  uint64_t empty[kStages];
  uint64_t resident_full;
};

// dynamic shared memory a block takes
template <int D, bool kLabel>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<D, kLabel>);
}

// What a launch computes. Blocks [0, di_blocks) are di units of 128 item
// rows; block di_blocks + b is the ds unit of 128-row session block b %
// m_blocks and item tiles [unit_tiles * (b / m_blocks), unit_tiles * (b /
// m_blocks + 1)), writing ds partial b / m_blocks of ds_out, (units, M, D):
// - ds_mode 0: its f32 sum, once;
// - ds_mode 1: its f32 sum rounded to bf16, once (bf16 ds_out);
// - ds_mode 2: each step of step_tiles item tiles summed in f32, rounded to
//   bf16 and added to the f32 partial (the first step stores).
struct Params {
  const float* z;
  const long long* y;
  const float* coeff;
  void* ds_out;
  float* di_out;
  int M, N;  // below kMaxRows: TMA's coordinates are 32-bit, and so is every row index below
  int di_blocks, m_blocks, unit_tiles, step_tiles, ds_mode;
};
// rows a launch takes, so that a tile's rows past M or N stay within an int
constexpr long long kMaxRows = (1LL << 31) - 2 * kConsumers * kTileRows;

// What block blockIdx.x walks: its role, its resident rows [res_row0, res_row0
// + 128), its streamed tiles [t_begin, t_begin + n_tiles) and, a ds unit, the
// ds partial it writes
struct Unit {
  bool di;
  int res_row0, t_begin, n_tiles, unit;
};

__device__ __forceinline__ Unit unit_of(const Params& p) {
  Unit u;
  u.di = (int)blockIdx.x < p.di_blocks;
  if (u.di) {
    u.res_row0 = (int)blockIdx.x * kConsumers * kTileRows;
    u.t_begin = 0;
    u.n_tiles = (p.M + kTileRows - 1) / kTileRows;
    u.unit = 0;
  } else {
    const int b = (int)blockIdx.x - p.di_blocks;
    const int item_tiles = (p.N + kTileRows - 1) / kTileRows;
    u.unit = b / p.m_blocks;
    u.res_row0 = (b % p.m_blocks) * kConsumers * kTileRows;
    u.t_begin = u.unit * p.unit_tiles;
    u.n_tiles = item_tiles - u.t_begin < p.unit_tiles ? item_tiles - u.t_begin : p.unit_tiles;
  }
  return u;
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// wait until the barrier's phase of this parity has completed. kGuard (the
// producer's waits): trap after kHangClocks instead of hanging, so that a
// block whose consumers never release a stage fails; the consumers' waits
// keep no guard, whose clock and trap cost registers and time at D = 256
// (tools/ce_grads_bf16_variants.py `guarded_consumers`)
template <bool kGuard>
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  long long start = 0;
  for (int spins = 0;; ++spins) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if constexpr (kGuard) {
      if (spins == 0) start = clock64();
      if ((spins & 1023) == 1023 && clock64() - start > kHangClocks) __trap();
    }
  }
}

// rows [y, y + 64), columns [x, x + box) of the map's 2-d tensor into dst, on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x, int y) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(y), "r"(smem_u32(bar))
      : "memory");
}

// entries [x, x + 64) of the map's 1-d tensor into dst, on bar
__device__ __forceinline__ void tma_load_1d(void* dst, const CUtensorMap* map, uint64_t* bar, int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2}], [%3];" ::"r"(
          smem_u32(dst)),
      "l"((uint64_t)map), "r"(x), "r"(smem_u32(bar))
      : "memory");
}

// the 64-row tile of rows [row, row + 64), one box a column block
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const CUtensorMap* map, uint64_t* bar, int row) {
#pragma unroll
  for (int cb = 0; cb < Geo<D>::kColBlocks; ++cb)
    tma_load(reinterpret_cast<char*>(dst) + cb * Geo<D>::kBlockBytes, map, bar, cb * Geo<D>::kBoxCols, row);
}

// a shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (bits 62-63)
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo, uint64_t layout) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

// A staged tile read K-major (its rows the M or N of a product, its D
// columns the depth): 8-row groups kRowBytes * 8 apart; depth step kk
// ([16 kk, 16 kk + 16)) starts k_step(kk) 16-byte units further, 32 bytes
// into a swizzled row or in the next column block.
template <int D>
__device__ __forceinline__ uint64_t desc_k(const void* tile) {
  return smem_desc(tile, 16, 8 * Geo<D>::kRowBytes, Geo<D>::kLayout);
}
template <int D>
__host__ __device__ constexpr uint64_t k_step(int kk) {
  return ((32 * kk) / Geo<D>::kRowBytes * Geo<D>::kBlockBytes + (32 * kk) % Geo<D>::kRowBytes) >> 4;
}

// A staged tile read MN-major as B (its rows the depth, its D columns the N):
// 8-row groups kRowBytes * 8 apart, column blocks kBlockBytes apart; depth
// step kk (rows [16 kk, 16 kk + 16)) starts mn_step(kk) 16-byte units further.
template <int D>
__device__ __forceinline__ uint64_t desc_mn(const void* tile) {
  return smem_desc(tile, Geo<D>::kBlockBytes, 8 * Geo<D>::kRowBytes, Geo<D>::kLayout);
}
template <int D>
__host__ __device__ constexpr uint64_t mn_step(int kk) {
  return (16 * kk * Geo<D>::kRowBytes) >> 4;
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// pin registers that an asynchronous product reads or writes to this point
template <int n>
__device__ __forceinline__ void pin(float (&r)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) asm volatile("" : "+r"(r[i][q])::"memory");
}

// d (64 x 64 f32) = (scale_d ? d : 0) + A B^T, A and B K-major bf16 tiles in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// d (64 x N f32) = (scale_d ? d : 0) + A B, A (64 x 16) bf16 fragments in
// registers, B (16 x N) from shared memory: MN-major if kTransB, else K-major
template <int N, int kTransB>
struct Rs;

template <int kTransB>
struct Rs<16, kTransB> {
  static __device__ __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Rs<32, kTransB> {
  static __device__ __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Rs<64, kTransB> {
  static __device__ __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Rs<128, kTransB> {
  static __device__ __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
};

template <int kTransB>
struct Rs<256, kTransB> {
  static __device__ __forceinline__ void mma(float (&d)[128], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB));
  }
};

// ------------------------------------------------------------ the roles

// the TMA maps of a launch: the towers, and the session rows' z, coeff and labels
struct Maps {
  CUtensorMap s, items, z, coeff, y;
};

// Walk the unit's streamed tiles, the resident tiles first: the producer
// thread's side. A di unit's stage also takes the session tile's z and, with
// kLabel, its coeff and labels.
template <int D, bool kLabel>
__device__ __forceinline__ void produce(Smem<D, kLabel>& sm, const Maps& maps, const Unit& u) {
  bar_arrive_tx(&sm.resident_full, kConsumers * Geo<D>::kTileBytes);
#pragma unroll
  for (int c = 0; c < kConsumers; ++c)
    load_tile<D>(sm.resident[c], u.di ? &maps.items : &maps.s, &sm.resident_full, u.res_row0 + kTileRows * c);
  for (int t = 0; t < u.n_tiles; ++t) {
    const int stage = t % kStages;
    bar_wait<true>(&sm.empty[stage], ((t / kStages) & 1) ^ 1);
    const int row0 = (u.t_begin + t) * kTileRows;
    bar_arrive_tx(&sm.full[stage], Geo<D>::kTileBytes + (u.di ? (int)sizeof(RowVec<kLabel>) : 0));
    load_tile<D>(sm.stream[stage], u.di ? &maps.s : &maps.items, &sm.full[stage], row0);
    if (u.di) {
      tma_load_1d(sm.vec[stage].z, &maps.z, &sm.full[stage], row0);
      if constexpr (kLabel) {
        tma_load_1d(sm.vec[stage].coeff, &maps.coeff, &sm.full[stage], row0);
        tma_load_1d(sm.vec[stage].y, &maps.y, &sm.full[stage], row0);
      }
    }
  }
}

// the ds rows of a unit's (or a rounded step's) sum into ds partial `unit` (ds_mode of Params)
template <int D>
__device__ __forceinline__ void store_ds(const Params& p, const float (&acc)[D / 2], const int (&row)[2], int unit,
                                        int t4, bool first_step) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row[h] >= p.M) continue;
    const long long base = ((long long)unit * p.M + row[h]) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (p.ds_mode == 1) {
        *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(p.ds_out) + base + col) = bt::pack(v.x, v.y);
        continue;
      }
      float* out = static_cast<float*>(p.ds_out) + base + col;
      if (p.ds_mode == 2) {
        v = make_float2(bt::round_bf16(v.x), bt::round_bf16(v.y));
        if (!first_step) {
          const float2 run = *reinterpret_cast<const float2*>(out);
          v = make_float2(run.x + v.x, run.y + v.y);
        }
      }
      *reinterpret_cast<float2*>(out) = v;
    }
  }
}

// The weights of a logits tile: (P - D) in f32 from the logits x (P alone
// without kLabel), rounded to bf16 as product 2's A fragments (depth step kk =
// tile columns [16 kk, 16 kk + 16)). ds: item columns, the rows' z, coeff and
// label in registers, 0 past N; di: session columns, their z, coeff and label
// staged in vec (an item row past N loads as zeros, and its weights reach
// only its own di row, never written).
template <bool kDi, bool kTail, bool kLabel>
__device__ __forceinline__ void weigh(const float (&x)[32], uint32_t (&a)[4][4], int t4, const RowVec<kLabel>& vec,
                                      const int (&row)[2], const float (&zr)[2], const float (&cr)[2],
                                      const int (&lab)[2], int n_left) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    if constexpr (kDi) {
      const float2 zc = *reinterpret_cast<const float2*>(vec.z + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pw0 = expf(x[4 * j + 2 * h] - zc.x), pw1 = expf(x[4 * j + 2 * h + 1] - zc.y);
        if constexpr (kLabel) {
          const float2 cc = *reinterpret_cast<const float2*>(vec.coeff + c);
          const longlong2 yc = *reinterpret_cast<const longlong2*>(vec.y + c);
          if (row[h] == yc.x) pw0 -= cc.x;
          if (row[h] == yc.y) pw1 -= cc.y;
        }
        a[j >> 1][2 * (j & 1) + h] = bt::pack(pw0, pw1);
      }
    } else {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float pw0 = expf(x[4 * j + 2 * h] - zr[h]), pw1 = expf(x[4 * j + 2 * h + 1] - zr[h]);
        if constexpr (kLabel) {
          if (c == lab[h]) pw0 -= cr[h];
          if (c + 1 == lab[h]) pw1 -= cr[h];
        }
        if (kTail && c >= n_left) pw0 = 0.f;
        if (kTail && c + 1 >= n_left) pw1 = 0.f;
        a[j >> 1][2 * (j & 1) + h] = bt::pack(pw0, pw1);
      }
    }
  }
}

// The consumer warpgroups' side: kDi walks session tiles against resident
// item rows, else item tiles against resident session rows (unit = the ds
// partial it writes); kLabel: with the label term. Per tile: product 1, the
// weights, product 2 or 3, each product waited for where its result is read;
// the two warpgroups of a block interleave, one forming weights while the
// other's products run.
template <int D, bool kDi, bool kLabel>
__device__ __forceinline__ void consume(Smem<D, kLabel>& sm, const Params& p, const Unit& u) {
  const int wg = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31, t4 = lane & 3;
  int row[2];  // the thread's resident rows: sessions (ds) or items (di)
  row[0] = u.res_row0 + kTileRows * wg + 16 * w + (lane >> 2);
  row[1] = row[0] + 8;
  // ds: the rows' z, coeff and label (+inf, 0, none past M); a label is an item row, below kMaxRows
  float zr[2] = {0.f, 0.f}, cr[2] = {0.f, 0.f};
  int yr[2] = {-1, -1};
  if constexpr (!kDi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool ok = row[h] < p.M;
      zr[h] = ok ? p.z[row[h]] : INFINITY;
      if constexpr (kLabel) {
        cr[h] = ok ? p.coeff[row[h]] : 0.f;
        yr[h] = ok ? (int)p.y[row[h]] : -1;
      }
    }
  }
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  bar_wait<false>(&sm.resident_full, 0);
  const __nv_bfloat16* res = sm.resident[wg];

  for (int t = 0; t < u.n_tiles; ++t) {
    const int stage = t % kStages;
    bar_wait<false>(&sm.full[stage], (t / kStages) & 1);
    const __nv_bfloat16* tile = sm.stream[stage];
    const int col0 = (u.t_begin + t) * kTileRows;  // the tile's first item (ds) or session (di)
    int lab[2] = {-1, -1}, n_left = kTileRows;         // ds: the rows' labels as tile columns, the catalog's end
    if constexpr (!kDi) {
      n_left = p.N - col0 < kTileRows ? p.N - col0 : kTileRows;
      if constexpr (kLabel) {
#pragma unroll
        for (int h = 0; h < 2; ++h) lab[h] = yr[h] >= col0 && yr[h] < col0 + kTileRows ? yr[h] - col0 : -1;
      }
    }
    // product 1: the logits of the resident rows against the streamed tile's
    float x[32];
    const uint64_t da = desc_k<D>(res), db = desc_k<D>(tile);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64(x, da + k_step<D>(kk), db + k_step<D>(kk), kk > 0);
    wg_commit();
    wg_wait_all();
    pin(x);

    uint32_t a[4][4];
    if constexpr (kDi)
      weigh<true, false, kLabel>(x, a, t4, sm.vec[stage], row, zr, cr, lab, n_left);
    else if (n_left < kTileRows)
      weigh<false, true, kLabel>(x, a, t4, sm.vec[stage], row, zr, cr, lab, n_left);
    else
      weigh<false, false, kLabel>(x, a, t4, sm.vec[stage], row, zr, cr, lab, n_left);

    // product 2 (ds += (P - D) items) or 3 (di += (P - D)^T s) on the same tile read MN-major
    const uint64_t dm = desc_mn<D>(tile);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) Rs<D, 1>::mma(acc, a[kk], dm + mn_step<D>(kk), 1);
    wg_commit();
    wg_wait_all();
    pin(acc);
    pin(a);
    __syncwarp();
    if (lane == 0) bar_arrive(&sm.empty[stage]);

    if constexpr (!kDi) {
      // a ds unit's end, or a rounded step's: its rows of ds partial `unit`
      if (t + 1 == u.n_tiles || (p.ds_mode == 2 && (t + 1) % p.step_tiles == 0)) {
        store_ds<D>(p, acc, row, u.unit, t4, t < p.step_tiles);  // the unit's first step: store
#pragma unroll
        for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
      }
    }
  }
  if constexpr (kDi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= p.N) continue;
      float* out = p.di_out + (long long)row[h] * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(out + 8 * j + 2 * t4) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

template <int D, bool kLabel>
__global__ void __launch_bounds__(kThreads, 1) ce_grads_bf16_kernel(const __grid_constant__ Maps maps, const Params p) {
  // the block's dynamic shared memory starts 1,024-byte aligned (the swizzle's atom; checked), and a cast that
  // keeps it a shared-memory pointer keeps every access below an ld.shared / st.shared
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem<D, kLabel>& sm = *reinterpret_cast<Smem<D, kLabel>*>(smem_raw);
  if (threadIdx.x == 0 && (smem_u32(smem_raw) & 1023) != 0) __trap();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      bar_init(&sm.full[s], 1);                // the producer thread
      bar_init(&sm.empty[s], 4 * kConsumers);  // the consumer warps
    }
    bar_init(&sm.resident_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the unit is worked out after setmaxnreg in each branch, so that nothing is live across it
  if (threadIdx.x >= 128 * kConsumers) {  // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 128 * kConsumers) produce<D, kLabel>(sm, maps, unit_of(p));
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const Unit u = unit_of(p);
    if (u.di)
      consume<D, true, kLabel>(sm, p, u);
    else
      consume<D, false, kLabel>(sm, p, u);
  }
}

// ------------------------------------------------------------ launches

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (nothing
// links libcuda); null if the driver has none
EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// the TMA map of a contiguous (rows, D) bf16 matrix: 64-row boxes of one column block, swizzled as staged
template <int D>
bool tensor_map(CUtensorMap* map, const void* base, long long rows) {
  using G = Geo<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)D, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)D * 2};
  const cuuint32_t box[2] = {(cuuint32_t)G::kBoxCols, (cuuint32_t)kTileRows};
  const cuuint32_t unit_strides[2] = {1, 1};
  const CUtensorMapSwizzle swizzle = G::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : G::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                          : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box, unit_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the TMA map of a (rows,) vector (16-byte aligned): 64-entry boxes, zeros past its end
bool vector_map(CUtensorMap* map, const void* base, long long rows, CUtensorMapDataType type) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[1] = {(cuuint64_t)rows};
  const cuuint64_t strides[1] = {0};
  const cuuint32_t box[1] = {(cuuint32_t)kTileRows};
  const cuuint32_t unit_strides[1] = {1};
  return encode(map, type, 1, const_cast<void*>(base), dims, strides, box, unit_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// A launch of the di role (with_di) and of ds units over ds_ranges item ranges
// of unit_tiles tiles (0: none), di units first: each walks every session
// tile, the ds units fill the card around them. kLabel: kernel 7 (z, coeff
// and labels), else kernel 12 (z alone; p.coeff and p.y unread).
template <int D, bool kLabel>
int launch(const void* s, const void* items, Params p, bool with_di, long long ds_ranges, cudaStream_t stream) {
  auto kernel = ce_grads_bf16_kernel<D, kLabel>;
  Maps maps = {};
  if (!tensor_map<D>(&maps.s, s, p.M) || !tensor_map<D>(&maps.items, items, p.N) ||
      !vector_map(&maps.z, p.z, p.M, CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
    return (int)cudaErrorInvalidValue;
  if (kLabel && (!vector_map(&maps.coeff, p.coeff, p.M, CU_TENSOR_MAP_DATA_TYPE_FLOAT32) ||
                 !vector_map(&maps.y, p.y, p.M, CU_TENSOR_MAP_DATA_TYPE_INT64)))
    return (int)cudaErrorInvalidValue;
  // setmaxnreg.inc takes what setmaxnreg.dec gives back: refuse a build whose launch allocation would leave the
  // consumers waiting for registers
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if (128 * kProducerRegs + 128 * kConsumers * kConsumerRegs > kThreads * attr.numRegs)
    return (int)cudaErrorInvalidConfiguration;
  p.di_blocks = with_di ? (int)ceil_div(p.N, kConsumers * kTileRows) : 0;
  p.m_blocks = (int)ceil_div(p.M, kConsumers * kTileRows);
  const long long grid = p.di_blocks + p.m_blocks * ds_ranges;
  const int smem = smem_bytes<D, kLabel>();
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// fn(std::integral_constant<int, D>{}) for D in {16, 32, 64, 128, 256}, else cudaErrorInvalidValue
template <class Fn>
int by_width(int D, Fn fn) {
  switch (D) {
    case 16: return fn(std::integral_constant<int, 16>{});
    case 32: return fn(std::integral_constant<int, 32>{});
    case 64: return fn(std::integral_constant<int, 64>{});
    case 128: return fn(std::integral_constant<int, 128>{});
    case 256: return fn(std::integral_constant<int, 256>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const float* z, const long long* y, const float* coeff, void* ds_out, float* di_out, long long M,
                   long long N) {
  Params p = {};  // the entries refuse M or N of kMaxRows or more
  p.z = z;
  p.y = y;
  p.coeff = coeff;
  p.ds_out = ds_out;
  p.di_out = di_out;
  p.M = (int)M;
  p.N = (int)N;
  p.unit_tiles = 1;
  p.step_tiles = 1;
  return p;
}

// the one pass of kernel 7 (kLabel) or 12: both roles in one launch, ds partials per chunk_rows item rows (bf16
// when bf16_partials), di whole
template <bool kLabel>
int one_pass(const void* s, const void* items, const float* z, const long long* y, const float* coeff, void* ds_part,
             float* di, long long M, long long N, int D, long long chunk_rows, int bf16_partials,
             cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M >= kMaxRows || N >= kMaxRows) return (int)cudaErrorInvalidValue;
  if (chunk_rows <= 0 || chunk_rows % kTileRows) return (int)cudaErrorInvalidValue;
  Params p = make_params(z, y, coeff, ds_part, di, M, N);
  p.unit_tiles = (int)(chunk_rows / kTileRows);
  p.ds_mode = bf16_partials ? 1 : 0;
  return by_width(D, [&](auto w) {
    return launch<decltype(w)::value, kLabel>(s, items, p, true, ceil_div(N, chunk_rows), stream);
  });
}

}  // namespace

// Kernel 7's one pass on bf16 sessions (M, D) and items (N, D), rows 16-byte
// aligned and contiguous (checked by the Python wrapper): ds partials
// (ceil(N / chunk_rows), M, D), bf16 when bf16_partials else f32, and f32 di
// (N, D). chunk_rows a multiple of 64. z, coeff f32 (M,), y int64 (M,).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ce_fused_bf16(const void* s, const void* items, const float* z, const long long* y,
                             const float* coeff, void* ds_part, float* di, long long M, long long N, int D,
                             long long chunk_rows, int bf16_partials, cudaStream_t stream) {
  return one_pass<true>(s, items, z, y, coeff, ds_part, di, M, N, D, chunk_rows, bf16_partials, stream);
}

// Kernel 12's one pass on bf16 sessions (M, D) and items (N, D): kernel 7's
// with no label term (P = exp(logit - z)), the same partials and di. z f32
// (M,), 16-byte aligned (TMA).
extern "C" int grads_z_fused_bf16(const void* s, const void* items, const float* z, void* ds_part, float* di,
                                  long long M, long long N, int D, long long chunk_rows, int bf16_partials,
                                  cudaStream_t stream) {
  return one_pass<false>(s, items, z, nullptr, nullptr, ds_part, di, M, N, D, chunk_rows, bf16_partials, stream);
}

// Kernel 7's ds launch: f32 ds partials (n_chunks, M, D), one per item chunk
// of chunk_rows rows of ops/softmax_lse.py `split_bwd_plan`, each the sum of
// its steps of step_rows rows rounded to bf16 (0: one f32 sum, no rounding).
// chunk_rows and step_rows multiples of 64; another n_chunks returns
// cudaErrorInvalidValue.
extern "C" int ce_ds_bf16(const void* s, const void* items, const float* z, const long long* y, const float* coeff,
                          float* ds_part, long long M, long long N, int D, long long chunk_rows, long long n_chunks,
                          long long step_rows, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M >= kMaxRows || N >= kMaxRows) return (int)cudaErrorInvalidValue;
  if (chunk_rows <= 0 || chunk_rows % kTileRows || step_rows < 0 || step_rows % kTileRows ||
      ceil_div(N, chunk_rows) != n_chunks)
    return (int)cudaErrorInvalidValue;
  Params p = make_params(z, y, coeff, ds_part, nullptr, M, N);
  p.unit_tiles = (int)(chunk_rows / kTileRows);
  p.step_tiles = step_rows ? (int)(step_rows / kTileRows) : 1;
  p.ds_mode = step_rows ? 2 : 0;
  return by_width(D, [&](auto w) { return launch<decltype(w)::value, true>(s, items, p, false, n_chunks, stream); });
}

// Kernel 7's di launch: f32 di (N, D), each 64-row item tile written once.
extern "C" int ce_di_bf16(const void* s, const void* items, const float* z, const long long* y, const float* coeff,
                          float* di, long long M, long long N, int D, cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if (M >= kMaxRows || N >= kMaxRows) return (int)cudaErrorInvalidValue;
  Params p = make_params(z, y, coeff, nullptr, di, M, N);
  return by_width(D, [&](auto w) { return launch<decltype(w)::value, true>(s, items, p, true, 0, stream); });
}

// Bytes of dynamic shared memory a block takes at width D; cudaErrorInvalidValue (1) for another D. Kernel 7's
// (kernel 12's stages hold z alone: 768 bytes fewer a stage).
extern "C" int ce_grads_bf16_smem_bytes(int D) {
  return by_width(D, [&](auto w) { return smem_bytes<decltype(w)::value, true>(); });
}
