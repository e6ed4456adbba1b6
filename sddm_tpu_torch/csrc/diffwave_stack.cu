// The gated residual stack of DiffWave, f32 and bf16, sm_90a.
//
// Replaces the Pallas kernel sddm_tpu/ops/pallas/diffwave_stack.py
// ::diffwave_stack, which runs all L residual layers of the fused DiffWave
// engine (sddm_tpu/models/diffwave_fused.py) in one call and returns the
// skip sum.  For each layer l, with d = 2^(l mod cycle):
//
//   xd   = round(x + emb_l)                       (activation dtype)
//   y    = sum_k tap_k(xd) @ wconv_l[k] + cond_l  (f32; tap_k = xd shifted by
//                                                  (k-1)d, zero outside [0, T))
//   g    = round(sigmoid(y[:C]) * tanh(y[C:]))
//   rs   = g @ wrs_l + brs_l                      (f32)
//   x    = round((x + rs[:C]) * 2^-1/2)
//   skip = round(skip + round(rs[C:]))            (an add in the activation dtype)
//
// with the rounding points of diffwave_stack_reference, which the plain
// PyTorch version (sddm_tpu_torch/ops/diffwave_stack.py) transcribes.
//
// Bound.  At the served shape (B=8, T=16384, C=64, L=30, bf16) the stack
// must read cond (L x B x T x 2C x 2 B = 1.007 GB) and x0 and write the skip
// sum (16.8 MB each): 1.042 GB, 0.311 ms at 3.35 TB/s, against 258 GFLOP of
// tensor-core work, 0.26 ms at 989 TFLOP/s.  The TPU kernel kept one batch
// row (2 MiB in bf16) resident in VMEM across all L layers; an H100 block
// has 227 KB of shared memory, and even a 16-block cluster cannot hold a
// row's x ping-pong and skip sum (6 MiB), so every kernel here launches once
// per layer.  Layer l+1 reads x at +-2d, which other blocks write, so x
// ping-pongs between two [B, T, C] buffers and the skip sum is updated in
// place.  Each layer then reads cond_l (33.55 MB) and x (16.78 MB), writes
// x (16.78 MB), and reads and writes skip (33.55 MB): over the stack,
// 30 x 100.66 MB less the first layer's skip read and the last layer's x
// write, 2.99 GB, 0.89 ms at 3.35 TB/s.  That per-layer floor, not the
// 0.311 ms bound, is what a per-layer design can reach.
//
// bf16, C = 64 (the served width): layer_wgmma, built for that floor.
//   * Persistent blocks: one per SM (no more than the B x ceil(T/64) tiles);
//     block i takes tiles i, i + grid, ... of M = 64 rows of one batch row.
//     A block loads layer l's weights (wconv_l 48 KB, wrs_l 16 KB) into
//     shared memory once, with TMA: 8.4 MB a layer over 132 blocks, where
//     a block per 4 tiles read 33.5 MB.
//   * Warp roles, 3 warpgroups of 128 threads.  One producer thread (its
//     warpgroup gives registers to the consumers with setmaxnreg, 40 vs
//     232) keeps a ring of TMA loads in flight: per tile cond_l's [64, 2C],
//     the x taps, the old skip tile and emb_l[b].  When 2d <= M one window
//     of M + 2d rows (two 64-row boxes) holds all three taps and the ring
//     has S = 4 stages of 40 KB; above, three 64-row boxes at -d, 0, +d and
//     S = 3 stages of 48 KB.  The x and skip maps are 3-D [B, T, C], so
//     TMA's zero fill stops at a batch row's edge.  Two consumer
//     warpgroups take alternate tiles, so one's gate and epilogue overlap
//     the other's products.  Each (consumer, stage) pair has its own
//     mbarrier: a barrier shared by both consumers could be waited on two
//     phases ahead by the faster one, where a parity test cannot tell.
//     The producer also issues the TMA stores (below) and issues a reused
//     stage's x, skip and emb loads before the previous stores have read
//     the cond cells.  Layers after the first launch as programmatic
//     dependents: weights and the first stages' cond_l load while the
//     previous layer drains.
//   * Products on wgmma m64n128k16, f32 accumulators: y = taps @ wconv_l
//     (K = 3C = 192, 12 steps, each tap's steps running while the next tap
//     is formed) and rs = g @ wrs_l (K = 64, 4 steps, each running while
//     the next step's gate is taken).  B is the weights in 128B-swizzled
//     shared memory, N contiguous (the transpose bit).  A comes from
//     registers: ldmatrix of the staged x rows, + emb_l with one packed
//     bf16 add (the exact sum rounded once, which equals flax's f32 sum
//     rounded), and zero where the source row lies outside [0, T) (TMA
//     fills x = 0 there, which would give emb, not the zero of flax's
//     padded x + emb).  The gate is taken on the accumulators (a thread
//     holds columns c and c + C), with __expf and __fdividef in the sigmoid
//     (a few f32 ulps before the bf16 rounding) and tanhf, and rounded to
//     bf16 straight into the A registers of the second product.  No global
//     load into registers is in flight at a wgmma.fence, which waits for
//     all of them: every input of a tile comes through the stage.
//   * Epilogue: x and skip are written over the tile's cond_l cells (each
//     thread rewrites only the cells it read), and the producer stores
//     them with TMA, which also clips a ragged last tile.  The last layer
//     writes no x.  No atomics: the same call gives the same bits.
//   * Shared memory: 64 KB of weights + a 160 KB ring + barriers, one
//     block per SM.
// bf16, C = 32: layer_bf16, the earlier design (mma.sync m16n8k16, taps
// staged by every thread, weights staged per block of 4 tiles); its 64 B
// rows would need other swizzles, and no served model has C = 32.
// f32: layer_f32, FMA in true f32 (no TF32) on the CUDA cores, the tight
// parity check, not a served path.
//
// C interface, loaded with ctypes: one launcher per type runs all L layers
// on the given stream without synchronising, allocates nothing, and returns
// the first nonzero CUDA error (0 when every launch was taken).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kRsqrt2 = 0.70710678118654752440f;
constexpr int kTilesPerBlock = 4;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  ldsm_x4(r, (uint32_t)__cvta_generic_to_shared(p));
}

// ------------------------------------------------- bf16, C = 64: Hopper ----
constexpr int kM = 64;          // rows of T per tile: one wgmma M
constexpr int kConsumers = 2;   // consumer warpgroups
constexpr int kThreadsWg = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kBox = 64 * 64 * 2;  // one TMA box: 64 rows of 64 bf16 (128 B, one swizzle row)
// The ring holds up to 20 boxes: 4 stages of 5 when 2d <= M (x as one
// window of two boxes), else 3 stages of 6 (x as three taps).  A stage is
// cond_l [2 column halves][M rows][64] (then x_out | skip), x, and the old
// skip [M rows][64].
constexpr int kMaxStages = 4;
constexpr int kCond = 0, kX = 2 * kBox;
// shared memory, bytes from a 1024-aligned base (the 128B swizzle repeats every 1024 B)
constexpr int kWconv = 0;                 // wconv_l: [2 column halves][3C rows][64]
constexpr int kWrs = 6 * kBox;            // wrs_l:   [2 column halves][C rows][64]
constexpr int kRing = 8 * kBox;
constexpr int kEmb = kRing + 20 * kBox;   // emb_l[b] of each stage's tile, [64]
constexpr int kBars = kEmb + kMaxStages * 128;  // full[consumer][stage], done[stage], weights
constexpr int kSmemWg = kBars + 8 * ((kConsumers + 1) * kMaxStages + 1) + 1024;

__device__ __forceinline__ uint32_t lds32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void sts32(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// the byte offset of (row, 16-byte chunk) in a 128B-swizzled tile of 128-byte rows
__device__ __forceinline__ uint32_t swz(int row, int chunk) {
  return (uint32_t)(row * 128 + ((chunk ^ (row & 7)) << 4));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// cond_l's tiles, read once: evicted from L2 first, before the x rows that
// neighbouring tiles read again
__device__ __forceinline__ void tma_load_4d_once(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                                 int c0, int c1, int c2, int c3) {
  asm volatile(
      "{\n"
      ".reg .b64 policy;\n"
      "createpolicy.fractional.L2::evict_first.b64 policy, 1.0;\n"
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%3, %4, %5, %6}], [%2], policy;\n"
      "}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// a contiguous copy of `bytes` (a multiple of 16) completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(src), "r"(c0), "r"(c1), "r"(c2)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait0() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// keep the compiler from moving accesses of wgmma's registers across the asm around it
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B operand: K x 128 bf16 in two 64-column halves `lbo` bytes apart, each
// [K rows][64] with 128 B rows, 128B swizzle, N contiguous (MN-major); the
// 8-row groups of K are 1024 B apart.
__device__ __forceinline__ uint64_t desc_b(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128, f32) (+)= a (64 x 16 bf16, registers) @ b (16 x 128 bf16, shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// round(a + b) of two bf16 pairs.  The exact sum rounded once equals the
// f32 sum rounded to bf16, as the plain version computes it: an f32 sum of
// two bf16 values is inexact only when their exponents differ by more than
// 16, and then the smaller is below half a bf16 ulp of the larger.
__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 r = __hadd2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                             *reinterpret_cast<const __nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&r);
}

// sigmoid with the approximate exp and division (a few f32 ulps; the gate is
// rounded to bf16 after it)
__device__ __forceinline__ float sigmoid_fast(float v) { return __fdividef(1.0f, 1.0f + __expf(-v)); }

// One layer.  tm_x: x in, tm_xout: x out, tm_skip: the skip sum, all 3-D
// [B, T, C]; tm_cond: 4-D [L, B, T, 2C]; tm_wconv: 2-D [L 3C, 2C]; tm_wrs:
// 2-D [L C, 2C]; every box 64 x 64, 128B swizzle.  emb, brs: this layer's
// [B, C] and [2C].
__global__ void __launch_bounds__(kThreadsWg, 1)
    layer_wgmma(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_xout,
                const __grid_constant__ CUtensorMap tm_skip, const __grid_constant__ CUtensorMap tm_cond,
                const __grid_constant__ CUtensorMap tm_wconv, const __grid_constant__ CUtensorMap tm_wrs,
                const bf16* __restrict__ emb, const bf16* __restrict__ brs, int T,
                int tiles_per_row, int ntiles, int layer, int d, int first, int write_x) {
  constexpr int kC = 64;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = ((uint32_t)__cvta_generic_to_shared(smem_raw) + 1023u) & ~1023u;
  const uint32_t full0 = base + kBars, done0 = full0 + 8 * kConsumers * kMaxStages;
  const uint32_t wbar = done0 + 8 * kMaxStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kConsumers * kMaxStages; ++s) mbar_init(full0 + 8 * s, 1);  // TMA bytes
    for (int s = 0; s < kMaxStages; ++s) mbar_init(done0 + 8 * s, 1);  // x_out, skip are in the stage
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const bool window = 2 * d <= kM;   // one window of M + 2d rows holds all three taps
  const int step = window ? d : kM;  // rows between a tile row's taps in the stage's x area
  const int stages = window ? 4 : 3;
  const uint32_t skip_off = kX + (window ? 2 : 3) * kBox;
  const uint32_t stage_bytes = skip_off + kBox;
  // Tile i of this block sits in stage i % stages and is consumed by
  // warpgroup i % kConsumers, which waits on its own full barrier of that
  // stage: each barrier is used by one consumer, in order, once every
  // `period` tiles, so its phase parity is never ambiguous.
  const int period = stages % kConsumers == 0 ? stages : stages * kConsumers;

  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid != 0) return;
    // the next layer's blocks may start as this layer's leave their SMs
    asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
    mbar_expect_tx(wbar, 8 * kBox);
    for (int h = 0; h < 2; ++h) {
      for (int k = 0; k < 3; ++k)
        tma_load_2d(base + kWconv + (3 * h + k) * kBox, &tm_wconv, wbar, 64 * h, (3 * layer + k) * kC);
      tma_load_2d(base + kWrs + h * kBox, &tm_wrs, wbar, 64 * h, layer * kC);
    }
    // the x_out and skip tiles of this block's i-th tile leave by TMA store
    // once its consumer is done with the stage
    auto store = [&](int i) {
      const int s = i % stages, tile = blockIdx.x + i * gridDim.x;
      const int b = tile / tiles_per_row, t0 = (tile % tiles_per_row) * kM;
      const uint32_t st = base + kRing + s * stage_bytes;
      mbar_wait(done0 + 8 * s, (i / stages) & 1);
      if (write_x) tma_store_3d(&tm_xout, st + kCond, 0, t0, b);
      tma_store_3d(&tm_skip, st + kCond + kBox, 0, t0, b);
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    };
    // tile j's loads complete on its consumer's full barrier of its stage:
    // cond_l into the cells the stores read, the rest elsewhere
    auto full = [&](int j) { return full0 + 8 * ((j % kConsumers) * kMaxStages + j % stages); };
    auto load_cond = [&](int j) {
      const int tile = blockIdx.x + j * gridDim.x;
      const int b = tile / tiles_per_row, t0 = (tile % tiles_per_row) * kM;
      const uint32_t st = base + kRing + (j % stages) * stage_bytes;
      tma_load_4d_once(st + kCond, &tm_cond, full(j), 0, t0, b, layer);
      tma_load_4d_once(st + kCond + kBox, &tm_cond, full(j), kC, t0, b, layer);
    };
    auto load_rest = [&](int j) {
      const int tile = blockIdx.x + j * gridDim.x;
      const int b = tile / tiles_per_row, t0 = (tile % tiles_per_row) * kM;
      const uint32_t st = base + kRing + (j % stages) * stage_bytes, bar = full(j);
      if (window) {
        tma_load_3d(st + kX, &tm_x, bar, 0, t0 - d, b);
        tma_load_3d(st + kX + kBox, &tm_x, bar, 0, t0 - d + kM, b);
      } else {
        for (int k = 0; k < 3; ++k) tma_load_3d(st + kX + k * kBox, &tm_x, bar, 0, t0 + (k - 1) * d, b);
      }
      if (!first) tma_load_3d(st + skip_off, &tm_skip, bar, 0, t0, b);
      bulk_load(base + kEmb + (j % stages) * 128, emb + (size_t)b * kC, 2 * kC, bar);
    };
    const uint32_t bytes = stage_bytes - (first ? kBox : 0) + 2 * kC;
    const int tiles = (ntiles - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's
    const int prefill = tiles < stages ? tiles : stages;
    // cond_l is an input of the stack: the first stages' tiles of it load
    // while the previous layer finishes; x and the skip sum are that layer's
    // (griddepcontrol.wait is a no-op when this launch waited for it in full)
    for (int j = 0; j < prefill; ++j) {
      mbar_expect_tx(full(j), bytes);
      load_cond(j);
    }
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (int j = 0; j < prefill; ++j) load_rest(j);
    for (int j = prefill; j < tiles; ++j) {
      store(j - stages);  // the stage's last tile
      mbar_expect_tx(full(j), bytes);
      load_rest(j);
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");  // the stores have read the stage
      load_cond(j);
    }
    for (int i = tiles > stages ? tiles - stages : 0; i < tiles; ++i) store(i);
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    return;
  }

  // -------------------------------------------------------------- consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  // Accumulator element 4n + 2h + e is row r0 + 8h, column 8n + 2q + e.
  const int r0 = 16 * warp + lane / 4;
  const int arow = 16 * warp + (lane & 15), achunk = lane >> 4;  // ldmatrix row addresses
  uint32_t bias[16];  // brs_l at columns 8n + 2q, + 1: res (n < 8), skip (n >= 8)
#pragma unroll
  for (int n = 0; n < 16; ++n) bias[n] = *reinterpret_cast<const uint32_t*>(brs + 8 * n + 2 * q);
  mbar_wait(wbar, 0);

  for (int j = wg;; j += kConsumers) {
    const int tile = blockIdx.x + j * gridDim.x;
    if (tile >= ntiles) break;
    const int s = j % stages;
    const int t0 = (tile % tiles_per_row) * kM;
    const uint32_t st = base + kRing + s * stage_bytes;
    // No global load into registers may be in flight at a wgmma.fence, which
    // waits for every outstanding register write: a tile's inputs come
    // through the stage.
    mbar_wait(full0 + 8 * (wg * kMaxStages + s), (j / period) & 1);
    uint32_t e[4][2];  // emb_l[b] at columns 16kk + 2q (+ 8)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      e[kk][0] = lds32(base + kEmb + s * 128 + 32 * kk + 4 * q);
      e[kk][1] = lds32(base + kEmb + s * 128 + 32 * kk + 16 + 4 * q);
    }

    // y = taps @ wconv_l.  A of tap k: round(x + emb), zero where the source
    // row t + (k-1)d lies outside [0, T); each tap's products run while the
    // next tap is formed.
    float acc[64];
    uint32_t a[3][4][4];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const int src = t0 + r0 + (k - 1) * d;
      const bool v0 = (unsigned)src < (unsigned)T, v1 = (unsigned)(src + 8) < (unsigned)T;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int r = arow + k * step;
        ldsm_x4(a[k][kk], st + kX + swz(r, 2 * kk + achunk));
        a[k][kk][0] = v0 ? add_bf16x2(a[k][kk][0], e[kk][0]) : 0u;
        a[k][kk][1] = v1 ? add_bf16x2(a[k][kk][1], e[kk][0]) : 0u;
        a[k][kk][2] = v0 ? add_bf16x2(a[k][kk][2], e[kk][1]) : 0u;
        a[k][kk][3] = v1 ? add_bf16x2(a[k][kk][3], e[kk][1]) : 0u;
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, a[k][kk], desc_b(base + kWconv + (4 * k + kk) * 2048, 3 * kBox), k + kk > 0);
    }
    wgmma_commit();
    uint32_t cy[8][2], cz[8][2];  // cond_l at this thread's cells, read while the products run
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        cy[n][h] = lds32(st + kCond + swz(r0 + 8 * h, n) + 4 * q);
        cz[n][h] = lds32(st + kCond + kBox + swz(r0 + 8 * h, n) + 4 * q);
      }
    }
    wgmma_wait0();
    fence_regs(acc);

    // + cond_l, gate, round to bf16 into the A registers of rs = g @ wrs_l:
    // k-step kk takes columns 16kk.. (n = 2kk) and 16kk + 8.. (n = 2kk + 1),
    // and runs while the next k-step's gate is taken
    float rs[64];
    uint32_t ga[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int n = 2 * kk + i / 2, h = i % 2;
        const float2 y = bf2_to_f2(cy[n][h]), z = bf2_to_f2(cz[n][h]);
        const float g0 = sigmoid_fast(acc[4 * n + 2 * h] + y.x) * tanhf(acc[4 * (n + 8) + 2 * h] + z.x);
        const float g1 =
            sigmoid_fast(acc[4 * n + 2 * h + 1] + y.y) * tanhf(acc[4 * (n + 8) + 2 * h + 1] + z.y);
        ga[kk][i] = pack_bf16(g0, g1);
      }
      wgmma_fence();
      wgmma_rs(rs, ga[kk], desc_b(base + kWrs + kk * 2048, kBox), kk > 0);
    }
    uint32_t xc[8][2], sk_old[8][2];  // the raw centre tap and the old skip sum
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        xc[n][h] = write_x ? lds32(st + kX + swz(r0 + 8 * h + step, n) + 4 * q) : 0u;
        sk_old[n][h] = first ? 0u : lds32(st + skip_off + swz(r0 + 8 * h, n) + 4 * q);
      }
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(rs);

    // x_out = round((x + res) * 2^-1/2) and skip = round(skip + round(skip_l)),
    // each over this thread's own cond_l cells (halves 0 and 1)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float2 br = bf2_to_f2(bias[n]), bs = bf2_to_f2(bias[n + 8]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t off = swz(r0 + 8 * h, n) + 4 * q;
        if (write_x) {
          const float2 x = bf2_to_f2(xc[n][h]);
          sts32(st + kCond + off, pack_bf16((x.x + (rs[4 * n + 2 * h] + br.x)) * kRsqrt2,
                                            (x.y + (rs[4 * n + 2 * h + 1] + br.y)) * kRsqrt2));
        }
        const uint32_t sk = pack_bf16(rs[4 * (n + 8) + 2 * h] + bs.x, rs[4 * (n + 8) + 2 * h + 1] + bs.y);
        sts32(st + kCond + kBox + off, first ? sk : add_bf16x2(sk_old[n][h], sk));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // generic writes -> TMA
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");   // this warpgroup's writes
    if (tid == 0) mbar_arrive(done0 + 8 * s);
    __syncwarp();
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver API call: reached through the runtime,
// so that the library needs no link against libcuda.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 tensor map over a contiguous array of `rank` dims (innermost
// first) with 64 x 64 boxes (1 in the outer dims) and 128B swizzle.
bool tensor_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  cuuint64_t size[4], stride[3];
  cuuint32_t box[4], one[4] = {1, 1, 1, 1};
  uint64_t bytes = 2;
  for (int i = 0; i < rank; ++i) {
    size[i] = dims[i];
    box[i] = i < 2 ? 64 : 1;
    if (i > 0) stride[i - 1] = bytes;
    bytes *= dims[i];
  }
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, (cuuint32_t)rank, const_cast<void*>(ptr), size,
                stride, box, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int run_stack_wgmma(const void* x0, void* xa, void* xb, void* skip, const void* cond,
                    const void* emb, const void* wconv, const void* wrs, const void* brs, int B,
                    int T, int L, int cycle, void* stream) {
  constexpr int kC = 64;
  // TMA coordinates are signed 32-bit (t0 - d must fit); cond's outer
  // stride, B T 2C 2 bytes, must stay below 2^40
  if (B <= 0 || T <= 0 || T >= (1 << 30) || (long long)B * T >= (1LL << 32) || L <= 0 ||
      cycle <= 0 || cycle > 30)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(layer_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemWg);
  cudaFuncAttributes attr;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, layer_wgmma);
  if (err != cudaSuccess) return (int)err;
  // setmaxnreg moves registers within the block's launch allocation: with
  // fewer, the consumers' increase could never be granted
  if (attr.numRegs * kThreadsWg < 128 * (kProducerRegs + kConsumers * kConsumerRegs))
    return (int)cudaErrorInvalidConfiguration;

  CUtensorMap m_x[3], m_skip, m_cond, m_wconv, m_wrs;
  const uint64_t xdims[3] = {kC, (uint64_t)T, (uint64_t)B};
  const uint64_t cdims[4] = {2 * kC, (uint64_t)T, (uint64_t)B, (uint64_t)L};
  const uint64_t wdims[2] = {2 * kC, (uint64_t)L * 3 * kC};
  const uint64_t rdims[2] = {2 * kC, (uint64_t)L * kC};
  const void* xs[3] = {x0, xa, xb};
  bool ok = tensor_map(&m_skip, skip, 3, xdims) && tensor_map(&m_cond, cond, 4, cdims) &&
            tensor_map(&m_wconv, wconv, 2, wdims) && tensor_map(&m_wrs, wrs, 2, rdims);
  for (int i = 0; i < 3; ++i) ok = ok && tensor_map(&m_x[i], xs[i], 3, xdims);
  if (!ok) return (int)cudaErrorInvalidValue;

  const int tiles_per_row = (T + kM - 1) / kM, ntiles = B * tiles_per_row;
  const int grid = ntiles < sms ? ntiles : sms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int l = 0; l < L; ++l) {
    // layer l reads x0 (l = 0), xa (odd l) or xb, and writes xa (even l) or xb
    const CUtensorMap& in = m_x[l == 0 ? 0 : (l % 2 == 1 ? 1 : 2)];
    const CUtensorMap& out = m_x[l % 2 == 0 ? 1 : 2];
    // Layers after the first launch as programmatic dependents: their blocks
    // start as the previous layer's blocks leave, and wait in the kernel
    // (griddepcontrol.wait) before touching x or the skip sum.  The first
    // waits for the stream's earlier work in full, as cond and emb come from it.
    cudaLaunchAttribute pdl;
    pdl.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    pdl.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)grid);
    cfg.blockDim = dim3(kThreadsWg);
    cfg.dynamicSmemBytes = kSmemWg;
    cfg.stream = s;
    cfg.attrs = &pdl;
    cfg.numAttrs = l > 0 ? 1 : 0;
    err = cudaLaunchKernelEx(&cfg, layer_wgmma, in, out, m_skip, m_cond, m_wconv, m_wrs,
                             static_cast<const bf16*>(emb) + (size_t)l * B * kC,
                             static_cast<const bf16*>(brs) + (size_t)l * 2 * kC, T, tiles_per_row,
                             ntiles, l, 1 << (l % cycle), (int)(l == 0), (int)(l + 1 < L));
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// ---------------------------------------------------- bf16, C = 32 -------
constexpr int kWarps = 4;
constexpr int kThreadsBf = 32 * kWarps;
constexpr int kTileBf = 16 * kWarps;  // rows of T per tile

// Sizes for C residual channels: N = 2C gate + filter columns; the shared
// row strides in bf16 (at C = 32, 80 B and 144 B) keep ldmatrix free of
// bank conflicts.
template <int kC>
struct Dims {
  static constexpr int kN = 2 * kC;
  static constexpr int kLdA = kC + 8;
  static constexpr int kLdW = kN + 8;
  static constexpr int kSmemBf = (3 * kC * kLdW + kC * kLdW + 3 * kTileBf * kLdA) * 2;
};

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy a [rows, kN] bf16 matrix into shared memory with row stride kLdW.
template <int kN, int kLdW>
__device__ __forceinline__ void stage_weights(bf16* dst, const bf16* __restrict__ src, int rows) {
  for (int i = threadIdx.x; i < rows * (kN / 8); i += kThreadsBf) {
    const int r = i / (kN / 8), v = i % (kN / 8);
    *reinterpret_cast<uint4*>(dst + r * kLdW + v * 8) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * kN + v * 8);
  }
}

template <int kC>
__global__ void __launch_bounds__(kThreadsBf)
    layer_bf16(const bf16* __restrict__ x_in, bf16* __restrict__ x_out,
               bf16* __restrict__ skip, const bf16* __restrict__ cond,
               const bf16* __restrict__ emb, const bf16* __restrict__ wconv,
               const bf16* __restrict__ wrs, const bf16* __restrict__ brs, int T,
               int d, int first, int write_x) {
  constexpr int kN = Dims<kC>::kN, kLdA = Dims<kC>::kLdA, kLdW = Dims<kC>::kLdW;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sW = reinterpret_cast<bf16*>(smem);  // [3C][kLdW]: wconv_l as K x N
  bf16* sR = sW + 3 * kC * kLdW;             // [C][kLdW]:  wrs_l
  bf16* sA = sR + kC * kLdW;                 // [3][kTileBf][kLdA]: taps

  const int b = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, q = lane % 4;  // mma fragment row and column pair
  const bf16* xb = x_in + (size_t)b * T * kC;
  const bf16* eb = emb + (size_t)b * kC;
  const bf16* cb = cond + (size_t)b * T * kN;

  stage_weights<kN, kLdW>(sW, wconv, 3 * kC);
  stage_weights<kN, kLdW>(sR, wrs, kC);

  const int ntiles = (T + kTileBf - 1) / kTileBf;
  const int tile_end = min((int)(blockIdx.x + 1) * kTilesPerBlock, ntiles);
  for (int tile = blockIdx.x * kTilesPerBlock; tile < tile_end; ++tile) {
    const int t0 = tile * kTileBf;
    // This thread's cond_l, x and skip pairs, loaded first so that their
    // latency overlaps the tap staging and the tensor-core product.  Element
    // e of accumulator n-tile n is row g + 8(e/2), column 8n + 2q + e%2, so
    // the thread owns rows row0 and row0 + 8 at columns c = 8n + 2q, c + 1.
    const int row0 = t0 + warp * 16 + g;
    uint32_t cy[kC / 8][2], cz[kC / 8][2], xo[kC / 8][2], so[kC / 8][2];
#pragma unroll
    for (int n = 0; n < kC / 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = row0 + 8 * h, c = n * 8 + q * 2;
        cy[n][h] = cz[n][h] = xo[n][h] = so[n][h] = 0u;
        if (t < T) {
          const size_t off = ((size_t)b * T + t) * kC + c;
          cy[n][h] = *reinterpret_cast<const uint32_t*>(cb + (size_t)t * kN + c);
          cz[n][h] = *reinterpret_cast<const uint32_t*>(cb + (size_t)t * kN + kC + c);
          if (write_x) xo[n][h] = *reinterpret_cast<const uint32_t*>(x_in + off);
          if (!first) so[n][h] = *reinterpret_cast<const uint32_t*>(skip + off);
        }
      }
    }
    __syncthreads();  // the weights are staged; the last tile's taps are read

    // taps: tap k of row t is round(x[t + (k-1)d] + emb), 0 outside [0, T)
    for (int i = threadIdx.x; i < 3 * kTileBf * (kC / 8); i += kThreadsBf) {
      const int k = i / (kTileBf * (kC / 8));
      const int r = (i / (kC / 8)) % kTileBf;
      const int v = i % (kC / 8);
      const int t = t0 + r, s = t + (k - 1) * d;
      uint4 out = make_uint4(0u, 0u, 0u, 0u);
      if (t < T && s >= 0 && s < T) {
        const uint4 xv = *reinterpret_cast<const uint4*>(xb + (size_t)s * kC + v * 8);
        const uint4 ev = *reinterpret_cast<const uint4*>(eb + v * 8);
        const bf16* xs = reinterpret_cast<const bf16*>(&xv);
        const bf16* es = reinterpret_cast<const bf16*>(&ev);
        bf16* os = reinterpret_cast<bf16*>(&out);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          os[j] = __float2bfloat16_rn(__bfloat162float(xs[j]) + __bfloat162float(es[j]));
      }
      *reinterpret_cast<uint4*>(sA + (k * kTileBf + r) * kLdA + v * 8) = out;
    }
    __syncthreads();

    // y = taps @ wconv_l: this warp's 16 rows x kN columns, K = 3C
    float acc[kN / 8][4];
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 3 * kC / 16; ++ks) {
      const int k = ks / (kC / 16), kk = ks % (kC / 16);
      uint32_t a[4];
      ldsm_x4(a, sA + (k * kTileBf + warp * 16 + (lane & 15)) * kLdA + kk * 16 + (lane >> 4) * 8);
      const bf16* wrow = sW + (ks * 16 + (lane & 15)) * kLdW + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t bq[4];
        ldsm_x4_t(bq, wrow + np * 16);
        mma_bf16(acc[2 * np], a, bq[0], bq[1]);
        mma_bf16(acc[2 * np + 1], a, bq[2], bq[3]);
      }
    }

    // + cond_l, gate, round to bf16 into the A fragments of the next product
    uint32_t ga[kC / 8][2];
#pragma unroll
    for (int n = 0; n < kC / 8; ++n) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 y = bf2_to_f2(cy[n][h]), z = bf2_to_f2(cz[n][h]);
        const float g0 = sigmoidf_(acc[n][2 * h] + y.x) * tanhf(acc[n + kC / 8][2 * h] + z.x);
        const float g1 = sigmoidf_(acc[n][2 * h + 1] + y.y) * tanhf(acc[n + kC / 8][2 * h + 1] + z.y);
        ga[n][h] = pack_bf16(g0, g1);
      }
    }

    // rs = g @ wrs_l, A straight from registers: the fragment of k-step kk is
    // (n-tile 2kk, rows g and g+8), then (n-tile 2kk+1, rows g and g+8)
    float rs[kN / 8][4];
#pragma unroll
    for (int n = 0; n < kN / 8; ++n) rs[n][0] = rs[n][1] = rs[n][2] = rs[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kC / 16; ++kk) {
      const uint32_t a[4] = {ga[2 * kk][0], ga[2 * kk][1], ga[2 * kk + 1][0], ga[2 * kk + 1][1]};
      const bf16* wrow = sR + (kk * 16 + (lane & 15)) * kLdW + (lane >> 4) * 8;
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t bq[4];
        ldsm_x4_t(bq, wrow + np * 16);
        mma_bf16(rs[2 * np], a, bq[0], bq[1]);
        mma_bf16(rs[2 * np + 1], a, bq[2], bq[3]);
      }
    }

    // x_out = round((x + res) * 2^-1/2); skip = round(skip + round(skip_l))
#pragma unroll
    for (int n = 0; n < kC / 8; ++n) {
      const int c = n * 8 + q * 2;
      const float br0 = __bfloat162float(brs[c]), br1 = __bfloat162float(brs[c + 1]);
      const float bs0 = __bfloat162float(brs[kC + c]), bs1 = __bfloat162float(brs[kC + c + 1]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int t = row0 + 8 * h;
        if (t >= T) continue;
        const size_t off = ((size_t)b * T + t) * kC + c;
        if (write_x) {
          const float2 x = bf2_to_f2(xo[n][h]);
          *reinterpret_cast<uint32_t*>(x_out + off) =
              pack_bf16((x.x + (rs[n][2 * h] + br0)) * kRsqrt2,
                        (x.y + (rs[n][2 * h + 1] + br1)) * kRsqrt2);
        }
        uint32_t sk = pack_bf16(rs[n + kC / 8][2 * h] + bs0, rs[n + kC / 8][2 * h + 1] + bs1);
        if (!first) {
          const float2 old = bf2_to_f2(so[n][h]), add = bf2_to_f2(sk);
          sk = pack_bf16(old.x + add.x, old.y + add.y);
        }
        *reinterpret_cast<uint32_t*>(skip + off) = sk;
      }
    }
  }
}

// ----------------------------------------------------------------- f32 ----
constexpr int kThreadsF = 256;
constexpr int kTileF = 32;

template <int kC>
constexpr int smem_f32() { return (3 * kTileF * kC + kTileF * 2 * kC + kTileF * kC) * 4; }

template <int kC>
__global__ void __launch_bounds__(kThreadsF)
    layer_f32(const float* __restrict__ x_in, float* __restrict__ x_out,
              float* __restrict__ skip, const float* __restrict__ cond,
              const float* __restrict__ emb, const float* __restrict__ wconv,
              const float* __restrict__ wrs, const float* __restrict__ brs, int T,
              int d, int first, int write_x) {
  constexpr int kN = 2 * kC;
  constexpr int kRowStep = kThreadsF / kN;             // 2 at C = 64, 4 at C = 32
  constexpr int kRowsPerThread = kTileF / kRowStep;    // 16 at C = 64, 8 at C = 32
  extern __shared__ __align__(16) unsigned char smem[];
  float* sA = reinterpret_cast<float*>(smem);  // [3][kTileF][C] taps
  float* sY = sA + 3 * kTileF * kC;            // [kTileF][kN] y
  float* sG = sY + kTileF * kN;                // [kTileF][C] gate

  const int b = blockIdx.y;
  // thread -> column n; rows r0 + kRowStep i (a warp shares its rows: shared
  // reads broadcast)
  const int n = threadIdx.x % kN, r0 = threadIdx.x / kN;
  const float* xb = x_in + (size_t)b * T * kC;
  const float* eb = emb + (size_t)b * kC;
  const float* cb = cond + (size_t)b * T * kN;

  const int ntiles = (T + kTileF - 1) / kTileF;
  const int tile_end = min((int)(blockIdx.x + 1) * kTilesPerBlock, ntiles);
  for (int tile = blockIdx.x * kTilesPerBlock; tile < tile_end; ++tile) {
    const int t0 = tile * kTileF;
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * kTileF * kC; i += kThreadsF) {
      const int k = i / (kTileF * kC), r = (i / kC) % kTileF, c = i % kC;
      const int t = t0 + r, s = t + (k - 1) * d;
      sA[i] = (t < T && s >= 0 && s < T) ? xb[(size_t)s * kC + c] + eb[c] : 0.f;
    }
    __syncthreads();

    float acc[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
    for (int k = 0; k < 3; ++k) {
      for (int c = 0; c < kC; ++c) {
        const float w = wconv[(size_t)(k * kC + c) * kN + n];
        const float* a = sA + (k * kTileF + r0) * kC + c;
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) acc[i] = fmaf(a[kRowStep * i * kC], w, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = r0 + kRowStep * i, t = t0 + r;
      sY[r * kN + n] = acc[i] + (t < T ? cb[(size_t)t * kN + n] : 0.f);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < kTileF * kC; i += kThreadsF) {
      const int r = i / kC, c = i % kC;
      sG[i] = sigmoidf_(sY[r * kN + c]) * tanhf(sY[r * kN + kC + c]);
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.f;
    for (int c = 0; c < kC; ++c) {
      const float w = wrs[(size_t)c * kN + n];
      const float* a = sG + r0 * kC + c;
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) acc[i] = fmaf(a[kRowStep * i * kC], w, acc[i]);
    }
    const float bn = brs[n];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int t = t0 + r0 + kRowStep * i;
      if (t >= T) continue;
      const float v = acc[i] + bn;
      const size_t row = ((size_t)b * T + t) * kC;
      if (n < kC) {
        if (write_x) x_out[row + n] = (xb[(size_t)t * kC + n] + v) * kRsqrt2;
      } else {
        skip[row + n - kC] = first ? v : skip[row + n - kC] + v;
      }
    }
  }
}

template <typename Elem, int kC, typename Kernel>
int run_stack(Kernel kernel, int threads, int tile, int smem, const void* x0, void* xa,
              void* xb, void* skip, const void* cond, const void* emb, const void* wconv,
              const void* wrs, const void* brs, int B, int T, int L, int cycle,
              void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || L <= 0 || cycle <= 0 || cycle > 30)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (T + tile - 1) / tile;
  const dim3 grid((unsigned)((ntiles + kTilesPerBlock - 1) / kTilesPerBlock), (unsigned)B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Elem* x_in = static_cast<const Elem*>(x0);
  constexpr int kN = 2 * kC;
  for (int l = 0; l < L; ++l) {
    Elem* x_out = static_cast<Elem*>(l % 2 == 0 ? xa : xb);
    kernel<<<grid, threads, smem, s>>>(
        x_in, x_out, static_cast<Elem*>(skip),
        static_cast<const Elem*>(cond) + (size_t)l * B * T * kN,
        static_cast<const Elem*>(emb) + (size_t)l * B * kC,
        static_cast<const Elem*>(wconv) + (size_t)l * 3 * kC * kN,
        static_cast<const Elem*>(wrs) + (size_t)l * kC * kN,
        static_cast<const Elem*>(brs) + (size_t)l * kN, T, 1 << (l % cycle), l == 0,
        l + 1 < L);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    x_in = x_out;
  }
  return 0;
}

}  // namespace

// x0 [B,T,C], cond [L,B,T,2C], emb [L,B,C], wconv [L,3,C,2C], wrs [L,C,2C],
// brs [L,2C], all of one dtype and contiguous; xa, xb: [B,T,C] scratch for x;
// skip: [B,T,C] output.  C must be 32 or 64.
extern "C" int diffwave_stack_bf16(const void* x0, void* xa, void* xb, void* skip,
                                   const void* cond, const void* emb, const void* wconv,
                                   const void* wrs, const void* brs, int B, int T, int L,
                                   int cycle, int C, void* stream) {
  if (C == 64)
    return run_stack_wgmma(x0, xa, xb, skip, cond, emb, wconv, wrs, brs, B, T, L, cycle, stream);
  if (C == 32)
    return run_stack<bf16, 32>(layer_bf16<32>, kThreadsBf, kTileBf, Dims<32>::kSmemBf, x0, xa,
                               xb, skip, cond, emb, wconv, wrs, brs, B, T, L, cycle, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int diffwave_stack_f32(const void* x0, void* xa, void* xb, void* skip,
                                  const void* cond, const void* emb, const void* wconv,
                                  const void* wrs, const void* brs, int B, int T, int L,
                                  int cycle, int C, void* stream) {
  if (C == 64)
    return run_stack<float, 64>(layer_f32<64>, kThreadsF, kTileF, smem_f32<64>(), x0, xa, xb,
                                skip, cond, emb, wconv, wrs, brs, B, T, L, cycle, stream);
  if (C == 32)
    return run_stack<float, 32>(layer_f32<32>, kThreadsF, kTileF, smem_f32<32>(), x0, xa, xb,
                                skip, cond, emb, wconv, wrs, brs, B, T, L, cycle, stream);
  return (int)cudaErrorInvalidValue;
}
