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
// The kernels are templated on the residual channel count C; C = 32 and 64
// are built (at C = 128 the staged bf16 weights, 4C x (2C + 8) x 2 bytes,
// take 264 KB, over a block's 227 KB of shared memory in this design).
//
// Bound: memory traffic.  At the served shape (B=8, T=16384, C=64, L=30,
// bf16) the stack must read cond (L x B x T x 2C, 1.007 GB), read x0 and
// write the skip sum (16.8 MB each): 0.31 ms at 3.35 TB/s, against 258 GFLOP
// of tensor-core work, 0.26 ms at 989 TFLOP/s.  The TPU kernel kept one
// batch row resident in VMEM across all L layers; a row is 2 MiB in bf16 and
// an H100 block has 227 KB of shared memory, so that design does not carry
// over.  This one launches once per layer:
//   * x ping-pongs between two [B, T, C] buffers (a layer reads x at +-d, up
//     to 512 rows away, so it never writes the x it reads); the skip sum is
//     updated in place, as each row is owned by one thread;
//   * a block owns kTilesPerBlock consecutive tiles of one batch row and
//     loads the layer's weights into shared memory once;
//   * per tile, the three taps of x + emb_l are staged in shared memory,
//     rounded as flax rounds x + d; a bounds check zeroes taps outside
//     [0, T), in place of the TPU kernel's -emb sentinel pads, and handles a
//     ragged last tile, so any T is taken;
//   * bf16: each warp computes 16 rows x 2C columns of y with mma.sync
//     m16n8k16 (bf16 in, f32 accumulate), K = 3C over the taps; the gate is
//     taken on the accumulators (a thread holds column c and c + C of the
//     same row) and rounded to bf16 straight into the A fragments of the
//     res/skip product, which never leaves registers;
//   * f32: the same dataflow with FMA in true f32 (no TF32) on the CUDA
//     cores, so that the tight parity check has a kernel to hold.
// This moves x and skip through memory once per layer (about 2 GB more per
// stack than the bound counts) and loads the weights once per block: the
// known costs of this simple design.
//
// C interface, loaded with ctypes: one launcher per type runs all L layers
// on the given stream without synchronising, allocates nothing, and returns
// the first nonzero cudaGetLastError() (0 when every launch was taken).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kRsqrt2 = 0.70710678118654752440f;
constexpr int kTilesPerBlock = 4;

__device__ __forceinline__ float sigmoidf_(float v) { return 1.0f / (1.0f + expf(-v)); }

// ---------------------------------------------------------------- bf16 ----
constexpr int kWarps = 4;
constexpr int kThreadsBf = 32 * kWarps;
constexpr int kTileBf = 16 * kWarps;  // rows of T per tile

// Sizes for C residual channels: N = 2C gate + filter columns; the shared
// row strides in bf16 (at C = 64, 144 B and 272 B; at C = 32, 80 B and
// 144 B) keep ldmatrix free of bank conflicts.
template <int kC>
struct Dims {
  static constexpr int kN = 2 * kC;
  static constexpr int kLdA = kC + 8;
  static constexpr int kLdW = kN + 8;
  static constexpr int kSmemBf = (3 * kC * kLdW + kC * kLdW + 3 * kTileBf * kLdA) * 2;
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 bf2_to_f2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
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
    return run_stack<bf16, 64>(layer_bf16<64>, kThreadsBf, kTileBf, Dims<64>::kSmemBf, x0, xa,
                               xb, skip, cond, emb, wconv, wrs, brs, B, T, L, cycle, stream);
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
