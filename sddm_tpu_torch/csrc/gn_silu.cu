// Fused GroupNorm + SiLU forward, f32 and bf16, sm_90a, in two layouts.
//
// NCHW (gn_silu_f32, gn_silu_bf16) replaces the Pallas kernel
// sddm_tpu/experimental/pallas_groupnorm_swish.py::group_norm_swish, which
// the JAX model reaches through the flax GroupNorm -> swish prologue of
// every Block (sddm_tpu/models/blocks.py).  It computes that prologue's
// function, not the Pallas body: flax GroupNorm(num_groups, eps) with f32
// statistics, the variance clamped at 0 as flax clamps it (E[x^2] - E[x]^2
// can round below 0, and rsqrt of a negative is NaN), a per-channel affine,
// x * sigmoid(x), and one rounding to the input type.  Any channels-per-group
// count cg = C / G is taken.
//
// Bound: memory traffic.  The function reads the tensor at least once and
// writes it once; at about ten f32 operations per element its arithmetic
// intensity is below 5 operations per byte, far under the card's 295
// operations-per-byte ridge.  So the design only tries to move few bytes in
// wide, coalesced accesses:
//   * In NCHW one (batch row, group) is one contiguous run of cg * H * W
//     values.  One block owns one run: the statistics need no cross-block
//     reduction and no second launch.
//   * Sweep 1 reads the run in 16-byte vectors and sums x and x^2 in f32;
//     a warp-shuffle plus shared-memory reduction gives the block's sums.
//   * Sweep 2 reads the run again (largely from L2), normalises, applies the
//     channel's affine and the SiLU, rounds and stores in 16-byte vectors.
// The second read is the known cost of this simple design: a later version
// can keep the run in shared memory (128 KB in bf16 at the largest flagship
// site) and read the tensor once.
//
// NHWC (gn_silu_nhwc_f32, gn_silu_nhwc_bf16) replaces the Pallas kernel
// sddm_tpu/experimental/pallas_gn_silu.py::gn_silu, the GroupNorm -> SiLU
// (-> offset mask) chain of the packed (space-to-depth) engine
// (sddm_tpu/models/unet_packed.py: _GN, jax.nn.silu, _offset_mask_np).  x is
// [B, H, W, C4]; channel j belongs to group group_of[j], a map that need not
// be contiguous (packed channels of concatenated skip sections interleave).
// Per batch row: f32 sums of x and x^2 per channel over the H*W positions,
// then per group; mean = s1 / n, var = max(0, s2 / n - mean^2) with the
// caller's divisor n; y = silu(((x - mean) * rsqrt(var + eps)) * scale +
// bias); at offset sites y is zeroed at rows h = 0 / H-1 and columns w = 0 /
// W-1 by the channel's phase bits (j / (2c)) & 1 and (j / c) & 1, c = C4/4,
// the out-of-range plain rows and columns of the offset grid; one rounding.
//
// Bound: memory traffic again, one read and one write of x: 0.040 ms for the
// largest flagship site [16, 128, 64, 256] bf16 at 3.35 TB/s.  In NHWC a
// group is not contiguous: it is a set of channels at every position.  The
// Pallas kernel carried the per-channel sums in VMEM from one sequential grid
// step to the next; CUDA blocks run in no order and carry nothing, so the
// statistics take a reduction across blocks, done in fixed order (sampler
// trajectories bifurcate on last-bit changes of the statistics, so the same
// call must give the same bits; no float atomics):
//   * pass 1 (nhwc_stats): block (slice s, channel tile, batch row b) owns a
//     slice of rows.  Threads run along channels, 16 bytes each, so a warp
//     reads contiguous memory; each thread keeps its channels' f32 sums of x
//     and x^2 in registers, the block folds its row lanes in shared memory
//     and writes partials [B, S, 2, C4];
//   * finalize (nhwc_finalize): one block per batch row sums the S partials
//     in order, combines channels into groups through group_of (a warp per
//     group, shuffle tree), clamps, takes rsqrt and writes the per-channel
//     mean and 1/std [B, 2, C4];
//   * pass 2 (nhwc_norm): the pass-1 geometry again; each thread loads its
//     channels' statistics, affine and phase bits once, then normalises,
//     applies SiLU and the mask, rounds and stores its rows.
// The known cost: pass 2 reads x again (from L2 where it still lies there),
// and the statistics take a third, small launch.
//
// C interface, loaded with ctypes: one launcher per type and layout.  Each
// takes device pointers, the sizes and a cudaStream_t, launches on that
// stream without synchronising, allocates nothing (the NHWC launchers take a
// workspace of B * (S + 1) * 2 * C4 floats from the caller), and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (x - mean) * (rstd * w) + b, then y * sigmoid(y): the order of flax's
// _normalize (mul = rsqrt(var + eps) * scale; y = (x - mean) * mul + bias).
__device__ __forceinline__ float norm_silu(float x, float mean, float a, float b) {
  float y = (x - mean) * a + b;
  return y / (1.0f + expf(-y));
}

// kVec: every channel's H*W run is a whole number of 16-byte packs and both
// pointers are 16-byte aligned, so no pack straddles two channels.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    gn_silu_kernel(const T* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ b, T* __restrict__ y, int C,
                   int HW, int G, float eps) {
  constexpr int P = 16 / sizeof(T);
  const int cg = C / G;
  const int g = blockIdx.x % G;
  const int64_t n = (int64_t)cg * HW;
  const T* xg = x + (int64_t)blockIdx.x * n;
  T* yg = y + (int64_t)blockIdx.x * n;

  float s = 0.f, ss = 0.f;
  if (kVec) {
    const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(xg);
    const int64_t np = n / P;
    for (int64_t i = threadIdx.x; i < np; i += kThreads) {
      const Pack<T> p = xp[i];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const float v = to_f32(p.v[k]);
        s += v;
        ss += v * v;
      }
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      const float v = to_f32(xg[i]);
      s += v;
      ss += v * v;
    }
  }

  __shared__ float red[2][kWarps];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? red[0][lane] : 0.f;
    ss = lane < kWarps ? red[1][lane] : 0.f;
    s = warp_sum(s);
    ss = warp_sum(ss);
    if (lane == 0) {
      red[0][0] = s;
      red[1][0] = ss;
    }
  }
  __syncthreads();
  const float mean = red[0][0] / (float)n;
  const float var = fmaxf(red[1][0] / (float)n - mean * mean, 0.f);
  const float rstd = rsqrtf(var + eps);

  if (kVec) {
    const Pack<T>* xp = reinterpret_cast<const Pack<T>*>(xg);
    Pack<T>* yp = reinterpret_cast<Pack<T>*>(yg);
    const int64_t np = n / P;
    for (int64_t i = threadIdx.x; i < np; i += kThreads) {
      const int c = g * cg + (int)((i * P) / HW);
      const float a = rstd * w[c];
      const float bc = b[c];
      const Pack<T> p = xp[i];
      Pack<T> o;
#pragma unroll
      for (int k = 0; k < P; ++k) o.v[k] = from_f32<T>(norm_silu(to_f32(p.v[k]), mean, a, bc));
      yp[i] = o;
    }
  } else {
    for (int64_t i = threadIdx.x; i < n; i += kThreads) {
      const int c = g * cg + (int)(i / HW);
      yg[i] = from_f32<T>(norm_silu(to_f32(xg[i]), mean, rstd * w[c], b[c]));
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int B, int C,
           int HW, int G, float eps, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 ||
      (int64_t)B * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int P = 16 / sizeof(T);
  const bool vec = HW % P == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const dim3 grid((unsigned)(B * G));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* xt = static_cast<const T*>(x);
  const float* wt = static_cast<const float*>(w);
  const float* bt = static_cast<const float*>(b);
  T* yt = static_cast<T*>(y);
  if (vec)
    gn_silu_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, wt, bt, yt, C, HW, G, eps);
  else
    gn_silu_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, wt, bt, yt, C, HW, G, eps);
  return (int)cudaGetLastError();
}


// ------------------------------------------------------------------ NHWC ----
constexpr int kThreadsN = 256;

template <typename T, int P>
__device__ __forceinline__ void load_vec(const T* p, float (&o)[P]) {
  if constexpr (P == 1) {
    o[0] = to_f32(p[0]);
  } else {
    const Pack<T> v = *reinterpret_cast<const Pack<T>*>(p);
#pragma unroll
    for (int k = 0; k < P; ++k) o[k] = to_f32(v.v[k]);
  }
}

template <typename T, int P>
__device__ __forceinline__ void store_vec(T* p, const float (&o)[P]) {
  if constexpr (P == 1) {
    p[0] = from_f32<T>(o[0]);
  } else {
    Pack<T> v;
#pragma unroll
    for (int k = 0; k < P; ++k) v.v[k] = from_f32<T>(o[k]);
    *reinterpret_cast<Pack<T>*>(p) = v;
  }
}

// Thread geometry shared by both passes: the C4 channels are V vectors of P
// channels, split into tiles of VT vectors (gridDim.y tiles); thread t runs
// vector t % VT of its tile over the rows r = t / VT (mod RL) of the block's
// slice of rows_per_slice rows (gridDim.x slices, gridDim.z batch rows).
template <typename T, int P>
__global__ void __launch_bounds__(kThreadsN)
    nhwc_stats(const T* __restrict__ x, float* __restrict__ part, int HW, int C4, int V,
               int VT, int RL, int rows_per_slice) {
  const int s = blockIdx.x, ct = blockIdx.y, b = blockIdx.z, S = gridDim.x;
  const int vl = threadIdx.x % VT, rl = threadIdx.x / VT, v = ct * VT + vl;
  float sum[P], sq[P];
#pragma unroll
  for (int k = 0; k < P; ++k) sum[k] = sq[k] = 0.f;
  const int r0 = s * rows_per_slice, r1 = min(HW, r0 + rows_per_slice);
  if (rl < RL && v < V) {
    const T* xb = x + (size_t)b * HW * C4 + (size_t)v * P;
    for (int r = r0 + rl; r < r1; r += RL) {
      float xv[P];
      load_vec<T, P>(xb + (size_t)r * C4, xv);
#pragma unroll
      for (int k = 0; k < P; ++k) {
        sum[k] += xv[k];
        sq[k] += xv[k] * xv[k];
      }
    }
  }
  __shared__ float red[2][kThreadsN * P];
  const int nt = VT * P;  // channels of this tile
  if (rl < RL) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      red[0][rl * nt + vl * P + k] = sum[k];
      red[1][rl * nt + vl * P + k] = sq[k];
    }
  }
  __syncthreads();
  float* pb = part + (size_t)(b * S + s) * 2 * C4;
  for (int i = threadIdx.x; i < nt; i += kThreadsN) {
    const int c = ct * nt + i;
    if (c >= C4) break;
    float a = 0.f, q = 0.f;
    for (int j = 0; j < RL; ++j) {
      a += red[0][j * nt + i];
      q += red[1][j * nt + i];
    }
    pb[c] = a;
    pb[C4 + c] = q;
  }
}

__global__ void __launch_bounds__(kThreadsN)
    nhwc_finalize(const float* __restrict__ part, const int* __restrict__ group_of,
                  float* __restrict__ stats, int C4, int G, int S, float n, float eps) {
  extern __shared__ float sh[];
  float* cs1 = sh;           // [C4] channel sums of x
  float* cs2 = sh + C4;      // [C4] channel sums of x^2
  float* gm = sh + 2 * C4;   // [G] group means
  float* gi = gm + G;        // [G] group 1/std
  const int b = blockIdx.x;
  const float* pb = part + (size_t)b * S * 2 * C4;
  for (int c = threadIdx.x; c < C4; c += kThreadsN) {
    float a = 0.f, q = 0.f;
    for (int s = 0; s < S; ++s) {
      a += pb[(size_t)s * 2 * C4 + c];
      q += pb[(size_t)s * 2 * C4 + C4 + c];
    }
    cs1[c] = a;
    cs2[c] = q;
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < G; g += kThreadsN / 32) {
    float a = 0.f, q = 0.f;
    for (int c = lane; c < C4; c += 32) {
      if (group_of[c] == g) {
        a += cs1[c];
        q += cs2[c];
      }
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane == 0) {
      const float mean = a / n;
      gm[g] = mean;
      // __fmul_rn keeps mean^2 rounded on its own, as the plain version
      // rounds it, instead of contracting the difference into an fma
      gi[g] = rsqrtf(fmaxf(__fsub_rn(q / n, __fmul_rn(mean, mean)), 0.f) + eps);
    }
  }
  __syncthreads();
  float* st = stats + (size_t)b * 2 * C4;
  for (int c = threadIdx.x; c < C4; c += kThreadsN) {
    const int g = group_of[c];
    const bool ok = g >= 0 && g < G;
    st[c] = ok ? gm[g] : __int_as_float(0x7fc00000);
    st[C4 + c] = ok ? gi[g] : __int_as_float(0x7fc00000);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreadsN)
    nhwc_norm(const T* __restrict__ x, const float* __restrict__ stats,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ y, int H, int W, int C4, int V, int VT, int RL,
              int rows_per_slice, int offset) {
  const int s = blockIdx.x, ct = blockIdx.y, b = blockIdx.z;
  const int vl = threadIdx.x % VT, rl = threadIdx.x / VT, v = ct * VT + vl;
  if (rl >= RL || v >= V) return;
  const int HW = H * W, c4 = C4 / 4;
  const float* st = stats + (size_t)b * 2 * C4;
  float mu[P], iv[P], sc[P], bi[P];
  unsigned row_bit = 0u, col_bit = 0u;  // phase bits of this thread's channels
#pragma unroll
  for (int k = 0; k < P; ++k) {
    const int c = v * P + k;
    mu[k] = st[c];
    iv[k] = st[C4 + c];
    sc[k] = scale[c];
    bi[k] = bias[c];
    if (offset) {
      row_bit |= (unsigned)((c / (2 * c4)) & 1) << k;
      col_bit |= (unsigned)((c / c4) & 1) << k;
    }
  }
  const int r0 = s * rows_per_slice, r1 = min(HW, r0 + rows_per_slice);
  const size_t base = (size_t)b * HW * C4 + (size_t)v * P;
  for (int r = r0 + rl; r < r1; r += RL) {
    float o[P];
    load_vec<T, P>(x + base + (size_t)r * C4, o);
    const int h = r / W, w = r - h * W;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      float val = ((o[k] - mu[k]) * iv[k]) * sc[k] + bi[k];
      val = val / (1.0f + expf(-val));
      if (offset) {
        const bool rb = (row_bit >> k) & 1u, cb = (col_bit >> k) & 1u;
        const float row_ok = ((h == 0 && !rb) || (h == H - 1 && rb)) ? 0.f : 1.f;
        const float col_ok = ((w == 0 && !cb) || (w == W - 1 && cb)) ? 0.f : 1.f;
        val = val * row_ok * col_ok;
      }
      o[k] = val;
    }
    store_vec<T, P>(y + base + (size_t)r * C4, o);
  }
}

template <typename T, int P>
int launch_nhwc_p(const T* x, const float* scale, const float* bias, const int* group_of,
                  T* y, float* work, int B, int H, int W, int C4, int G, int S, float n,
                  int offset, float eps, cudaStream_t stream) {
  const int HW = H * W, V = C4 / P;
  const int CT = (V + kThreadsN - 1) / kThreadsN;
  const int VT = (V + CT - 1) / CT;
  const int RL = kThreadsN / VT;
  const int rows = (HW + S - 1) / S;
  float* part = work;                            // [B, S, 2, C4]
  float* stats = work + (size_t)B * S * 2 * C4;  // [B, 2, C4]
  const dim3 grid((unsigned)S, (unsigned)CT, (unsigned)B);
  nhwc_stats<T, P><<<grid, kThreadsN, 0, stream>>>(x, part, HW, C4, V, VT, RL, rows);
  nhwc_finalize<<<B, kThreadsN, (2 * C4 + 2 * G) * sizeof(float), stream>>>(
      part, group_of, stats, C4, G, S, n, eps);
  nhwc_norm<T, P><<<grid, kThreadsN, 0, stream>>>(x, stats, scale, bias, y, H, W, C4, V, VT,
                                                   RL, rows, offset);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_nhwc(const void* x, const void* scale, const void* bias, const void* group_of,
                void* y, void* work, int B, int H, int W, int C4, int G, int S, float n,
                int offset, float eps, void* stream) {
  // the finalize block holds 2 * C4 + 2 * G floats of shared memory: 40 KB at most
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C4 <= 0 || C4 > 4096 || G <= 0 ||
      G > 1024 || S <= 0 || S > 65535 || !(n > 0.f) || (offset && C4 % 4 != 0) ||
      (int64_t)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int P = 16 / sizeof(T);
  const bool vec = C4 % P == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  const int* go = static_cast<const int*>(group_of);
  float* wk = static_cast<float*>(work);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec)
    return launch_nhwc_p<T, P>(xt, sc, bi, go, yt, wk, B, H, W, C4, G, S, n, offset, eps, s);
  return launch_nhwc_p<T, 1>(xt, sc, bi, go, yt, wk, B, H, W, C4, G, S, n, offset, eps, s);
}

}  // namespace

extern "C" int gn_silu_f32(const void* x, const void* w, const void* b, void* y,
                           int B, int C, int HW, int G, float eps, void* stream) {
  return launch<float>(x, w, b, y, B, C, HW, G, eps, stream);
}

extern "C" int gn_silu_bf16(const void* x, const void* w, const void* b, void* y,
                            int B, int C, int HW, int G, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, B, C, HW, G, eps, stream);
}

// x, y: [B, H, W, C4]; scale, bias: [C4] f32; group_of: [C4] int32 in [0, G);
// work: B * (S + 1) * 2 * C4 floats; n: the statistics' divisor; offset != 0
// zeroes the offset grid's out-of-range rows and columns after the SiLU.
extern "C" int gn_silu_nhwc_f32(const void* x, const void* scale, const void* bias,
                                const void* group_of, void* y, void* work, int B, int H,
                                int W, int C4, int G, int S, float n, int offset, float eps,
                                void* stream) {
  return launch_nhwc<float>(x, scale, bias, group_of, y, work, B, H, W, C4, G, S, n, offset,
                            eps, stream);
}

extern "C" int gn_silu_nhwc_bf16(const void* x, const void* scale, const void* bias,
                                 const void* group_of, void* y, void* work, int B, int H,
                                 int W, int C4, int G, int S, float n, int offset, float eps,
                                 void* stream) {
  return launch_nhwc<__nv_bfloat16>(x, scale, bias, group_of, y, work, B, H, W, C4, G, S, n,
                                    offset, eps, stream);
}
