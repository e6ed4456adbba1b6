// Fused GroupNorm + SiLU forward for NCHW tensors, f32 and bf16, sm_90a.
//
// Replaces the Pallas kernel sddm_tpu/experimental/pallas_groupnorm_swish.py
// ::group_norm_swish, which the JAX model reaches through the flax
// GroupNorm -> swish prologue of every Block (sddm_tpu/models/blocks.py).
// It computes that prologue's function, not the Pallas body: flax
// GroupNorm(num_groups, eps) with f32 statistics, the variance clamped at 0
// as flax clamps it (E[x^2] - E[x]^2 can round below 0, and rsqrt of a
// negative is NaN), a per-channel affine, x * sigmoid(x), and one rounding
// to the input type.  Any channels-per-group count cg = C / G is taken.
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
// C interface, loaded with ctypes: one launcher per type.  Each takes device
// pointers, the sizes and a cudaStream_t, launches on that stream without
// synchronising, allocates nothing, and returns cudaGetLastError().

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

}  // namespace

extern "C" int gn_silu_f32(const void* x, const void* w, const void* b, void* y,
                           int B, int C, int HW, int G, float eps, void* stream) {
  return launch<float>(x, w, b, y, B, C, HW, G, eps, stream);
}

extern "C" int gn_silu_bf16(const void* x, const void* w, const void* b, void* y,
                            int B, int C, int HW, int G, float eps, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, B, C, HW, G, eps, stream);
}
