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
// Bound: memory traffic.  The function reads x once and writes y once; at
// about ten f32 operations per element its arithmetic intensity is below 5
// operations per byte, far under the card's 295 operations-per-byte ridge:
// 0.040 ms for the largest flagship site [16, 64, 256, 128] bf16 at 3.35
// TB/s.  In NCHW one (batch row, group), a run, is cg * H * W contiguous
// values (8 KB to 128 KB in bf16 at the flagship's large sites, 320 bytes at
// its smallest).  The statistics need the whole run before any element can
// be normalised, so a design that streams the run twice reads x about three
// times once the runs in flight outgrow the 50 MB L2.  This design
// (gn_silu_nchw) reads every element once and keeps it on chip, in shared
// memory:
//   * a run of up to 64 KB is one CTA's (small runs several to a CTA, a warp
//     or a few a run); a larger one is split across the q <= 8 CTAs of a
//     thread-block cluster, whose partial sums meet through distributed
//     shared memory, summed in rank order in every CTA;
//   * a CTA reads its slice with eight 16-byte loads in flight a thread,
//     keeps it in shared memory and sums it; then it normalises from shared
//     memory and stores with 16-byte streaming stores: one launch, no
//     workspace, no atomics, the same bits on a repeat;
//   * a slice larger than 226 KB keeps what fits and reads the rest again
//     (no flagship site does).
// The SiLU of a bf16 result uses __expf and __fdividef: with the IEEE
// versions the arithmetic, not the memory, set the kernel's pace in
// development.  Keeping x in registers (16 KB a CTA on clusters of 8) and a
// persistent ring of cp.async stages were both slower in development: the
// CTAs of one SM load, wait at the cluster barrier and compute in lockstep,
// so the arithmetic does not overlap the memory traffic; slices of up to
// 64 KB in shared memory leave several CTAs an SM at different phases.
// The plan (cluster size, threads, runs a CTA, shared memory, grid) is
// computed in ops/gn_silu.py::nchw_plan and checked by the launcher.
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
// Pallas kernel held a whole batch row in VMEM and carried the per-channel
// sums from one sequential grid step to the next; CUDA blocks run in no
// order and a block has 227 KB, so the statistics take a reduction across
// blocks, done in fixed order (sampler trajectories bifurcate on last-bit
// changes of the statistics, so the same call must give the same bits; no
// float atomics).  The design (nhwc_gn_silu) is one cooperative launch of at
// most one 512-thread block per SM:
//   * a block owns contiguous ranges of positions (all channels: one span of
//     memory); it reads its range in 16-byte loads, eight rows a thread in
//     flight, keeps as much of it in shared memory as fits, sums x and x^2
//     per channel and writes its partials [B, K, 2, C4];
//   * one grid barrier; then every block sums its row's K partials in rank
//     order and the channels of each group over a group-major member list,
//     so all blocks of a row hold bit-identical statistics;
//   * it normalises, applies the SiLU (__expf, __fdividef) and the mask,
//     rounds once and stores; x is read again only where a range outgrows
//     the shared memory (the six largest sites), and that part is read last
//     before the barrier and first after it, while it lies in L2.
// Staging by cp.async.bulk was measured slower in development: the copies
// land together and leave the sum as a serial tail, while the loads here
// overlap the sum with the reads.
// The grid plan (ranges per row, staged positions, shared memory) is
// computed in ops/gn_silu.py::nhwc_plan and checked by the launcher.
//
// C interface, loaded with ctypes: one launcher per type and layout.  Each
// takes device pointers, the sizes and a cudaStream_t, launches on that
// stream without synchronising, allocates nothing (the NHWC launchers take a
// workspace of B * K * 2 * C4 floats from the caller), and returns
// cudaGetLastError() or the launch's error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
// kFast (a bf16 result): __expf and __fdividef, whose error of a few f32 ulps
// lies far under the result's bf16 rounding; else the IEEE expf and division.
template <bool kFast>
__device__ __forceinline__ float norm_silu(float x, float mean, float a, float b) {
  const float y = (x - mean) * a + b;
  return kFast ? __fdividef(y, 1.0f + __expf(-y)) : y / (1.0f + expf(-y));
}

// ------------------------------------------------------------------ NHWC ----
constexpr int kThreadsN = 512;     // one block of 512 threads on each SM
constexpr int kSmemMaxN = 232448;  // the dynamic shared memory one H100 block may take
constexpr int kLoadRows = 8;       // rows a thread has in flight while it sums
constexpr int kOutRows = 4;        // rows a thread has in flight while it normalises

// Shared memory before the staging area, in 4-byte words: the statistics'
// floats (before the grid barrier [2, P, kThreadsN] row-lane sums, after it
// [2, C4] channel sums), [2, G] group mean and 1/std, and the group-major
// channel list [G + 1 + C4]; in bytes rounded up to 128.
// ops/gn_silu.py::nhwc_fixed_bytes computes the same.
__host__ __device__ constexpr int nhwc_red_floats(int C4, int P) {
  return 2 * C4 > 2 * P * kThreadsN ? 2 * C4 : 2 * P * kThreadsN;
}
__host__ __device__ constexpr int nhwc_fixed_bytes(int C4, int G, int P) {
  return ((4 * (nhwc_red_floats(C4, P) + 3 * G + 1 + C4) + 127) / 128) * 128;
}

// One call's arguments and its grid plan (ops/gn_silu.py::nhwc_plan).
struct NhwcArgs {
  const void* x;
  void* y;
  const float* scale;
  const float* bias;
  const int* group_of;
  const int* order;  // [G + 1] offsets into the members, then [C4] channels by group
  float* part;       // [B * K, 2, C4] sums of x and x^2 of each (row, range) item
  int B, H, W, C4, G;
  int K;          // ranges (items) per batch row
  int rows;       // positions per range; the last range of a row may be shorter
  int staged;     // positions of each item kept in shared memory; the rest is read twice
  float n, eps;   // the statistics' divisor; GroupNorm's epsilon
  int offset;     // zero the offset grid's out-of-range rows and columns
};

// P channels as loaded: a 16-byte pack, or one element; converted at use, so
// that a load stays in flight until then
template <typename T, int P>
struct Raw {
  using type = Pack<T>;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int P>
__device__ __forceinline__ typename Raw<T, P>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, P>::type*>(p);
}

template <typename T, int P>
__device__ __forceinline__ void unpack(const typename Raw<T, P>::type& r, float (&o)[P]) {
  if constexpr (P == 1) {
    o[0] = to_f32(r);
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) o[k] = to_f32(r.v[k]);
  }
}

// a streaming store: y is written once here and read by the next kernel
template <typename T, int P>
__device__ __forceinline__ void store_vec(T* p, const float (&o)[P]) {
  if constexpr (P == 1) {
    p[0] = from_f32<T>(o[0]);
  } else {
    Pack<T> v;
#pragma unroll
    for (int k = 0; k < P; ++k) v.v[k] = from_f32<T>(o[k]);
    int4 bits;
    memcpy(&bits, &v, 16);
    __stcs(reinterpret_cast<int4*>(p), bits);
  }
}

template <int P>
__device__ __forceinline__ void accumulate(float (&s)[P], float (&q)[P], const float (&v)[P]) {
#pragma unroll
  for (int k = 0; k < P; ++k) {
    s[k] += v[k];
    q[k] += v[k] * v[k];
  }
}

// One launch per call: a cooperative grid of at most one block per SM.  Item
// i = b * K + k is the contiguous range of positions [k * rows, (k + 1) *
// rows) of batch row b, all C4 channels; block j takes items j, j + grid, ...
//   1. the block reads its item (kLoadRows rows in flight a thread), keeps
//      the first `staged` positions in shared memory, sums x and x^2 per
//      channel, folds its row lanes in a fixed order and writes the item's
//      partials; the positions it cannot keep are read last;
//   2. one grid barrier (cooperative_groups' grid sync);
//   3. every block of row b sums the row's K partials in rank order, then
//      per group over the group-major member list: bit-identical statistics
//      in every block, with no second barrier or launch;
//   4. it normalises the positions it could not keep first (read again,
//      largely from L2), then the kept ones from shared memory, and stores y
//      in 16-byte vectors.
// Thread geometry: the C4 / P vectors of a position are split into CT tiles
// of VT vectors; thread t runs vector t % VT of a tile over the rows t / VT
// (mod RL = kThreadsN / VT) of an item.  A thread reads back from shared
// memory only what it wrote there.
template <typename T, int P>
__global__ void __launch_bounds__(kThreadsN, 1) nhwc_gn_silu(const NhwcArgs a) {
  using RawT = typename Raw<T, P>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int H = a.H, W = a.W, HW = H * W, C4 = a.C4, G = a.G, K = a.K;
  const int V = C4 / P, CT = (V + kThreadsN - 1) / kThreadsN, VT = (V + CT - 1) / CT;
  const int RL = kThreadsN / VT, vl = tid % VT, rl = tid / VT;
  const int items = a.B * K;
  float* red = reinterpret_cast<float*>(smem);
  float* gm = red + nhwc_red_floats(C4, P);
  float* gi = gm + G;
  int* ord = reinterpret_cast<int*>(gi + G);
  T* stage = reinterpret_cast<T*>(smem + nhwc_fixed_bytes(C4, G, P));
  const T* x = static_cast<const T*>(a.x);
  T* y = static_cast<T*>(a.y);

  // loaded now, used after the grid barrier: the group-major channel list
  // and this thread's channels of tile 0 (group, affine, phase bits)
  for (int i = tid; i < G + 1 + C4; i += kThreadsN) ord[i] = __ldg(a.order + i);
  int gch[P];
  float sc[P], bi[P];
  unsigned row_bit = 0u, col_bit = 0u;
  auto channels = [&](int ct) {
    const int v = ct * VT + vl, c4 = C4 / 4;
    row_bit = col_bit = 0u;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int c = v * P + k;
      gch[k] = __ldg(a.group_of + c);
      sc[k] = __ldg(a.scale + c);
      bi[k] = __ldg(a.bias + c);
      if (a.offset) {
        row_bit |= (unsigned)((c / (2 * c4)) & 1) << k;
        col_bit |= (unsigned)((c / c4) & 1) << k;
      }
    }
  };
  if (rl < RL && vl < V) channels(0);

  // -- 1. sum, keeping the staged positions ------------------------------------
  int j = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
    const int b = item / K, p0 = (item - b * K) * a.rows;
    const int np = min(HW - p0, a.rows), ns = min(np, a.staged);
    const T* xi = x + ((size_t)b * HW + p0) * C4;
    T* st = stage + (size_t)j * a.staged * C4;
    float* pi = a.part + (size_t)item * 2 * C4;
    for (int ct = 0; ct < CT; ++ct) {
      const int v = ct * VT + vl;
      float s[P], q[P];
#pragma unroll
      for (int k = 0; k < P; ++k) s[k] = q[k] = 0.f;
      if (rl < RL && v < V) {
        const T* xv = xi + v * P;
        T* sv = st + v * P;
        int r = rl;
        for (; r + (kLoadRows - 1) * RL < np; r += kLoadRows * RL) {
          RawT t[kLoadRows];
#pragma unroll
          for (int u = 0; u < kLoadRows; ++u) t[u] = load_raw<T, P>(xv + (size_t)(r + u * RL) * C4);
#pragma unroll
          for (int u = 0; u < kLoadRows; ++u) {
            if (r + u * RL < ns) *reinterpret_cast<RawT*>(sv + (size_t)(r + u * RL) * C4) = t[u];
            float f[P];
            unpack<T, P>(t[u], f);
            accumulate<P>(s, q, f);
          }
        }
        for (; r < np; r += RL) {
          const RawT t = load_raw<T, P>(xv + (size_t)r * C4);
          if (r < ns) *reinterpret_cast<RawT*>(sv + (size_t)r * C4) = t;
          float f[P];
          unpack<T, P>(t, f);
          accumulate<P>(s, q, f);
        }
      }
      // fold the RL row lanes of each (sum, channel) in a fixed order: four
      // running sums over lanes l = 0, 1, 2, 3 (mod 4), then ((0 + 1) + (2 + 3))
#pragma unroll
      for (int k = 0; k < P; ++k) {
        red[k * kThreadsN + tid] = s[k];
        red[(P + k) * kThreadsN + tid] = q[k];
      }
      __syncthreads();
      for (int it = tid; it < 2 * P * VT; it += kThreadsN) {
        const int i = it % VT, k = (it / VT) % P, sum = it / (VT * P);
        if (ct * VT + i >= V) continue;
        const float* col = red + (sum * P + k) * kThreadsN + i;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int l = 0;
        for (; l + 3 < RL; l += 4) {
          a0 += col[l * VT];
          a1 += col[(l + 1) * VT];
          a2 += col[(l + 2) * VT];
          a3 += col[(l + 3) * VT];
        }
        for (; l < RL; ++l) a0 += col[l * VT];
        pi[sum * C4 + (ct * VT + i) * P + k] = (a0 + a1) + (a2 + a3);
      }
      __syncthreads();
    }
  }

  // -- 2. every item's partials are written: one grid barrier, or with one
  // block per batch row (K = 1, the same for every block) the block's own --
  if (K > 1)
    cooperative_groups::this_grid().sync();
  else
    __syncthreads();

  const int warp = tid / 32, lane = tid % 32;
  const int dh = RL / W, dw = RL - dh * W;
  j = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
    const int b = item / K, p0 = (item - b * K) * a.rows;
    const int np = min(HW - p0, a.rows), ns = min(np, a.staged);
    const size_t base = ((size_t)b * HW + p0) * C4;
    const T* st = stage + (size_t)j * a.staged * C4;

    // -- 3. the row's statistics: K partials in rank order (loads of eight
    // ranks in flight at once), then each group over its members --------------
    const float* pb = a.part + (size_t)b * K * 2 * C4;
    for (int c = tid; c < C4; c += kThreadsN) {
      float u1 = 0.f, u2 = 0.f;
      for (int k0 = 0; k0 < K; k0 += 8) {
        float l1[8], l2[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float* pk = pb + (size_t)min(k0 + u, K - 1) * 2 * C4 + c;
          l1[u] = __ldcg(pk);
          l2[u] = __ldcg(pk + C4);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (k0 + u < K) {
            u1 += l1[u];
            u2 += l2[u];
          }
        }
      }
      red[c] = u1;
      red[C4 + c] = u2;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kThreadsN / 32) {
      float u1 = 0.f, u2 = 0.f;
      for (int i = ord[g] + lane; i < ord[g + 1]; i += 32) {
        const int m = ord[G + 1 + i];
        u1 += red[m];
        u2 += red[C4 + m];
      }
      u1 = warp_sum(u1);
      u2 = warp_sum(u2);
      if (lane == 0) {
        const float mean = u1 / a.n;
        gm[g] = mean;
        // __fmul_rn keeps mean^2 rounded on its own, as the plain version
        // rounds it, instead of contracting the difference into an fma
        gi[g] = rsqrtf(fmaxf(__fsub_rn(u2 / a.n, __fmul_rn(mean, mean)), 0.f) + a.eps);
      }
    }
    __syncthreads();

    // -- 4. normalise ------------------------------------------------------------
    for (int ct = 0; ct < CT; ++ct) {
      const int v = ct * VT + vl;
      if (rl >= RL || v >= V) continue;
      if (CT > 1) channels(ct);
      float mu[P], iv[P];
#pragma unroll
      for (int k = 0; k < P; ++k) {
        const bool ok = (unsigned)gch[k] < (unsigned)G;
        mu[k] = ok ? gm[ok ? gch[k] : 0] : __int_as_float(0x7fc00000);
        iv[k] = ok ? gi[ok ? gch[k] : 0] : __int_as_float(0x7fc00000);
      }
      T* yv = y + base + v * P;
      // y at row r (position p0 + r = (h, w)): affine, SiLU, mask, store
      auto out = [&](float(&o)[P], int r, int h, int w) {
        unsigned kill = 0u;
        if (a.offset) {
          if (h == 0) kill |= ~row_bit;
          if (h == H - 1) kill |= row_bit;
          if (w == 0) kill |= ~col_bit;
          if (w == W - 1) kill |= col_bit;
        }
#pragma unroll
        for (int k = 0; k < P; ++k) {
          float val = ((o[k] - mu[k]) * iv[k]) * sc[k] + bi[k];
          val = __fdividef(val, 1.0f + __expf(-val));
          if ((kill >> k) & 1u) val *= 0.f;
          o[k] = val;
        }
        store_vec<T, P>(yv + (size_t)r * C4, o);
      };
      // rows [r_begin, r_end) of the item from src, kOutRows at a time
      auto rows_out = [&](const T* src, int r_begin, int r_end) {
        int r = r_begin + rl;
        int h = (p0 + r) / W, w = p0 + r - h * W;
        for (; r < r_end; r += kOutRows * RL) {
          RawT t[kOutRows];
#pragma unroll
          for (int u = 0; u < kOutRows; ++u)
            if (r + u * RL < r_end) t[u] = load_raw<T, P>(src + (size_t)(r + u * RL) * C4);
#pragma unroll
          for (int u = 0; u < kOutRows; ++u) {
            if (r + u * RL >= r_end) break;
            float o[P];
            unpack<T, P>(t[u], o);
            out(o, r + u * RL, h, w);
            w += dw;
            h += dh;
            if (w >= W) {
              w -= W;
              ++h;
            }
          }
        }
      };
      rows_out(x + base + v * P, ns, np);  // read twice: the last read before the barrier
      rows_out(st + v * P, 0, ns);
    }
    __syncthreads();  // red, gm and gi hold the next item's row
  }
}

template <typename T, int P>
int launch_nhwc_p(const NhwcArgs& a, int grid, int smem, cudaStream_t stream) {
  const auto kernel = nhwc_gn_silu<T, P>;
  static bool configured[64] = {};  // per device: the shared-memory ceiling is raised
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64)) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxN);
    configured[dev] = err == cudaSuccess;
  }
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreadsN, (size_t)smem);
  if (err != cudaSuccess) return (int)err;
  // a cooperative grid must be resident at once, or its barrier never opens
  if ((int64_t)per_sm * sms < grid) return (int)cudaErrorCooperativeLaunchTooLarge;
  NhwcArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3((unsigned)grid),
                                    dim3(kThreadsN), params, (size_t)smem, stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_nhwc(const void* x, const void* scale, const void* bias, const void* group_of,
                const void* order, void* y, void* work, int B, int H, int W, int C4, int G,
                int K, int rows, int staged, int grid, int smem, float n, int offset, float eps,
                void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || W <= 0 || C4 <= 0 || C4 > 4096 || G <= 0 || G > 1024 ||
      !(n > 0.f) || (offset && C4 % 4 != 0) || (int64_t)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // the plan: K ranges of `rows` positions cover a row, none of them empty;
  // the grid holds no block without an item
  constexpr int P = 16 / sizeof(T);
  const bool vec = C4 % P == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int64_t HW = (int64_t)H * W, items = (int64_t)B * K;
  if (K < 1 || rows < 1 || (int64_t)(K - 1) * rows >= HW || (int64_t)K * rows < HW ||
      items > 0x7fffffffLL || grid < 1 || grid > items || staged < 0 || staged > rows)
    return (int)cudaErrorInvalidValue;
  const int64_t per_block = (items + grid - 1) / grid;
  const int64_t want = nhwc_fixed_bytes(C4, G, vec ? P : 1) +
                       per_block * staged * C4 * (int64_t)sizeof(T);
  if (smem != want || smem > kSmemMaxN) return (int)cudaErrorInvalidValue;
  NhwcArgs a;
  a.x = x;
  a.y = y;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.group_of = static_cast<const int*>(group_of);
  a.order = static_cast<const int*>(order);
  a.part = static_cast<float*>(work);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C4 = C4;
  a.G = G;
  a.K = K;
  a.rows = rows;
  a.staged = staged;
  a.n = n;
  a.eps = eps;
  a.offset = offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_nhwc_p<T, P>(a, grid, smem, s) : launch_nhwc_p<T, 1>(a, grid, smem, s);
}

// ------------------------------------------------------------------ NCHW ----
constexpr int kThreadsC = 512;     // threads of one CTA, at most
constexpr int kClusterC = 8;       // CTAs of one cluster, at most (the portable limit)
constexpr int kLoadsC = 8;         // units a thread has in flight while it reads its slice
constexpr int kSmemMaxC = 231424;  // dynamic shared memory of a CTA: 227 KB less 1 KB kept
                                   // for the static reduction arrays

// One call's arguments and its plan (ops/gn_silu.py::nchw_plan).  A unit is
// what one load moves: a 16-byte pack of P elements, or one element.
struct NchwArgs {
  const void* x;
  void* y;
  const float* w;
  const float* b;
  int64_t n;  // elements of a run (one batch row's group: cg * HW)
  int G, cg;
  int upc;    // units of a channel: HW / P
  int runs;   // B * G
  int q;      // CTAs of a cluster; a run is split into q slices
  int rpc;    // runs of a CTA (q == 1 only)
  int tpr;    // threads of a run in its CTA, whole warps
  int slice;  // units of a slice (the last one may be shorter)
  int cap;    // units of a slice kept in shared memory; the rest is read twice
  float eps;
};

// the channel of unit i of a run as i steps by `step`, without a division a step
struct ChannelWalk {
  int c, r, dq, dr, upc;
  __device__ ChannelWalk(int i, int step, int upc_)
      : c(i / upc_), r(i % upc_), dq(step / upc_), dr(step % upc_), upc(upc_) {}
  __device__ void next() {
    c += dq;
    r += dr;
    if (r >= upc) {
      r -= upc;
      ++c;
    }
  }
};

// One launch per call.  Run r (batch row r / G, group r % G) is cg * HW
// contiguous elements.  With q > 1 the q CTAs of cluster r each take one
// slice of run r; with q == 1 CTA i takes runs i * rpc ... (i + 1) * rpc - 1,
// tpr threads a run.  Thread j of a run handles units lo + j + m * tpr of its
// slice [lo, hi).
//   1. it reads its units once, kLoadsC 16-byte loads in flight, keeps them
//      in shared memory (the first `cap` units of the slice: all of it at
//      every flagship site) and sums x and x^2 in f32, in order; units past
//      `cap` are read again in step 3;
//   2. a warp shuffle tree, then the run's warps in order, give the CTA's
//      sums; with q > 1 each CTA writes them to its shared memory, one
//      cluster barrier, and every warp reads the q partials through
//      distributed shared memory and sums them in rank order, so every CTA
//      of the run holds the same bits: no atomics, workspace or second
//      launch;
//   3. it normalises from shared memory, applies the affine and the SiLU,
//      rounds once and stores with 16-byte streaming stores.
// With q > 1 a second cluster barrier, split, comes before a CTA exits: it
// arrives once it has read its peers' partials and waits at its end, so
// that its own shared memory outlives its peers' reads.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreadsC) gn_silu_nchw(const NchwArgs a) {
  constexpr int P = kVec ? 16 / (int)sizeof(T) : 1;
  constexpr bool kFast = sizeof(T) == 2;
  using U = typename Raw<T, P>::type;
  extern __shared__ __align__(16) unsigned char nchw_stage[];
  __shared__ float red[2][kThreadsC / 32];
  __shared__ float part[2];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = a.q, tpr = a.tpr, slot = tid / tpr, j = tid - slot * tpr, wpr = tpr / 32;
  const int run = (int)(blockIdx.x / q) * a.rpc + slot;
  const bool live = run < a.runs;  // the last CTA may hold fewer runs
  const int rank = q > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  // unit offsets within a run fit an int: the launcher takes n < 2^31 - 2^13
  const int units = (int)(a.n / P), lo = rank * a.slice;
  const int hi = lo + a.slice < units ? lo + a.slice : units;
  const int mid = lo + a.cap < hi ? lo + a.cap : hi;  // [lo, mid) kept in shared memory
  const size_t base = (size_t)(live ? run : 0) * a.n;
  const U* xu = reinterpret_cast<const U*>(static_cast<const T*>(a.x) + base);
  U* yu = reinterpret_cast<U*>(static_cast<T*>(a.y) + base);
  U* st = reinterpret_cast<U*>(nchw_stage) + slot * a.cap;  // unit i at st[i - lo]

  // -- 1. read the slice once, sum ------------------------------------------------
  float s = 0.f, ss = 0.f;
  auto add = [&](const U& u) {
    float f[P];
    unpack<T, P>(u, f);
#pragma unroll
    for (int e = 0; e < P; ++e) {
      s += f[e];
      ss += f[e] * f[e];
    }
  };
  if (live) {
    int i = lo + j;
    for (; i + (kLoadsC - 1) * tpr < mid; i += kLoadsC * tpr) {
      U t[kLoadsC];
#pragma unroll
      for (int u = 0; u < kLoadsC; ++u) t[u] = xu[i + u * tpr];
#pragma unroll
      for (int u = 0; u < kLoadsC; ++u) {
        st[i + u * tpr - lo] = t[u];
        add(t[u]);
      }
    }
    for (; i < mid; i += tpr) {
      const U t = xu[i];
      st[i - lo] = t;
      add(t);
    }
    for (i = mid + j; i < hi; i += tpr) add(xu[i]);  // read again in step 3
  }

  // -- 2. the run's statistics ------------------------------------------------------
  s = warp_sum(s);  // every lane ends with the same bits
  ss = warp_sum(ss);
  if (q > 1 || wpr > 1) {
    if (lane == 0) {
      red[0][warp] = s;
      red[1][warp] = ss;
    }
    __syncthreads();
    s = ss = 0.f;
    for (int w = slot * wpr; w < (slot + 1) * wpr; ++w) {
      s += red[0][w];
      ss += red[1][w];
    }
    if (q > 1) {
      auto cluster = cooperative_groups::this_cluster();
      if (tid == 0) {
        part[0] = s;
        part[1] = ss;
      }
      cluster.sync();
      float ps = 0.f, pss = 0.f;
      if (lane < q) {
        const float* peer = cluster.map_shared_rank(&part[0], lane);
        ps = peer[0];
        pss = peer[1];
      }
      s = ss = 0.f;
      for (int r = 0; r < q; ++r) {
        s += __shfl_sync(0xffffffffu, ps, r);
        ss += __shfl_sync(0xffffffffu, pss, r);
      }
      cluster.barrier_arrive();  // the second barrier, split: the peers' partials are read
    }
  }
  const float mean = s / (float)a.n;
  // __fmul_rn keeps mean^2 rounded on its own, as the plain version rounds it
  const float var = fmaxf(__fsub_rn(ss / (float)a.n, __fmul_rn(mean, mean)), 0.f);
  const float rstd = rsqrtf(var + a.eps);

  // -- 3. normalise from shared memory ------------------------------------------------
  if (live) {
    const float* wg = a.w + (run % a.G) * a.cg;
    const float* bg = a.b + (run % a.G) * a.cg;
    auto out = [&](const U& u, int i, const ChannelWalk& ch) {
      float f[P];
      unpack<T, P>(u, f);
      const float aw = rstd * __ldg(wg + ch.c), bc = __ldg(bg + ch.c);
#pragma unroll
      for (int e = 0; e < P; ++e) f[e] = norm_silu<kFast>(f[e], mean, aw, bc);
      store_vec<T, P>(reinterpret_cast<T*>(yu + i), f);
    };
    ChannelWalk ch(lo + j, tpr, a.upc);  // a unit never straddles two channels
    for (int i = lo + j; i < mid; i += tpr, ch.next()) out(st[i - lo], i, ch);
    ChannelWalk cr(mid + j, tpr, a.upc);
    for (int i = mid + j; i < hi; i += tpr, cr.next()) out(xu[i], i, cr);
  }
  if (q > 1) cooperative_groups::this_cluster().barrier_wait();
}

// Launch one instantiation with q CTAs a cluster (no cluster attribute for
// q == 1), raising the shared-memory ceiling once per device.  For q > 1 the
// clusters the card can hold at once are counted
// (cudaOccupancyMaxActiveClusters) once per device, q, threads and shared
// memory: fewer than one and the launch could never run, which is an error.
// With a == nullptr only the count is taken, into *clusters.
template <typename T, bool kVec>
int nchw_launch(const NchwArgs* a, int q, int threads, int grid, int smem, cudaStream_t stream,
                int* clusters) {
  const auto kernel = gn_silu_nchw<T, kVec>;
  static bool configured[64] = {};  // per device: the shared-memory ceiling is raised
  static int checked[64][4] = {};   // per device and log2(q): the configuration counted
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64)) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxC);
    configured[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)q;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = q > 1 ? 1 : 0;
  if (q > 1) {
    const int lq = q == 2 ? 1 : q == 4 ? 2 : 3, key = 1 + threads + (kThreadsC + 1) * smem;
    if (clusters != nullptr || checked[dev][lq] != key) {
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (clusters != nullptr) *clusters = n;
      if (n < 1) return (int)cudaErrorInvalidClusterSize;  // no cluster of q fits
      checked[dev][lq] = key;
    }
  }
  if (a == nullptr) return (int)cudaSuccess;
  err = cudaLaunchKernelEx(&cfg, kernel, *a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* w, const void* b, void* y, int B, int C, int HW, int G,
           float eps, int q, int threads, int rpc, int cap, int grid, int smem, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || (int64_t)B * G > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int PV = 16 / sizeof(T);
  const bool vec = HW % PV == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0;
  const int pack = vec ? PV : 1, unit = pack * (int)sizeof(T);
  const int64_t n = (int64_t)(C / G) * HW, units = n / pack, runs = (int64_t)B * G;
  if (n >= (1LL << 31) - 8192) return (int)cudaErrorInvalidValue;  // int unit offsets
  // the plan: q slices of a run (none empty) or rpc runs a CTA, whole warps a
  // run; each slice kept in shared memory up to the ceiling, and nothing
  // else there; a whole number of clusters, every run in one of them
  if (!(q == 1 || q == 2 || q == 4 || q == kClusterC) || rpc < 1 || (q > 1 && rpc > 1) ||
      threads < 32 || threads > kThreadsC || threads % rpc != 0 || (threads / rpc) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t slice = (units + q - 1) / q, room = kSmemMaxC / ((int64_t)rpc * unit);
  if ((int64_t)(q - 1) * slice >= units || cap != (slice < room ? slice : room) ||
      (int64_t)smem != (int64_t)rpc * cap * unit || (int64_t)grid != (runs + rpc - 1) / rpc * q)
    return (int)cudaErrorInvalidValue;
  NchwArgs a;
  a.x = x;
  a.y = y;
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.n = n;
  a.G = G;
  a.cg = C / G;
  a.upc = HW / pack;
  a.runs = (int)runs;
  a.q = q;
  a.rpc = rpc;
  a.tpr = threads / rpc;
  a.slice = (int)slice;
  a.cap = cap;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? nchw_launch<T, true>(&a, q, threads, grid, smem, s, nullptr)
             : nchw_launch<T, false>(&a, q, threads, grid, smem, s, nullptr);
}

}  // namespace

// x, y: [B, C, H, W] with HW = H * W; w, b: [C] f32.  q, threads, rpc, cap,
// grid and smem are the plan of ops/gn_silu.py::nchw_plan, which the
// launcher checks.
extern "C" int gn_silu_f32(const void* x, const void* w, const void* b, void* y, int B, int C,
                           int HW, int G, float eps, int q, int threads, int rpc, int cap,
                           int grid, int smem, void* stream) {
  return launch<float>(x, w, b, y, B, C, HW, G, eps, q, threads, rpc, cap, grid, smem, stream);
}

extern "C" int gn_silu_bf16(const void* x, const void* w, const void* b, void* y, int B, int C,
                            int HW, int G, float eps, int q, int threads, int rpc, int cap,
                            int grid, int smem, void* stream) {
  return launch<__nv_bfloat16>(x, w, b, y, B, C, HW, G, eps, q, threads, rpc, cap, grid, smem,
                               stream);
}

// The clusters of q CTAs that the card holds at once for the NCHW kernel of
// element size elem (2 or 4), 16-byte packs or not, with `threads` a CTA and
// `smem` bytes of staging: cudaOccupancyMaxActiveClusters.
extern "C" int gn_silu_nchw_max_clusters(int elem, int vec, int threads, int q, int smem,
                                         int* clusters) {
  if (q < 2 || q > kClusterC || threads < 32 || threads > kThreadsC || smem < 0 ||
      smem > kSmemMaxC || !(elem == 2 || elem == 4))
    return (int)cudaErrorInvalidValue;
  if (elem == 4)
    return vec ? nchw_launch<float, true>(nullptr, q, threads, q, smem, 0, clusters)
               : nchw_launch<float, false>(nullptr, q, threads, q, smem, 0, clusters);
  return vec ? nchw_launch<__nv_bfloat16, true>(nullptr, q, threads, q, smem, 0, clusters)
             : nchw_launch<__nv_bfloat16, false>(nullptr, q, threads, q, smem, 0, clusters);
}

// x, y: [B, H, W, C4]; scale, bias: [C4] f32; group_of: [C4] int32 in [0, G);
// order: [G + 1 + C4] int32, the member offsets of each group, then the
// channels sorted by group; work: B * K * 2 * C4 floats; n: the statistics'
// divisor; offset != 0 zeroes the offset grid's out-of-range rows and
// columns after the SiLU.  K, rows, staged, grid and smem are the grid plan
// of ops/gn_silu.py::nhwc_plan, which the launcher checks.
extern "C" int gn_silu_nhwc_f32(const void* x, const void* scale, const void* bias,
                                const void* group_of, const void* order, void* y, void* work,
                                int B, int H, int W, int C4, int G, int K, int rows, int staged,
                                int grid, int smem, float n, int offset, float eps,
                                void* stream) {
  return launch_nhwc<float>(x, scale, bias, group_of, order, y, work, B, H, W, C4, G, K, rows,
                            staged, grid, smem, n, offset, eps, stream);
}

extern "C" int gn_silu_nhwc_bf16(const void* x, const void* scale, const void* bias,
                                 const void* group_of, const void* order, void* y, void* work,
                                 int B, int H, int W, int C4, int G, int K, int rows, int staged,
                                 int grid, int smem, float n, int offset, float eps,
                                 void* stream) {
  return launch_nhwc<__nv_bfloat16>(x, scale, bias, group_of, order, y, work, B, H, W, C4, G, K,
                                    rows, staged, grid, smem, n, offset, eps, stream);
}
