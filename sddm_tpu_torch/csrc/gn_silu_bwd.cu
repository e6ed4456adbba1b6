// Fused GroupNorm + SiLU backward, NCHW, f32 and bf16, sm_90a.
//
// The gradient of the NCHW forward of csrc/gn_silu.cu (gn_silu_nchw), which
// replaces the Pallas kernel
// sddm_tpu/experimental/pallas_groupnorm_swish.py::group_norm_swish.  That
// kernel has no VJP in the JAX package: JAX trains the flagship by letting XLA
// differentiate flax's GroupNorm -> swish (sddm_tpu/models/blocks.py::Block),
// so no TPU kernel is the model for this one.  It computes the gradient of
// ops/gn_silu.py::gn_silu_reference, the function the forward kernel computes.
// Per run (one batch row's group), with the forward's statistics
// mean = E[x], v = E[x^2] - mean^2, r = rsqrt(max(v, 0) + eps), and per
// element xhat = (x - mean) r, y = (x - mean) (r w) + b, s = sigmoid(y):
//   dz      = dy s (1 + y (1 - s));
//   dbias   = sum over (batch, position) of dz;
//   dweight = sum over (batch, position) of dz xhat;
//   dx      = r (dz w - mean_run(dz w) - xhat mean_run(dz w xhat)),
// the last term dropped where v < 0, as torch's clamp_min passes no gradient
// there (a constant run whose E[x^2] rounds below mean^2).
//
// Bound: memory traffic.  The function reads x and dy once and writes dx once
// (the affine and dweight/dbias are [C]); at some thirty f32 operations per
// element it is under the card's ridge: 0.060 ms for the largest flagship
// site [16, 64, 256, 128] in bf16 at 3.35 TB/s, 0.120 ms in f32.  dx needs
// two sums over the whole run (of dz w and dz w xhat), and those need the
// run's statistics, so a design that streams the run from device memory
// makes three passes; once the 512 runs in flight of a flagship site
// outgrow the 50 MB L2 it moves about twice the bytes the function needs.
// This design (gn_silu_bwd_run) reads x and dy once and keeps them on chip:
//   * a run of up to 32 KB of x (as much again of dy) is one CTA's, small runs
//     several to a CTA of up to 256 threads while every SM keeps a CTA, a
//     warp or a few a run; a larger run is split across the q <= 8 CTAs of a
//     thread-block cluster;
//   * pass 1 reads the CTA's slice of x and dy with 16-byte loads, eight of
//     each in flight a thread, keeps both in shared memory and sums x and
//     x^2; the cluster's partials meet through distributed shared memory,
//     summed in rank order in every CTA, so all CTAs of a run hold the same
//     mean and r;
//   * pass 2, from shared memory, sums dz and dz xhat per channel of the
//     slice (a slice may cross channel boundaries: a run is cg channels of
//     HW contiguous values), four channels' warp trees interleaved, writes
//     each channel's partials to a [2, q, C, B] workspace and sums w dz and
//     w dz xhat over its channels; those two partials meet across the
//     cluster as the statistics did;
//   * pass 3, from shared memory, computes dx and stores it with 16-byte
//     streaming stores; where a channel has fewer units than the run has
//     threads it sweeps the slice a unit a thread, not channel by channel;
//   * dweight and dbias: once a run's partials are written it takes an
//     integer ticket of its group with one acquire-release atomic; the run
//     that takes the group's last one (of B q) sums the group's channels of
//     the workspace, a channel a thread, over the ranks that share a channel
//     and then the batch rows, in order (the ticket picks the run, not the
//     order of a float sum).  So the G groups' sums run in parallel at the
//     end of the launch, on as many CTAs, with no fence: the ticket's
//     acquire orders the sum's loads.  One launch a call;
//   * a slice larger than the shared memory keeps what fits and reads the
//     rest again in each pass (no flagship site does).
// What holds it back.  At the largest site (per-CTA timestamps taken in
// development): a CTA's life is some 8 us of loads, then 6 and 7 us of passes
// 2 and 3, in which three CTAs an SM keep its schedulers and MUFU pipe busy
// (the sigmoid is computed in both passes in bf16); loads and arithmetic
// overlap only where CTAs of an SM happen to be in different phases, so the
// kernel takes about the sum of its memory time and its arithmetic, each
// near the 0.060 ms bound.  Slower there in development: an f32 copy of dz
// in shared memory for bf16 (the room it takes costs more CTAs an SM than
// the sigmoid it saves), dy streamed in pass 2 with dz kept, a persistent
// grid whose CTAs prefetch the next run's slice with cp.async, and CTAs of
// an SM started apart.  At the smallest sites a call is a chain of
// latencies (load, per-channel sums, the partials' release, dx, the group's
// sum); the group sum's loads are 16-byte and eight rows at once, as more
// live registers spill.
// Arithmetic: in bf16 the sigmoid is recomputed in pass 3 with __expf and
// __fdividef (whose few f32 ulps lie far under the result's bf16 rounding;
// with the IEEE versions the kernel was a quarter slower in development).
// In f32, dz replaces dy in shared memory in pass 2, at no cost in room, so
// pass 3 computes no sigmoid; the sigmoid is IEEE there.  The kernel is held
// to 64 registers a thread, so that three CTAs of 256 threads share an SM.
// Sums are taken in a fixed order with no float atomics (the port's rule: the
// same call gives the same bits): a thread's units in order, a warp xor tree,
// the warps of a run in order, then the cluster's ranks in order.  The plan
// (cluster size, threads, runs a CTA, shared memory, grid) is computed in
// ops/gn_silu.py::nchw_backward_plan and checked by the launcher.
//
// C interface, loaded with ctypes: one launcher per type.  It takes device
// pointers, the sizes, the plan and a cudaStream_t, launches on that stream
// without synchronising, allocates nothing (the workspace and the tickets
// are the caller's) and returns cudaGetLastError() or the launch's error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreadsB = 512;     // threads of one CTA, at most
constexpr int kClusterB = 8;       // CTAs of one cluster, at most (the portable limit)
constexpr int kLoadsB = 8;         // units of x, and as many of dy, a thread has in flight
constexpr int kChunkB = 16;        // channels whose CTA sums are met at once
constexpr int kIlpB = 4;           // channels whose warp sums are taken together
constexpr int kSmemMaxB = 229376;  // dynamic shared memory of a CTA: 227 KB less 3 KB kept
                                   // for the static reduction arrays

template <typename T>
struct alignas(16) Pack {
  T v[16 / sizeof(T)];
};

// P elements as loaded: a 16-byte pack, or one element
template <typename T, int P>
struct Raw {
  using type = Pack<T>;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

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

template <typename T, int P>
__device__ __forceinline__ void unpack(const typename Raw<T, P>::type& r, float (&o)[P]) {
  if constexpr (P == 1) {
    o[0] = to_f32(r);
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) o[k] = to_f32(r.v[k]);
  }
}

// f32 values as a unit of the f32 stage (dz in place of dy)
template <int P>
__device__ __forceinline__ typename Raw<float, P>::type repack(const float (&f)[P]) {
  if constexpr (P == 1) {
    return f[0];
  } else {
    Pack<float> u;
#pragma unroll
    for (int k = 0; k < P; ++k) u.v[k] = f[k];
    return u;
  }
}

// a streaming store: dx is written once here and read by the next kernel
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

// a ticket: an atomic add at device scope that releases the partials this
// run wrote before it (the barrier before it orders the writing threads'
// stores) and acquires those of the runs that took a ticket before it, so
// that the run taking a group's last ticket reads every partial of the group
// with no fence of its own (a fence there would wait for its dx stores)
__device__ __forceinline__ unsigned int take_ticket(unsigned int* t) {
  unsigned int old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(old) : "l"(t) : "memory");
  return old;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the xor tree leaves the same bits in every lane
}

// dz of one element, y computed in the forward's order ((x - mean) * (r * w)
// + b) so that s is the forward's sigmoid.  kFast (bf16): __expf, __fdividef.
template <bool kFast>
__device__ __forceinline__ float dz_of(float d, float g, float aw, float bc) {
  const float y = d * aw + bc;
  const float s = kFast ? __fdividef(1.f, 1.f + __expf(-y)) : 1.f / (1.f + expf(-y));
  return g * s * (1.f + y * (1.f - s));
}

// One call's arguments and its plan (ops/gn_silu.py::nchw_backward_plan).  A
// unit is what one load moves: a 16-byte pack of P elements, or one element.
struct BwdArgs {
  const void* x;
  const void* dy;
  const float* w;
  const float* b;
  void* dx;
  float* part;  // [2, q, C, B]: per rank, channel and batch row, sum of dz xhat, then of dz
  float* dw;
  float* db;
  unsigned int* ticket;  // [G]: per group, runs (of a rank) done with their partials;
                         // 0 between calls
  int64_t n;    // elements of a run (one batch row's group: cg * HW)
  int B, C, G, cg;
  int upc;    // units of a channel: HW / P
  int runs;   // B * G
  int q;      // CTAs of a cluster; a run is split into q slices
  int rpc;    // runs of a CTA (q == 1 only)
  int tpr;    // threads of a run in its CTA, whole warps
  int slice;  // units of a slice (the last one may be shorter)
  int cap;    // units of a slice kept in shared memory; the rest is read again
  float eps;
};

// The rows r0 ... r0 + R - 1 of one channel's partials, each summed over the
// ranks first ... last in order, added in row order to (sw, sb); kVec: four
// rows a 16-byte load (B a multiple of 4, all R rows below B), else a row
// past B reads row B - 1 and is not added.  Loads go past L1: the partials
// were written by other SMs.
template <int R, bool kVec>
__device__ __forceinline__ void add_rows(const float* pw, const float* pb, size_t plane,
                                         int first, int last, int r0, int B, float& sw,
                                         float& sb) {
  float tw[R], tb[R];
#pragma unroll
  for (int u = 0; u < R; ++u) tw[u] = tb[u] = 0.f;
  for (int k = first; k <= last; ++k) {
    const float* qw = pw + k * plane + r0;
    const float* qb = pb + k * plane + r0;
    if constexpr (kVec) {
#pragma unroll
      for (int u = 0; u < R; u += 4) {
        const float4 w4 = __ldcg(reinterpret_cast<const float4*>(qw + u));
        const float4 b4 = __ldcg(reinterpret_cast<const float4*>(qb + u));
        tw[u] += w4.x;
        tw[u + 1] += w4.y;
        tw[u + 2] += w4.z;
        tw[u + 3] += w4.w;
        tb[u] += b4.x;
        tb[u + 1] += b4.y;
        tb[u + 2] += b4.z;
        tb[u + 3] += b4.w;
      }
    } else {
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int r = r0 + u < B ? u : B - 1 - r0;
        tw[u] += __ldcg(qw + r);
        tb[u] += __ldcg(qb + r);
      }
    }
  }
#pragma unroll
  for (int u = 0; u < R; ++u) {
    if (kVec || r0 + u < B) {
      sw += tw[u];
      sb += tb[u];
    }
  }
}

// dweight[c] and dbias[c] of the channels of group grp, by the tpr threads of
// the run that took the group's last ticket, a channel a thread: per batch
// row, the partials of the ranks whose slices hold channel c, in rank order;
// then the rows in order.  A channel's rows are contiguous in the workspace,
// so where B is a multiple of 4 a thread loads eight rows at once, two
// 16-byte loads a tensor (sixteen rows spill registers); else four rows.
__device__ void sum_group(const BwdArgs& a, int grp, int j, int tpr) {
  const size_t plane = (size_t)a.C * a.B;  // one rank's [C, B]
  for (int ci = j; ci < a.cg; ci += tpr) {
    const int c = grp * a.cg + ci;
    const int first = (int)((int64_t)ci * a.upc / a.slice);
    const int last = (int)(((int64_t)(ci + 1) * a.upc - 1) / a.slice);
    const float* pw = a.part + (size_t)c * a.B;
    const float* pb = pw + (size_t)a.q * plane;
    float sw = 0.f, sb = 0.f;
    int r0 = 0;
    if (a.B % 4 == 0) {
      for (; r0 + 8 <= a.B; r0 += 8) add_rows<8, true>(pw, pb, plane, first, last, r0, a.B, sw, sb);
      for (; r0 < a.B; r0 += 4) add_rows<4, true>(pw, pb, plane, first, last, r0, a.B, sw, sb);
    } else {
      for (; r0 < a.B; r0 += 4) add_rows<4, false>(pw, pb, plane, first, last, r0, a.B, sw, sb);
    }
    a.dw[c] = sw;
    a.db[c] = sb;
  }
}

// One launch per call.  Run r (batch row r / G, group r % G) is
// cg * HW contiguous elements.  With q > 1 the q CTAs of cluster r each take
// one slice of run r; with q == 1 CTA i takes runs i * rpc ... (i + 1) * rpc -
// 1, tpr threads a run.  The first `cap` units [lo, mid) of a slice [lo, hi)
// are kept in shared memory (x in one region, dy after it), the rest read from
// device memory in each pass.  In pass 1 thread j takes units lo + j + m * tpr;
// in pass 2 it takes units a + j + m * tpr of each channel [a, b) of the
// slice, the kept ones first, and so in pass 3 unless a channel has fewer
// units than tpr, where pass 3 takes units lo + j + m * tpr.
// With q > 1 a third cluster barrier, split, comes before a CTA exits: it
// arrives once it has read its peers' partials and waits at its end, so that
// its own shared memory outlives its peers' reads.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreadsB, 2) gn_silu_bwd_run(const BwdArgs a) {
  constexpr int P = kVec ? 16 / (int)sizeof(T) : 1;
  constexpr bool kFast = sizeof(T) == 2;
  constexpr bool kCache = sizeof(T) == 4;  // dz replaces dy in shared memory
  using U = typename Raw<T, P>::type;
  extern __shared__ __align__(16) unsigned char bwd_stage[];
  __shared__ float red[2][kThreadsB / 32];
  __shared__ float cred[2][kChunkB][kThreadsB / 32];
  __shared__ float msum[kThreadsB / 32][2];  // per run of the CTA: sum of w dz, of w dz xhat
  __shared__ float stat[2];
  __shared__ int last_run[kThreadsB / 32];  // per run of the CTA: it sums its group
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int q = a.q, tpr = a.tpr, slot = tid / tpr, j = tid - slot * tpr, wpr = tpr / 32;
  const int w0 = slot * wpr;  // the run's first warp
  const int run = (int)(blockIdx.x / q) * a.rpc + slot;
  const bool live = run < a.runs;  // the last CTA may hold fewer runs
  const int rank = q > 1 ? (int)cooperative_groups::this_cluster().block_rank() : 0;
  // unit offsets within a run fit an int: the launcher takes n < 2^31 - 2^13
  const int units = (int)(a.n / P), lo = rank * a.slice;
  const int hi = lo + a.slice < units ? lo + a.slice : units;
  const int mid = lo + a.cap < hi ? lo + a.cap : hi;  // [lo, mid) kept in shared memory
  const int r0 = live ? run : 0;
  const size_t base = (size_t)r0 * (size_t)a.n;
  const U* xu = reinterpret_cast<const U*>(static_cast<const T*>(a.x) + base);
  const U* gu = reinterpret_cast<const U*>(static_cast<const T*>(a.dy) + base);
  U* du = reinterpret_cast<U*>(static_cast<T*>(a.dx) + base);
  U* sx = reinterpret_cast<U*>(bwd_stage) + (size_t)slot * a.cap;  // unit i at sx[i - lo]
  U* sg = reinterpret_cast<U*>(bwd_stage) + (size_t)(a.rpc + slot) * a.cap;
  const int grp = r0 % a.G, row = r0 / a.G;
  const float* wg = a.w + (size_t)grp * a.cg;
  const float* bg = a.b + (size_t)grp * a.cg;
  const int kfirst = lo / a.upc, klast = (hi - 1) / a.upc;  // the slice's channels
  // the weights and biases of the slice's first kChunkB channels, a channel a
  // lane, loaded before x so that passes 2 and 3 find them in registers
  const int kn0 = klast + 1 - kfirst < kChunkB ? klast + 1 - kfirst : kChunkB;
  const float wl0 = lane < kn0 ? __ldg(wg + kfirst + lane) : 0.f;
  const float bl0 = lane < kn0 ? __ldg(bg + kfirst + lane) : 0.f;

  // -- 1. read the slice of x and dy once, keep it, sum x and x^2 ----------------
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
    for (; i + (kLoadsB - 1) * tpr < mid; i += kLoadsB * tpr) {
      U t[kLoadsB], d[kLoadsB];
#pragma unroll
      for (int u = 0; u < kLoadsB; ++u) {
        t[u] = xu[i + u * tpr];
        d[u] = gu[i + u * tpr];
      }
#pragma unroll
      for (int u = 0; u < kLoadsB; ++u) {
        sx[i + u * tpr - lo] = t[u];
        sg[i + u * tpr - lo] = d[u];
        add(t[u]);
      }
    }
    for (; i < mid; i += tpr) {
      const U t = xu[i];
      sx[i - lo] = t;
      sg[i - lo] = gu[i];
      add(t);
    }
    for (i = mid + j; i < hi; i += tpr) add(xu[i]);  // read again in passes 2 and 3
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  s = ss = 0.f;
  for (int w = w0; w < w0 + wpr; ++w) {
    s += red[0][w];
    ss += red[1][w];
  }
  if (q > 1) {
    auto cluster = cooperative_groups::this_cluster();
    if (tid == 0) {
      stat[0] = s;
      stat[1] = ss;
    }
    cluster.sync();
    float ps = 0.f, pss = 0.f;
    if (lane < q) {
      const float* peer = cluster.map_shared_rank(&stat[0], lane);
      ps = peer[0];
      pss = peer[1];
    }
    s = ss = 0.f;
    for (int r = 0; r < q; ++r) {
      s += __shfl_sync(0xffffffffu, ps, r);
      ss += __shfl_sync(0xffffffffu, pss, r);
    }
  }
  const float mean = s / (float)a.n;
  // __fmul_rn keeps mean^2 rounded on its own, as the plain version rounds it
  const float v = __fsub_rn(ss / (float)a.n, __fmul_rn(mean, mean));
  const float rstd = rsqrtf(fmaxf(v, 0.f) + a.eps);

  // -- 2. per channel of the slice: sums of dz and dz xhat; of w dz, w dz xhat ----
  float mdz = 0.f, mdzx = 0.f;  // in the run's first warp
  for (int k0 = kfirst; k0 <= klast; k0 += kChunkB) {
    const int kn = klast + 1 - k0 < kChunkB ? klast + 1 - k0 : kChunkB;
    // the chunk's weights and biases, a channel a lane, loaded once
    const float wl = k0 == kfirst ? wl0 : lane < kn ? __ldg(wg + k0 + lane) : 0.f;
    const float bl = k0 == kfirst ? bl0 : lane < kn ? __ldg(bg + k0 + lane) : 0.f;
    // kIlpB channels at a time, so that their warp trees interleave
    for (int kb = 0; kb < kn; kb += kIlpB) {
      float sdz[kIlpB], sdzx[kIlpB];
#pragma unroll
      for (int t = 0; t < kIlpB; ++t) {
        const int kk = kb + t < kn ? kb + t : kn - 1;
        const float wc = __shfl_sync(0xffffffffu, wl, kk), bc = __shfl_sync(0xffffffffu, bl, kk);
        sdz[t] = sdzx[t] = 0.f;
        if (live && kb + t < kn) {
          const int k = k0 + kk;
          const int ca = k * a.upc > lo ? k * a.upc : lo;
          const int cb = (k + 1) * a.upc < hi ? (k + 1) * a.upc : hi;
          const float aw = rstd * wc;
          auto sum = [&](const U& ux, const U& ug, U* keep) {
            float fx[P], fg[P];
            unpack<T, P>(ux, fx);
            unpack<T, P>(ug, fg);
#pragma unroll
            for (int e = 0; e < P; ++e) {
              const float d = fx[e] - mean;
              fg[e] = dz_of<kFast>(d, fg[e], aw, bc);
              sdz[t] += fg[e];
              sdzx[t] += fg[e] * (d * rstd);
            }
            if constexpr (kCache) {
              if (keep != nullptr) *keep = repack<P>(fg);
            }
          };
          const int cm = cb < mid ? cb : mid;
          for (int i = ca + j; i < cm; i += tpr) sum(sx[i - lo], sg[i - lo], sg + (i - lo));
          for (int i = (ca > mid ? ca : mid) + j; i < cb; i += tpr) sum(xu[i], gu[i], nullptr);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {  // warp_sum's xor tree, level by level
#pragma unroll
        for (int t = 0; t < kIlpB; ++t) {
          sdz[t] += __shfl_xor_sync(0xffffffffu, sdz[t], off);
          sdzx[t] += __shfl_xor_sync(0xffffffffu, sdzx[t], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int t = 0; t < kIlpB; ++t) {
          if (kb + t < kn) {
            cred[0][kb + t][warp] = sdzx[t];
            cred[1][kb + t][warp] = sdz[t];
          }
        }
      }
    }
    __syncthreads();
    if (warp == w0) {
      float pdzx = 0.f, pdz = 0.f;
      if (lane < kn) {
        for (int w = w0; w < w0 + wpr; ++w) {
          pdzx += cred[0][lane][w];
          pdz += cred[1][lane][w];
        }
        if (live) {
          const size_t c = (size_t)grp * a.cg + k0 + lane;
          a.part[((size_t)rank * a.C + c) * a.B + row] = pdzx;
          a.part[((size_t)(q + rank) * a.C + c) * a.B + row] = pdz;
        }
      }
      mdz += warp_sum(wl * pdz);
      mdzx += warp_sum(wl * pdzx);
    }
    __syncthreads();  // cred is filled again by the next chunk
  }
  // this run's partials are written: take its group's ticket (read after pass 3)
  unsigned int taken = 0u;
  if (j == 0 && live) taken = take_ticket(a.ticket + grp);
  if (warp == w0 && lane == 0) {
    msum[slot][0] = mdz;
    msum[slot][1] = mdzx;
  }
  if (q > 1) {
    auto cluster = cooperative_groups::this_cluster();
    cluster.sync();
    float pm = 0.f, pmx = 0.f;
    if (lane < q) {
      const float* peer = cluster.map_shared_rank(&msum[0][0], lane);
      pm = peer[0];
      pmx = peer[1];
    }
    mdz = mdzx = 0.f;
    for (int r = 0; r < q; ++r) {
      mdz += __shfl_sync(0xffffffffu, pm, r);
      mdzx += __shfl_sync(0xffffffffu, pmx, r);
    }
    cluster.barrier_arrive();  // the third barrier, split: the peers' partials are read
  } else {
    __syncthreads();
    mdz = 0.f + msum[slot][0];
    mdzx = 0.f + msum[slot][1];
  }
  const float m1 = mdz / (float)a.n;
  const float m2 = v >= 0.f ? mdzx / (float)a.n : 0.f;  // clamp_min's gradient

  // -- 3. dx from shared memory ----------------------------------------------------
  auto out = [&](const U& ux, const U& ug, bool cached, int i, float wc, float bc) {
    const float aw = rstd * wc;
    float fx[P], fg[P];
    unpack<T, P>(ux, fx);
    unpack<T, P>(ug, fg);
#pragma unroll
    for (int e = 0; e < P; ++e) {
      const float d = fx[e] - mean;
      const float dz = kCache && cached ? fg[e] : dz_of<kFast>(d, fg[e], aw, bc);
      fx[e] = rstd * (dz * wc - m1 - (d * rstd) * m2);
    }
    store_vec<T, P>(reinterpret_cast<T*>(du + i), fx);
  };
  if (live && a.upc < tpr && klast - kfirst < kChunkB) {
    // channels of fewer units than the run has threads: the slice in sweeps of
    // a unit a thread, each unit's weight and bias from the lane that holds it
    for (int i0 = lo; i0 < hi; i0 += tpr) {
      const int i = i0 + j, k = (i < hi ? i : hi - 1) / a.upc - kfirst;
      const float wc = __shfl_sync(0xffffffffu, wl0, k), bc = __shfl_sync(0xffffffffu, bl0, k);
      if (i < mid) out(sx[i - lo], sg[i - lo], true, i, wc, bc);
      else if (i < hi) out(xu[i], gu[i], false, i, wc, bc);
    }
  } else if (live) {
    for (int k0 = kfirst; k0 <= klast; k0 += kChunkB) {
      const int kn = klast + 1 - k0 < kChunkB ? klast + 1 - k0 : kChunkB;
      const float wl = k0 == kfirst ? wl0 : lane < kn ? __ldg(wg + k0 + lane) : 0.f;
      const float bl = k0 == kfirst ? bl0 : lane < kn ? __ldg(bg + k0 + lane) : 0.f;
      for (int kk = 0; kk < kn; ++kk) {
        const int k = k0 + kk;
        const int ca = k * a.upc > lo ? k * a.upc : lo;
        const int cb = (k + 1) * a.upc < hi ? (k + 1) * a.upc : hi;
        const float wc = __shfl_sync(0xffffffffu, wl, kk), bc = __shfl_sync(0xffffffffu, bl, kk);
        const int cm = cb < mid ? cb : mid;
        for (int i = ca + j; i < cm; i += tpr) out(sx[i - lo], sg[i - lo], true, i, wc, bc);
        for (int i = (ca > mid ? ca : mid) + j; i < cb; i += tpr)
          out(xu[i], gu[i], false, i, wc, bc);
      }
    }
  }
  // -- dweight and dbias: the run that took its group's last ticket sums the group --
  if (j == 0) last_run[slot] = live && taken == (unsigned)a.B * (unsigned)q - 1u;
  __syncthreads();
  if (last_run[slot]) {
    sum_group(a, grp, j, tpr);
    if (j == 0) a.ticket[grp] = 0u;  // ready for the next call on this stream
  }
  if (q > 1) cooperative_groups::this_cluster().barrier_wait();
}

// Launch the run kernel with q CTAs a cluster (no cluster attribute for
// q == 1), raising the shared-memory ceiling once per device; for q > 1 the
// clusters the card can hold at once are counted once per device, q, threads
// and shared memory: fewer than one and the launch could never run.
template <typename T, bool kVec>
int run_launch(const BwdArgs& a, int threads, int grid, int smem, cudaStream_t stream) {
  const auto kernel = gn_silu_bwd_run<T, kVec>;
  static bool configured[64] = {};  // per device: the shared-memory ceiling is raised
  static int checked[64][4] = {};   // per device and log2(q): the configuration counted
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && (dev < 0 || dev >= 64)) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !configured[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxB);
    configured[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = (unsigned)a.q;
  attr.val.clusterDim.y = attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = a.q > 1 ? 1 : 0;
  if (a.q > 1) {
    const int lq = a.q == 2 ? 1 : a.q == 4 ? 2 : 3, key = 1 + threads + (kThreadsB + 1) * smem;
    if (checked[dev][lq] != key) {
      int n = 0;
      err = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (n < 1) return (int)cudaErrorInvalidClusterSize;  // no cluster of q fits
      checked[dev][lq] = key;
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* dy, const void* w, const void* b, void* dx, void* part,
           void* dw, void* db, void* ticket, int B, int C, int HW, int G, float eps, int q,
           int threads, int rpc, int cap, int grid, int smem, void* stream) {
  if (B <= 0 || C <= 0 || HW <= 0 || G <= 0 || C % G != 0 || (int64_t)B * G > 0x7fffffffLL ||
      (int64_t)B * q > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int PV = 16 / sizeof(T);
  const bool vec = HW % PV == 0 && (uintptr_t)x % 16 == 0 && (uintptr_t)dy % 16 == 0 &&
                   (uintptr_t)dx % 16 == 0;
  const int pack = vec ? PV : 1, unit = pack * (int)sizeof(T);
  const int64_t n = (int64_t)(C / G) * HW, units = n / pack, runs = (int64_t)B * G;
  if (n >= (1LL << 31) - 8192) return (int)cudaErrorInvalidValue;  // int unit offsets
  if ((uintptr_t)part % 16 != 0) return (int)cudaErrorInvalidValue;  // its rows' 16-byte loads
  // the plan: q slices of a run (none empty) or rpc runs a CTA, whole warps a
  // run; each slice's x and dy kept in shared memory up to the ceiling, and
  // nothing else there; a whole number of clusters, every run in one of them
  if (!(q == 1 || q == 2 || q == 4 || q == kClusterB) || rpc < 1 || (q > 1 && rpc > 1) ||
      threads < 32 || threads > kThreadsB || threads % rpc != 0 || (threads / rpc) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t slice = (units + q - 1) / q, room = kSmemMaxB / (2LL * rpc * unit);
  if ((int64_t)(q - 1) * slice >= units || cap != (slice < room ? slice : room) ||
      (int64_t)smem != 2LL * rpc * cap * unit || (int64_t)grid != (runs + rpc - 1) / rpc * q)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.x = x;
  a.dy = dy;
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.dx = dx;
  a.part = static_cast<float*>(part);
  a.dw = static_cast<float*>(dw);
  a.db = static_cast<float*>(db);
  a.ticket = static_cast<unsigned int*>(ticket);
  a.n = n;
  a.B = B;
  a.C = C;
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
  return vec ? run_launch<T, true>(a, threads, grid, smem, s)
             : run_launch<T, false>(a, threads, grid, smem, s);
}

}  // namespace

// x, dy, dx: [B, C, H, W] with HW = H * W, contiguous, of one type; w, b, dw,
// db: [C] f32; part: a [2, q, C, B] f32 workspace, 16-byte aligned; ticket: G unsigned ints,
// 0 before the call and 0 after it (the caller keeps them per stream).  q,
// threads, rpc, cap, grid and smem are the plan of
// ops/gn_silu.py::nchw_backward_plan, which the launcher checks.
extern "C" int gn_silu_bwd_f32(const void* x, const void* dy, const void* w, const void* b,
                               void* dx, void* part, void* dw, void* db, void* ticket, int B,
                               int C, int HW, int G, float eps, int q, int threads, int rpc,
                               int cap, int grid, int smem, void* stream) {
  return launch<float>(x, dy, w, b, dx, part, dw, db, ticket, B, C, HW, G, eps, q, threads, rpc,
                       cap, grid, smem, stream);
}

extern "C" int gn_silu_bwd_bf16(const void* x, const void* dy, const void* w, const void* b,
                                void* dx, void* part, void* dw, void* db, void* ticket, int B,
                                int C, int HW, int G, float eps, int q, int threads, int rpc,
                                int cap, int grid, int smem, void* stream) {
  return launch<__nv_bfloat16>(x, dy, w, b, dx, part, dw, db, ticket, B, C, HW, G, eps, q,
                               threads, rpc, cap, grid, smem, stream);
}
