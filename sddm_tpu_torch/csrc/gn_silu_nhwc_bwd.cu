// Backward of the NHWC GroupNorm + SiLU (+ offset mask), f32 and bf16, sm_90a.
//
// No Pallas kernel is its model: the JAX package trains its packed engine
// (sddm_tpu/models/unet_packed.py::PackedTrainUNetModified2) by letting XLA
// differentiate the jnp chain _GN -> jax.nn.silu -> offset mask.  The port's
// forward of that chain is the CUDA kernel nhwc_gn_silu (csrc/gn_silu.cu,
// which replaces sddm_tpu/experimental/pallas_gn_silu.py::gn_silu), so its
// gradient is a kernel too.  x and dy are [B, H, W, C4]; packed channel c
// belongs to group group_of[c].  Per batch row b and group g the forward
// wrote mean and v = s2 / n - mean^2 (unclamped) into `stats`; with
// r = rsqrt(max(v, 0) + eps), xhat = (x - mean) r, y = xhat * scale + bias,
// s = sigmoid(y) and the offset mask m:
//   dz = (dy m) s (1 + y (1 - s)),
//   dbias_c = sum over b and positions of dz, dscale_c = sum of dz xhat,
//   dx = r (dz scale - A_bg / n - xhat B_bg / n), with A_bg = sum over c in g
//   of scale_c sum_pos dz and B_bg of scale_c sum_pos dz xhat; the last term
//   is dropped where v < 0 (the clamp passes no gradient there).
// So per (row, channel) sums of dz and dz xhat give every reduction.
//
// Bound: memory traffic.  The function reads x and dy once and writes dx
// once: 0.060 ms for the largest flagship site [16, 128, 64, 256] bf16 at
// 3.35 TB/s.  dx needs the row's sums, which need the whole row, and a row
// of x and dy (8.4 MB at that site) outgrows any block; so the design keeps
// each block's range of x and dy in shared memory between its sums and its
// dx, and the card takes a call's rows in waves that fit its shared memory:
//   * one cooperative launch (nhwc_bwd_fused) of at most as many 512-thread
//     blocks as are co-resident (one an SM);
//   * item i = b * K + k is the range of `rows` positions [k * rows, ...) of
//     batch row b, all channels (one span of memory); block j takes items j,
//     j + grid, ...: the rows in waves;
//   * a block keeps two items in shared memory where the plan allows it
//     (`buffers`); each arrives by bulk copies (TMA: x, dy and the row's
//     statistics, issued by one thread) in four chunks, each completing its
//     own mbarrier, and the copy of a slot's next item starts chunk by chunk
//     as dx is written from it, so the card streams the next item while the
//     block works;
//   * A, per item: the sums of dz and dz xhat per channel from shared memory
//     (each thread over its row lane in order, the row lanes folded in a
//     fixed order), the item's channel partials and group partials (sum over
//     the group's members of scale times the channel partials), stored, and
//     the row's integer ticket taken (a release add, not waited on, by a
//     thread other than the one that then waits for a row);
//   * B, per item, once its row's ticket reads K: the row's group sums from
//     its K items' partials in rank order, by 16-byte loads all in flight
//     (fold_groups: every block of the row gets the same bits), then dx
//     from shared memory (in float32 A leaves dz in dy's place, the same
//     width, so B does not compute it again).  With two buffers a block runs
//     A of its next item before B of this one, so the wait for the row is
//     spent on arithmetic and a row may span two waves; with one, a wave is
//     whole rows.  Every
//     block of the grid is resident, and a block takes the ticket of every
//     item it has summed before it waits for a row (two buffers: K up to
//     twice the grid; one: K up to the grid), so every wait ends;
//   * after a grid barrier, each row's channel sums over its K items, then
//     after another dscale and dbias over the rows, each block a share of
//     the values in a fixed order; block 0 sets the tickets back to zero for
//     the next call on the stream.
// Why it is built so (development readings on an H100): per item a block
// otherwise waits out a chain of L2 round trips (the channels' constants, the
// statistics, a ticket's value, a row's published sums) as long as its
// arithmetic, and a row whose blocks wait right after their sums waits a
// whole item for any part of it in the next wave.  So the channels'
// constants stay in registers, the statistics arrive with the item, no block
// waits for a ticket's value, the row's sums are one round trip of loads,
// the channel sums wait for the end, and the items are as large as two fit.
// No float atomics: the same inputs give the same bits.  A range larger than
// the block's shared memory keeps its first `staged` positions and reads the
// rest again (no flagship site does).  Without 16-byte spans (odd C4 or
// pointers) the threads stage the item themselves, one item a block.  The
// sigmoid of a bf16 call uses __expf and __fdividef, as the forward.  The
// plan (ranges a row, positions a range and staged, buffers, grid, shared
// memory) is computed in ops/gn_silu.py::nhwc_backward_plan from the
// co-resident blocks that gn_silu_nhwc_bwd_blocks_per_sm reports, and
// checked by the launcher.
//
// C interface, loaded with ctypes: gn_silu_nhwc_bwd_f32 and _bf16 take
// device pointers, the sizes, the plan and a cudaStream_t, launch on that
// stream without synchronising, allocate nothing, and return the launch's
// error or cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kThreadsB = 512;     // threads of a block
constexpr int kBlocksPerSmB = 1;   // blocks an SM the registers are sized for (128 a thread)
constexpr int kRowsB = 2;          // rows of x and dy a thread has in flight
constexpr int kPackBytesB = 8;     // bytes of x (and of dy) a thread takes at a position
constexpr int kChunksB = 4;        // copies an item arrives in, with two buffers
constexpr int kSmemMaxB = 232448;  // dynamic shared memory of a block, at most (227 KB)

// P channels of one position as a thread loads them
template <typename T, int P>
struct alignas(sizeof(T) * P) Pack {
  T v[P];
};

// the bits of a pack
template <int Bytes>
struct Bits;
template <>
struct Bits<16> {
  using type = int4;
};
template <>
struct Bits<8> {
  using type = int2;
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
struct Raw {
  using type = Pack<T, P>;
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
__device__ __forceinline__ void store_raw(T* p, const typename Raw<T, P>::type& v) {
  *reinterpret_cast<typename Raw<T, P>::type*>(p) = v;
}

// x and dy from device memory, cached in L2 only (the staged item takes
// nearly all of the SM's shared memory, which leaves L1 small)
template <typename T, int P>
__device__ __forceinline__ typename Raw<T, P>::type load_stream(const T* p) {
  if constexpr (P == 1) {
    return *p;
  } else {
    using B = typename Bits<sizeof(T) * P>::type;
    const B bits = __ldcg(reinterpret_cast<const B*>(p));
    Pack<T, P> v;
    memcpy(&v, &bits, sizeof(B));
    return v;
  }
}

// P floats as a pack of T
template <typename T, int P>
__device__ __forceinline__ typename Raw<T, P>::type pack(const float (&o)[P]) {
  typename Raw<T, P>::type v;
  if constexpr (P == 1) {
    v = from_f32<T>(o[0]);
  } else {
#pragma unroll
    for (int k = 0; k < P; ++k) v.v[k] = from_f32<T>(o[k]);
  }
  return v;
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

template <typename T, int P>
__device__ __forceinline__ void store_vec(T* p, const float (&o)[P]) {
  if constexpr (P == 1) {
    p[0] = from_f32<T>(o[0]);
  } else {
    using B = typename Bits<sizeof(T) * P>::type;
    Pack<T, P> v;
#pragma unroll
    for (int k = 0; k < P; ++k) v.v[k] = from_f32<T>(o[k]);
    B bits;
    memcpy(&bits, &v, sizeof(B));
    __stcs(reinterpret_cast<B*>(p), bits);
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;  // the xor tree leaves the same bits in every lane
}

// a ticket: an atomic add at device scope, without a wait for its value,
// that releases the partials the block stored before it (the barrier before
// it orders the storing threads' stores)
__device__ __forceinline__ void take_ticket(unsigned int* t) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" ::"l"(t) : "memory");
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* t) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(t) : "memory");
  return v;
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
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

// a contiguous copy of `bytes` (a multiple of 16) completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// Shared memory before the staging area, in bytes rounded up to 128: 128
// bytes for the mbarriers (one a slot and chunk) and an int, then floats [2, P, kThreadsB] row-lane
// sums, [2, C4] the item's channel sums, [C4] scale, [2, G] group sums, [4,
// G] group mean, r, A / n and B / n, then ints [G + 1 + C4], the group-major
// channel list.  ops/gn_silu.py::nhwc_backward_fixed_bytes computes the same.
__host__ __device__ constexpr int bwd_fixed_bytes(int C4, int G, int P) {
  return ((128 + 4 * (2 * P * kThreadsB + 3 * C4 + 6 * G + G + 1 + C4) + 127) / 128) * 128;
}

// One staged item: x and dy of `staged` positions, then the row's [G, 2]
// statistics, in bytes rounded up to 16.  ops/gn_silu.py::nhwc_backward_plan
// computes the same.
__host__ __device__ constexpr int64_t bwd_item_bytes(int staged, int C4, int G, int elem) {
  return ((2 * (int64_t)staged * C4 * elem + 8 * (int64_t)G + 15) / 16) * 16;
}

struct BwdArgs {
  const void* x;
  const void* dy;
  void* dx;
  const float* scale;
  const float* bias;
  const int* group_of;
  const int* order;      // [G + 1] offsets into the members, then [C4] channels by group
  const float* stats;    // [B, G, 2]: the forward's mean and s2 / n - mean^2
  float* row_c;          // [B, 2, C4]: each row's sums of dz and dz * xhat
  float* row_g;          // [B, 2, G]: a one-range row's group sums (of scale times row_c)
  float* part_c;         // [B * K, 2, C4]: each item's sums of dz and dz * xhat (K > 1)
  float* part_g;         // [B * K, 2, G]: each item's sums times scale, per group (K > 1)
  unsigned int* ticket;  // [B]: items of the row done with their partials; zero between calls
  float* dscale;
  float* dbias;
  int B, H, W, C4, G;
  int K;        // ranges (items) a batch row
  int rows;     // positions a range; the last range of a row may be shorter
  int staged;   // positions of a range kept in shared memory; the rest is read twice
  int buffers;  // items a block keeps at once: 2 (the next copied as the last is read) or 1
  int stats_bulk;  // the row's statistics come with the bulk copies (else the threads copy them)
  float n, eps;
  int offset;
};

// The thread geometry: the C4 / P vectors of a position are split into CT
// tiles of VT vectors; thread t runs vector t % VT of a tile over the rows
// t / VT (mod RL = kThreadsB / VT) of an item.
struct Geometry {
  int V, CT, VT, RL, vl, rl;
  __device__ Geometry(int C4, int P) {
    V = C4 / P;
    CT = (V + kThreadsB - 1) / kThreadsB;
    VT = (V + CT - 1) / CT;
    RL = kThreadsB / VT;
    vl = threadIdx.x % VT;
    rl = threadIdx.x / VT;
  }
};

// One thread's P channels of a tile: group, affine, phase bits (offset sites)
template <int P>
struct Channels {
  int grp[P];
  float sc[P], bi[P];
  unsigned row_bit, col_bit;
  __device__ void load(const BwdArgs& a, int v) {
    const int c4 = a.C4 / 4;
    row_bit = col_bit = 0u;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int c = v * P + k;
      grp[k] = __ldg(a.group_of + c);
      sc[k] = __ldg(a.scale + c);
      bi[k] = __ldg(a.bias + c);
      if (a.offset) {
        row_bit |= (unsigned)((c / (2 * c4)) & 1) << k;
        col_bit |= (unsigned)((c / c4) & 1) << k;
      }
    }
  }
  // the channels the offset mask zeroes at (h, w)
  __device__ unsigned kill(const BwdArgs& a, int h, int w) const {
    unsigned k = 0u;
    if (h == 0) k |= ~row_bit;
    if (h == a.H - 1) k |= row_bit;
    if (w == 0) k |= ~col_bit;
    if (w == a.W - 1) k |= col_bit;
    return k;
  }
};

// the (h, w) of a thread's rows: position p0 + rl, then steps of RL
struct Walk {
  int h, w, dh, dw, W;
  __device__ Walk(int p, int step, int W_)
      : h(p / W_), w(p % W_), dh(step / W_), dw(step % W_), W(W_) {}
  __device__ void next() {
    w += dw;
    h += dh;
    if (w >= W) {
      w -= W;
      ++h;
    }
  }
};

// dz of one element, and xhat: y = xhat * scale + bias as the forward forms
// it, s = sigmoid(y), dz = (dy m) s (1 + y (1 - s))
template <bool kFast>
__device__ __forceinline__ float grad_z(float x, float g, float mu, float r, float sc, float bi,
                                        float& xhat) {
  xhat = (x - mu) * r;
  const float y = xhat * sc + bi;
  const float s = kFast ? __fdividef(1.0f, 1.0f + __expf(-y)) : 1.0f / (1.0f + expf(-y));
  return g * (s * (1.0f + y * (1.0f - s)));
}

// For j < nv: the sum over ranks k < K of load(j, k), by the whole block,
// handed to store(j, sum).  L lanes a value (the largest power of two up to
// 32 with nv * L <= kThreadsB): lane q sums ranks q, q + L, ... in order (its
// loads independent, so in flight together), then the L lanes by a shuffle
// tree.  The transcription in tests/test_torch_gn_silu_nhwc_backward.py
// follows it.
template <typename Load, typename Store>
__device__ __forceinline__ void fold_ranks(int nv, int K, Load load, Store store) {
  int lg = 0;
  while (lg < 5 && nv * (2 << lg) <= kThreadsB) ++lg;
  const int L = 1 << lg, q = threadIdx.x & (L - 1);
  for (int base = 0; base < nv; base += kThreadsB >> lg) {
    const int j = base + ((int)threadIdx.x >> lg);
    float u = 0.f;
    if (j < nv) {
#pragma unroll 8
      for (int k = q; k < K; k += L) u += load(j, k);
    }
    for (int off = L / 2; off > 0; off >>= 1) u += __shfl_xor_sync(0xffffffffu, u, off);
    if (q == 0 && j < nv) store(j, u);
  }
}

// For j < G2 (even G2 / 2): out[j] = the sum over ranks k < K of src[k * G2 +
// j], by the whole block with 16-byte loads: NV = G2 / 4 threads a rank, Q =
// kThreadsB / NV lanes; lane q sums ranks q, q + Q, ... in order (about K /
// Q independent loads, in flight together), the Q lanes then through `red`
// ([Q, G2] floats) by four running sums over q = 0, 1, 2, 3 (mod 4), then
// ((0 + 1) + (2 + 3)).  The transcription in
// tests/test_torch_gn_silu_nhwc_backward.py follows it.
__device__ __forceinline__ void fold_groups(const float* src, int G2, int K, float* red,
                                            float* out) {
  const int nv = G2 / 4, nq = kThreadsB / nv, q = threadIdx.x / nv, jv = threadIdx.x % nv;
  if (q < nq) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int k = q; k < K; k += nq) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(src + (size_t)k * G2) + jv);
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    reinterpret_cast<float4*>(red + q * G2)[jv] = acc;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < G2; j += kThreadsB) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
    int i = 0;
    for (; i + 3 < nq; i += 4) {
      a0 += red[i * G2 + j];
      a1 += red[(i + 1) * G2 + j];
      a2 += red[(i + 2) * G2 + j];
      a3 += red[(i + 3) * G2 + j];
    }
    for (; i < nq; ++i) a0 += red[i * G2 + j];
    out[j] = (a0 + a1) + (a2 + a3);
  }
}

template <typename T, int P>
__global__ void __launch_bounds__(kThreadsB, kBlocksPerSmB) nhwc_bwd_fused(const BwdArgs a) {
  using RawT = typename Raw<T, P>::type;
  constexpr bool kFast = sizeof(T) == 2;
  constexpr bool kTma = P > 1;  // 16-byte spans: the items are staged by bulk copies
  constexpr bool kKeepDz = sizeof(T) == 4;  // dz takes a staged dy's place (same width)
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x;
  const int C4 = a.C4, G = a.G, K = a.K, HW = a.H * a.W, items = a.B * K, nb = a.buffers;
  const int nch = nb == 2 ? kChunksB : 1;  // chunks an item is copied in
  // one mbarrier a (slot, chunk); [64, 68): the members of the largest group
  const uint32_t bar0 = (uint32_t)__cvta_generic_to_shared(smem);
  int& most = *reinterpret_cast<int*>(smem + 64);
  float* red = reinterpret_cast<float*>(smem + 128);  // [2, P, kThreadsB]
  float* csum = red + 2 * P * kThreadsB;              // [2, C4]
  float* scs = csum + 2 * C4;                         // [C4]
  float* gsum = scs + C4;                             // [2, G]
  float* gm = gsum + 2 * G;
  float* gr = gm + G;
  float* ga = gr + G;
  float* gb = ga + G;
  int* ord = reinterpret_cast<int*>(gb + G);  // [G + 1 + C4]
  unsigned char* stage = smem + bwd_fixed_bytes(C4, G, P);
  const int64_t item_bytes = bwd_item_bytes(a.staged, C4, G, sizeof(T));
  if (tid == 0) {
    for (int i = 0; i < nb * nch; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    most = 1;
  }
  for (int i = tid; i < G + 1 + C4; i += kThreadsB) ord[i] = __ldg(a.order + i);
  for (int c = tid; c < C4; c += kThreadsB) scs[c] = __ldg(a.scale + c);
  __syncthreads();
  for (int g = tid; g < G; g += kThreadsB) atomicMax(&most, ord[g + 1] - ord[g]);
  const Geometry geo(C4, P);
  Channels<P> ch0;  // the thread's channels of tile 0: all of them where C4 / P <= kThreadsB
  if (geo.rl < geo.RL) ch0.load(a, geo.vl);
  __syncthreads();
  int ml = 1;  // lanes a group's partial: a power of two up to 32
  while (ml < 32 && ml < most) ml *= 2;
  const int mine = (items - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;
  // rows a chunk, a multiple of the row lanes: each thread's rows of a chunk
  // are the chunk's start plus its lane, then steps of RL
  const int chunk = geo.RL * ((((a.rows + nch - 1) / nch) + geo.RL - 1) / geo.RL);

  struct Item {
    int b, k, p0, np, ns;
    size_t base;
  };
  auto item_of = [&](int t) {
    Item it;
    const int i = blockIdx.x + t * gridDim.x;
    it.b = i / K;
    it.k = i - it.b * K;
    it.p0 = it.k * a.rows;
    it.np = min(HW - it.p0, a.rows);
    it.ns = min(it.np, a.staged);
    it.base = ((size_t)it.b * HW + it.p0) * C4;
    return it;
  };
  // the block's t-th item's staging (x, dy, statistics), the mbarrier of its
  // chunk c, and the phase that barrier completes for it
  auto slot = [&](int t) { return stage + (t % nb) * item_bytes; };
  auto bar = [&](int t, int c) { return bar0 + 8 * ((t % nb) * nch + c); };
  auto parity = [&](int t) { return (uint32_t)((t / nb) & 1); };
  // thread 0: start the copy of chunk c of the block's t-th item (the row's
  // statistics come with chunk 0); a chunk past the item's end completes
  // its phase empty
  auto stage_chunk = [&](int t, int c) {
    if (!kTma || t >= mine) return;
    const Item it = item_of(t);
    const int r0 = min(c * chunk, it.ns), r1 = min(r0 + chunk, it.ns);
    const size_t row_bytes = (size_t)C4 * sizeof(T), half = (size_t)a.staged * row_bytes;
    const uint32_t bytes = (uint32_t)((r1 - r0) * row_bytes);
    const uint32_t sbytes = a.stats_bulk && c == 0 ? 8u * G : 0u;
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(slot(t)) + (uint32_t)(r0 * row_bytes);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // the slot was read
    mbar_expect_tx(bar(t, c), 2 * bytes + sbytes);
    if (bytes) {
      bulk_load(dst, static_cast<const T*>(a.x) + it.base + (size_t)r0 * C4, bytes, bar(t, c));
      bulk_load(dst + (uint32_t)half, static_cast<const T*>(a.dy) + it.base + (size_t)r0 * C4,
                bytes, bar(t, c));
    }
    if (sbytes)
      bulk_load((uint32_t)__cvta_generic_to_shared(slot(t)) + (uint32_t)(2 * half),
                a.stats + (size_t)it.b * 2 * G, sbytes, bar(t, c));
  };

  // -- A: the t-th item's sums of dz and dz * xhat per channel, chunk by chunk
  // as its copies land, and its partials ------------------------------------------
  auto sums = [&](int t) {
    const Item it = item_of(t);
    const T* x = static_cast<const T*>(a.x) + it.base;
    const T* dy = static_cast<const T*>(a.dy) + it.base;
    T* sx = reinterpret_cast<T*>(slot(t));
    T* sg = sx + (size_t)a.staged * C4;
    float* sst = reinterpret_cast<float*>(sg + (size_t)a.staged * C4);  // [G, 2]
    if (kTma) mbar_wait(bar(t, 0), parity(t));  // the statistics come with chunk 0
    if (!a.stats_bulk) {
      for (int i = tid; i < 2 * G; i += kThreadsB)
        sst[i] = __ldg(a.stats + (size_t)it.b * 2 * G + i);
      __syncthreads();
    }
    for (int ct = 0; ct < geo.CT; ++ct) {
      const int v = ct * geo.VT + geo.vl;
      float s1[P], s2[P];
#pragma unroll
      for (int e = 0; e < P; ++e) s1[e] = s2[e] = 0.f;
      if (geo.rl < geo.RL && v < geo.V) {
        Channels<P> ch = ch0;
        if (ct > 0) ch.load(a, v);
        float mu[P], r[P];
#pragma unroll
        for (int e = 0; e < P; ++e) {  // NaN for a channel outside [0, G)
          const bool ok = (unsigned)ch.grp[e] < (unsigned)G;
          const int g = ok ? ch.grp[e] : 0;
          mu[e] = ok ? sst[2 * g] : __int_as_float(0x7fc00000);
          r[e] = ok ? rsqrtf(fmaxf(sst[2 * g + 1], 0.f) + a.eps) : __int_as_float(0x7fc00000);
        }
        // the rows, with the offset mask's select only where there is one
        auto rows = [&](auto masked) {
          constexpr bool kMasked = decltype(masked)::value;
          Walk pos(it.p0 + geo.rl, geo.RL, a.W);
          for (int c = 0; c < nch && c * chunk < it.np; ++c) {
            const int c1 = min((c + 1) * chunk, it.np);
            if (kTma && c > 0 && c * chunk < it.ns) mbar_wait(bar(t, c), parity(t));
            for (int row = c * chunk + geo.rl; row < c1; row += kRowsB * geo.RL) {
              RawT tx[kRowsB], tg[kRowsB];
#pragma unroll
              for (int u = 0; u < kRowsB; ++u) {
                const int rr = row + u * geo.RL;
                const size_t o = (size_t)rr * C4 + v * P;
                if (kTma && rr < it.ns) {
                  tx[u] = load_raw<T, P>(sx + o);
                  tg[u] = load_raw<T, P>(sg + o);
                } else if (rr < c1) {
                  tx[u] = load_stream<T, P>(x + o);
                  tg[u] = load_stream<T, P>(dy + o);
                }
              }
#pragma unroll
              for (int u = 0; u < kRowsB; ++u) {
                const int rr = row + u * geo.RL;
                if (rr >= c1) break;
                float fx[P], fg[P];
                unpack<T, P>(tx[u], fx);
                unpack<T, P>(tg[u], fg);
                unsigned kill = 0u;
                if (kMasked) {
                  kill = ch.kill(a, pos.h, pos.w);
                  pos.next();
                }
#pragma unroll
                for (int e = 0; e < P; ++e) {
                  float xhat;
                  const float g = kMasked && ((kill >> e) & 1u) ? fg[e] * 0.f : fg[e];
                  const float dz = grad_z<kFast>(fx[e], g, mu[e], r[e], ch.sc[e], ch.bi[e], xhat);
                  s1[e] += dz;
                  s2[e] += dz * xhat;
                  fg[e] = dz;
                }
                if (rr < it.ns) {  // x staged (by the threads without bulk copies); float32
                  const size_t o = (size_t)rr * C4 + v * P;  // keeps dz in dy's place
                  if (!kTma) store_raw<T, P>(sx + o, tx[u]);
                  if constexpr (kKeepDz) {
                    store_raw<T, P>(sg + o, pack<T, P>(fg));
                  } else if (!kTma) {
                    store_raw<T, P>(sg + o, tg[u]);
                  }
                }
              }
            }
          }
        };
        if (a.offset)
          rows(std::true_type{});
        else
          rows(std::false_type{});
      }
      // fold the RL row lanes of each channel: four running sums over lanes
      // l = 0, 1, 2, 3 (mod 4), then ((0 + 1) + (2 + 3))
#pragma unroll
      for (int e = 0; e < P; ++e) {
        red[e * kThreadsB + tid] = s1[e];
        red[(P + e) * kThreadsB + tid] = s2[e];
      }
      __syncthreads();
      for (int i2 = tid; i2 < 2 * P * geo.VT; i2 += kThreadsB) {
        const int i = i2 % geo.VT, e = (i2 / geo.VT) % P, sum = i2 / (geo.VT * P);
        if (ct * geo.VT + i >= geo.V) continue;
        const float* col = red + (sum * P + e) * kThreadsB + i;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int l = 0;
        for (; l + 3 < geo.RL; l += 4) {
          a0 += col[l * geo.VT];
          a1 += col[(l + 1) * geo.VT];
          a2 += col[(l + 2) * geo.VT];
          a3 += col[(l + 3) * geo.VT];
        }
        for (; l < geo.RL; ++l) a0 += col[l * geo.VT];
        csum[sum * C4 + (ct * geo.VT + i) * P + e] = (a0 + a1) + (a2 + a3);
      }
      __syncthreads();
    }
    // the item's group partials: each group's members times scale, `ml`
    // lanes a group (lane q over members q, q + ml, ... in order), then a
    // shuffle tree over the ml lanes
    const int lane = tid % 32, gpw = 32 / ml;
    for (int g0 = tid / 32 * gpw; g0 < G; g0 += kThreadsB / 32 * gpw) {
      const int g = g0 + lane / ml;
      float u1 = 0.f, u2 = 0.f;
      if (g < G) {
        for (int i = ord[g] + lane % ml; i < ord[g + 1]; i += ml) {
          const int m = ord[G + 1 + i];
          u1 += __fmul_rn(scs[m], csum[m]);
          u2 += __fmul_rn(scs[m], csum[C4 + m]);
        }
      }
      for (int off = ml / 2; off > 0; off >>= 1) {
        u1 += __shfl_xor_sync(0xffffffffu, u1, off);
        u2 += __shfl_xor_sync(0xffffffffu, u2, off);
      }
      if (g < G && lane % ml == 0) {
        gsum[g] = u1;
        gsum[G + g] = u2;
      }
    }
    __syncthreads();
    const size_t item = (size_t)it.b * K + it.k;
    float* pc = K > 1 ? a.part_c + item * 2 * C4 : a.row_c + (size_t)it.b * 2 * C4;
    float* pg = K > 1 ? a.part_g + item * 2 * G : a.row_g + (size_t)it.b * 2 * G;
    for (int i = tid; i < 2 * C4; i += kThreadsB) pc[i] = csum[i];
    for (int i = tid; i < 2 * G; i += kThreadsB) pg[i] = gsum[i];
    if (K > 1) {
      __syncthreads();  // the block's partials are stored before its ticket
      if (tid == 32 && nb > 1 && t == 0) take_ticket(a.ticket + it.b);  // (else in B)
    }
  };

  // -- B: the t-th item's dx, once its row's K items have taken their tickets.
  // First the ticket of the item A just summed, `summed`, by another thread
  // than the one that waits: the release's fence then overlaps the wait.  As
  // each chunk of the slot is read for the last time, the same chunk of the
  // block's item `next` is copied into it. ------------------------------------------
  auto finish = [&](int t, int summed, int next) {
    if (K > 1 && tid == 32 && summed >= 0) take_ticket(a.ticket + item_of(summed).b);
    const Item it = item_of(t);
    const T* x = static_cast<const T*>(a.x) + it.base;
    const T* dy = static_cast<const T*>(a.dy) + it.base;
    const T* sx = reinterpret_cast<const T*>(slot(t));
    const T* sg = sx + (size_t)a.staged * C4;
    const float* sst = reinterpret_cast<const float*>(sg + (size_t)a.staged * C4);
    if (K > 1 && tid == 0)
      while (load_acquire(a.ticket + it.b) < (unsigned)K) __nanosleep(32);
    __syncthreads();  // (K == 1: the block's own row sums are stored)
    if (K > 1) {  // the row's group sums, its K items' partials in rank order
      const float* src = a.part_g + (size_t)it.b * K * 2 * G;
      if (kTma && G % 2 == 0) {  // 16-byte loads; `red` holds the lanes
        fold_groups(src, 2 * G, K, red, gsum);
      } else {
        fold_ranks(2 * G, K, [&](int j, int k) { return __ldcg(src + (size_t)k * 2 * G + j); },
                   [&](int j, float u) { gsum[j] = u; });
      }
      __syncthreads();
    }
    for (int g = tid; g < G; g += kThreadsB) {
      const float* rg = K > 1 ? gsum : a.row_g + (size_t)it.b * 2 * G;
      const float v = sst[2 * g + 1];
      gm[g] = sst[2 * g];
      gr[g] = rsqrtf(fmaxf(v, 0.f) + a.eps);
      ga[g] = (K > 1 ? rg[g] : __ldcg(rg + g)) / a.n;
      gb[g] = v < 0.f ? 0.f : (K > 1 ? rg[G + g] : __ldcg(rg + G + g)) / a.n;
    }
    __syncthreads();
    T* dx = static_cast<T*>(a.dx) + it.base;
    const bool refill = kTma && next < mine;
    for (int c = 0; c < nch; ++c) {
      const int c0 = c * chunk, c1 = min(c0 + chunk, it.np);
      for (int ct = 0; ct < geo.CT && c0 < it.np; ++ct) {
        const int v = ct * geo.VT + geo.vl;
        if (geo.rl >= geo.RL || v >= geo.V) continue;
        Channels<P> ch = ch0;
        if (ct > 0) ch.load(a, v);
        // dx = r (dz scale - A / n - xhat B / n) = k1 dz + (k2 xhat + k0)
        float mu[P], r[P], k0[P], k1[P], k2[P];
#pragma unroll
        for (int e = 0; e < P; ++e) {
          const bool ok = (unsigned)ch.grp[e] < (unsigned)G;
          const int g = ok ? ch.grp[e] : 0;
          const float nan = __int_as_float(0x7fc00000);
          mu[e] = ok ? gm[g] : nan;
          r[e] = ok ? gr[g] : nan;
          k1[e] = r[e] * ch.sc[e];
          k0[e] = -(r[e] * (ok ? ga[g] : nan));
          k2[e] = -(r[e] * (ok ? gb[g] : nan));
        }
        auto rows = [&](auto masked) {
          constexpr bool kMasked = decltype(masked)::value;
          Walk pos(it.p0 + c0 + geo.rl, geo.RL, a.W);
          for (int row = c0 + geo.rl; row < c1; row += kRowsB * geo.RL) {
            RawT tx[kRowsB], tg[kRowsB];
#pragma unroll
            for (int u = 0; u < kRowsB; ++u) {
              const int rr = row + u * geo.RL;
              const size_t o = (size_t)rr * C4 + v * P;
              if (rr < it.ns) {
                tx[u] = load_raw<T, P>(sx + o);
                tg[u] = load_raw<T, P>(sg + o);
              } else if (rr < c1) {  // past the staged positions: read again
                tx[u] = load_stream<T, P>(x + o);
                tg[u] = load_stream<T, P>(dy + o);
              }
            }
#pragma unroll
            for (int u = 0; u < kRowsB; ++u) {
              const int rr = row + u * geo.RL;
              if (rr >= c1) break;
              float fx[P], fg[P], o[P];
              unpack<T, P>(tx[u], fx);
              unpack<T, P>(tg[u], fg);
              unsigned kill = 0u;
              if (kMasked) {
                kill = ch.kill(a, pos.h, pos.w);
                pos.next();
              }
              const bool kept = kKeepDz && rr < it.ns;  // dy's place holds dz
#pragma unroll
              for (int e = 0; e < P; ++e) {
                float xhat, dz;
                if (kept) {
                  xhat = (fx[e] - mu[e]) * r[e];
                  dz = fg[e];
                } else {
                  const float g = kMasked && ((kill >> e) & 1u) ? fg[e] * 0.f : fg[e];
                  dz = grad_z<kFast>(fx[e], g, mu[e], r[e], ch.sc[e], ch.bi[e], xhat);
                }
                o[e] = fmaf(k1[e], dz, fmaf(k2[e], xhat, k0[e]));
              }
              store_vec<T, P>(dx + (size_t)rr * C4 + v * P, o);
            }
          }
        };
        if (a.offset)
          rows(std::true_type{});
        else
          rows(std::false_type{});
      }
      if (refill) {
        __syncthreads();  // chunk c of the slot is read
        if (tid == 0) stage_chunk(next, c);
      }
    }
    __syncthreads();  // the slot and the shared coefficients are free again
  };

  // Every slot's first item is copied now.  Two buffers: A(t), then B(t - 1),
  // which copies item t + 1 into its slot chunk by chunk.  One: A(t), then
  // B(t), which copies item t + 1.
  if (tid == 0)
    for (int t = 0; t < nb; ++t)
      for (int c = 0; c < nch; ++c) stage_chunk(t, c);
  for (int t = 0; t < mine + (nb > 1 ? 1 : 0); ++t) {
    if (t < mine) sums(t);
    if (nb == 1)
      finish(t, t, t + 1);
    else if (t >= 1)
      finish(t - 1, t < mine ? t : -1, t + 1);
  }

  // -- each row's channel sums over its K items, then dscale and dbias over the
  // rows; block i takes the i-th share of the values ----------------------------------
  auto grid = cooperative_groups::this_grid();
  grid.sync();
  const int nblk = gridDim.x;
  if (K > 1) {
    const int pairs = a.B * 2 * C4, per = (pairs + nblk - 1) / nblk, j0 = blockIdx.x * per;
    fold_ranks(
        min(per, pairs - j0), K,
        [&](int j, int k) {
          const int p = j0 + j, b = p / (2 * C4);
          return __ldcg(a.part_c + ((size_t)b * K + k) * 2 * C4 + (p - b * 2 * C4));
        },
        [&](int j, float u) { a.row_c[j0 + j] = u; });
    if (blockIdx.x == 0)
      for (int i = tid; i < a.B; i += kThreadsB) a.ticket[i] = 0u;  // ready for the next call
    grid.sync();
  }
  const int per = (2 * C4 + nblk - 1) / nblk, j0 = blockIdx.x * per;
  fold_ranks(
      min(per, 2 * C4 - j0), a.B,
      [&](int j, int b) { return __ldcg(a.row_c + (size_t)b * 2 * C4 + j0 + j); },
      [&](int j, float u) {
        if (j0 + j < C4)
          a.dbias[j0 + j] = u;
        else
          a.dscale[j0 + j - C4] = u;
      });
}

template <typename T, int P>
cudaError_t configure(int dev) {
  static bool configured[64] = {};  // per device: the shared-memory ceiling is raised
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (configured[dev]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      nhwc_bwd_fused<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMaxB);
  configured[dev] = err == cudaSuccess;
  return err;
}

// the blocks of one instantiation an SM holds at once with `smem` bytes each
template <typename T, int P>
cudaError_t blocks_per_sm(int smem, int* per_sm) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = configure<T, P>(dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, nhwc_bwd_fused<T, P>, kThreadsB,
                                                        (size_t)smem);
  return err;
}

// A cooperative grid must be resident at once, or its waits never end: the
// launch refuses one that is not (cudaErrorCooperativeLaunchTooLarge).
template <typename T, int P>
int launch_bwd_p(const BwdArgs& a, int grid, int smem, cudaStream_t stream) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = configure<T, P>(dev);
  if (err != cudaSuccess) return (int)err;
  BwdArgs args = a;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(nhwc_bwd_fused<T, P>),
                                    dim3((unsigned)grid), dim3(kThreadsB), params, (size_t)smem,
                                    stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int launch_bwd(const void* x, const void* dy, const void* scale, const void* bias,
               const void* group_of, const void* order, const void* stats, void* dx, void* work,
               void* dscale, void* dbias, void* ticket, int B, int H, int W, int C4, int G, int K,
               int rows, int staged, int buffers, int grid, int smem, float n, int offset,
               float eps, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C4 <= 0 || C4 > 4096 || G <= 0 || G > 1024 || G > C4 ||
      !(n > 0.f) || (offset && (C4 % 4 != 0 || H < 2 || W < 2)) ||
      (int64_t)H * W > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  // bulk copies need 16-byte aligned spans of whole 16-byte units; a thread
  // then takes kPackBytesB of x (and of dy) at a position
  constexpr int PV = kPackBytesB / sizeof(T);
  const bool vec = C4 % (16 / sizeof(T)) == 0 && (uintptr_t)x % 16 == 0 &&
                   (uintptr_t)dy % 16 == 0 && (uintptr_t)dx % 16 == 0;
  // the plan: K ranges of `rows` positions cover a row, none of them empty;
  // no block without an item; no row that its blocks' waits could hold up
  // (K up to the grid with one item a block, twice that with two); two
  // staged items only by bulk copies; the staged items fill the shared
  // memory the plan asks for
  const int64_t HW = (int64_t)H * W, items = (int64_t)B * K;
  if (K < 1 || rows < 1 || (int64_t)(K - 1) * rows >= HW || (int64_t)K * rows < HW ||
      items > 0x7fffffffLL || grid > items || staged < 0 || staged > rows ||
      !(buffers == 1 || (buffers == 2 && vec)) || (int64_t)K > (int64_t)grid * buffers)
    return (int)cudaErrorInvalidValue;
  const int64_t want = bwd_fixed_bytes(C4, G, vec ? PV : 1) +
                       buffers * bwd_item_bytes(staged, C4, G, sizeof(T));
  if (smem != want || smem > kSmemMaxB) return (int)cudaErrorInvalidValue;
  BwdArgs a;
  a.x = x;
  a.dy = dy;
  a.dx = dx;
  a.scale = static_cast<const float*>(scale);
  a.bias = static_cast<const float*>(bias);
  a.group_of = static_cast<const int*>(group_of);
  a.order = static_cast<const int*>(order);
  a.stats = static_cast<const float*>(stats);
  a.part_g = static_cast<float*>(work);  // first: 16-byte aligned rows where G is even
  a.row_g = a.part_g + (K > 1 ? items * 2 * G : 0);
  a.row_c = a.row_g + (int64_t)B * 2 * G;
  a.part_c = a.row_c + (int64_t)B * 2 * C4;
  a.ticket = static_cast<unsigned int*>(ticket);
  a.dscale = static_cast<float*>(dscale);
  a.dbias = static_cast<float*>(dbias);
  a.B = B;
  a.H = H;
  a.W = W;
  a.C4 = C4;
  a.G = G;
  a.K = K;
  a.rows = rows;
  a.staged = staged;
  a.buffers = buffers;
  a.stats_bulk = vec && (8 * G) % 16 == 0 && (uintptr_t)stats % 16 == 0;
  a.n = n;
  a.eps = eps;
  a.offset = offset;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? launch_bwd_p<T, PV>(a, grid, smem, s) : launch_bwd_p<T, 1>(a, grid, smem, s);
}

}  // namespace

// x, dy, dx: [B, H, W, C4]; scale, bias, dscale, dbias: [C4] f32; group_of:
// [C4] int32; order: [G + 1 + C4] int32, the member offsets of each group,
// then the channels sorted by group; stats: [B, G, 2] f32, the forward's;
// work: 16-byte aligned, B * 2 * (C4 + G) floats, and B * K * 2 * (C4 + G)
// more where K > 1;
// ticket: B unsigned ints, zero (the kernel leaves them zero); n: the
// statistics' divisor; offset != 0 masks dy at the offset grid's
// out-of-range rows and columns.  K, rows, staged, buffers, grid and smem are
// the plan of ops/gn_silu.py::nhwc_backward_plan, which the launcher checks.
extern "C" int gn_silu_nhwc_bwd_f32(const void* x, const void* dy, const void* scale,
                                    const void* bias, const void* group_of, const void* order,
                                    const void* stats, void* dx, void* work, void* dscale,
                                    void* dbias, void* ticket, int B, int H, int W, int C4, int G,
                                    int K, int rows, int staged, int buffers, int grid, int smem,
                                    float n, int offset, float eps, void* stream) {
  return launch_bwd<float>(x, dy, scale, bias, group_of, order, stats, dx, work, dscale, dbias,
                           ticket, B, H, W, C4, G, K, rows, staged, buffers, grid, smem, n,
                           offset, eps, stream);
}

extern "C" int gn_silu_nhwc_bwd_bf16(const void* x, const void* dy, const void* scale,
                                     const void* bias, const void* group_of, const void* order,
                                     const void* stats, void* dx, void* work, void* dscale,
                                     void* dbias, void* ticket, int B, int H, int W, int C4,
                                     int G, int K, int rows, int staged, int buffers, int grid,
                                     int smem, float n, int offset, float eps, void* stream) {
  return launch_bwd<__nv_bfloat16>(x, dy, scale, bias, group_of, order, stats, dx, work, dscale,
                                   dbias, ticket, B, H, W, C4, G, K, rows, staged, buffers, grid,
                                   smem, n, offset, eps, stream);
}

// The blocks of the kernel for elements of `elem` bytes (4 or 2), in packs or
// one at a time (`vec`), that one SM holds at once with `smem` bytes of
// dynamic shared memory each: cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int gn_silu_nhwc_bwd_blocks_per_sm(int elem, int vec, int smem, int* blocks) {
  if (!(elem == 2 || elem == 4) || smem < 0 || smem > kSmemMaxB || blocks == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  if (elem == 4)
    err = vec ? blocks_per_sm<float, kPackBytesB / 4>(smem, blocks)
              : blocks_per_sm<float, 1>(smem, blocks);
  else
    err = vec ? blocks_per_sm<__nv_bfloat16, kPackBytesB / 2>(smem, blocks)
              : blocks_per_sm<__nv_bfloat16, 1>(smem, blocks);
  return (int)err;
}
