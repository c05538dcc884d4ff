// The masked pool's five reductions, without the combine, for NVIDIA Hopper
// (sm_90a): one kernel a call, on one of two routes the host picks by size,
// rows straight into registers, or TMA bulk copies into a ring of
// shared-memory stages.
//
// Replaces the TPU kernel mga_yolo_tpu/ops/pallas/masked_pool.py:36 _kernel
// (pallas_call :115) as the spatial mesh takes it: the reductions of a band
// of rows, before _combine. Per image b, from features x (B, C, N) and mask
// probabilities m (B, 1, N), float32 or bfloat16 (NCHW planes; batch and
// channel strides as given), in float32 whatever the inputs' type:
//   msum = sum m, wsum_c = sum x*m, gsum_c = sum x,
//   mmax_c = max of x over the pixels with m > 0.5 (-3e38 where none),
//   cnt = #(m > 0.5)
// written as one (B, 2C + 2) buffer msum | wsum | gsum | cnt and mmax
// (B, C) beside it (ops/masked_reductions.py hands out views of both).
//
// Bound: x and m are read once (B*N*C + B*N elements) at a few operations
// an element, so the bytes bound it: 1.6-6.7 MB a call at the band shapes
// (B=16, 40/20/10 rows of 80/40/20, C=64/128/256, bf16), 0.5-2.0 us at
// 3.35 TB/s. At that size a launch (~1 us), a round trip to memory and an
// idle SM cost as much as the bytes. The planner (ops/masked_reductions.py
// reductions_plan) cuts the B x C rows into groups of consecutive channels
// of one image, of about equal bytes, for two blocks an SM (at the band
// shapes 16 groups of 4 / 8 / 16 channels an image, 256 blocks), gives each
// row of a group tpc threads, the most that fill the block, and picks one
// of two routes:
//  - The registers' route (masked_reductions_direct), a block a group,
//    where each of a row's threads has at most 32 of its 16-byte vectors
//    (the band shapes of a 640 and a 1280 px image): the threads load x and
//    m from global memory into registers, kDirectI of each at once, and
//    nothing waits on a barrier. It also takes every call whose rows are
//    not on 16 bytes (N = 41 x 43 in bf16, an odd channel slice), one
//    element a load. Where masked_pool.cu's row reduction (block_partials)
//    has a warp take its channels in turn (two round trips a warp at the
//    P3 and P5 bands, 7 of 32 lanes idle at P5), every thread here is busy
//    and a row's loads are in flight at once.
//  - The bulk-copy route (masked_reductions_kernel), for larger planes: a
//    grid of two blocks an SM (a block takes groups i, i + gridDim.x, ...),
//    each group's rows in items of all its rows over a chunk of pixels
//    that fills a stage. One thread issues cp.async.bulk copies of an
//    item's rows (one copy where they are consecutive in memory) and of
//    its image's mask chunk, and arms the stage's "full" mbarrier with the
//    bytes it issued (expect_tx): thread 0 the copies that wait on nothing,
//    before the block's first __syncthreads, a producer warp the rest,
//    each once the consumers have released its stage ("empty" mbarrier),
//    so the next items' copies overlap the reduction of this one. The mask
//    chunk goes to a slot once a chunk and every channel reads it from
//    shared memory; each consumer thread keeps its row's partials in
//    registers over the chunks, and a row's threads meet once a group.
// Which route is faster where was measured on the card (chip_smoke.py
// --reductions-alone; PERF.md): at the band shapes a bulk copy's latency
// and its barriers cost more than the round trips they save. Each image's
// msum and cnt are counted once, by the threads of the first row of its
// first group. A row of one warp or less is written by its warp once its
// lanes meet by shuffles; a row of several warps meets in shared memory. No
// atomics across blocks and a fixed order of every float32 sum: the same
// result on every run. One launch a call: no workspace, no counter in
// global memory, no host synchronisation, so it may be captured in a CUDA
// graph. A barrier wait traps after ~4 s rather than hang the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;                    // consumer warps; on the bulk-copy route warp kWarps is the producer
constexpr int kConsumers = 32 * kWarps;
constexpr int kLogConsumers = 8;
static_assert(1 << kLogConsumers == kConsumers, "kConsumers is a power of two");
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxStages = 4;
constexpr int kMaxSmem = 232448;             // shared memory a block may use on sm_90
constexpr int kDirectI = 4;                  // loads of x (and of m) a thread of the registers' route has in flight
constexpr int kMinBlocks = 2;                // blocks an SM the registers must allow (the plan aims at 2)
constexpr int kDirectBlocks = 3;             // the same on the registers' route: more groups than 2 an SM in one wave
constexpr float kNeg = -3.0e38f;             // masked-max sentinel
constexpr long long kTimeoutCycles = 1LL << 33;  // ~4 s: a barrier wait that long traps

// The shared-memory layout of a plan, as ops/masked_reductions.py layout()
// computes it: S stages of R rows of `pitch` bytes, M mask slots of `pitch`
// bytes, the mbarriers (full and empty a stage, full and empty a mask
// slot: 2 S + 4), then two sets (one a group, in turns) of the slots'
// partials. A row of an item is taken by tpc consumer threads, the largest
// power of two with tpc R <= kConsumers; spr = tpc / 32 warps a row where
// tpc > 32; a slot is a (channel, warp of its row). `direct`: a row is one
// warp or less and its threads meet with the channel's whole sums (a plane
// of one chunk, or an item of the group's whole rows, whose threads keep
// their partials over the chunks), so its warp writes them.
struct Layout {
  int gmax, tpc, log_tpc, spr, slots, pitch, stage, mask_off, bar_off, acc_off, acc_floats, bytes;
  bool direct;
  Layout() = default;
  Layout(int C, int q, int N, int L, int R, int S, int M, int isz) {
    gmax = (C + q - 1) / q;
    tpc = kConsumers;
    log_tpc = kLogConsumers;
    while (tpc > 1 && tpc * R > kConsumers) {
      tpc >>= 1;
      --log_tpc;
    }
    direct = tpc <= 32 && (L == N || R >= gmax);
    spr = tpc > 32 ? tpc / 32 : 1;
    slots = gmax * spr;
    pitch = (L * isz + 15) / 16 * 16;
    stage = R * pitch;
    mask_off = S * stage;
    bar_off = mask_off + M * pitch;
    acc_off = bar_off + 8 * (2 * S + 4);
    acc_floats = 3 * slots + 2 * spr;  // w, g, mx a slot; msum, cnt a warp of a row
    bytes = acc_off + 2 * acc_floats * 4;
  }
};

__device__ __forceinline__ uint32_t saddr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(bar)) : "memory");
}

__device__ __forceinline__ void bar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(bar)), "r"(bytes)
               : "memory");
}

// Until the barrier's phase of this parity has completed; traps after
// kTimeoutCycles rather than hang the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = saddr(bar);
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0)
      t0 = clock64();
    else if (clock64() - t0 > kTimeoutCycles)
      __trap();
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          saddr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(saddr(bar))
      : "memory");
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// 16 bytes of shared memory, raw, and as floats.
__device__ __forceinline__ uint4 lds16(const void* p) {
  uint4 r;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
               : "r"(saddr(p)));
  return r;
}

__device__ __forceinline__ void unpack(uint4 r, float* out, float) {
  out[0] = __uint_as_float(r.x);
  out[1] = __uint_as_float(r.y);
  out[2] = __uint_as_float(r.z);
  out[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack(uint4 r, float* out, __nv_bfloat16) {
  const uint32_t u[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(u[i] << 16);
    out[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

// Per-thread partials over its part of one row; even and odd elements in two
// sets, added at the end (a fixed order).
struct Acc {
  float w[2] = {0.f, 0.f}, g[2] = {0.f, 0.f}, mx = kNeg, ms[2] = {0.f, 0.f}, mc = 0.f;
  template <bool kMask>
  __device__ __forceinline__ void add(float x, float m, int parity) {
    w[parity] = fmaf(x, m, w[parity]);
    g[parity] += x;
    if (m > 0.5f) mx = fmaxf(mx, x);
    if (kMask) {
      ms[parity] += m;
      mc += m > 0.5f ? 1.f : 0.f;
    }
  }
};

// 16 bytes of global memory, through the read-only path.
__device__ __forceinline__ uint4 ldg16(const void* p) { return __ldg(reinterpret_cast<const uint4*>(p)); }

// Thread `sub` of the nt taking a row: its 16-byte vectors sub, sub + nt,
// ... of the row's len elements, kI loads of x and of m in flight (from
// shared memory, or from global memory where kGlobal), then elements of the
// ragged tail.
template <typename T, bool kMask, bool kGlobal = false, int kI = 2>
__device__ __forceinline__ void reduce_row(const T* xr, const T* mr, int len, int sub, int nt, Acc& a) {
  constexpr int V = 16 / sizeof(T);
  const int nv = len / V;
  for (int v0 = sub; v0 < nv; v0 += nt * kI) {
    uint4 xq[kI], mq[kI];
#pragma unroll
    for (int i = 0; i < kI; ++i)
      if (v0 + nt * i < nv) {
        xq[i] = kGlobal ? ldg16(xr + (v0 + nt * i) * V) : lds16(xr + (v0 + nt * i) * V);
        mq[i] = kGlobal ? ldg16(mr + (v0 + nt * i) * V) : lds16(mr + (v0 + nt * i) * V);
      }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      if (v0 + nt * i >= nv) break;
      float xv[V], mv[V];
      unpack(xq[i], xv, T());
      unpack(mq[i], mv, T());
#pragma unroll
      for (int e = 0; e < V; ++e) a.add<kMask>(xv[e], mv[e], e & 1);
    }
  }
  for (int e = nv * V + sub; e < len; e += nt) a.add<kMask>(to_f32(xr[e]), to_f32(mr[e]), 0);
}

// The same from global memory one element a load (rows not on 16 bytes):
// elements sub, sub + nt, ..., kU of x and of m in flight.
template <typename T, bool kMask>
__device__ __forceinline__ void reduce_elements(const T* __restrict__ xr, const T* __restrict__ mr, int len, int sub,
                                                int nt, Acc& a) {
  constexpr int kU = 8;
  for (int e0 = sub; e0 < len; e0 += nt * kU) {
    T xv[kU], mv[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (e0 + nt * u < len) {
        xv[u] = xr[e0 + nt * u];
        mv[u] = mr[e0 + nt * u];
      }
#pragma unroll
    for (int u = 0; u < kU; ++u)
      if (e0 + nt * u < len) a.add<kMask>(to_f32(xv[u]), to_f32(mv[u]), u & 1);
  }
}

// The span threads of a row meet by shuffles (within a warp; the mask's two
// only in a warp that counts it, mask_warp, which is warp-uniform).
__device__ __forceinline__ void meet(const Acc& p, int span, bool mask_warp, float& w, float& gs, float& mx,
                                     float& ms, float& mc) {
  w = p.w[0] + p.w[1];
  gs = p.g[0] + p.g[1];
  mx = p.mx;
  ms = p.ms[0] + p.ms[1];
  mc = p.mc;
  for (int o = span >> 1; o > 0; o >>= 1) {
    w += __shfl_xor_sync(0xffffffffu, w, o);
    gs += __shfl_xor_sync(0xffffffffu, gs, o);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  }
  if (mask_warp)
    for (int o = span >> 1; o > 0; o >>= 1) {
      ms += __shfl_xor_sync(0xffffffffu, ms, o);
      mc += __shfl_xor_sync(0xffffffffu, mc, o);
    }
}

// The call and its plan, with the layout worked out on the host (an
// integer division costs the card tens of instructions, before the first
// copy).
struct Args {
  const void* x;
  const void* m;
  int64_t x_sb, x_sc, m_sb;
  int B, C, N, q, L, R, S, nch;
  int gsz, grem;           // group k has gsz + (k < grem) channels: C = q gsz + grem
  int step_b, step_k;      // grid = step_b q + step_k: from a block's group to its next
  float inv_q;             // 1 / q, for the block's first group (B q <= 2^20: exact)
  Layout lay;
  float* sums;
  float* mmax;
};

// The groups of block blockIdx.x: i, i + gridDim.x, ... < B q; group gi is
// image gi / q, its k = gi % q'th group, channels [c0, c0 + g).
struct Groups {
  int b, k, c0, g;
  __device__ __forceinline__ explicit Groups(const Args& a) {
    b = __float2int_rz(((float)blockIdx.x + 0.5f) * a.inv_q);
    k = blockIdx.x - b * a.q;
    at(a);
  }
  __device__ __forceinline__ void at(const Args& a) {
    c0 = k * a.gsz + min(k, a.grem);
    g = a.gsz + (k < a.grem ? 1 : 0);
  }
  __device__ __forceinline__ bool valid(const Args& a) const { return b < a.B; }
  __device__ __forceinline__ void next(const Args& a) {
    b += a.step_b;
    k += a.step_k;
    if (k >= a.q) {
      k -= a.q;
      ++b;
    }
    at(a);
  }
};

// Channel c of image b's sums, and the image's mask sums where `mask`.
__device__ __forceinline__ void write_channel(const Args& a, int b, int c, bool mask, float w, float gs, float mx,
                                              float ms, float mc) {
  float* row = a.sums + (int64_t)b * (2 * a.C + 2);
  row[1 + c] = w;
  row[1 + a.C + c] = gs;
  a.mmax[(int64_t)b * a.C + c] = mx;
  if (mask) {
    row[0] = ms;
    row[2 * a.C + 1] = mc;
  }
}

// The registers' route: block i takes group i, in passes of kConsumers /
// tpc rows (one pass where a row has several warps: R = the group's rows),
// its threads loading x and m from global memory: 16-byte vectors where
// kVec, else one element a load. The mask row is read by every row's
// threads, through L1.
template <typename T, bool kVec>
__global__ void __launch_bounds__(kConsumers, kDirectBlocks) masked_reductions_direct(const __grid_constant__ Args a) {
  __shared__ float part[5][kWarps];  // w, g, mx, msum, cnt of each warp, where a row has several
  const Layout& lay = a.lay;
  const Groups gr(a);
  const int tpc = lay.tpc, spr = lay.spr, span = tpc < 32 ? tpc : 32, rows = kConsumers >> lay.log_tpc;
  const int rho = threadIdx.x >> lay.log_tpc, sub = threadIdx.x & (tpc - 1), warp = threadIdx.x >> 5;
  const T* mrow = static_cast<const T*>(a.m) + gr.b * a.m_sb;
  const T* xg = static_cast<const T*>(a.x) + gr.b * a.x_sb + gr.c0 * a.x_sc;
  for (int r0 = 0; r0 < gr.g; r0 += rows) {
    const bool mine = r0 + rho < gr.g, mask = gr.k == 0 && r0 == 0 && rho == 0;
    Acc p;
    if (mine) {
      const T* xrow = xg + (r0 + rho) * a.x_sc;
      if constexpr (kVec) {
        if (mask)
          reduce_row<T, true, true, kDirectI>(xrow, mrow, a.N, sub, tpc, p);
        else
          reduce_row<T, false, true, kDirectI>(xrow, mrow, a.N, sub, tpc, p);
      } else {
        if (mask)
          reduce_elements<T, true>(xrow, mrow, a.N, sub, tpc, p);
        else
          reduce_elements<T, false>(xrow, mrow, a.N, sub, tpc, p);
      }
    }
    float w, gs, mx, ms, mc;
    meet(p, span, gr.k == 0 && r0 == 0 && warp < spr, w, gs, mx, ms, mc);
    if (lay.direct) {
      if (mine && sub == 0) write_channel(a, gr.b, gr.c0 + r0 + rho, mask, w, gs, mx, ms, mc);
      continue;
    }
    if ((threadIdx.x & 31) == 0) {  // several warps a row: one pass
      part[0][warp] = w;
      part[1][warp] = gs;
      part[2][warp] = mx;
      part[3][warp] = ms;
      part[4][warp] = mc;
    }
    __syncthreads();
    const int j = threadIdx.x;
    if (j < gr.g) {
      w = 0.f, gs = 0.f, mx = kNeg, ms = 0.f, mc = 0.f;
      for (int k = j * spr; k < (j + 1) * spr; ++k) {
        w += part[0][k];
        gs += part[1][k];
        mx = fmaxf(mx, part[2][k]);
        ms += part[3][k];
        mc += part[4][k];
      }
      write_channel(a, gr.b, gr.c0 + j, gr.k == 0 && j == 0, w, gs, mx, ms, mc);
    }
  }
}

// The block's copies in the order its consumers take them: for each group
// (i, i + gridDim.x, ... < B q), for each chunk of L pixels, the chunk of
// the image's mask into slot u % 2 (unit u), then items of R rows of the
// group's channels into stage n % S (item n). kPrologue: the copies that
// wait on nothing (units u < 2, items n < S, up to the first that would),
// issued by thread 0 before the block's first barrier. kRest: the others,
// by the producer warp's first lane, each after its slot's or stage's last
// use.
enum Mode { kPrologue, kRest };

template <typename T, Mode kMode>
__device__ __forceinline__ void produce(const Args& a, unsigned char* smem) {
  const Layout& lay = a.lay;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + a.S;
  uint64_t* mfull = empty + a.S;
  uint64_t* mempty = mfull + 2;
  const int pitch = lay.pitch / (int)sizeof(T);
  const T* x = static_cast<const T*>(a.x);
  const T* m = static_cast<const T*>(a.m);
  bool blocked = false;
  int u = 0, s = 0, round = 0;  // the block's item n goes to stage s = n % S in round n / S
  for (Groups gr(a); gr.valid(a); gr.next(a)) {
    const int b = gr.b, g = gr.g;
    const T* x_g = x + b * a.x_sb + gr.c0 * a.x_sc;
    for (int ch = 0; ch < a.nch; ++ch, ++u) {
      const int p0 = ch * a.L, len = min(a.L, a.N - p0);
      const uint32_t row_bytes = (uint32_t)len * sizeof(T);
      {  // the unit's mask chunk
        const bool wait = u >= 2;
        blocked |= wait;
        if (kMode == kPrologue && blocked) return;
        if (kMode == kPrologue || blocked) {
          if (wait) bar_wait(&mempty[u & 1], ((u >> 1) - 1) & 1);
          bar_arrive_expect_tx(&mfull[u & 1], row_bytes);
          bulk_copy(reinterpret_cast<T*>(smem + lay.mask_off) + (u & 1) * pitch, m + b * a.m_sb + p0, row_bytes,
                    &mfull[u & 1]);
        }
      }
      for (int r0 = 0; r0 < g; r0 += a.R, s = s + 1 == a.S ? 0 : s + 1, round += s == 0) {
        const int r = min(a.R, g - r0);
        const bool wait = round > 0;
        blocked |= wait;
        if (kMode == kPrologue && blocked) return;
        if (kMode == kRest && !blocked) continue;
        if (wait) bar_wait(&empty[s], (round - 1) & 1);
        T* dst = reinterpret_cast<T*>(smem + s * lay.stage);
        const T* src = x_g + r0 * a.x_sc + p0;
        bar_arrive_expect_tx(&full[s], (uint32_t)r * row_bytes);
        if (a.x_sc == len && (int)row_bytes == lay.pitch)  // the rows are consecutive in memory: one copy
          bulk_copy(dst, src, (uint32_t)r * row_bytes, &full[s]);
        else
          for (int j = 0; j < r; ++j) bulk_copy(dst + j * pitch, src + j * a.x_sc, row_bytes, &full[s]);
      }
    }
  }
}

// The bulk-copy route: thread 0 sets up the barriers and issues the first
// copies, the producer warp the rest; the consumers (warps 0..kWarps-1)
// take thread t to row t / tpc of each item, its part sub = t % tpc.
template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks) masked_reductions_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout& lay = a.lay;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off);
  uint64_t* empty = full + a.S;
  uint64_t* mfull = empty + a.S;
  uint64_t* mempty = mfull + 2;
  float* acc = reinterpret_cast<float*>(smem + lay.acc_off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {  // the barriers the copies complete, the first copies, then the others
    for (int s = 0; s < a.S; ++s) bar_init(&full[s], 1);
    for (int k = 0; k < 2; ++k) bar_init(&mfull[k], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    produce<T, kPrologue>(a, smem);
    for (int s = 0; s < a.S; ++s) bar_init(&empty[s], kWarps);
    for (int k = 0; k < 2; ++k) bar_init(&mempty[k], kWarps);
  }
  __syncthreads();

  if (warp == kWarps) {  // the producer
    if (lane == 0) produce<T, kRest>(a, smem);
    return;
  }

  // The consumers. Where an item holds the group's whole rows (R >= gmax:
  // `carry`), each thread keeps its row's partials over the chunks and a
  // row's threads meet once a group; else once an item. They meet by
  // shuffles within a warp; where a row is one warp or less and its last
  // meet holds the channel's whole sums (`direct`), its warp writes them,
  // else each warp's partials go to the row's channel's slot, added over the
  // chunks, and the group is written after a barrier.
  const int pitch = lay.pitch / (int)sizeof(T);
  const int tpc = lay.tpc, spr = lay.spr, span = tpc < 32 ? tpc : 32;
  const bool direct = lay.direct, carry = a.R >= lay.gmax;
  const int rho = threadIdx.x >> lay.log_tpc, sub = threadIdx.x & (tpc - 1), slice = sub >> 5;
  int u = 0, gl = 0, s = 0, round = 0;
  for (Groups gr(a); gr.valid(a); gr.next(a), ++gl) {
    const int b = gr.b, c0 = gr.c0, g = gr.g;
    const bool first = gr.k == 0;
    float* aw = acc + (gl & 1) * lay.acc_floats;
    float* ag = aw + lay.slots;
    float* amx = ag + lay.slots;
    float* ams = amx + lay.slots;
    float* amc = ams + spr;
    float* row = a.sums + (int64_t)b * (2 * a.C + 2);
    Acc p;
    for (int ch = 0; ch < a.nch; ++ch, ++u) {
      const int len = min(a.L, a.N - ch * a.L);
      bar_wait(&mfull[u & 1], (u >> 1) & 1);
      const T* mrow = reinterpret_cast<const T*>(smem + lay.mask_off) + (u & 1) * pitch;
      for (int r0 = 0; r0 < g; r0 += a.R, s = s + 1 == a.S ? 0 : s + 1, round += s == 0) {
        const int r = min(a.R, g - r0);
        bar_wait(&full[s], round & 1);
        const bool mine = rho < r, mask = first && r0 == 0 && rho == 0;
        const bool mask_warp = first && r0 == 0 && warp < spr;  // warp-uniform: the warps of row 0
        if (!carry) p = Acc();
        if (mine) {
          const T* xrow = reinterpret_cast<const T*>(smem + s * lay.stage) + rho * pitch;
          if (mask)
            reduce_row<T, true>(xrow, mrow, len, sub, tpc, p);
          else
            reduce_row<T, false>(xrow, mrow, len, sub, tpc, p);
        }
        __syncwarp();
        if (lane == 0) bar_arrive(&empty[s]);  // the rows are read; the partials stay in registers
        if (carry && ch + 1 < a.nch) continue;
        float w, gs, mx, ms, mc;
        meet(p, span, mask_warp, w, gs, mx, ms, mc);
        if (direct) {  // the row's warp holds its channel's whole sums: out at once
          if (mine && sub == 0) write_channel(a, b, c0 + r0 + rho, mask, w, gs, mx, ms, mc);
        } else if (mine && (sub & (span - 1)) == 0) {
          const bool set = ch == 0 || carry;
          const int slot = (r0 + rho) * spr + slice;
          aw[slot] = set ? w : aw[slot] + w;
          ag[slot] = set ? gs : ag[slot] + gs;
          amx[slot] = set ? mx : fmaxf(amx[slot], mx);
          if (mask) {
            ams[slice] = set ? ms : ams[slice] + ms;
            amc[slice] = set ? mc : amc[slice] + mc;
          }
        }
      }
      __syncwarp();
      if (lane == 0) bar_arrive(&mempty[u & 1]);
    }
    if (direct) continue;
    // Every slot of the group is in; the next group writes the other set.
    asm volatile("bar.sync 1, %0;\n" ::"r"(kConsumers) : "memory");
    for (int j = threadIdx.x; j < g; j += kConsumers) {
      float w = 0.f, gs = 0.f, mx = kNeg;
      for (int sl = 0; sl < spr; ++sl) {
        w += aw[j * spr + sl];
        gs += ag[j * spr + sl];
        mx = fmaxf(mx, amx[j * spr + sl]);
      }
      row[1 + c0 + j] = w;
      row[1 + a.C + c0 + j] = gs;
      a.mmax[(int64_t)b * a.C + c0 + j] = mx;
    }
    if (first && threadIdx.x == 0) {
      float ms = 0.f, mc = 0.f;
      for (int sl = 0; sl < spr; ++sl) {
        ms += ams[sl];
        mc += amc[sl];
      }
      row[0] = ms;
      row[2 * a.C + 1] = mc;
    }
  }
}

// Whether every row's start and length may go by cp.async.bulk: both bases,
// the strides and the chunk and row lengths in bytes multiples of 16.
bool tma_rows(const void* x, const void* m, long long x_sb, long long x_sc, long long m_sb, int N, int L,
              int isz) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
         (x_sb * isz) % 16 == 0 && (x_sc * isz) % 16 == 0 && (m_sb * isz) % 16 == 0 &&
         ((long long)N * isz) % 16 == 0 && ((long long)L * isz) % 16 == 0;
}

template <typename T>
int launch_ring(const Args& a, int grid, int smem, cudaStream_t stream) {
  static unsigned long long configured = 0;  // devices whose limit this kernel has raised
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 64 && !(configured >> dev & 1ull)) {
    err = cudaFuncSetAttribute(masked_reductions_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured |= 1ull << dev;
  }
  masked_reductions_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int route, const Args& a, int grid, int smem, cudaStream_t stream) {
  if (route == 1) return launch_ring<T>(a, grid, smem, stream);
  if (route == 2)
    masked_reductions_direct<T, true><<<grid, kConsumers, 0, stream>>>(a);
  else
    masked_reductions_direct<T, false><<<grid, kConsumers, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and m share it). route: 0 for the
// registers' route one element a load, 1 for cp.async.bulk copies into the
// ring, 2 for the registers' route with 16-byte loads (1 and 2 refused
// unless tma_rows holds; 0 and 2 unless L = N, S = M = 1, smem = 0 and
// grid = B q). q
// groups an image, chunks of L pixels, items of R rows, S stages, M mask
// slots, grid blocks and smem bytes of shared memory, as
// ops/masked_reductions.py reductions_plan gives them (on route 1 smem must
// equal the layout's). sums: (B, 2C + 2) float32, mmax: (B, C) float32,
// contiguous. Returns the cudaError_t of the launch (0 = success).
int masked_reductions_launch(int dtype, int route, const void* x, const void* m, long long x_sb, long long x_sc,
                             long long m_sb, int B, int C, int N, int q, int L, int R, int S, int M, int grid,
                             int smem, float* sums, float* mmax, void* stream) {
  const int isz = dtype == 0 ? 4 : dtype == 1 ? 2 : 0;
  if (isz == 0 || route < 0 || route > 2 || B < 1 || C < 1 || N < 1 || q < 1 || q > C ||
      (long long)C * q > 0x7fffffffLL || L < 1 || L > N || R < 1 ||
      R > kConsumers || R > (C + q - 1) / q || S < 1 || S > kMaxStages || grid < 1 || (long long)B * q > (1 << 20) ||
      grid > B * q || M < 1 || M > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Layout lay(C, q, N, L, R, S, M, isz);
  // one mask slot: one unit a block
  const bool ring = lay.bytes == smem && smem <= kMaxSmem && (long long)L * isz <= kMaxSmem &&
                    (M == 2 || (grid == B * q && L == N));
  const bool regs = smem == 0 && L == N && S == 1 && M == 1 && grid == B * q;  // one group a block
  if (route == 1 ? !ring : !regs) return static_cast<int>(cudaErrorInvalidValue);
  if (route > 0 && !tma_rows(x, m, x_sb, x_sc, m_sb, N, L, isz)) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{x,         m,         (int64_t)x_sb, (int64_t)x_sc,        (int64_t)m_sb, B,   C,
               N,         q,         L,             R,                    S,             (N + L - 1) / L,
               C / q,     C % q,     grid / q,      grid % q,             1.0f / (float)q, lay, sums, mmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch<float>(route, a, grid, smem, st) : launch<__nv_bfloat16>(route, a, grid, smem, st);
}

}  // extern "C"
