// Fused masked average and max pooling (MaskECA's descriptor) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel mga_yolo_tpu/ops/pallas/masked_pool.py _kernel
// (wrapper _reductions_pallas) and the _combine after it. Computes, per
// image b, from features x (B, C, N) and mask probabilities m (B, 1, N), in
// float32 whatever the inputs' type:
//   msum = sum m, wsum_c = sum x*m, gsum_c = sum x,
//   mmax_c = max over pixels with m > 0.5 (sentinel -3e38), cnt = #(m > 0.5)
//   gap = gsum / N, mavg = wsum / max(msum, eps)
//   avg = (msum / N >= tiny_thr) ? mavg : gap      (tiny-mask GAP blend)
//   mx  = cnt > 0 ? mmax : gap                      (no-pixel fallback)
// and writes avg and mx (B, C) in x's type (float32 or bfloat16, rounded to
// nearest even).
//
// Bound: x and m are read once (B*N*C + B*N elements) at a few operations
// per element, so the function is memory-bound on this card; at the serving
// shapes (1.6-6.6 MB a call at B=8 bf16: 0.5-2.0 us of bytes) a launch and a
// round trip to memory cost as much as the bytes, so the design counts
// launches and dependent round trips. Descriptor (b, c) needs only channel
// c's plane and image b's mask: there is no step across channels. So one
// launch per call, and a block owns `tile` channels of one image over their
// whole planes: no workspace, no counter, no second kernel. Its 8 warps
// split the tile as channels x pixel slices (`wpc` warps a channel, each
// taking every wpc-th 32-lane stretch of vectors); they reduce in registers
// (masked_reduce.cuh's 16-byte loads where the base, strides and N allow,
// one element a load elsewhere), meet once in shared memory, and the first
// `tile` threads write the descriptors. The warps of the tile's first
// channel also sum the mask, so each pixel of m is counted once a block;
// the other channels' mask loads hit L1 / L2. The wrapper (ops/masked_pool.py
// pool_plan) picks tile and wpc so the grid holds about two blocks per SM.

#include "masked_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 64;  // (channel, slice) partials a block holds: tile * wpc <= kSlots

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// (channel, slice) partials of a block, and the mask's per slice.
struct Partials {
  float w[kSlots], g[kSlots], mx[kSlots], msum[kWarps], cnt[kWarps];
};

// Block of image b, channels [c0, c0 + tile): each warp's partials into s.
// Warp w: slice w % wpc of channels j = w / wpc, w / wpc + kWarps / wpc, ... < tile.
template <typename T, int V>
__device__ __forceinline__ void block_partials(Partials& s, const T* __restrict__ x,
                                               const T* __restrict__ m, int64_t x_sb, int64_t x_sc,
                                               int64_t m_sb, int C, int N, int tile, int wpc, int b,
                                               int c0) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = warp % wpc;
  const T* m_row = m + b * m_sb;

  for (int j = warp / wpc; j < tile; j += kWarps / wpc) {
    const int c = c0 + j;  // warp-uniform: the whole warp takes one branch
    float w = 0.f, g = 0.f, mx = kNeg, msum = 0.f, cnt = 0.f;
    if (c < C)
      reduce_row<T, V>(x + b * x_sb + c * x_sc, m_row, N, slice * 32 + lane, wpc * 32, j == 0, w,
                       g, mx, msum, cnt);
    w = warp_sum(w);
    g = warp_sum(g);
    mx = warp_max(mx);
    if (j == 0) {  // c0 < C always: the first channel's warps sum the mask
      msum = warp_sum(msum);
      cnt = warp_sum(cnt);
      if (lane == 0) {
        s.msum[slice] = msum;
        s.cnt[slice] = cnt;
      }
    }
    if (lane == 0) {
      s.w[j * wpc + slice] = w;
      s.g[j * wpc + slice] = g;
      s.mx[j * wpc + slice] = mx;
    }
  }
  __syncthreads();
}

// Channel j's totals over the wpc slices, and the mask's.
__device__ __forceinline__ void channel_totals(const Partials& s, int j, int wpc, float& tot,
                                               float& any, float& w, float& g, float& mx) {
  tot = any = w = g = 0.f;
  mx = kNeg;
  for (int q = 0; q < wpc; ++q) {
    tot += s.msum[q];
    any += s.cnt[q];
    w += s.w[j * wpc + q];
    g += s.g[j * wpc + q];
    mx = fmaxf(mx, s.mx[j * wpc + q]);
  }
}

// Block i: image i / tiles, channels [c0, c0 + tile) with c0 = (i % tiles) * tile.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
masked_pool_kernel(const T* __restrict__ x, const T* __restrict__ m, int64_t x_sb, int64_t x_sc,
                   int64_t m_sb, int C, int N, int tile, int wpc, float tiny_thr, float eps,
                   T* __restrict__ avg, T* __restrict__ mxd) {
  __shared__ Partials s;
  const int tiles = (C + tile - 1) / tile;
  const int b = blockIdx.x / tiles;
  const int c0 = (blockIdx.x - b * tiles) * tile;
  block_partials<T, V>(s, x, m, x_sb, x_sc, m_sb, C, N, tile, wpc, b, c0);

  const int j = threadIdx.x;
  if (j >= tile || c0 + j >= C) return;
  float tot, any, w, g, mx;
  channel_totals(s, j, wpc, tot, any, w, g, mx);
  const float gap = g / (float)N;
  const int64_t o = (int64_t)b * C + c0 + j;
  store(avg + o, tot / (float)N >= tiny_thr ? w / fmaxf(tot, eps) : gap);
  store(mxd + o, any > 0.f ? mx : gap);
}

template <typename T>
int launch(const void* x, const void* m, long long x_sb, long long x_sc, long long m_sb, int B,
           int C, int N, int tile, int wpc, float tiny_thr, float eps, void* avg, void* mx,
           void* stream) {
  constexpr int V = 16 / sizeof(T);
  const unsigned blocks = (unsigned)B * (unsigned)((C + tile - 1) / tile);
  auto kernel = vector_rows(x, m, x_sb, x_sc, m_sb, N, V) ? masked_pool_kernel<T, V>
                                                          : masked_pool_kernel<T, 1>;
  kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(m), (int64_t)x_sb, (int64_t)x_sc,
      (int64_t)m_sb, C, N, tile, wpc, tiny_thr, eps, static_cast<T*>(avg), static_cast<T*>(mx));
  return static_cast<int>(cudaGetLastError());
}

bool bad_plan(int B, int C, int N, int tile, int wpc) {
  return B < 1 || C < 1 || N < 1 || tile < 1 || wpc < 1 || kWarps % wpc != 0 ||
         (long long)tile * wpc > kSlots || (long long)B * ((C + tile - 1) / tile) > 0x7fffffffLL;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x, m, avg and mx share it). tile
// channels a block, wpc warps a channel (a divisor of 8), tile * wpc <= 64
// (ops/masked_pool.py pool_plan keeps to it). Returns the cudaError_t of the
// launch (0 = success).
int masked_pool_launch(int dtype, const void* x, const void* m, long long x_sb, long long x_sc,
                       long long m_sb, int B, int C, int N, int tile, int wpc, float tiny_thr,
                       float eps, void* avg, void* mx, void* stream) {
  if (bad_plan(B, C, N, tile, wpc)) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch<float>(x, m, x_sb, x_sc, m_sb, B, C, N, tile, wpc, tiny_thr, eps, avg, mx,
                         stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, m, x_sb, x_sc, m_sb, B, C, N, tile, wpc, tiny_thr, eps, avg,
                                 mx, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
