// The five masked reductions of the mask-guided attention blocks, for
// NVIDIA Hopper (sm_90a): pass 1 of both csrc/cam_gate.cu (MaskCBAM's CAM
// gate) and csrc/masked_pool.cu (MaskECA's masked pool).
//
// Per image b, from features x (B, C, N) and mask probabilities m (B, 1, N):
//   msum = sum m, wsum_c = sum x*m, gsum_c = sum x,
//   mmax_c = max over pixels with m > 0.5 (sentinel -3e38), cnt = #(m > 0.5)
// all in float32, whatever the inputs' type (float32 or bfloat16).
//
// Bound: the pass reads x and m once (B*N*C + B*N elements) and does a few
// operations per element, so it is memory-bound on this card. Design: the
// TPU kernels carry these sums across a sequential grid; Hopper blocks run in
// no order, so the grid splits (B, 32-channel tiles, 512-pixel chunks) over
// blocks, each writing float32 partial sums of its chunk to a small
// workspace, and the including source's second pass combines the chunks.
// Within a channel the pixels are contiguous (NCHW), so a warp's loads
// coalesce. The last chunk is masked, so N need not divide anything.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChanTile = 32;   // channels per pass-1 block
constexpr int kPixChunk = 512;  // pixels per pass-1 block
constexpr float kNeg = -3.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Number of pixel chunks S of an N-pixel plane.
inline int masked_reduce_chunks(int N) { return (N + kPixChunk - 1) / kPixChunk; }

// Workspace layout (float32), S = number of pixel chunks:
//   wsum (B, S, C) | gsum (B, S, C) | mmax (B, S, C) | msum (B, S) | cnt (B, S)
template <typename T>
__global__ void __launch_bounds__(kThreads)
masked_reduce_kernel(const T* __restrict__ x, const T* __restrict__ m,
                     int64_t x_sb, int64_t x_sc, int64_t m_sb, int C, int N, int S,
                     float* __restrict__ ws) {
  const int b = blockIdx.x, ct = blockIdx.y, s = blockIdx.z;
  const int n0 = s * kPixChunk;
  const int len = min(kPixChunk, N - n0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  __shared__ float sm[kPixChunk];
  __shared__ float red_m[kWarps], red_c[kWarps];

  const T* mb = m + b * m_sb + n0;
  float msum = 0.f, cnt = 0.f;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const float v = to_f32(mb[i]);
    sm[i] = v;
    msum += v;
    cnt += v > 0.5f ? 1.f : 0.f;
  }
  if (ct == 0) {  // one channel tile writes the per-chunk mask sums
    msum = warp_sum(msum);
    cnt = warp_sum(cnt);
    if (lane == 0) { red_m[warp] = msum; red_c[warp] = cnt; }
  }
  __syncthreads();
  if (ct == 0 && threadIdx.x == 0) {
    float a = 0.f, c = 0.f;
    for (int w = 0; w < kWarps; ++w) { a += red_m[w]; c += red_c[w]; }
    float* ws_msum = ws + (int64_t)3 * gridDim.x * S * C;
    ws_msum[b * S + s] = a;
    ws_msum[(int64_t)gridDim.x * S + b * S + s] = c;
  }

  const int64_t plane = (int64_t)gridDim.x * S * C;
  for (int cc = warp; cc < kChanTile; cc += kWarps) {
    const int c = ct * kChanTile + cc;
    if (c >= C) break;
    const T* xc = x + b * x_sb + c * x_sc + n0;
    float w = 0.f, g = 0.f, mx = kNeg;
    for (int i = lane; i < len; i += 32) {
      const float xv = to_f32(xc[i]);
      const float mv = sm[i];
      w += xv * mv;
      g += xv;
      if (mv > 0.5f) mx = fmaxf(mx, xv);
    }
    w = warp_sum(w);
    g = warp_sum(g);
    mx = warp_max(mx);
    if (lane == 0) {
      const int64_t idx = ((int64_t)b * S + s) * C + c;
      ws[idx] = w;
      ws[plane + idx] = g;
      ws[2 * plane + idx] = mx;
    }
  }
}

// Launch pass 1 on `stream`; the workspace holds B * S * (3C + 2) floats.
template <typename T>
void launch_masked_reduce(const void* x, const void* m, long long x_sb, long long x_sc,
                          long long m_sb, int B, int C, int N, void* ws, cudaStream_t stream) {
  const int S = masked_reduce_chunks(N);
  dim3 grid(B, (C + kChanTile - 1) / kChanTile, S);
  masked_reduce_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(m), x_sb, x_sc, m_sb, C, N, S,
      static_cast<float*>(ws));
}

}  // namespace
