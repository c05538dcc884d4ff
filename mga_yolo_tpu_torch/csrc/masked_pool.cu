// Fused masked average and max pooling (MaskECA's descriptor) for NVIDIA
// Hopper (sm_90a).
//
// Replaces the TPU kernel mga_yolo_tpu/ops/pallas/masked_pool.py _kernel
// (wrapper _reductions_pallas) and the _combine after it. Computes, per
// image b, from features x (B, C, N) and mask probabilities m (B, 1, N), the
// five reductions of masked_reduce.cuh (in float32), then
//   gap = gsum / N, mavg = wsum / max(msum, eps)
//   avg = (msum / N >= tiny_thr) ? mavg : gap      (tiny-mask GAP blend)
//   mx  = cnt > 0 ? mmax : gap                      (no-pixel fallback)
// and writes avg and mx (B, C) in x's type (float32 or bfloat16, rounded to
// nearest even).
//
// Bound: x and m are read once (B*N*C + B*N elements) at a few operations
// per element, so the function is memory-bound on this card. Design: pass 1
// is the CAM gate's (masked_reduce.cuh: blocks over B x 32-channel tiles x
// 512-pixel chunks, float32 partials to a workspace, since Hopper blocks
// cannot carry sums across a grid as the TPU's sequential grid does); pass 2
// gives each (image, 256-channel tile) one block whose threads combine the
// chunks of one channel each, reading the workspace coalesced along C.

#include "masked_reduce.cuh"

namespace {

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
pool_combine_kernel(const float* __restrict__ ws, int B, int C, int N, int S, float tiny_thr,
                    float eps, T* __restrict__ avg, T* __restrict__ mxd) {
  __shared__ float s_msum, s_cnt;
  const int b = blockIdx.x;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const int64_t plane = (int64_t)B * S * C;
  const float* ws_msum = ws + 3 * plane;
  const float* ws_cnt = ws_msum + (int64_t)B * S;

  if (threadIdx.x == 0) {
    float a = 0.f, n = 0.f;
    for (int s = 0; s < S; ++s) { a += ws_msum[b * S + s]; n += ws_cnt[b * S + s]; }
    s_msum = a;
    s_cnt = n;
  }
  __syncthreads();
  if (c >= C) return;
  const float msum = s_msum;
  const bool valid = msum / (float)N >= tiny_thr;
  const bool any = s_cnt > 0.f;

  float w = 0.f, g = 0.f, mx = kNeg;
  for (int s = 0; s < S; ++s) {
    const int64_t idx = ((int64_t)b * S + s) * C + c;
    w += ws[idx];
    g += ws[plane + idx];
    mx = fmaxf(mx, ws[2 * plane + idx]);
  }
  const float gap = g / (float)N;
  store(avg + (int64_t)b * C + c, valid ? w / fmaxf(msum, eps) : gap);
  store(mxd + (int64_t)b * C + c, any ? mx : gap);
}

template <typename T>
int launch(const void* x, const void* m, long long x_sb, long long x_sc, long long m_sb, int B,
           int C, int N, float tiny_thr, float eps, void* ws, void* avg, void* mx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  launch_masked_reduce<T>(x, m, x_sb, x_sc, m_sb, B, C, N, ws, st);
  dim3 grid(B, (C + kThreads - 1) / kThreads);
  pool_combine_kernel<T><<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(ws), B, C, N, masked_reduce_chunks(N), tiny_thr, eps,
      static_cast<T*>(avg), static_cast<T*>(mx));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pixels per pass-1 block: the wrapper sizes the workspace from it.
int masked_pool_pix_chunk() { return kPixChunk; }

// dtype: 0 = float32, 1 = bfloat16 (x, m, avg and mx share it).
// Returns the cudaError_t of the launches (0 = success).
int masked_pool_launch(int dtype, const void* x, const void* m, long long x_sb, long long x_sc,
                       long long m_sb, int B, int C, int N, float tiny_thr, float eps, void* ws,
                       void* avg, void* mx, void* stream) {
  if (dtype == 0)
    return launch<float>(x, m, x_sb, x_sc, m_sb, B, C, N, tiny_thr, eps, ws, avg, mx, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, m, x_sb, x_sc, m_sb, B, C, N, tiny_thr, eps, ws, avg, mx,
                                 stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
