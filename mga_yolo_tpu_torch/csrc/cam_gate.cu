// Fused CAM gate of MaskCBAM for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mga_yolo_tpu/ops/pallas/masked_pool.py
// _cam_kernel_factory (wrapper _cam_gate_pallas). Computes, per image b,
// from features x (B, C, N) and mask probabilities m (B, 1, N):
//   msum = sum m, wsum_c = sum x*m, gsum_c = sum x,
//   mmax_c = max over pixels with m > 0.5 (sentinel -3e38), cnt = #(m > 0.5)
//   gap = gsum / N, mavg = wsum / max(msum, eps)
//   avg = (msum / N >= tiny_thr) ? mavg : gap      (tiny-mask GAP blend)
//   mx  = cnt > 0 ? mmax : gap                      (no-pixel fallback)
//   gate = sigmoid(mlp(avg) + mlp(mx)),  mlp(d) = W2 relu(W1 d + b1) + b2
// and writes gate (B, C) in float32. Inputs are float32 or bfloat16; every
// sum is taken in float32.
//
// Bound: the kernel must read x and m once (B*N*C + B*N elements), a few
// operations per byte, so it is memory-bound on this card. Design: the TPU
// kernel carried its sums across a sequential grid; Hopper blocks run in no
// order, so pass 1 splits (B, channel tiles, pixel chunks) over blocks, each
// writing float32 partial sums to a small workspace, and pass 2 (one block
// per image) combines the chunks and runs the MLP. Within a channel the
// pixels are contiguous (NCHW), so a warp's loads coalesce. The last chunk
// is masked, so N need not divide anything.

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

// Workspace layout (float32), S = number of pixel chunks:
//   wsum (B, S, C) | gsum (B, S, C) | mmax (B, S, C) | msum (B, S) | cnt (B, S)
template <typename T>
__global__ void __launch_bounds__(kThreads)
cam_reduce_kernel(const T* __restrict__ x, const T* __restrict__ m,
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
cam_combine_kernel(const float* __restrict__ ws, const T* __restrict__ w1,
                   const T* __restrict__ b1, const T* __restrict__ w2,
                   const T* __restrict__ b2, int B, int C, int H, int N, int S,
                   float tiny_thr, float eps, float* __restrict__ gate) {
  extern __shared__ float sh[];  // avg[C] | mx[C] | h_avg[H] | h_mx[H]
  float* avg = sh;
  float* mxd = sh + C;
  float* ha = sh + 2 * C;
  float* hm = ha + H;
  __shared__ float s_msum, s_cnt;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t plane = (int64_t)B * S * C;
  const float* ws_msum = ws + 3 * plane;
  const float* ws_cnt = ws_msum + (int64_t)B * S;

  if (threadIdx.x == 0) {
    float a = 0.f, c = 0.f;
    for (int s = 0; s < S; ++s) { a += ws_msum[b * S + s]; c += ws_cnt[b * S + s]; }
    s_msum = a;
    s_cnt = c;
  }
  __syncthreads();
  const float msum = s_msum;
  const bool valid = msum / (float)N >= tiny_thr;
  const bool any = s_cnt > 0.f;
  const float denom = fmaxf(msum, eps);

  for (int c = threadIdx.x; c < C; c += kThreads) {
    float w = 0.f, g = 0.f, mx = kNeg;
    for (int s = 0; s < S; ++s) {
      const int64_t idx = ((int64_t)b * S + s) * C + c;
      w += ws[idx];
      g += ws[plane + idx];
      mx = fmaxf(mx, ws[2 * plane + idx]);
    }
    const float gap = g / (float)N;
    avg[c] = valid ? w / denom : gap;
    mxd[c] = any ? mx : gap;
  }
  __syncthreads();

  for (int j = warp; j < H; j += kWarps) {  // hidden units: one warp each
    const T* row = w1 + (int64_t)j * C;
    float a = 0.f, q = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float wv = to_f32(row[c]);
      a += wv * avg[c];
      q += wv * mxd[c];
    }
    a = warp_sum(a);
    q = warp_sum(q);
    if (lane == 0) {
      const float bj = to_f32(b1[j]);
      ha[j] = fmaxf(a + bj, 0.f);
      hm[j] = fmaxf(q + bj, 0.f);
    }
  }
  __syncthreads();

  for (int c = threadIdx.x; c < C; c += kThreads) {
    const T* row = w2 + (int64_t)c * H;
    const float bc = to_f32(b2[c]);
    float oa = bc, om = bc;
    for (int j = 0; j < H; ++j) {
      const float wv = to_f32(row[j]);
      oa += wv * ha[j];
      om += wv * hm[j];
    }
    gate[(int64_t)b * C + c] = 1.f / (1.f + expf(-(oa + om)));
  }
}

template <typename T>
int launch(const void* x, const void* m, const void* w1, const void* b1, const void* w2,
           const void* b2, long long x_sb, long long x_sc, long long m_sb, int B, int C,
           int N, int H, float tiny_thr, float eps, void* ws, void* gate, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int S = (N + kPixChunk - 1) / kPixChunk;
  dim3 grid1(B, (C + kChanTile - 1) / kChanTile, S);
  cam_reduce_kernel<T><<<grid1, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(m), x_sb, x_sc, m_sb, C, N, S,
      static_cast<float*>(ws));
  const size_t shmem = sizeof(float) * (2 * (size_t)C + 2 * (size_t)H);
  cam_combine_kernel<T><<<B, kThreads, shmem, st>>>(
      static_cast<const float*>(ws), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(w2), static_cast<const T*>(b2), B, C, H, N, S, tiny_thr, eps,
      static_cast<float*>(gate));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Pixels per pass-1 block: the wrapper sizes the workspace from it.
int cam_gate_pix_chunk() { return kPixChunk; }

// dtype: 0 = float32, 1 = bfloat16 (x, m and the MLP weights share it).
// Returns the cudaError_t of the launches (0 = success).
int cam_gate_launch(int dtype, const void* x, const void* m, const void* w1, const void* b1,
                    const void* w2, const void* b2, long long x_sb, long long x_sc,
                    long long m_sb, int B, int C, int N, int H, float tiny_thr, float eps,
                    void* ws, void* gate, void* stream) {
  if (dtype == 0)
    return launch<float>(x, m, w1, b1, w2, b2, x_sb, x_sc, m_sb, B, C, N, H, tiny_thr, eps,
                         ws, gate, stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, m, w1, b1, w2, b2, x_sb, x_sc, m_sb, B, C, N, H,
                                 tiny_thr, eps, ws, gate, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
