// The loads and the row reduction shared by the mask-guided attention
// kernels for NVIDIA Hopper (sm_90a): csrc/cam_gate.cu (MaskCBAM's CAM gate)
// and csrc/masked_pool.cu (MaskECA's masked pool).
//
// Over pixels of one channel row of features x and of the mask
// probabilities m (both float32 or bfloat16), in float32:
//   w += x*m, g += x, mx = max(mx, x) where m > 0.5,
//   and, where asked, msum += m, cnt += (m > 0.5)
// with 16-byte loads (Vec<T, V>, V = 16 / sizeof(T)) where the caller has
// checked that the row's base, strides and length allow them, and one
// element a load (V = 1) elsewhere. Each thread keeps kI loads of x and of m
// in flight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kI = 4;               // loads of x (and of m) a thread has in flight
constexpr float kNeg = -3.0e38f;    // masked-max sentinel

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

// V consecutive elements of T as floats, from one 16-byte vector (V > 1) or one element.
template <typename T, int V>
struct Vec {
  using Raw = T;
  __device__ static Raw load(const T* p) { return *p; }
  __device__ static void unpack(Raw r, float* out) { out[0] = to_f32(r); }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
  __device__ static void unpack(Raw r, float* out) {
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  __device__ static void unpack(Raw r, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 f = __bfloat1622float2(h[q]);
      out[2 * q] = f.x;
      out[2 * q + 1] = f.y;
    }
  }
};

// Thread t of the nt threads sharing a row takes its vectors t, t + nt, ...
// of pixels [0, n), kI of x and of m in flight; it adds to w, g, mx, and to
// msum and cnt if count_m.
template <typename T, int V>
__device__ __forceinline__ void reduce_row(const T* x_row, const T* m_row, int n, int t, int nt,
                                           bool count_m, float& w, float& g, float& mx,
                                           float& msum, float& cnt) {
  using R = Vec<T, V>;
  for (int q0 = t * V; q0 < n; q0 += nt * V * kI) {
    typename R::Raw xr[kI], mr[kI];
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      const int q = q0 + nt * V * i;
      if (q < n) {
        xr[i] = R::load(x_row + q);
        mr[i] = R::load(m_row + q);
      }
    }
#pragma unroll
    for (int i = 0; i < kI; ++i) {
      if (q0 + nt * V * i >= n) break;
      float xv[V], mv[V];
      R::unpack(xr[i], xv);
      R::unpack(mr[i], mv);
#pragma unroll
      for (int e = 0; e < V; ++e) {
        w += xv[e] * mv[e];
        g += xv[e];
        if (mv[e] > 0.5f) mx = fmaxf(mx, xv[e]);
        if (count_m) {
          msum += mv[e];
          cnt += mv[e] > 0.5f ? 1.f : 0.f;
        }
      }
    }
  }
}

// Whether a (B, C, N) call may take 16-byte loads of V elements: both bases
// on 16 bytes, every row start a multiple of V elements from them, N a
// multiple of V.
inline bool vector_rows(const void* x, const void* m, long long x_sb, long long x_sc,
                        long long m_sb, int N, int V) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0 &&
         x_sb % V == 0 && x_sc % V == 0 && m_sb % V == 0 && N % V == 0;
}

}  // namespace
