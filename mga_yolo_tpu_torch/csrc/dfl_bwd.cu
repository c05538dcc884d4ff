// Fused DFL decode + distribution-focal CE backward for NVIDIA Hopper (sm_90a).
//
// Replaces both TPU kernels of mga_yolo_tpu/ops/pallas/dfl_bwd.py:
// _kernel (batch-major (B, A, 4) aux, wrapper dfl_decode_ce_bwd_pallas) and
// _kernel_planar (planar (4, B, A) aux, wrapper
// dfl_decode_ce_bwd_pallas_planar). Both compute, for every (anchor, side)
// segment of R logits z of pd (B, A, 4, R):
//
//   p  = softmax(z)                                          (float32)
//   t  = clip(target, 0, R-1-0.01); tl = floor(t); wl = tl+1-t
//   q  = wl*onehot(tl) + (1-wl)*onehot(tl+1)
//   dz = p*((j - ltrb)*g_ltrb + g_ce/4) - q*g_ce/4           -> pd's dtype
//
// Each aux tensor (ltrb, g_ltrb, target: per side; g_ce: per anchor) comes
// with its own (batch, anchor, side) strides, so a (B, A, 4) tensor and a
// permuted view of a planar (4, B, A) one launch the same kernel with no
// copy: that is how one source covers both TPU kernels.
//
// Bound: pd is read once and dz written once (2 * B*A*4*R elements) beside
// 13 float32 aux values per anchor; a few dozen operations per segment, so
// the kernel is bound by bytes on this card. Design: one thread per segment,
// R contiguous logits fetched with 16-byte vector loads into registers, the
// max / exp / sum / dz all in float32 registers, and dz stored with 16-byte
// vector stores. The TPU kernels packed 8 segments into a 128-lane row and
// broadcast aux values with one-hot matmuls; a thread owning its segment
// needs neither. The tail of the grid is masked, so B*A needs no padding.
// dz uses round-to-nearest intrinsics so nvcc cannot contract it into fused
// multiply-adds: it rounds as the plain version does, operation by operation.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

struct Aux {
  const float* ptr;
  long long sb, sa, ss;  // element strides of batch, anchor, side
};

__device__ __forceinline__ float at(const Aux& t, long long b, long long a, int s) {
  return t.ptr[b * t.sb + a * t.sa + s * t.ss];
}

// R values of one segment <-> registers, in 16-byte vectors.
template <int R>
__device__ __forceinline__ void load_seg(const float* src, float* x) {
  const float4* v = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < R / 4; ++i) {
    const float4 f = v[i];
    x[4 * i] = f.x; x[4 * i + 1] = f.y; x[4 * i + 2] = f.z; x[4 * i + 3] = f.w;
  }
}

template <int R>
__device__ __forceinline__ void load_seg(const __nv_bfloat16* src, float* x) {
  const uint4* v = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
    uint4 u = v[i];
    const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) x[8 * i + k] = __bfloat162float(h[k]);
  }
}

template <int R>
__device__ __forceinline__ void store_seg(float* dst, const float* y) {
  float4* v = reinterpret_cast<float4*>(dst);
#pragma unroll
  for (int i = 0; i < R / 4; ++i)
    v[i] = make_float4(y[4 * i], y[4 * i + 1], y[4 * i + 2], y[4 * i + 3]);
}

template <int R>
__device__ __forceinline__ void store_seg(__nv_bfloat16* dst, const float* y) {
  uint4* v = reinterpret_cast<uint4*>(dst);
#pragma unroll
  for (int i = 0; i < R / 8; ++i) {
    uint4 u;
    __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16_rn(y[8 * i + k]);
    v[i] = u;
  }
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
dfl_bwd_kernel(const T* __restrict__ pd, T* __restrict__ dz, Aux ltrb, Aux g_ltrb, Aux target,
               Aux g_ce, long long A, long long n_seg) {
  const long long seg = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (seg >= n_seg) return;
  const int s = (int)(seg & 3);
  const long long ba = seg >> 2;
  const long long b = ba / A, a = ba - b * A;

  float x[R];
  load_seg<R>(pd + seg * R, x);
  float mx = x[0];
#pragma unroll
  for (int j = 1; j < R; ++j) mx = fmaxf(mx, x[j]);
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    x[j] = expf(x[j] - mx);
    sum += x[j];
  }

  const float t = fminf(fmaxf(at(target, b, a, s), 0.f), (float)(R - 1) - 0.01f);
  const float tl = floorf(t);
  const float wl = __fsub_rn(__fadd_rn(tl, 1.f), t);
  const float wr = __fsub_rn(1.f, wl);
  const float L = at(ltrb, b, a, s);
  const float G = at(g_ltrb, b, a, s);
  const float gs = __fdiv_rn(at(g_ce, b, a, 0), 4.f);
  const int il = (int)tl;

#pragma unroll
  for (int j = 0; j < R; ++j) {
    const float p = __fdiv_rn(x[j], sum);
    const float q = (j == il ? wl : 0.f) + (j == il + 1 ? wr : 0.f);
    const float inner = __fadd_rn(__fmul_rn(__fsub_rn((float)j, L), G), gs);
    x[j] = __fsub_rn(__fmul_rn(p, inner), __fmul_rn(q, gs));
  }
  store_seg<R>(dz + seg * R, x);
}

template <typename T, int R>
int launch_r(const void* pd, void* dz, const Aux& l, const Aux& g, const Aux& t, const Aux& c,
             long long B, long long A, cudaStream_t st) {
  const long long n_seg = B * A * 4;
  const long long blocks = (n_seg + kThreads - 1) / kThreads;
  dfl_bwd_kernel<T, R><<<(unsigned)blocks, kThreads, 0, st>>>(
      static_cast<const T*>(pd), static_cast<T*>(dz), l, g, t, c, A, n_seg);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(int R, const void* pd, void* dz, const Aux& l, const Aux& g, const Aux& t,
           const Aux& c, long long B, long long A, cudaStream_t st) {
  switch (R) {
    case 8: return launch_r<T, 8>(pd, dz, l, g, t, c, B, A, st);
    case 16: return launch_r<T, 16>(pd, dz, l, g, t, c, B, A, st);
    case 32: return launch_r<T, 32>(pd, dz, l, g, t, c, B, A, st);
    case 64: return launch_r<T, 64>(pd, dz, l, g, t, c, B, A, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (pd and dz). R in {8, 16, 32, 64}.
// Aux strides are in elements: (batch, anchor, side) for ltrb, g_ltrb and
// target, (batch, anchor) for g_ce. pd and dz are contiguous (B, A, 4, R)
// and 16-byte aligned. Returns the cudaError_t of the launch (0 = success).
int dfl_bwd_launch(int dtype, int R, long long B, long long A, const void* pd, void* dz,
                   const float* ltrb, long long l_sb, long long l_sa, long long l_ss,
                   const float* g_ltrb, long long g_sb, long long g_sa, long long g_ss,
                   const float* target, long long t_sb, long long t_sa, long long t_ss,
                   const float* g_ce, long long c_sb, long long c_sa, void* stream) {
  const Aux l{ltrb, l_sb, l_sa, l_ss}, g{g_ltrb, g_sb, g_sa, g_ss}, t{target, t_sb, t_sa, t_ss};
  const Aux c{g_ce, c_sb, c_sa, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * A == 0) return 0;
  if (dtype == 0) return launch<float>(R, pd, dz, l, g, t, c, B, A, st);
  if (dtype == 1) return launch<__nv_bfloat16>(R, pd, dz, l, g, t, c, B, A, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
