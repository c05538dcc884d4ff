// Greedy NMS suppression for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel mga_yolo_tpu/ops/pallas/nms.py
// _suppress_kernel_factory (wrapper _suppress_pallas). Input per image: k
// score-sorted candidates with class-offset boxes (x1, y1, x2, y2) and their
// scores. Candidate i is kept iff score_i > conf_thr and no kept j < i has
// IoU(j, i) > iou_thr, with IoU = inter / (area_i + area_j - inter + 1e-7),
// computed in float32 in that operation order (the _rn intrinsics keep nvcc
// from contracting it into fused multiply-adds, so it rounds as the reference).
//
// Bound: the data it needs are small (20 bytes a candidate); the work is
// one IoU for each pair (kept j, later i), and the greedy order makes it a
// chain of k dependent steps, so the kernel is latency-bound, far above both
// the byte and the operation bound. Design: one block per image; the boxes
// sit in shared memory; thread t owns candidates t, t + blockDim, ... and
// keeps their keep bits in registers (only the owner ever reads them). Step
// i broadcasts box i from shared memory, each thread tests its own kept
// j < i, and one __syncthreads_or per step decides candidate i.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kPerThread = 2;  // so k <= 2048

__global__ void __launch_bounds__(kMaxThreads)
nms_suppress_kernel(const float* __restrict__ boxes, const float* __restrict__ scores,
                    unsigned char* __restrict__ keep, int k, float iou_thr, float conf_thr) {
  extern __shared__ float sh[];  // x1[k] | y1[k] | x2[k] | y2[k] | score[k]
  float* sx1 = sh;
  float* sy1 = sh + k;
  float* sx2 = sh + 2 * k;
  float* sy2 = sh + 3 * k;
  float* ssc = sh + 4 * k;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, nt = blockDim.x;
  const float4* bx = reinterpret_cast<const float4*>(boxes + (int64_t)b * k * 4);
  const float* sc = scores + (int64_t)b * k;
  for (int i = tid; i < k; i += nt) {
    const float4 v = bx[i];
    sx1[i] = v.x;
    sy1[i] = v.y;
    sx2[i] = v.z;
    sy2[i] = v.w;
    ssc[i] = sc[i];
  }
  __syncthreads();

  float jx1[kPerThread], jy1[kPerThread], jx2[kPerThread], jy2[kPerThread], ja[kPerThread];
  bool jk[kPerThread];
#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int j = tid + p * nt;
    jk[p] = false;
    if (j < k) {
      jx1[p] = sx1[j];
      jy1[p] = sy1[j];
      jx2[p] = sx2[j];
      jy2[p] = sy2[j];
      ja[p] = __fmul_rn(__fsub_rn(jx2[p], jx1[p]), __fsub_rn(jy2[p], jy1[p]));
    } else {
      jx1[p] = jy1[p] = jx2[p] = jy2[p] = ja[p] = 0.f;
    }
  }

  for (int i = 0; i < k; ++i) {
    const float x1 = sx1[i], y1 = sy1[i], x2 = sx2[i], y2 = sy2[i];
    const float ai = __fmul_rn(__fsub_rn(x2, x1), __fsub_rn(y2, y1));
    int sup = 0;
#pragma unroll
    for (int p = 0; p < kPerThread; ++p) {
      const int j = tid + p * nt;
      if (j < i && jk[p]) {
        const float iw = fmaxf(__fsub_rn(fminf(x2, jx2[p]), fmaxf(x1, jx1[p])), 0.f);
        const float ih = fmaxf(__fsub_rn(fminf(y2, jy2[p]), fmaxf(y1, jy1[p])), 0.f);
        const float inter = __fmul_rn(iw, ih);
        const float den = __fadd_rn(__fsub_rn(__fadd_rn(ai, ja[p]), inter), 1e-7f);
        sup |= __fdiv_rn(inter, den) > iou_thr;
      }
    }
    const int suppressed = __syncthreads_or(sup);
    if (!suppressed && ssc[i] > conf_thr) {
#pragma unroll
      for (int p = 0; p < kPerThread; ++p)
        if (tid + p * nt == i) jk[p] = true;
    }
  }

#pragma unroll
  for (int p = 0; p < kPerThread; ++p) {
    const int j = tid + p * nt;
    if (j < k) keep[(int64_t)b * k + j] = jk[p] ? 1 : 0;
  }
}

}  // namespace

extern "C" {

// Largest k one launch takes.
int nms_suppress_max_k() { return kMaxThreads * kPerThread; }

// boxes (B, k, 4) float32, scores (B, k) float32, keep (B, k) bytes in {0, 1}.
// Returns the cudaError_t of the launch (0 = success).
int nms_suppress_launch(const void* boxes, const void* scores, void* keep, int B, int k,
                        float iou_thr, float conf_thr, void* stream) {
  if (k < 1 || k > kMaxThreads * kPerThread) return static_cast<int>(cudaErrorInvalidValue);
  int threads = (k + kPerThread - 1) / kPerThread;
  threads = ((threads + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const size_t shmem = sizeof(float) * 5 * (size_t)k;
  nms_suppress_kernel<<<B, threads, shmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const float*>(scores),
      static_cast<unsigned char*>(keep), k, iou_thr, conf_thr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
