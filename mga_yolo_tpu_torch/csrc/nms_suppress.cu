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
// chain of k dependent decisions, so it is latency-bound, far above both the
// byte and the operation bound. Design: take the IoUs out of the chain.
//
// 1. nms_mask_kernel computes every IoU at once, on many SMs: one 64-thread
//    block per (image, 64-row block r, 64-column block c >= r). The column
//    block's boxes sit in shared memory; the thread of row i writes one
//    64-bit word whose bit j is set iff j > i and IoU(i, j) > iou_thr. The
//    IoU is symmetric bit for bit (min, max and + commute), so the upper
//    triangle is enough. Words go to a workspace (B, k, W), W = ceil(k / 64),
//    1 MB at B = 8, k = 1024, which stays in L2.
// 2. nms_scan_kernel runs the greedy chain, one block per image, word by
//    word. Lane w of warp 0 owns the `removed` word w (W <= 32). For word w
//    every lane loads the 64 diagonal words of the row block into registers
//    and resolves its 64 candidates in registers only (keep iff live and not
//    removed; a kept candidate removes the later ones its row marks), two
//    dependent 32-bit operations a candidate; then each lane w' > w ORs the
//    rows of the kept candidates into its own word. Those rows come from
//    shared memory: while warp 0 resolves row block w, the other warps copy
//    row block w + kAhead from the workspace into a ring of kAhead + 1
//    buffers (cp.async), so no step of the chain waits on L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

constexpr int kMaxK = 2048;        // W <= 32: one lane of warp 0 per word
constexpr int kMaxWords = kMaxK / 64;
constexpr int kScanThreads = 256;  // warp 0 scans, warps 1..7 prefetch
constexpr int kAhead = 3;          // row blocks in flight ahead of the scan

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(__fsub_rn(b.z, b.x), __fsub_rn(b.w, b.y));
}

// IoU(a, b) > thr in the plain version's operation order. Where the boxes
// do not meet, inter / den is +-0 for every den but 0 and NaN, so the
// division is skipped there with the same result.
__device__ __forceinline__ bool iou_above(float4 a, float area_a, float4 b, float area_b,
                                          float thr) {
  const float iw = fmaxf(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), 0.f);
  const float ih = fmaxf(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), 0.f);
  const float inter = __fmul_rn(iw, ih);
  const float den = __fadd_rn(__fsub_rn(__fadd_rn(area_a, area_b), inter), 1e-7f);
  if (inter == 0.f && den != 0.f && den == den) return 0.f > thr;
  return __fdiv_rn(inter, den) > thr;
}

// One 256-thread block per (image, 64-row block r, 64-column block c >= r):
// thread (q, t) tests row r*64 + t against the q-th 16 columns; the four
// partial words of a row are ORed in shared memory.
__global__ void __launch_bounds__(256)
nms_mask_kernel(const float4* __restrict__ boxes, int k, int W, float iou_thr,
                u64* __restrict__ mask) {
  // blockIdx.x enumerates the (r, c >= r) pairs row by row; blockIdx.y the image
  int idx = blockIdx.x, r = 0;
  while (idx >= W - r) {
    idx -= W - r;
    ++r;
  }
  const int c = r + idx;
  const int b = blockIdx.y, t = threadIdx.x & 63, q = threadIdx.x >> 6;
  __shared__ float4 col[64];
  __shared__ float col_area[64];
  __shared__ u64 part[4][64];
  const float4* bx = boxes + (int64_t)b * k;
  const int j0 = c * 64, i = r * 64 + t;
  if (q == 0 && j0 + t < k) {
    col[t] = bx[j0 + t];
    col_area[t] = box_area(col[t]);
  }
  __syncthreads();
  u64 word = 0;
  if (i < k) {
    const float4 row = bx[i];
    const float row_area = box_area(row);
    const int j_end = min(16 * q + 16, k - j0);
    for (int j = (c == r) ? max(16 * q, t + 1) : 16 * q; j < j_end; ++j)
      if (iou_above(row, row_area, col[j], col_area[j], iou_thr)) word |= 1ull << j;
  }
  part[q][t] = word;
  __syncthreads();
  if (q == 0 && i < k)
    mask[((int64_t)b * k + i) * W + c] = part[0][t] | part[1][t] | part[2][t] | part[3][t];
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Wait until at most kAhead - 1 of this thread's copy groups are in flight.
__device__ __forceinline__ void cp_async_wait_ahead() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead - 1));
}

// Bits [0, t] of v with bit t copied into every higher bit.
__device__ __forceinline__ unsigned sext_bit(unsigned v, int t) {
  int r;
  asm("bfe.s32 %0, %1, 0, %2;" : "=r"(r) : "r"(v), "r"(t + 1));
  return static_cast<unsigned>(r);
}

// Start copying words [w, W) of the rows of row block w into dst[t * W + word].
__device__ __forceinline__ void stage_rows(const u64* __restrict__ mask_b, int k, int W, int w,
                                           u64* dst, int tid, int nthreads) {
  const int nw = W - w;
  for (int e = tid; e < 64 * nw; e += nthreads) {
    const int t = e / nw, word = w + e % nw;
    const int row = w * 64 + t;
    if (row < k)
      cp_async8(dst + t * W + word, mask_b + (int64_t)row * W + word);
    else
      dst[t * W + word] = 0ull;
  }
}

__global__ void __launch_bounds__(kScanThreads)
nms_scan_kernel(const u64* __restrict__ mask, const float* __restrict__ scores,
                unsigned char* __restrict__ keep, int k, int W, float conf_thr) {
  extern __shared__ u64 sh[];  // rows[kAhead + 1][64 * W] | live[W]
  u64* live = sh + (kAhead + 1) * 64 * W;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64* mask_b = mask + (int64_t)b * k * W;
  const float* sc = scores + (int64_t)b * k;
  unsigned char* kb = keep + (int64_t)b * k;

  if (warp > 0) {  // one copy group per row block, also where it is past the last
    for (int a = 0; a < kAhead; ++a) {
      if (a < W)
        stage_rows(mask_b, k, W, a, sh + a * 64 * W, tid - 32, kScanThreads - 32);
      cp_async_commit();
    }
  }
  // live bits: every thread loads its scores at once; warp v's ballot of
  // round j is 32-bit half 8 j + v of the live words
  constexpr int kRounds = kMaxK / kScanThreads;
  float sv[kRounds];
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = j * kScanThreads + tid;
    sv[j] = i < k ? sc[i] : 0.f;
  }
#pragma unroll
  for (int j = 0; j < kRounds; ++j) {
    const int i = j * kScanThreads + tid;
    const unsigned bits = __ballot_sync(~0u, i < k && sv[j] > conf_thr);
    const int half = j * (kScanThreads / 32) + warp;
    if (lane == 0 && half < 2 * W) reinterpret_cast<unsigned*>(live)[half] = bits;
  }
  if (warp > 0) cp_async_wait_ahead();
  __syncthreads();

  u64 removed = 0;  // warp 0: lane w holds the removed bits of word w
  for (int w = 0; w < W; ++w) {
    const u64* cur = sh + (w % (kAhead + 1)) * 64 * W;
    if (warp > 0) {
      const int a = w + kAhead;
      if (a < W)
        stage_rows(mask_b, k, W, a, sh + (a % (kAhead + 1)) * 64 * W, tid - 32, kScanThreads - 32);
      cp_async_commit();
      cp_async_wait_ahead();  // row block w + 1 has landed
    } else {
      u64 diag[64];
#pragma unroll
      for (int t = 0; t < 64; ++t) diag[t] = cur[t * W + w];
      const u64 todo = live[w] & ~__shfl_sync(~0u, removed, w);
      // Candidate t clears the later bits its row marks iff its own bit is
      // still set; a bit is never cleared after its own step, so what is left
      // is the kept set.
      unsigned lo = static_cast<unsigned>(todo), hi = static_cast<unsigned>(todo >> 32);
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const unsigned s = sext_bit(lo, t);
        lo &= ~(static_cast<unsigned>(diag[t]) & s);
        const unsigned all = static_cast<unsigned>(static_cast<int>(s) >> 31);
        hi &= ~(static_cast<unsigned>(diag[t] >> 32) & all);
      }
#pragma unroll
      for (int t = 32; t < 64; ++t)
        hi &= ~(static_cast<unsigned>(diag[t] >> 32) & sext_bit(hi, t - 32));
      const u64 kept = ((u64)hi << 32) | lo;
      if (lane > w && lane < W) {  // independent shared-memory loads, one OR each
        u64 acc = 0;
#pragma unroll
        for (int t = 0; t < 64; ++t)
          if ((kept >> t) & 1ull) acc |= cur[t * W + lane];
        removed |= acc;
      }
      const int i0 = w * 64 + lane;
      if (i0 < k) kb[i0] = (kept >> lane) & 1ull;
      if (i0 + 32 < k) kb[i0 + 32] = (kept >> (lane + 32)) & 1ull;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Largest k one launch takes.
int nms_suppress_max_k() { return kMaxK; }

// boxes (B, k, 4) float32 (16-byte aligned), scores (B, k) float32, keep
// (B, k) bytes in {0, 1}; ws a workspace of B * k * ceil(k / 64) 64-bit words.
// Launches the mask kernel, then the scan. Returns the cudaError_t of the
// launches (0 = success).
int nms_suppress_launch(const void* boxes, const void* scores, void* keep, void* ws, int B, int k,
                        float iou_thr, float conf_thr, void* stream) {
  if (B < 1 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int W = (k + 63) / 64;
  nms_mask_kernel<<<dim3(W * (W + 1) / 2, B), 256, 0, st>>>(
      static_cast<const float4*>(boxes), k, W, iou_thr, static_cast<u64*>(ws));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  static const cudaError_t attr = cudaFuncSetAttribute(  // once: room for k = kMaxK
      nms_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(u64) * ((kAhead + 1) * 64 * kMaxWords + kMaxWords)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const size_t shmem = sizeof(u64) * ((kAhead + 1) * 64 * (size_t)W + W);
  nms_scan_kernel<<<B, kScanThreads, shmem, st>>>(static_cast<const u64*>(ws),
                                                  static_cast<const float*>(scores),
                                                  static_cast<unsigned char*>(keep), k, W, conf_thr);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
