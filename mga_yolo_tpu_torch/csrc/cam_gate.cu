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
// operations per byte, so it is memory-bound on this card; at the serving
// shapes (1.6-6.6 MB a call) a launch and a few dependent round trips cost
// as much as the bytes, so the design counts launches and round trips.
// One launch per call. The grid is (channel tiles x pixel chunks, B): a tile
// is one channel per warp, and the chunks are cut so the grid holds about
// kBlocksPerSM blocks per SM (P3 splits pixels, P5 channels). A warp reduces
// its channel's chunk with 16-byte loads (8 bf16 or 4 float32, kI of x and m
// in flight a lane) where the plane's base, strides and N allow, and one
// element a load elsewhere (an odd N, a channel slice). Each block writes its
// float32 partials to a workspace and counts itself on its image's counter;
// the last block of the image to arrive combines the partials, runs the MLP
// and sigmoid (its weights copied into shared memory by cp.async meanwhile)
// and puts the counter back to 0. Each launch gets counters of its own from
// the wrapper (a ring, zeroed once), so launches on concurrent streams never
// share one, and a CUDA graph's replays, which never overlap each other,
// find theirs at 0 again. A launch captured into a graph keeps its counters
// while the graph lives: cam_gate_hold_counters ties a CUDA user object to
// the graph under capture, whose destructor queues the counters' offset,
// and cam_gate_released hands the queue to the wrapper's ring.

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <vector>

#include "masked_reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // channels per tile: one a warp
constexpr int kMinChunk = 256;         // fewest pixels a block's chunk is cut to
constexpr int kBlocksPerSM = 2;        // what the grid aims at
constexpr int kStageBytes = 32 * 1024; // MLP weights staged in shared memory up to this

// Adds 1 to *counter at device scope, releasing this thread's (and, after a
// barrier, its block's) earlier writes and acquiring those released by earlier
// adds; returns the old value.
__device__ __forceinline__ int arrive_acq_rel(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], %2;"
               : "=r"(old)
               : "l"(counter), "r"(1)
               : "memory");
  return old;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Block (tile cs, chunk ps) of image b: warp w reduces channel cs * kWarps + w
// over pixels [ps * chunk, ps * chunk + chunk). Partials, per image and chunk:
// wsum[C] | gsum[C] | mmax[C] | msum | cnt (3C + 2 floats).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
cam_gate_kernel(const T* __restrict__ x, const T* __restrict__ m, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ w2, const T* __restrict__ b2,
                int64_t x_sb, int64_t x_sc, int64_t m_sb, int C, int N, int H, int PS, int chunk,
                bool stage, float tiny_thr, float eps, float* __restrict__ ws,
                int* __restrict__ counters, float* __restrict__ gate) {
  // the last block's: avg[C] | mx[C] | ha[H] | hm[H] | (16-byte aligned) w1[H C] w2[C H] in T
  extern __shared__ __align__(16) float sh[];
  __shared__ bool s_last;
  const int b = blockIdx.y;
  const int cs = blockIdx.x / PS, ps = blockIdx.x - cs * PS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = ps * chunk, len = min(chunk, N - n0);
  const int c = cs * kWarps + warp;
  const int slot = 3 * C + 2;
  float* wsb = ws + (int64_t)b * PS * slot;

  if (c < C) {
    float w = 0.f, g = 0.f, mx = kNeg, msum = 0.f, cnt = 0.f;
    reduce_row<T, V>(x + b * x_sb + c * x_sc + n0, m + b * m_sb + n0, len, lane, 32, c == 0, w,
                     g, mx, msum, cnt);
    w = warp_sum(w);
    g = warp_sum(g);
    mx = warp_max(mx);
    float* p = wsb + ps * slot;
    if (c == 0) {  // one warp of each chunk sends the mask's sums
      msum = warp_sum(msum);
      cnt = warp_sum(cnt);
      if (lane == 0) {
        p[3 * C] = msum;
        p[3 * C + 1] = cnt;
      }
    }
    if (lane == 0) {
      p[c] = w;
      p[C + c] = g;
      p[2 * C + c] = mx;
    }
  }
  // The barrier orders the block's partials before thread 0's release; its
  // acquire, and the barrier after it, order the other blocks' before the
  // combine's reads (no fence for each writer).
  __syncthreads();
  if (tid == 0) s_last = arrive_acq_rel(counters + b) == (int)gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;

  float* avg = sh;
  float* mxd = avg + C;
  float* ha = mxd + C;
  float* hm = ha + H;
  const T* W1 = w1;
  const T* W2 = w2;
  if (stage) {  // bring the weights in while the partials are combined
    T* w1s = reinterpret_cast<T*>(sh + ((2 * C + 2 * H + 3) & ~3));
    T* w2s = w1s + H * C;
    const int n16 = H * C * (int)sizeof(T) / 16;
    for (int e = tid; e < 2 * n16; e += kThreads) {
      if (e < n16)
        cp_async16(reinterpret_cast<char*>(w1s) + 16 * e, reinterpret_cast<const char*>(w1) + 16 * e);
      else
        cp_async16(reinterpret_cast<char*>(w2s) + 16 * (e - n16),
                   reinterpret_cast<const char*>(w2) + 16 * (e - n16));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    W1 = w1s;
    W2 = w2s;
  }

  float tot = 0.f, any = 0.f;
  for (int p = 0; p < PS; ++p) {
    tot += __ldcg(wsb + p * slot + 3 * C);
    any += __ldcg(wsb + p * slot + 3 * C + 1);
  }
  const bool valid = tot / (float)N >= tiny_thr;
  const float denom = fmaxf(tot, eps);
  for (int cc = tid; cc < C; cc += kThreads) {
    float w = 0.f, g = 0.f, mx = kNeg;
    for (int p = 0; p < PS; ++p) {
      const float* r = wsb + p * slot;
      w += __ldcg(r + cc);
      g += __ldcg(r + C + cc);
      mx = fmaxf(mx, __ldcg(r + 2 * C + cc));
    }
    const float gap = g / (float)N;
    avg[cc] = valid ? w / denom : gap;
    mxd[cc] = any > 0.f ? mx : gap;
  }
  if (stage) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  for (int j = warp; j < H; j += kWarps) {  // hidden units: one warp each
    const T* row = W1 + (int64_t)j * C;
    float a = 0.f, q = 0.f;
    for (int cc = lane; cc < C; cc += 32) {
      const float wv = to_f32(row[cc]);
      a += wv * avg[cc];
      q += wv * mxd[cc];
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
  for (int cc = tid; cc < C; cc += kThreads) {
    const T* row = W2 + (int64_t)cc * H;
    const float bc = to_f32(b2[cc]);
    float oa = bc, om = bc;
    for (int j = 0; j < H; ++j) {
      const float wv = to_f32(row[j]);
      oa += wv * ha[j];
      om += wv * hm[j];
    }
    gate[(int64_t)b * C + cc] = 1.f / (1.f + expf(-(oa + om)));
  }
  if (tid == 0) counters[b] = 0;  // every block of this image has counted
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || n < 1)
      n = 132;
    cudaGetLastError();
  }
  return n;
}

// Pixel chunks PS and their length (a multiple of 8, so of every V) of an
// (B, C, N) call: about kBlocksPerSM blocks per SM, chunks of >= kMinChunk.
void plan(int B, int C, int N, int* PS, int* chunk) {
  const long long tiles = (long long)B * ((C + kWarps - 1) / kWarps);
  const long long want = (kBlocksPerSM * (long long)sm_count() + tiles - 1) / tiles;
  const int ps = (int)std::max(1LL, std::min(want, (long long)(N / kMinChunk)));
  *chunk = ((N + ps - 1) / ps + 7) / 8 * 8;
  *PS = (N + *chunk - 1) / *chunk;
}

template <typename T, int V>
cudaError_t launch(const void* x, const void* m, const void* w1, const void* b1, const void* w2,
                   const void* b2, long long x_sb, long long x_sc, long long m_sb, int B, int C,
                   int N, int H, float tiny_thr, float eps, void* ws, void* counters, void* gate,
                   cudaStream_t st) {
  int PS, chunk;
  plan(B, C, N, &PS, &chunk);
  const size_t wbytes = (size_t)H * C * sizeof(T);
  const bool stage = 2 * wbytes <= (size_t)kStageBytes && wbytes % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w1) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(w2) % 16 == 0;
  const size_t shmem = ((2 * (size_t)C + 2 * H + 3) / 4) * 16 + (stage ? 2 * wbytes : 0);
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        cam_gate_kernel<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(((C + kWarps - 1) / kWarps) * PS, B);
  cam_gate_kernel<T, V><<<grid, kThreads, shmem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(m), static_cast<const T*>(w1),
      static_cast<const T*>(b1), static_cast<const T*>(w2), static_cast<const T*>(b2),
      (int64_t)x_sb, (int64_t)x_sc, (int64_t)m_sb, C, N, H, PS, chunk, stage, tiny_thr, eps,
      static_cast<float*>(ws), static_cast<int*>(counters), static_cast<float*>(gate));
  return cudaGetLastError();
}

template <typename T>
int launch_typed(const void* x, const void* m, const void* w1, const void* b1, const void* w2,
                 const void* b2, long long x_sb, long long x_sc, long long m_sb, int B, int C,
                 int N, int H, float tiny_thr, float eps, void* ws, void* counters, void* gate,
                 void* stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = vector_rows(x, m, x_sb, x_sc, m_sb, N, V);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      vec ? launch<T, V>(x, m, w1, b1, w2, b2, x_sb, x_sc, m_sb, B, C, N, H, tiny_thr, eps, ws,
                         counters, gate, st)
          : launch<T, 1>(x, m, w1, b1, w2, b2, x_sb, x_sc, m_sb, B, C, N, H, tiny_thr, eps, ws,
                         counters, gate, st);
  return static_cast<int>(err);
}

std::mutex g_released_mu;
std::vector<long long> g_released;  // offsets of counters whose graph is gone

// Runs on a CUDA thread once the graph and every executable made from it
// are destroyed; it may call no CUDA function.
void release_counters(void* offset_plus_one) {
  std::lock_guard<std::mutex> lock(g_released_mu);
  g_released.push_back(static_cast<long long>(reinterpret_cast<intptr_t>(offset_plus_one)) - 1);
}

}  // namespace

extern "C" {

// Ties the counters at ring offset `offset` to the graph being captured on
// `stream`: when that graph and its executables are destroyed, the offset
// is queued for cam_gate_released. Returns a cudaError_t (0 = success).
int cam_gate_hold_counters(void* stream, long long offset) {
  cudaStreamCaptureStatus status;
  cudaGraph_t graph = nullptr;
  // the trailing outputs default to none (their number differs between CUDA 12 and 13)
  cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, nullptr, &graph);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive || graph == nullptr)
    return static_cast<int>(cudaErrorIllegalState);
  cudaUserObject_t obj;
  err = cudaUserObjectCreate(&obj, reinterpret_cast<void*>(static_cast<intptr_t>(offset + 1)),
                             release_counters, 1, cudaUserObjectNoDestructorSync);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGraphRetainUserObject(graph, obj, 1, cudaGraphUserObjectMove));
}

// Moves up to `cap` queued offsets of released counters into `out`;
// returns how many.
int cam_gate_released(long long* out, int cap) {
  std::lock_guard<std::mutex> lock(g_released_mu);
  int n = std::min(cap, static_cast<int>(g_released.size()));
  std::copy(g_released.end() - n, g_released.end(), out);
  g_released.resize(g_released.size() - n);
  return n;
}

// Floats of workspace a (B, C, N) call needs: B * PS * (3C + 2).
long long cam_gate_workspace_floats(int B, int C, int N) {
  int PS, chunk;
  plan(B, C, N, &PS, &chunk);
  return (long long)B * PS * (3LL * C + 2);
}

// dtype: 0 = float32, 1 = bfloat16 (x, m and the MLP weights share it).
// ws: cam_gate_workspace_floats(B, C, N) floats; counters: B int32 zeros,
// which the launch leaves at zero. Returns the cudaError_t of the launch
// (0 = success).
int cam_gate_launch(int dtype, const void* x, const void* m, const void* w1, const void* b1,
                    const void* w2, const void* b2, long long x_sb, long long x_sc,
                    long long m_sb, int B, int C, int N, int H, float tiny_thr, float eps,
                    void* ws, void* counters, void* gate, void* stream) {
  if (B < 1 || B > 65535 || C < 1 || N < 1 || H < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0)
    return launch_typed<float>(x, m, w1, b1, w2, b2, x_sb, x_sc, m_sb, B, C, N, H, tiny_thr, eps,
                               ws, counters, gate, stream);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x, m, w1, b1, w2, b2, x_sb, x_sc, m_sb, B, C, N, H,
                                       tiny_thr, eps, ws, counters, gate, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
