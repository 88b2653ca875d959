// Replay backward in one launch: the Hopper counterpart of replay_persistent
// in cpu_path_tracing_tpu/ops/pallas/replay_kernel.py.
//
// What it computes.  The analytic gradients of sum(ct * render) with
// respect to albedo, emission and background (cpu_path_tracing_tpu_torch/
// ops/replay.py has the algebra): each path is rendered again with the
// forward kernel's step math (bounce<true>, same decisions), and beside it
// every bounce adds its contribution q = ct * thr * (emission pickup | sky)
// to per-thread partials, weighted by the path's prefix counters:
//   [0:3N)    cq[m]   += cnt[m] * q          (albedo numerator)
//   [3N:4N)   rw[m]   += cnt_rr[m] * sum(q)  (albedo roulette term)
//   [4N:7N)   ge[hit] += ct * thr            (emission)
//   [7N:7N+6) bg      += ct * thr * (1-t, t) on a miss
// then cnt[hit] and, after a surviving roulette, cnt_rr[hit] count the hit
// when the path continues.  The partials are float32, as in the TPU kernel.
//
// Design.  The forward kernel's schedule (csrc/megakernel.cu): a persistent
// grid, one live path per thread, regenerating in place over a fixed item
// stride, the sphere table and camera in shared memory.  A regenerating
// thread resets its counters and reads its path's cotangent ct[item %
// n_cells] (3 floats) from device memory; the TPU kernel's K-slot cotangent
// ring and its admission DMA existed because TPU gathers are slow.  The
// per-thread partials (7N+6) and counters (2N) are arrays sized by a
// compile-time bucket of N (8, 16, 40) and indexed by compile-time
// constants only, so they can live in registers; the largest bucket spills.
//
// Bound: the forward's FP32/integer ALU work and divergence, plus 7 FP32
// multiply-adds per sphere per bounce for the accumulation and the register
// pressure of the partials, which limits the threads resident per SM.
// Device-memory traffic is 12 bytes of ct per item.
//
// Reduction, deterministic: no float atomics.  At the end each warp sums
// its threads' partials with shuffles in a fixed order, the block's warps
// are summed in warp order through shared memory, and each block writes one
// row of a [blocks, 7N+6] buffer that the wrapper sums in plain torch.  Two
// launches on the same inputs give bitwise-equal rows.
//
// Counters: as the forward kernel's (segments, most trips of one thread).

#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxSpheres = 40;  // MAX_REPLAY_SPHERES in ops/kernels/replay.py

// Warp sum of v in a fixed shuffle order; lane 0 stores it to *dst.
__device__ __forceinline__ void warp_sum_to(float v, float* dst) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) *dst = v;
}

template <int NB>
__global__ void __launch_bounds__(kThreads)
replay_kernel(const float* __restrict__ table, const float* __restrict__ cam,
              const float* __restrict__ ct, float* __restrict__ rows,
              unsigned long long* __restrict__ counters, const pt::Params p) {
  extern __shared__ float smem[];
  const int n = p.n_spheres;
  const int m_total = 7 * n + 6;
  float* s_table = smem;
  float* s_cam = smem + n * pt::kTableCols;
  float* s_red = s_cam + pt::kCamLen;  // [kWarps][m_total]
  for (int i = threadIdx.x; i < n * pt::kTableCols; i += blockDim.x) s_table[i] = table[i];
  for (int i = threadIdx.x; i < pt::kCamLen; i += blockDim.x) s_cam[i] = cam[i];
  __syncthreads();

  float cq[NB][3], rw[NB], ge[NB][3], cnt[NB], crr[NB], bg[6];
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    cq[m][0] = cq[m][1] = cq[m][2] = 0.0f;
    ge[m][0] = ge[m][1] = ge[m][2] = 0.0f;
    rw[m] = cnt[m] = crr[m] = 0.0f;
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) bg[c] = 0.0f;
  float ctx = 0.0f, cty = 0.0f, ctz = 0.0f;

  const long long lanes = static_cast<long long>(gridDim.x) * blockDim.x;
  long long next = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long item = -1;  // the item of the live path, -1 when idle
  unsigned int trips = 0;
  pt::Path s;
  while (true) {
    if (item < 0) {
      if (next >= p.n_items) break;
      item = next;
      next += lanes;
      pt::start_path(s, item, s_cam, p);
      const long long c = item % p.n_cells;
      ctx = ct[3 * c];
      cty = ct[3 * c + 1];
      ctz = ct[3 * c + 2];
#pragma unroll
      for (int m = 0; m < NB; ++m) cnt[m] = crr[m] = 0.0f;  // a fresh path has no prefix
    }
    ++trips;
    float rx, ry, rz;
    pt::BounceAux a;
    const bool done = pt::bounce<true>(s, s_table, s_cam, p, rx, ry, rz, a);

    const float tcx = ctx * a.thr_x, tcy = cty * a.thr_y, tcz = ctz * a.thr_z;
    float qx, qy, qz;
    if (a.sidx >= 0) {  // emission pickup (also on a path the roulette ends)
      qx = tcx * a.eh_x;
      qy = tcy * a.eh_y;
      qz = tcz * a.eh_z;
    } else {  // miss: sky, and the background terms
      qx = tcx * a.sky_x;
      qy = tcy * a.sky_y;
      qz = tcz * a.sky_z;
      const float w1 = 1.0f - a.sky_t;
      bg[0] += w1 * tcx;
      bg[1] += w1 * tcy;
      bg[2] += w1 * tcz;
      bg[3] += a.sky_t * tcx;
      bg[4] += a.sky_t * tcy;
      bg[5] += a.sky_t * tcz;
    }
    const float sq = qx + qy + qz;
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      if (m < n) {
        cq[m][0] += cnt[m] * qx;
        cq[m][1] += cnt[m] * qy;
        cq[m][2] += cnt[m] * qz;
        rw[m] += crr[m] * sq;
        if (m == a.sidx) {
          ge[m][0] += tcx;
          ge[m][1] += tcy;
          ge[m][2] += tcz;
          // Counters after the accumulation: f_k multiplies later bounces.
          if (a.cont) {
            cnt[m] += 1.0f;
            if (a.rr_scaled) crr[m] += 1.0f;
          }
        }
      }
    }
    if (done) item = -1;
  }

  // Every thread of the block reaches this point.
  unsigned long long seg = trips;
  unsigned int most = trips;
  for (int off = 16; off > 0; off >>= 1) {
    seg += __shfl_down_sync(0xffffffffu, seg, off);
    most = max(most, __shfl_down_sync(0xffffffffu, most, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counters[0], seg);
    atomicMax(&counters[1], static_cast<unsigned long long>(most));
  }

  float* red = s_red + (threadIdx.x >> 5) * m_total;
#pragma unroll
  for (int m = 0; m < NB; ++m) {
    if (m < n) {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        warp_sum_to(cq[m][c], red + 3 * m + c);
        warp_sum_to(ge[m][c], red + 4 * n + 3 * m + c);
      }
      warp_sum_to(rw[m], red + 3 * n + m);
    }
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) warp_sum_to(bg[c], red + 7 * n + c);
  __syncthreads();
  for (int i = threadIdx.x; i < m_total; i += blockDim.x) {
    float t = s_red[i];
    for (int w = 1; w < kWarps; ++w) t += s_red[w * m_total + i];
    rows[static_cast<long long>(blockIdx.x) * m_total + i] = t;
  }
}

using ReplayFn = void (*)(const float*, const float*, const float*, float*, unsigned long long*,
                          const pt::Params);

ReplayFn pick(int n_spheres) {
  if (n_spheres <= 8) return replay_kernel<8>;
  if (n_spheres <= 16) return replay_kernel<16>;
  return replay_kernel<kMaxSpheres>;
}

size_t smem_bytes(int n_spheres) {
  return static_cast<size_t>(n_spheres * pt::kTableCols + pt::kCamLen +
                             kWarps * (7 * n_spheres + 6)) * sizeof(float);
}

}  // namespace

extern "C" {

// The persistent grid for a replay of n_items items over n_spheres spheres:
// as many blocks as fit on the card at once, fewer when there are fewer
// items.  Writes the blocks and threads per block; returns a cudaError_t.
int pt_replay_grid(int n_spheres, long long n_items, long long* blocks, int* threads) {
  if (n_spheres < 1 || n_spheres > kMaxSpheres) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pick(n_spheres), kThreads,
                                                        smem_bytes(n_spheres));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long b = static_cast<long long>(sms) * per_sm;
  const long long needed = (n_items + kThreads - 1) / kThreads;
  if (b > needed) b = needed;
  if (b < 1) b = 1;
  *blocks = b;
  *threads = kThreads;
  return 0;
}

// Launches the replay on ``stream`` with ``blocks`` blocks (pt_replay_grid).
// ``ct`` is [n_cells, 3] float32, ``rows`` [blocks, 7N+6] float32 (every
// row is written), ``counters`` 2 zeroed uint64 words.  Returns
// cudaGetLastError() after the launch.
int pt_replay_persistent(const float* table, const float* cam, const float* ct, float* rows,
                         unsigned long long* counters, const pt::Params* params, long long blocks,
                         void* stream) {
  const pt::Params p = *params;
  if (p.n_spheres < 1 || p.n_spheres > kMaxSpheres || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  pick(p.n_spheres)<<<static_cast<unsigned int>(blocks), kThreads, smem_bytes(p.n_spheres),
                      static_cast<cudaStream_t>(stream)>>>(table, cam, ct, rows, counters, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
