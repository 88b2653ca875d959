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
// Bound: the forward's FP32/integer ALU work and divergence; the sums beside
// it are a few per cent.  What held the first design at 1.5x the forward
// kernel's time a segment was residency: 7N+6 partials and 2N counters in a
// thread's registers (137 at N = 8) left 12 warps an SM to hide the latency
// of the intersect's square roots and divisions, where the forward has 32.
//
// Design.  The forward kernel's loop (csrc/megakernel.cu): a persistent
// grid, one live path per thread, a refill phase the warp's idle lanes enter
// together (there a lane also reads its path's cotangent ct[item % n_cells],
// 3 floats, and clears its counters), warp-owned items (pt::item_at in
// csrc/step_math.cuh).  The 7N+6 partials of a thread live in shared
// memory, laid out [k][thread] so that a
// warp's accesses fall in 32 banks whatever sphere each lane touches; only
// the 2N counters stay in registers, in a compile-time bucket of N (8, 16,
// 40).  A bounce adds to the partials of the spheres whose counter is not
// zero, the spheres the path has hit and continued from, and skips the
// others (their term is 0 * q).  The TPU kernel's K-slot cotangent ring and
// its admission DMA existed because TPU gathers are slow.
//
// Reduction, deterministic: no atomics on floats, and nothing depends on
// which block runs when: the items of a warp and the order its lanes take
// them in are fixed by the launch.  At the end each warp sums the block's
// columns in a fixed order and each block writes one row of a [blocks, 7N+6]
// buffer that the wrapper sums in plain torch.  Two launches on the same
// inputs give bitwise-equal rows.
//
// Counters: as the forward kernel's (segments, most bounce phases of a warp,
// bounce phases summed over warps).

#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

constexpr int kMaxSpheres = 40;  // MAX_REPLAY_SPHERES in ops/kernels/replay.py

// Threads a block by bucket.  A block's partials are (7 NB + 6) x threads
// floats of shared memory: 31 KB, 59 KB and 72 KB, which leave an SM 640,
// 384 and 192 resident threads (91, 109 and 155 registers: the compiler's
// own choice; asked for 6 or 7 blocks an SM the 8-sphere bucket spills and
// measured no faster).  Half and twice these threads measured slower on an
// H100 in every bucket but the first, where half measured the same.
template <int NB>
constexpr int kBlockThreads = NB <= 16 ? 128 : 64;

// Floats of shared memory a block of bucket NB needs for n spheres.
template <int NB>
constexpr size_t smem_floats(int n_spheres) {
  return static_cast<size_t>(pt::scene_floats(n_spheres)) + (7 * NB + 6) * kBlockThreads<NB>;
}

template <typename Index, int NB>
__global__ void __launch_bounds__(kBlockThreads<NB>)
replay_kernel(const float* __restrict__ table, const float* __restrict__ cam,
              const float* __restrict__ ct, float* __restrict__ rows,
              unsigned long long* __restrict__ counters, const pt::Params p) {
  constexpr int T = kBlockThreads<NB>;
  // Rows of the partials in shared memory, by bucket: cq, rw, ge, bg.
  constexpr int kCq = 0, kRw = 3 * NB, kGe = 4 * NB, kBg = 7 * NB, kRows = 7 * NB + 6;
  extern __shared__ __align__(16) float smem[];
  const int n = p.n_spheres;
  const float* s_table = smem;
  const float* s_cam = pt::load_scene(smem, table, cam, n);
  float* part = smem + pt::scene_floats(n) + threadIdx.x;  // this thread's column
#pragma unroll 1
  for (int k = 0; k < kRows; ++k) part[k * T] = 0.0f;
#ifdef PT_SIMT_PROBE
  pt::simt_zero();
  const long long pt_warp_t = clock64();
#endif
  PT_SEC_DECL();

  float cnt[NB], crr[NB];
#pragma unroll
  for (int m = 0; m < NB; ++m) cnt[m] = crr[m] = 0.0f;
  float ctx = 0.0f, cty = 0.0f, ctz = 0.0f;

  // This warp's items.
  const Index warps = static_cast<Index>(gridDim.x) * (T / 32);
  const Index warp = static_cast<Index>(blockIdx.x) * (T / 32) + (threadIdx.x >> 5);
  Index next = 0;  // the warp's position in its walk
  const Index end = pt::owned_positions<Index>(p.n_items, warp, warps);
  const Index n_items = static_cast<Index>(p.n_items);
  const unsigned int lane = threadIdx.x & 31;

  bool alive = false;
  unsigned int phases = 0;          // warp-uniform
  unsigned long long segments = 0;  // warp-uniform: live lanes summed over phases
  pt::Path s;
  while (true) {
    const unsigned int idle = __ballot_sync(0xffffffffu, !alive);
    unsigned int live = ~idle;
    if (next < end && __popc(idle) >= pt::kRefillMin) {
      const Index at = next + static_cast<Index>(__popc(idle & pt::lanes_below()));
      const Index mine = pt::item_at<Index>(at, warp, warps);
      next += static_cast<Index>(__popc(idle));
      if (!alive && at < end && mine < n_items) {
        PT_SEC_BEGIN();
        const size_t c = static_cast<size_t>(pt::start_path<Index>(s, mine, s_cam, p));
        ctx = ct[3 * c];
        cty = ct[3 * c + 1];
        ctz = ct[3 * c + 2];
#pragma unroll
        for (int m = 0; m < NB; ++m) cnt[m] = crr[m] = 0.0f;  // a fresh path has no prefix
        alive = true;
        PT_SEC_END(pt::kSecRegen);
      }
      live = __ballot_sync(0xffffffffu, alive);
    } else if (idle == 0xffffffffu) {
      break;
    }
    ++phases;
    segments += __popc(live);
    if (alive) {
      float rx, ry, rz;
      pt::BounceAux a;
      const bool done = pt::bounce<true>(s, s_table, s_cam, p, rx, ry, rz, a);

      PT_SEC_BEGIN();
      const float tcx = ctx * a.thr_x, tcy = cty * a.thr_y, tcz = ctz * a.thr_z;
      float qx, qy, qz;
      if (a.sidx >= 0) {  // emission pickup (also on a path the roulette ends)
        qx = tcx * a.eh_x;
        qy = tcy * a.eh_y;
        qz = tcz * a.eh_z;
        float* ge = part + (kGe + 3 * a.sidx) * T;
        ge[0] += tcx;
        ge[T] += tcy;
        ge[2 * T] += tcz;
      } else {  // miss: sky, and the background terms
        qx = tcx * a.sky_x;
        qy = tcy * a.sky_y;
        qz = tcz * a.sky_z;
        const float w1 = 1.0f - a.sky_t;
        part[(kBg + 0) * T] += w1 * tcx;
        part[(kBg + 1) * T] += w1 * tcy;
        part[(kBg + 2) * T] += w1 * tcz;
        part[(kBg + 3) * T] += a.sky_t * tcx;
        part[(kBg + 4) * T] += a.sky_t * tcy;
        part[(kBg + 5) * T] += a.sky_t * tcz;
      }
      const float sq = qx + qy + qz;
#pragma unroll
      for (int m = 0; m < NB; ++m) {
        if (cnt[m] != 0.0f) {  // crr[m] <= cnt[m]: a sphere not yet hit adds 0 * q
          part[(kCq + 3 * m) * T] += cnt[m] * qx;
          part[(kCq + 3 * m + 1) * T] += cnt[m] * qy;
          part[(kCq + 3 * m + 2) * T] += cnt[m] * qz;
          part[(kRw + m) * T] += crr[m] * sq;
        }
        // Counters after the accumulation: f_k multiplies later bounces.
        if (m == a.sidx && a.cont) {
          cnt[m] += 1.0f;
          if (a.rr_scaled) crr[m] += 1.0f;
        }
      }
      if (done) alive = false;
      PT_SEC_END(pt::kSecAccumulate);
    }
  }
#ifdef PT_SIMT_PROBE
  pt::simt_end(pt::kSecWarp, pt_warp_t);
  pt::simt_flush(counters);
#endif

  // Every thread of the block reaches this point, with its warp's counts.
  if (lane == 0) {
    atomicAdd(&counters[0], segments);
    atomicMax(&counters[1], static_cast<unsigned long long>(phases));
    atomicAdd(&counters[3], static_cast<unsigned long long>(phases));
  }

  // The block's row: output k is the sum of a row of the partials over the
  // block's threads, in thread order within a lane, then a fixed shuffle tree.
  __syncthreads();
  const float* all = smem + pt::scene_floats(n);
  const int m_total = 7 * n + 6;
  for (int k = threadIdx.x >> 5; k < m_total; k += T / 32) {
    // Output layout over n spheres -> the bucket's rows.
    const int kb = k < 3 * n ? kCq + k
                 : k < 4 * n ? kRw + (k - 3 * n)
                 : k < 7 * n ? kGe + (k - 4 * n)
                             : kBg + (k - 7 * n);
    float v = 0.0f;
#pragma unroll
    for (int t = 0; t < T; t += 32) v += all[kb * T + t + lane];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) rows[static_cast<size_t>(blockIdx.x) * m_total + k] = v;
  }
}

using ReplayFn = void (*)(const float*, const float*, const float*, float*, unsigned long long*,
                          const pt::Params);

struct Launch {
  ReplayFn kernel;
  int threads;
  size_t smem;
};

template <int NB>
Launch launch_of(int index_bits, int n_spheres) {
  return {index_bits == 32 ? replay_kernel<uint32_t, NB> : replay_kernel<long long, NB>,
          kBlockThreads<NB>, smem_floats<NB>(n_spheres) * sizeof(float)};
}

Launch pick(int index_bits, int n_spheres) {
  if (n_spheres <= 8) return launch_of<8>(index_bits, n_spheres);
  if (n_spheres <= 16) return launch_of<16>(index_bits, n_spheres);
  return launch_of<kMaxSpheres>(index_bits, n_spheres);
}

// Above 48 KB of dynamic shared memory a kernel has to ask.
cudaError_t allow_smem(const Launch& l) {
  if (l.smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(reinterpret_cast<const void*>(l.kernel),
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(l.smem));
}

bool bad_args(int n_spheres, int index_bits) {
  return n_spheres < 1 || n_spheres > kMaxSpheres || (index_bits != 32 && index_bits != 64);
}

}  // namespace

extern "C" {

// The persistent grid for a replay of n_items items over n_spheres spheres:
// as many blocks as fit on the card at once, fewer when there are fewer
// items.  Writes the blocks and threads per block; returns a cudaError_t.
int pt_replay_grid(int n_spheres, long long n_items, int index_bits, long long* blocks,
                   int* threads) {
  if (bad_args(n_spheres, index_bits)) return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = pick(index_bits, n_spheres);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = allow_smem(l);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l.kernel, l.threads, l.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long b = static_cast<long long>(sms) * per_sm;
  const long long needed = (n_items + l.threads - 1) / l.threads;
  if (b > needed) b = needed;
  if (b < 1) b = 1;
  *blocks = b;
  *threads = l.threads;
  return 0;
}

// Launches the replay on ``stream`` with ``blocks`` blocks (pt_replay_grid,
// asked with the same ``index_bits``: 32 when the span's indices are below
// 2^31, as for the forward kernel).  ``ct`` is [n_cells, 3] float32, ``rows``
// [blocks, 7N+6] float32 (every row is written), ``counters`` 4 zeroed uint64
// words.  Returns cudaGetLastError() after the launch.
int pt_replay_persistent(const float* table, const float* cam, const float* ct, float* rows,
                         unsigned long long* counters, const pt::Params* params, int index_bits,
                         long long blocks, void* stream) {
  const pt::Params p = *params;
  if (bad_args(p.n_spheres, index_bits) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = pick(index_bits, p.n_spheres);
  const cudaError_t err = allow_smem(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  l.kernel<<<static_cast<unsigned int>(blocks), l.threads, l.smem,
             static_cast<cudaStream_t>(stream)>>>(table, cam, ct, rows, counters, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
