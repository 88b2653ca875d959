// Forward render in one launch: the Hopper counterpart of persistent_render
// in cpu_path_tracing_tpu/ops/pallas/megakernel.py.
//
// Bound: FP32 and integer ALU work and divergence, not bytes.  A path
// segment costs an N-sphere quadratic, two 13-round Threefry blocks and
// the shading; the only device-memory traffic is 12 bytes per item.  What
// its design can win is instructions: those a warp issues for lanes that do
// no work, and those the arithmetic does not need.
//
// Design.  A persistent grid (as many 256-thread blocks as fit on the card
// at once, fewer when there are fewer items).  Each thread keeps one live
// path in registers and writes out[:, item] when it ends.  The loop of a
// warp has two phases:
//   * refill.  Lanes whose path ended sit out the bounces until a ballot
//     shows at least pt::kRefillMin of the warp's lanes idle (or none alive);
//     then all idle lanes run start_path together.  A lane that started its
//     next item at once, as the first design did, made the whole warp step
//     through start_path on 9 trips in 10 with 2 or 3 active lanes (counted
//     on the 1024x768 disco render).
//   * bounce.  Every live lane runs one pt::bounce.
// Items come from one queue for the whole launch, a device counter
// (counters[2]): at a refill one lane of the warp takes as many items as the
// warp has idle lanes with one atomicAdd, and the idle lanes take them in
// order.  So a warp's lanes share work whatever their path lengths (a fixed
// stride per thread made every warp wait for its slowest lane), and warps
// that draw long paths take fewer items (equal shares a warp, the replay
// kernel's map, left a tenth of this launch to the warps with the longest
// paths and measured 15-18% slower on the 1024x768 disco render on an H100).
// Every draw is keyed by (cell, sample, depth), so out[:, item] does not
// depend on which thread renders it: out and segments repeat bitwise; iters
// and phases belong to the schedule.
// The scene sits in shared memory as pt::load_scene lays it out.  The item
// index is 32-bit when the wrapper has checked that the span fits.
//
// Counters: counters[0] += path segments (live lanes summed over bounce
// phases), counters[1] = most bounce phases of one warp, counters[3] +=
// bounce phases summed over warps.  With lanes = threads launched, segments /
// (iters * lanes) is the share of thread trips that did work against the
// warp that ran longest, and segments / (32 * phases) the share of lane
// trips that did work: the SIMT efficiency of the bounce.

#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

constexpr int kThreads = 256;
// Resident blocks an SM asked of the compiler: 4 is 64 registers and 1,024
// threads an SM without a spill; 3 (68 registers) measured 5% slower on the
// 1024x768 disco render on an H100 and 5 (48 registers) spills.
constexpr int kMinBlocks = 4;

template <typename Index>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
persistent_render_kernel(const float* __restrict__ table, const float* __restrict__ cam,
                         float* __restrict__ out, unsigned long long* __restrict__ counters,
                         const pt::Params p) {
  extern __shared__ __align__(16) float smem[];
  const float* s_table = smem;
  const float* s_cam = pt::load_scene(smem, table, cam, p.n_spheres);
#ifdef PT_SIMT_PROBE
  pt::simt_zero();
  const long long pt_warp_t = clock64();
#endif
  PT_SEC_DECL();

  const unsigned long long n_items = static_cast<unsigned long long>(p.n_items);
  bool more = true;  // the queue may hold items (warp-uniform)

  bool alive = false;
  Index item = 0;
  unsigned int phases = 0;          // warp-uniform
  unsigned long long segments = 0;  // warp-uniform: live lanes summed over phases
  pt::Path s;
  while (true) {
    const unsigned int idle = __ballot_sync(0xffffffffu, !alive);
    unsigned int live = ~idle;
    if (more && __popc(idle) >= pt::kRefillMin) {
      const int leader = __ffs(idle) - 1;
      unsigned long long base = 0;
      if ((threadIdx.x & 31) == leader)
        base = atomicAdd(&counters[2], static_cast<unsigned long long>(__popc(idle)));
      base = __shfl_sync(0xffffffffu, base, leader);
      const unsigned long long taken = base + __popc(idle & pt::lanes_below());
      more = base + __popc(idle) < n_items;
      if (!alive && taken < n_items) {
        PT_SEC_BEGIN();
        item = static_cast<Index>(taken);
        pt::start_path<Index>(s, item, s_cam, p);
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
      pt::BounceAux unused;
      if (pt::bounce<false>(s, s_table, s_cam, p, rx, ry, rz, unused)) {
        PT_SEC_BEGIN();
        const size_t n = static_cast<size_t>(p.n_items);
        out[item] = rx;
        out[n + item] = ry;
        out[2 * n + item] = rz;
        alive = false;
        PT_SEC_END(pt::kSecRetire);
      }
    }
  }
#ifdef PT_SIMT_PROBE
  pt::simt_end(pt::kSecWarp, pt_warp_t);
  pt::simt_flush(counters);
#endif

  // Every thread of the warp reaches this point with the warp's counts.
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&counters[0], segments);
    atomicMax(&counters[1], static_cast<unsigned long long>(phases));
    atomicAdd(&counters[3], static_cast<unsigned long long>(phases));
  }
}

using RenderFn = void (*)(const float*, const float*, float*, unsigned long long*,
                          const pt::Params);

// The kernel for a span: 32-bit items when the wrapper says they fit.
RenderFn pick(int index_bits) {
  return index_bits == 32 ? persistent_render_kernel<uint32_t>
                          : persistent_render_kernel<long long>;
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream``.  ``out`` is [3, n_items] float32,
// ``counters`` 4 zeroed uint64 words on the device.  ``index_bits`` is 32
// when n_items, cell_start + n_cells, total_cells and the last sample index
// are below 2^31, else 64.  Writes the threads launched to *lanes and
// returns cudaGetLastError() after the launch.
int pt_persistent_render(const float* table, const float* cam, float* out,
                         unsigned long long* counters, const pt::Params* params, int index_bits,
                         long long* lanes, void* stream) {
  const pt::Params p = *params;
  if (index_bits != 32 && index_bits != 64) return static_cast<int>(cudaErrorInvalidValue);
  const RenderFn kernel = pick(index_bits);
  const size_t smem = static_cast<size_t>(pt::scene_floats(p.n_spheres)) * sizeof(float);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && smem > 48 * 1024)  // above 48 KB a kernel has to ask
    err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                               cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = static_cast<long long>(sms) * per_sm;
  const long long needed = (p.n_items + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;
  *lanes = blocks * kThreads;
  kernel<<<static_cast<unsigned int>(blocks), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      table, cam, out, counters, p);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
