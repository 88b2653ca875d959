// Forward render in one launch: the Hopper counterpart of persistent_render
// in cpu_path_tracing_tpu/ops/pallas/megakernel.py.
//
// Design.  A persistent grid (as many 256-thread blocks as fit on the
// card at once, fewer when there are fewer items) walks the item range
// [0, n_items) with a fixed stride: thread t owns items t, t+lanes,
// t+2*lanes, ...  Each thread keeps one live path in registers; when the
// path ends it writes out[:, item] and starts its next item in the same
// loop trip, so a warp's threads stay in the bounce code together while
// their path lengths differ (the role of the TPU kernel's regenerating
// lane pool).  The ring, watermark and DMA of the TPU kernel existed
// because TPU scatter is slow; here each finished path writes its three
// floats directly.  The sphere table (N x 17 floats) and the camera (20)
// sit in shared memory and are read as broadcasts.
//
// Bound: FP32 and integer ALU work and divergence, not bytes.  A path
// segment costs an N-sphere quadratic, two 13-round Threefry blocks and
// the shading; the only device-memory traffic is 12 bytes per item.
//
// Counters: counters[0] += path segments (sum over threads of loop trips,
// one bounce each), counters[1] = max trips of one thread.  With lanes =
// threads launched, segments / (iters * lanes) is the share of thread
// trips that did work: the load balance across threads.

#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
persistent_render_kernel(const float* __restrict__ table, const float* __restrict__ cam,
                         float* __restrict__ out, unsigned long long* __restrict__ counters,
                         const pt::Params p) {
  extern __shared__ float smem[];
  float* s_table = smem;
  float* s_cam = smem + p.n_spheres * pt::kTableCols;
  for (int i = threadIdx.x; i < p.n_spheres * pt::kTableCols; i += blockDim.x) s_table[i] = table[i];
  for (int i = threadIdx.x; i < pt::kCamLen; i += blockDim.x) s_cam[i] = cam[i];
  __syncthreads();

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
    }
    ++trips;
    float rx, ry, rz;
    pt::BounceAux unused;
    if (pt::bounce<false>(s, s_table, s_cam, p, rx, ry, rz, unused)) {
      out[item] = rx;
      out[p.n_items + item] = ry;
      out[2 * p.n_items + item] = rz;
      item = -1;
    }
  }

  // Every thread of the warp reaches this point: warp-reduce, one atomic each.
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
}

}  // namespace

extern "C" {

// Launches the kernel on ``stream``.  ``out`` is [3, n_items] float32,
// ``counters`` 2 zeroed uint64 words on the device.  Writes the threads
// launched to *lanes and returns cudaGetLastError() after the launch.
int pt_persistent_render(const float* table, const float* cam, float* out,
                         unsigned long long* counters, const pt::Params* params,
                         long long* lanes, void* stream) {
  const pt::Params p = *params;
  const size_t smem = static_cast<size_t>(p.n_spheres * pt::kTableCols + pt::kCamLen) * sizeof(float);
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, persistent_render_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  long long blocks = static_cast<long long>(sms) * per_sm;
  const long long needed = (p.n_items + kThreads - 1) / kThreads;
  if (blocks > needed) blocks = needed;
  if (blocks < 1) blocks = 1;
  *lanes = blocks * kThreads;
  persistent_render_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(table, cam, out, counters, p);
  return static_cast<int>(cudaGetLastError());
}

const char* pt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
