// A few wavefront iterations per launch: the Hopper counterpart of
// megakernel_step (body make_kernel) in
// cpu_path_tracing_tpu/ops/pallas/megakernel.py.
//
// What bounds it on an H100.  The bounce arithmetic is the whole-render
// kernel's (csrc/megakernel.cu); what this kernel adds is the lane state
// that lives in device memory between launches, 15 words read and written
// per live lane per launch, and the launches themselves.  With one step a
// launch that was 40 GB and 1,056 launches for the 310 M segments of the
// 1024x768 disco render, read, bounced and stored with nothing kept on chip.
//
// Design.  One thread per lane of a pool of B lanes (256-thread blocks,
// ceil(B/256) blocks).  The lane's path lives in device memory between
// launches, structure of arrays: row r of state_f / state_i is field r of
// every lane (LaneState in ops/kernels/megakernel.py), so a warp reads and
// writes each field as one coalesced 128-byte line.  A launch runs ``steps``
// steps (1..32) with the path in registers between them, so the state
// crosses device memory once per launch, not once per step:
//   1. the thread reads the lane's gen and alive words and, if alive, its
//      path;
//   2. in each step an idle lane with gen+1 < n_gens advances gen and, when
//      its item gen*B + lane is below n_items, starts that item's camera
//      path (pt::start_path); a pad item only advances gen.  A live lane
//      runs one pt::bounce<false>; a path that ends writes its radiance to
//      out[c * n_items + item] and the lane goes idle until the next step;
//   3. after the last step the thread stores gen and alive where they
//      changed and, if alive, its path.  The path rows of an idle lane are
//      never read, so they are left as they are;
//   4. step j's lanes alive after regeneration are counted with one ballot
//      per warp and added to seg[j] (int64) with one atomic per warp.
// An idle lane with nothing left to start reads two words and writes none,
// so a launch on a drained pool is a cheap no-op that adds 0.  Nothing in a
// launch depends on which launch it is (the counts go where ``seg`` points),
// so a batch of launches can be captured once in a CUDA graph and replayed.
//
// start_path and bounce<false> are the whole-render kernel's
// (csrc/megakernel.cu, with 64-bit items) and the
// build passes -fmad=false, so a
// path rounds alike in both kernels and the per-step render equals the
// whole-render one bitwise: the JAX package's "persistent == per-step
// EXACT" invariant.  The TPU kernel's K-slot result ring and watermark
// existed because TPU scatter is slow; here a finished path writes its
// three floats directly and no lane ever waits for another.

#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 32;  // one bit of a thread's live mask per step
// Rows of state_i; state_f's rows are ox oy oz dx dy dz thx thy thz emx emy emz.
enum IntRow { kDepth = 0, kK0, kK1, kGen, kAlive };

__global__ void __launch_bounds__(kThreads)
megakernel_step_kernel(const float* __restrict__ table, const float* __restrict__ cam,
                       float* __restrict__ state_f, int* __restrict__ state_i,
                       float* __restrict__ out, unsigned long long* __restrict__ seg,
                       const pt::Params p, const long long lanes, const long long n_gens,
                       const int steps) {
  extern __shared__ __align__(16) float smem[];
  const float* s_table = smem;
  const float* s_cam = pt::load_scene(smem, table, cam, p.n_spheres);

  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  unsigned int live_mask = 0;  // bit j: alive after regeneration in step j
  if (lane < lanes) {
    int* gen_p = state_i + kGen * lanes + lane;
    int* alive_p = state_i + kAlive * lanes + lane;
    const int gen_in = *gen_p;
    const bool alive_in = *alive_p != 0;
    long long gen = gen_in;
    bool alive = alive_in;
    pt::Path s;
    if (alive) {
      const float* f = state_f + lane;
      s.ox = f[0 * lanes];
      s.oy = f[1 * lanes];
      s.oz = f[2 * lanes];
      s.dx = f[3 * lanes];
      s.dy = f[4 * lanes];
      s.dz = f[5 * lanes];
      s.thx = f[6 * lanes];
      s.thy = f[7 * lanes];
      s.thz = f[8 * lanes];
      s.emx = f[9 * lanes];
      s.emy = f[10 * lanes];
      s.emz = f[11 * lanes];
      s.depth = state_i[kDepth * lanes + lane];
      s.k0 = static_cast<uint32_t>(state_i[kK0 * lanes + lane]);
      s.k1 = static_cast<uint32_t>(state_i[kK1 * lanes + lane]);
    }
    for (int j = 0; j < steps; ++j) {
      if (!alive) {
        if (gen + 1 >= n_gens) break;  // nothing left to start: idle in every later step
        ++gen;
        const long long item = gen * lanes + lane;
        if (item < p.n_items) {
          pt::start_path<long long>(s, item, s_cam, p);
          alive = true;
        }
      }
      if (alive) {
        live_mask |= 1u << j;
        float rx, ry, rz;
        pt::BounceAux unused;
        if (pt::bounce<false>(s, s_table, s_cam, p, rx, ry, rz, unused)) {
          const long long item = gen * lanes + lane;
          out[item] = rx;
          out[p.n_items + item] = ry;
          out[2 * p.n_items + item] = rz;
          alive = false;
        }
      }
    }
    if (gen != gen_in) *gen_p = static_cast<int>(gen);
    if (alive != alive_in) *alive_p = alive ? 1 : 0;
    if (alive) {
      float* f = state_f + lane;
      f[0 * lanes] = s.ox;
      f[1 * lanes] = s.oy;
      f[2 * lanes] = s.oz;
      f[3 * lanes] = s.dx;
      f[4 * lanes] = s.dy;
      f[5 * lanes] = s.dz;
      f[6 * lanes] = s.thx;
      f[7 * lanes] = s.thy;
      f[8 * lanes] = s.thz;
      f[9 * lanes] = s.emx;
      f[10 * lanes] = s.emy;
      f[11 * lanes] = s.emz;
      state_i[kDepth * lanes + lane] = s.depth;
      state_i[kK0 * lanes + lane] = static_cast<int>(s.k0);
      state_i[kK1 * lanes + lane] = static_cast<int>(s.k1);
    }
  }

  // Every thread of the warp reaches this point: one ballot per step, one
  // atomic per warp and step that had a live lane.
  for (int j = 0; j < steps; ++j) {
    const unsigned int votes = __ballot_sync(0xffffffffu, (live_mask >> j) & 1u);
    if ((threadIdx.x & 31) == 0 && votes)
      atomicAdd(&seg[j], static_cast<unsigned long long>(__popc(votes)));
  }
}

}  // namespace

extern "C" {

// Launches ``steps`` steps (1..32) on ``stream``.  ``state_f`` is
// [12, lanes] float32 and ``state_i`` [5, lanes] int32 (LaneState rows),
// ``out`` [3, n_items] float32, ``seg`` ``steps`` int64 words on the device:
// seg[j] gains step j's live lanes.  Reads ``*params`` now, on the host.
// Returns cudaGetLastError() after the launch.
int pt_megakernel_step(const float* table, const float* cam, float* state_f, int* state_i,
                       float* out, unsigned long long* seg, const pt::Params* params,
                       long long lanes, int steps, void* stream) {
  const pt::Params p = *params;
  if (lanes < 1 || p.n_items < 1 || steps < 1 || steps > kMaxSteps)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_gens = (p.n_items + lanes - 1) / lanes;
  const long long blocks = (lanes + kThreads - 1) / kThreads;
  const size_t smem = static_cast<size_t>(pt::scene_floats(p.n_spheres)) * sizeof(float);
  if (smem > 48 * 1024) {  // above 48 KB a kernel has to ask
    const cudaError_t err = cudaFuncSetAttribute(
        reinterpret_cast<const void*>(megakernel_step_kernel),
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  megakernel_step_kernel<<<static_cast<unsigned int>(blocks), kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(table, cam, state_f, state_i, out,
                                                                seg, p, lanes, n_gens, steps);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
