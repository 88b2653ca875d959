// Designs of the device-memory stream y = scale * x for an H100, kept for
// measurement only: ``scripts/torch_chip_measure.py --part stream`` builds
// this file and times every design beside ``torch.mul`` (PERF.md,
// Findings).  The package's stream kernel (cpu_path_tracing_tpu_torch/csrc/
// probe.cu) is the fastest of them, "tile 512x1 cs".
//
//   stride    a persistent grid of 8 blocks an SM striding the whole array,
//             four float4 loads in flight a thread (the first design);
//   tile TxU  one contiguous tile of T threads x U float4 a block, as many
//             blocks as tiles; "cs" loads and stores with the streaming
//             hint, "nc" loads through ld.global.nc.L1::no_allocate;
//   walk      a persistent grid of B blocks an SM taking tiles round robin,
//             "run" a contiguous run of tiles per block;
//   tma SxK   a persistent grid feeding a ring of S shared-memory stages of
//             K KB with TMA one-dimensional bulk copies
//             (cp.async.bulk, one mbarrier a stage), every thread scaling
//             the tile in shared memory, bulk stores back.
// n is a multiple of every tile here (the measurement runs 2^26).
#include <cuda_runtime.h>
#include <cstdint>

namespace {

template <int kHint>
__device__ __forceinline__ float4 ld4(const float4* p) {
  if constexpr (kHint == 0) {
    return *p;
  } else if constexpr (kHint == 1) {
    return __ldcs(p);
  } else {
    float4 v;
    asm volatile("ld.global.nc.L1::no_allocate.v4.f32 {%0,%1,%2,%3}, [%4];"
                 : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p));
    return v;
  }
}

template <int kHint>
__device__ __forceinline__ void st4(float4* p, float4 v) {
  if constexpr (kHint == 0) *p = v; else __stcs(p, v);
}

__device__ __forceinline__ float4 scale4(float4 v, float s) {
  v.x *= s; v.y *= s; v.z *= s; v.w *= s;
  return v;
}

// A persistent grid striding the whole array, four loads in flight a thread.
__global__ void __launch_bounds__(256)
stride_kernel(const float* __restrict__ x, float* __restrict__ y, const long long n, const float scale) {
  const long long n4 = n / 4;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  long long i = tid;
  for (; i + 3 * stride < n4; i += 4 * stride) {
    float4 v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = x4[i + u * stride];
#pragma unroll
    for (int u = 0; u < 4; ++u) y4[i + u * stride] = scale4(v[u], scale);
  }
  for (; i < n4; i += stride) y4[i] = scale4(x4[i], scale);
}

// One contiguous tile per trip; tiles handed out round robin (kChunk = 0) or
// as one contiguous run per block (kChunk = 1).  With gridDim.x == tiles it is
// the one-tile-a-block grid.
template <int kThreads, int kUnroll, int kHint, int kChunk>
__global__ void __launch_bounds__(kThreads)
tile_kernel(const float* __restrict__ x, float* __restrict__ y, const long long n, const float scale) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kUnroll;
  const long long n4 = n / 4;
  const long long tiles = (n4 + kTile - 1) / kTile;
  const float4* x4 = reinterpret_cast<const float4*>(x);
  float4* y4 = reinterpret_cast<float4*>(y);
  long long t, t_end, t_step;
  if constexpr (kChunk) {
    const long long per = (tiles + gridDim.x - 1) / gridDim.x;
    t = blockIdx.x * per;
    t_end = t + per < tiles ? t + per : tiles;
    t_step = 1;
  } else {
    t = blockIdx.x;
    t_end = tiles;
    t_step = gridDim.x;
  }
  for (; t < t_end; t += t_step) {
    const long long base = t * kTile + threadIdx.x;
    if (base - threadIdx.x + kTile <= n4) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = ld4<kHint>(x4 + base + u * kThreads);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) st4<kHint>(y4 + base + u * kThreads, scale4(v[u], scale));
    } else {
      for (long long i = base; i < n4; i += kThreads) st4<kHint>(y4 + i, scale4(ld4<kHint>(x4 + i), scale));
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}"
        : "=r"(ok) : "r"(bar), "r"(parity) : "memory");
  } while (!ok);
}

// TMA one-dimensional bulk copies through a ring of shared-memory stages.
template <int kStages, int kTileBytes, int kThreads>
__global__ void __launch_bounds__(kThreads)
tma_kernel(const float* __restrict__ x, float* __restrict__ y, const long long n_tiles, const float scale) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) unsigned long long full[kStages];
  constexpr int kTileF4 = kTileBytes / 16;
  constexpr long long kTileFloats = kTileBytes / 4;
  const long long first = blockIdx.x, stride = gridDim.x;
  const long long mine = first < n_tiles ? (n_tiles - first + stride - 1) / stride : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(smem_u32(&full[s])) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  auto load = [&](long long i) {
    const int s = static_cast<int>(i % kStages);
    const uint32_t bar = smem_u32(&full[s]);
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(bar), "r"(kTileBytes) : "memory");
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
                 :: "r"(smem_u32(ring + s * kTileBytes)), "l"(x + (first + i * stride) * kTileFloats),
                    "r"(kTileBytes), "r"(bar) : "memory");
  };
  if (threadIdx.x == 0)
    for (long long i = 0; i < mine && i < kStages; ++i) load(i);
  for (long long i = 0; i < mine; ++i) {
    const int s = static_cast<int>(i % kStages);
    mbar_wait(smem_u32(&full[s]), static_cast<uint32_t>((i / kStages) & 1));
    float4* b = reinterpret_cast<float4*>(ring + s * kTileBytes);
#pragma unroll
    for (int k = threadIdx.x; k < kTileF4; k += kThreads) b[k] = scale4(b[k], scale);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                   :: "l"(y + (first + i * stride) * kTileFloats), "r"(smem_u32(b)), "r"(kTileBytes)
                   : "memory");
      asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      if (i >= 1 && i - 1 + kStages < mine) {
        asm volatile("cp.async.bulk.wait_group.read 1;" ::: "memory");
        load(i - 1 + kStages);
      }
    }
  }
  if (threadIdx.x == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms;
}

template <int kThreads, int kUnroll, int kHint, int kChunk>
int run_tile(const float* x, float* y, long long n, float scale, cudaStream_t st, int blocks_per_sm) {
  constexpr long long kTile = static_cast<long long>(kThreads) * kUnroll;
  const long long tiles = (n / 4 + kTile - 1) / kTile;
  long long grid = blocks_per_sm > 0 ? static_cast<long long>(sm_count()) * blocks_per_sm : tiles;
  if (grid > tiles) grid = tiles;
  tile_kernel<kThreads, kUnroll, kHint, kChunk><<<static_cast<unsigned>(grid), kThreads, 0, st>>>(x, y, n, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int kStages, int kTileBytes, int kThreads>
int run_tma(const float* x, float* y, long long n, float scale, cudaStream_t st, int blocks_per_sm) {
  const long long n_tiles = n / (kTileBytes / 4);
  static bool set = false;
  const int smem = kStages * kTileBytes;
  if (!set) {
    cudaError_t e = cudaFuncSetAttribute(tma_kernel<kStages, kTileBytes, kThreads>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    set = true;
  }
  long long grid = static_cast<long long>(sm_count()) * blocks_per_sm;
  if (grid > n_tiles) grid = n_tiles;
  tma_kernel<kStages, kTileBytes, kThreads><<<static_cast<unsigned>(grid), kThreads, smem, st>>>(x, y, n_tiles, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* design_name(int v) {
  static const char* names[] = {
      "stride 8/SM", "tile 256x4 plain", "tile 256x4 cs", "tile 256x2 plain", "tile 256x2 cs",
      "tile 256x2 nc", "tile 256x1 plain", "tile 256x1 cs", "tile 128x1 cs", "tile 512x1 cs",
      "tile 512x1 plain", "tile 1024x1 cs", "tile 1024x1 plain", "tile 512x2 cs", "tile 128x4 cs",
      "walk 256x4 cs 8/SM", "walk 256x4 plain 8/SM", "run 256x4 cs 8/SM", "walk 512x1 cs 4/SM",
      "tma 4x16K 128thr 3/SM", "tma 4x16K 256thr 3/SM", "tma 3x32K 256thr 2/SM",
      "tma 8x8K 256thr 3/SM", "tma 6x32K 512thr 1/SM"};
  return v >= 0 && v < static_cast<int>(sizeof(names) / sizeof(names[0])) ? names[v] : nullptr;
}

// Launches design ``v`` on ``stream``; returns cudaGetLastError().
int design_run(int v, const float* x, float* y, long long n, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (v) {
    case 0: {
      const long long blocks = static_cast<long long>(sm_count()) * 8;
      stride_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(x, y, n, scale);
      return static_cast<int>(cudaGetLastError());
    }
    case 1: return run_tile<256, 4, 0, 0>(x, y, n, scale, st, 0);
    case 2: return run_tile<256, 4, 1, 0>(x, y, n, scale, st, 0);
    case 3: return run_tile<256, 2, 0, 0>(x, y, n, scale, st, 0);
    case 4: return run_tile<256, 2, 1, 0>(x, y, n, scale, st, 0);
    case 5: return run_tile<256, 2, 2, 0>(x, y, n, scale, st, 0);
    case 6: return run_tile<256, 1, 0, 0>(x, y, n, scale, st, 0);
    case 7: return run_tile<256, 1, 1, 0>(x, y, n, scale, st, 0);
    case 8: return run_tile<128, 1, 1, 0>(x, y, n, scale, st, 0);
    case 9: return run_tile<512, 1, 1, 0>(x, y, n, scale, st, 0);
    case 10: return run_tile<512, 1, 0, 0>(x, y, n, scale, st, 0);
    case 11: return run_tile<1024, 1, 1, 0>(x, y, n, scale, st, 0);
    case 12: return run_tile<1024, 1, 0, 0>(x, y, n, scale, st, 0);
    case 13: return run_tile<512, 2, 1, 0>(x, y, n, scale, st, 0);
    case 14: return run_tile<128, 4, 1, 0>(x, y, n, scale, st, 0);
    case 15: return run_tile<256, 4, 1, 0>(x, y, n, scale, st, 8);
    case 16: return run_tile<256, 4, 0, 0>(x, y, n, scale, st, 8);
    case 17: return run_tile<256, 4, 1, 1>(x, y, n, scale, st, 8);
    case 18: return run_tile<512, 1, 1, 0>(x, y, n, scale, st, 4);
    case 19: return run_tma<4, 16384, 128>(x, y, n, scale, st, 3);
    case 20: return run_tma<4, 16384, 256>(x, y, n, scale, st, 3);
    case 21: return run_tma<3, 32768, 256>(x, y, n, scale, st, 2);
    case 22: return run_tma<8, 8192, 256>(x, y, n, scale, st, 3);
    case 23: return run_tma<6, 32768, 512>(x, y, n, scale, st, 1);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
