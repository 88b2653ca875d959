// Machine-constant probes: the Hopper counterparts of the two Pallas kernels
// of scripts/perf_probe.py, _bench_kernel (op-rate microbenchmarks) and
// pallas_stream (a device-memory stream).
//
// probe_op_chain_kernel<OP, NA> computes out = sum_a body^iters(x_a): NA
// independent values per element, ``iters`` applications of one op chain
// to each, summed so that nothing is dead.  One thread owns one element
// and keeps its NA values in registers (the TPU kernel's register-resident
// blocks), which gives every thread NA independent dependency chains; the
// (64,128) block layout of the TPU kernel is not carried over.  ``iters``
// and the chain's constants are kernel arguments, so the compiler can
// neither fold nor hoist the loop.  The bodies are those of
// scripts/perf_probe.py:87-122, in the forms the render kernels use
// (csrc/step_math.cuh: precise sinf and sqrtf, 1/sqrtf, never rsqrtf), and
// the build passes -fmad=false, so ``x * a + b`` is a multiply and an add,
// two issues, as in the render kernels; kFma asks for the fused
// instruction explicitly.  Bound: the ALU issue rate (operations), by
// design: per launch the kernel moves (NA + 1) * 4 bytes per element.
//
// probe_stream_kernel computes y = scale * x.  Bound: device-memory bytes,
// 4 read and 4 written per element, and on this card the way the addresses
// reach the memory system decides how near the peak a pass comes.  One
// float4 a thread (16 bytes, neighbouring threads on neighbouring
// addresses), one contiguous 8 KB tile of 512 threads a block and as many
// blocks as tiles, the shape PyTorch's elementwise kernels have: the block
// scheduler then walks the array front to back, and the reads and writes in
// flight at any time lie in one region.  The loads and stores carry the
// streaming hint (ld.global.cs / st.global.cs): every byte is used once.
// The last block masks the ragged end and moves the n % 4 scalars.  The TPU
// kernel's blocks of 2^19 elements staged through on-chip memory have no
// counterpart: measured on an H100 (PERF.md, Findings; the designs are in
// scripts/torch_stream_designs.cu), a persistent grid, whether it strides
// the array, walks neighbouring tiles or feeds a ring of shared-memory
// stages with TMA bulk copies, is 5-9% slower than this, more float4 a
// thread 1-2%, and the same tile without the hint 3%.

#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

#include "step_math.cuh"

namespace {

constexpr int kThreads = 256;

// The op codes of OPS in ops/kernels/probe.py.
enum Op { kMulAdd = 0, kFma, kAdd, kSin, kSqrt, kRsqrt, kSelect, kU32Round, kThreefry };

// Constants of a chain (perf_probe.py's literals), passed at launch.
struct ChainConsts {
  float a, b, c;
  uint32_t k;
};

template <int OP>
using Elem = std::conditional_t<(OP >= kU32Round), uint32_t, float>;

// Outer-loop unroll: 8 for the one- to three-instruction bodies, whose loop
// overhead (an add, a compare, a branch) would otherwise be up to a quarter
// of the issues; 1 for the rest.
template <int OP>
constexpr int kUnroll = (OP == kMulAdd || OP == kFma || OP == kAdd || OP == kU32Round) ? 8 : 1;

template <int OP>
__device__ __forceinline__ Elem<OP> apply(Elem<OP> x, uint32_t i, const ChainConsts& k) {
  if constexpr (OP == kMulAdd) {
    return x * k.a + k.b;
  } else if constexpr (OP == kFma) {
    return __fmaf_rn(x, k.a, k.b);
  } else if constexpr (OP == kAdd) {
    return x + k.b;
  } else if constexpr (OP == kSin) {
    return sinf(x);
  } else if constexpr (OP == kSqrt) {
    return sqrtf(x + k.b);
  } else if constexpr (OP == kRsqrt) {
    return 1.0f / sqrtf(x + k.b);
  } else if constexpr (OP == kSelect) {
    return x > k.c ? x * k.a : x + k.b;
  } else if constexpr (OP == kU32Round) {
    // One Threefry round's mix: add, rotate left by 13, xor.
    const uint32_t y = x + k.k;
    return ((y << 13) | (y >> 19)) ^ x;
  } else {
    // The production cipher, one 13-round block per application.
    uint32_t y0, y1;
    pt::threefry2x32(x, x ^ k.k, x, x + i, y0, y1);
    return y0 ^ y1;
  }
}

template <int OP, int NA>
__global__ void __launch_bounds__(kThreads)
probe_op_chain_kernel(const Elem<OP>* __restrict__ xs, Elem<OP>* __restrict__ out,
                      const long long n, const int iters, const ChainConsts k) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Elem<OP> x[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) x[a] = xs[a * n + i];
#pragma unroll(kUnroll<OP>)
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int a = 0; a < NA; ++a) x[a] = apply<OP>(x[a], static_cast<uint32_t>(it), k);
  }
  Elem<OP> acc = x[0];
#pragma unroll
  for (int a = 1; a < NA; ++a) acc = acc + x[a];
  out[i] = acc;
}

constexpr int kStreamThreads = 512;  // float4 in a block's tile

__global__ void __launch_bounds__(kStreamThreads)
probe_stream_kernel(const float* __restrict__ x, float* __restrict__ y, const long long n,
                    const float scale) {
  const long long n4 = n / 4;
  const long long i = static_cast<long long>(blockIdx.x) * kStreamThreads + threadIdx.x;
  if (i < n4) {
    float4 v = __ldcs(reinterpret_cast<const float4*>(x) + i);
    v.x *= scale;
    v.y *= scale;
    v.z *= scale;
    v.w *= scale;
    __stcs(reinterpret_cast<float4*>(y) + i, v);
  }
  if (blockIdx.x == gridDim.x - 1) {
    const long long j = 4 * n4 + threadIdx.x;
    if (j < n) y[j] = x[j] * scale;
  }
}

template <int OP, int NA>
cudaError_t launch_chain(const void* xs, void* out, long long n, int iters, const ChainConsts& k,
                         cudaStream_t stream) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  probe_op_chain_kernel<OP, NA><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      static_cast<const Elem<OP>*>(xs), static_cast<Elem<OP>*>(out), n, iters, k);
  return cudaGetLastError();
}

template <int OP>
cudaError_t launch_arrays(int n_arrays, const void* xs, void* out, long long n, int iters,
                          const ChainConsts& k, cudaStream_t stream) {
  switch (n_arrays) {  // N_ARRAYS in ops/kernels/probe.py
    case 2: return launch_chain<OP, 2>(xs, out, n, iters, k, stream);
    case 8: return launch_chain<OP, 8>(xs, out, n, iters, k, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches one op chain on ``stream``.  ``xs`` is [n_arrays, n] and ``out``
// [n], float32 for ops 0..6 and 32-bit words for ops 7 and 8.  Returns
// cudaGetLastError() after the launch.
int pt_probe_op_chain(int op, int n_arrays, const void* xs, void* out, long long n, int iters,
                      float a, float b, float c, unsigned int k, void* stream) {
  if (n < 1 || n > 0x7fffffffLL * kThreads || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const ChainConsts consts{a, b, c, k};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (op) {
    case kMulAdd: err = launch_arrays<kMulAdd>(n_arrays, xs, out, n, iters, consts, s); break;
    case kFma: err = launch_arrays<kFma>(n_arrays, xs, out, n, iters, consts, s); break;
    case kAdd: err = launch_arrays<kAdd>(n_arrays, xs, out, n, iters, consts, s); break;
    case kSin: err = launch_arrays<kSin>(n_arrays, xs, out, n, iters, consts, s); break;
    case kSqrt: err = launch_arrays<kSqrt>(n_arrays, xs, out, n, iters, consts, s); break;
    case kRsqrt: err = launch_arrays<kRsqrt>(n_arrays, xs, out, n, iters, consts, s); break;
    case kSelect: err = launch_arrays<kSelect>(n_arrays, xs, out, n, iters, consts, s); break;
    case kU32Round: err = launch_arrays<kU32Round>(n_arrays, xs, out, n, iters, consts, s); break;
    case kThreefry: err = launch_arrays<kThreefry>(n_arrays, xs, out, n, iters, consts, s); break;
    default: break;
  }
  return static_cast<int>(err);
}

// Launches y = scale * x over n float32 on ``stream``; x and y are 16-byte
// aligned.  One block per tile of kStreamThreads float4, the last one ragged.
// Returns cudaGetLastError() after the launch.
int pt_probe_stream(const float* x, float* y, long long n, float scale, void* stream) {
  const long long blocks = n < 4 ? 1 : (n / 4 + kStreamThreads - 1) / kStreamThreads;
  if (n < 1 || blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  probe_stream_kernel<<<static_cast<unsigned int>(blocks), kStreamThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(x, y, n, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
