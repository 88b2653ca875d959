// Per-path step math of the forward render: the CUDA counterpart of
// make_step_math in cpu_path_tracing_tpu/ops/pallas/megakernel.py.
//
// One thread owns one path.  start_path() is the regeneration block (item
// key, lens-disk draws, thin-lens camera ray); bounce() is one bounce: the
// Threefry uniforms, the N-sphere anchor-point intersect, sky on a miss,
// emission pickup, Russian roulette, the three material samplers and the
// depth limit.  Every value a path keeps is computed by the expressions of
// the plain PyTorch version (ops/intersect.py, ops/materials.py,
// ops/integrator.py), term for term, so that both round alike:
//   * 1/sqrtf(x), never rsqrtf: rsqrtf is not correctly rounded;
//   * precise sqrtf, division, sinf and cosf (the build never passes
//     --use_fast_math, and passes -fmad=false); min/max propagate NaN, as
//     torch.minimum does.
// What differs from the plain version is only which values are computed,
// never how.  Only the chosen material's sampler runs (the plain version
// blends all three with exact 0/1 masks, which gives the same direction);
// the second block of bounce uniforms is drawn by the diffuse sampler, its
// only reader, and 1/|d| by the sky and the dielectric; and a sphere without
// a root takes the miss sentinel directly (hit_sphere says why that is the
// plain chain's value).  The kernels are held bitwise to the plain version
// on every item of every scene (chip_smoke.py).
//
// The kernels keep the scene in shared memory in rows of 20 floats
// (load_scene): the eight values the intersect reads first, as two 16-byte
// loads a sphere (2*radius is stored beside the radius: the product is
// exact, so (2*radius)*x rounds as 2*radius*x did), then the ten the hit
// record reads.  start_path is templated on the index type: uint32_t when
// the host has checked that the span fits (no 64-bit division, which the
// card does in software), long long otherwise.
// Floats see the same values either way.
//
// bounce<true> also fills a BounceAux with the internals the replay
// backward consumes (csrc/replay.cu; make_step_math(with_aux=True) in the
// JAX package) and the count of an exact tie of roots that the geometry
// replay reads (csrc/geometry_replay.cu); bounce<false>, the forward
// kernel's, compiles without them.

#pragma once

#include <cstdint>

namespace pt {

// ---- the SIMT probe (measurement builds only: -DPT_SIMT_PROBE) ----------
// The machine has no profiler that reads warp efficiency, so the kernel
// measures itself.  The code between PT_SEC_BEGIN() and PT_SEC_END(k) is
// section k.  Each group of lanes that leaves a section together (one
// __activemask()) adds, through its lowest lane, 1 to the section's
// executions, its lane count to the section's active lanes and the SM clock
// it spent there to the section's cycles, in shared memory; the kernel adds
// the block's sums to counters[kSimtBase + 3k ...] at its end.  Without the
// flag the macros are empty and the kernels are what they were.
enum Section {
  kSecRegen = 0,   // start_path and what a kernel does beside it at a refill
  kSecIntersect,   // the bounce uniforms and the N-sphere intersect
  kSecMiss,        // sky and the miss exit
  kSecShade,       // hit record, emission pickup, the roulette test
  kSecRoulette,    // the roulette exit
  kSecDiffuse,     // the cosine-weighted sampler
  kSecSpecular,    // the mirror direction (also the dielectric's start)
  kSecDielectric,  // the Schlick lottery and the refraction
  kSecUpdate,      // move, damp, count; the depth-limit exit
  kSecRetire,      // a finished path's result written out
  kSecAccumulate,  // the replay kernels' partials
  kSecRecord,      // the geometry replay's record of a bounce
  kSecSweep,       // the geometry replay's sweep back through a path's bounces
  kSecCamera,      // the geometry replay's seed and primary-ray VJP
  kSecWarp,        // a warp's whole stay in the kernel (executions = warps)
  kSections
};
constexpr int kSimtBase = 4;  // first word of the probe's sums in ``counters``

#ifdef PT_SIMT_PROBE
__shared__ unsigned long long simt_sums[3 * kSections];

__device__ __forceinline__ void simt_zero() {
  for (int i = threadIdx.x; i < 3 * kSections; i += blockDim.x) simt_sums[i] = 0ull;
  __syncthreads();
}

__device__ __forceinline__ void simt_end(int k, long long t_in) {
  const long long now = clock64();
  const unsigned int mask = __activemask();
  if ((threadIdx.x & 31) == __ffs(mask) - 1) {
    atomicAdd(&simt_sums[3 * k], 1ull);
    atomicAdd(&simt_sums[3 * k + 1], static_cast<unsigned long long>(__popc(mask)));
    atomicAdd(&simt_sums[3 * k + 2], static_cast<unsigned long long>(now - t_in));
  }
}

// Every thread of the block calls this after its loop.
__device__ __forceinline__ void simt_flush(unsigned long long* counters) {
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * kSections; i += blockDim.x)
    atomicAdd(&counters[kSimtBase + i], simt_sums[i]);
}

#define PT_SEC_DECL() long long pt_sec_t = 0
#define PT_SEC_BEGIN() pt_sec_t = clock64()
#define PT_SEC_END(k) pt::simt_end(k, pt_sec_t)
#else
#define PT_SEC_DECL()
#define PT_SEC_BEGIN()
#define PT_SEC_END(k)
#endif

// Host-to-kernel parameters.  Mirrored field for field by the ctypes
// structure _Params in ops/kernels/megakernel.py.
struct Params {
  long long n_items;       // items in this launch: item = sample*n_cells + c
  long long n_cells;       // cells in the launch's contiguous span
  long long total_cells;   // cells in the image (clamp for padded spans)
  long long cell_start;    // first cell id of the span
  long long sample_start;  // first sample index
  int n_spheres;
  int width, height, ns;   // image size and subpixels per axis
  int max_depth, rr_depth;
  unsigned int key0, key1; // master key (ops/rng.py master_key)
  float sub_len, inv_w, inv_h;  // 1/ns, 1/width, 1/height (float32)
  float eps, inf;               // intersection epsilon, miss sentinel
  float ratio_front, ratio_back;  // float32(1/ior), float32(ior)
};

constexpr int kTableCols = 17;  // pack_scene: p0(3) anchor(3) r center(3) em(3) al(3) mat
constexpr int kCamLen = 20;     // pack_camera
// A sphere's row in shared memory: p0(3) anchor(3) r 2r | center(3) em(3)
// al(3) mat, two floats of padding (16-byte aligned rows).
constexpr int kRowFloats = 20;
constexpr int kColCenter = 8, kColEmission = 11, kColAlbedo = 14, kColMaterial = 17;
constexpr float kTwoPi = 6.283185307179586f;

struct Path {
  float ox, oy, oz, dx, dy, dz;
  float thx, thy, thz;  // throughput
  float emx, emy, emz;  // accumulated emission
  int depth;
  uint32_t k0, k1;      // item key
};

// What one bounce of a live path did, for the replay backward: the bounce
// internals of ops/integrator.bounce_step(with_aux=True).  For a live path
// hit is sidx >= 0 and die_miss its negation.
struct BounceAux {
  int sidx;                  // hit sphere index, -1 on a miss
  int ties;                  // spheres whose root equals the hit's t (hit only)
  float thr_x, thr_y, thr_z;  // throughput before this bounce's update
  float eh_x, eh_y, eh_z;     // the hit sphere's emission (hit only)
  float sky_x, sky_y, sky_z;  // background radiance (miss only)
  float sky_t;               // its lerp parameter (miss only)
  bool cont;                 // hit and not killed by the roulette
  bool rr_scaled;            // roulette applied and survived: colf = 1/p
};

// Floats of shared memory for a scene of n spheres: its rows and the camera.
__host__ __device__ constexpr int scene_floats(int n_spheres) {
  return n_spheres * kRowFloats + kCamLen;
}

// Every thread of the block: copy the [N,17] table into shared rows and the
// camera beside them, then synchronise.  ``s_scene`` is 16-byte aligned;
// returns the camera's place in it.
__device__ __forceinline__ float* load_scene(float* s_scene, const float* __restrict__ table,
                                             const float* __restrict__ cam, int n_spheres) {
  for (int i = threadIdx.x; i < n_spheres * kRowFloats; i += blockDim.x) {
    const int j = i / kRowFloats, c = i - j * kRowFloats;
    const float* row = table + j * kTableCols;
    float v = 0.0f;
    if (c < 7) v = row[c];
    else if (c == 7) v = 2.0f * row[6];
    else if (c <= kColMaterial) v = row[c - 1];
    s_scene[i] = v;
  }
  float* s_cam = s_scene + n_spheres * kRowFloats;
  for (int i = threadIdx.x; i < kCamLen; i += blockDim.x) s_cam[i] = cam[i];
  __syncthreads();
  return s_cam;
}

#define PT_ROUND(r)                        \
  x0 += x1;                                \
  x1 = (x1 << (r)) | (x1 >> (32 - (r)));   \
  x1 ^= x0;

// Threefry-2x32, 13 rounds, key injection after every 4th round and none
// after the 13th (ops/rng.py threefry2x32).
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t c0,
                                             uint32_t c1, uint32_t& y0, uint32_t& y1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  uint32_t x0 = c0 + k0, x1 = c1 + k1;
  PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  PT_ROUND(17) PT_ROUND(29) PT_ROUND(16) PT_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  PT_ROUND(13) PT_ROUND(15) PT_ROUND(26) PT_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  PT_ROUND(17)
  y0 = x0;
  y1 = x1;
}

#undef PT_ROUND

// Uniform in [0,1) from the top 24 bits (exact in float32).
__device__ __forceinline__ float u01(uint32_t bits) {
  return static_cast<float>(bits >> 8) * 5.9604644775390625e-08f;
}

__device__ __forceinline__ float rsqrt_safe(float x) { return 1.0f / sqrtf(x > 0.0f ? x : 1.0f); }

// NaN-propagating min/max (torch.minimum / torch.maximum semantics).
__device__ __forceinline__ float nan_min(float a, float b) { return (a < b || a != a) ? a : b; }
__device__ __forceinline__ float nan_max(float a, float b) { return (a > b || a != a) ? a : b; }

// Regeneration: the camera ray of work item ``item`` (render.py
// screen_coords + models/camera.py get_rays; uniform jitter).  ``Index`` is
// uint32_t (the host checked that every index below fits 31 bits) or long
// long.  Returns the item's cell within the span, item % n_cells.
template <typename Index>
__device__ __forceinline__ Index start_path(Path& s, Index item, const float* cam,
                                            const Params& p) {
  const Index n_cells = static_cast<Index>(p.n_cells);
  const Index smp_in_span = item / n_cells;
  const Index c_idx = item - smp_in_span * n_cells;
  const Index smp = static_cast<Index>(p.sample_start) + smp_in_span;
  const Index cell = min(static_cast<Index>(p.cell_start) + c_idx,
                         static_cast<Index>(p.total_cells - 1));
  uint32_t a0, a1, c0, c1;
  threefry2x32(p.key0, p.key1, static_cast<uint32_t>(cell), static_cast<uint32_t>(smp), a0, a1);
  threefry2x32(a0, a1, 0u, 0u, c0, c1);  // purpose 0: the lens-disk pair
  const float jx = u01(a0), jy = u01(a1), du1 = u01(c0), du2 = u01(c1);

  const Index ns = static_cast<Index>(p.ns), ns2 = ns * ns, width = static_cast<Index>(p.width);
  const Index pix = cell / ns2, sub = cell - pix * ns2;
  const Index py_i = pix / width, sy_i = sub / ns;
  const float px = static_cast<float>(pix - py_i * width);
  const float py = static_cast<float>(py_i);
  const float sxf = static_cast<float>(sub - sy_i * ns);
  const float syf = static_cast<float>(sy_i);
  const float scr_s = (px + sxf * p.sub_len + jx * p.sub_len) * p.inv_w;
  const float scr_t = (py + syf * p.sub_len + jy * p.sub_len) * p.inv_h;

  // Thin lens with the reference's rd*(s+t) offset (src/camera.cpp:32-38).
  const float rr = sqrtf(du1) * cam[12];
  const float th = kTwoPi * du2;
  const float rdx = rr * cosf(th);
  const float rdy = rr * sinf(th);
  const float st_sum = scr_s + scr_t;
  const float offx = rdx * st_sum, offy = rdy * st_sum;
  const float ndx = cam[3] + cam[6] * scr_s + cam[9] * scr_t - cam[0] - offx;
  const float ndy = cam[4] + cam[7] * scr_s + cam[10] * scr_t - cam[1] - offy;
  const float ndz = cam[5] + cam[8] * scr_s + cam[11] * scr_t - cam[2];  // the lens offset has no z
  const float adv = cam[19];  // near-clip advance (smallpt's cam.o + d*140)
  s.ox = cam[0] + offx + adv * ndx;
  s.oy = cam[1] + offy + adv * ndy;
  s.oz = cam[2] + adv * ndz;
  s.dx = ndx;
  s.dy = ndy;
  s.dz = ndz;
  s.thx = s.thy = s.thz = 1.0f;
  s.emx = s.emy = s.emz = 0.0f;
  s.depth = 0;
  s.k0 = a0;
  s.k1 = a1;
  return c_idx;
}

// The anchor-point quadratic of one sphere (its shared row) against the ray,
// and the closest-hit update: strict <, so the lowest index wins a tie.
// With kTies, ``ties`` counts the spheres whose root equals t_best (< inf),
// the hit sphere included: the geometry replay splits t's adjoint among them.
template <bool kTies>
__device__ __forceinline__ void hit_sphere(const float* row, int j, float ox, float oy, float oz,
                                           float dx, float dy, float dz, float a_quad,
                                           float a_inv, const Params& p, float& t_best,
                                           int& best, int& ties) {
  const float4 ra = *reinterpret_cast<const float4*>(row);      // p0, anchor.x
  const float4 rb = *reinterpret_cast<const float4*>(row + 4);  // anchor.yz, r, 2r
  const float qx = ox - ra.x, qy = oy - ra.y, qz = oz - ra.z;
  const float qd = qx * dx + qy * dy + qz * dz;
  const float add = ra.w * dx + rb.x * dy + rb.y * dz;
  const float b = qd + rb.z * add;
  const float qq = qx * qx + qy * qy + qz * qz;
  const float qad = qx * ra.w + qy * rb.x + qz * rb.y;
  const float c = qq + rb.w * qad;
  const float disc = b * b - a_quad * c;
  // No root (disc negative or NaN).  The plain chain has no guard: sqrtf of
  // a negative is NaN, every comparison with NaN is false, and the sphere
  // falls through to the miss sentinel.  That sentinel is chosen here, and
  // the square root and the division run on a harmless operand instead of
  // taking their slow paths for a NaN.
  const bool has_root = disc >= 0.0f;
  const float sq = sqrtf(has_root ? disc : 1.0f);
  const float qf = -(b + (b >= 0.0f ? sq : -sq));  // sgn(b) * sq without the multiply
  const float r1 = qf * a_inv;
  const float r2 = qf != 0.0f ? c / qf : p.inf;
  // The nearer root at or beyond eps, else the farther, else the sentinel:
  // the least of the two candidates that pass.  (The plain version's
  // NaN-propagating min and max differ from this only when exactly one of
  // r1, r2 is NaN and the other passes, which a root cannot produce: r2 is
  // c / qf and r1 is qf * a_inv, so a NaN on one side comes with an
  // infinity, a zero or a NaN on the other.)
  const float c1 = r1 >= p.eps ? r1 : p.inf, c2 = r2 >= p.eps ? r2 : p.inf;
  const float root = has_root ? fminf(c1, c2) : p.inf;
  if (root < t_best) {
    t_best = root;
    best = j;
    if constexpr (kTies) ties = 1;
  } else if constexpr (kTies) {
    if (root == t_best && root < p.inf) ++ties;
  }
}

// ---- a warp's own items (the replay kernels: csrc/replay.cu, csrc/geometry_replay.cu) ----
// The items of a launch are dealt to the warps in chunks of 32 consecutive
// items, round robin: warp w of W owns chunks w, w + W, w + 2W, ...  A warp
// walks its chunks in order and hands the next positions to whichever of its
// lanes are idle, so its lanes share its work; the round robin spreads every
// part of the image over all warps (path lengths follow the image: a
// contiguous range a warp made the warps that drew the long paths the
// launch's tail).  Which lane runs an item is a pure function of the launch.
// Chunks of 8 items measured 6% slower on an H100, of 128 the same.
constexpr int kChunkLog2 = 5;

// Positions warp ``warp`` of ``warps`` owns: its chunks times the chunk size
// (the last chunk of the launch may hold fewer items: check item < n_items).
template <typename Index>
__device__ __forceinline__ Index owned_positions(long long n_items, long long warp,
                                                 long long warps) {
  const long long chunks = (n_items + (1ll << kChunkLog2) - 1) >> kChunkLog2;
  const long long mine = warp < chunks ? (chunks - warp + warps - 1) / warps : 0;
  return static_cast<Index>(mine << kChunkLog2);
}

// The item at position ``pos`` of warp ``warp``'s walk.
template <typename Index>
__device__ __forceinline__ Index item_at(Index pos, Index warp, Index warps) {
  return (((pos >> kChunkLog2) * warps + warp) << kChunkLog2) |
         (pos & ((Index(1) << kChunkLog2) - 1));
}

// Idle lanes that make a warp of the render kernels refill (1..32): 6 of 1,
// 4, 6, 8, 12, 16 and 32 measured on an H100 (PERF.md, Findings).  The one
// design parameter a measurement build sets (scripts/torch_chip_measure.py
// --part designs), since the best value follows the scenes' path lengths.
#ifndef PT_REFILL_MIN
#define PT_REFILL_MIN 6
#endif
constexpr int kRefillMin = PT_REFILL_MIN;

// The lanes of the warp before this one, as a mask (a special register: no
// register of the thread holds it between refills).
__device__ __forceinline__ unsigned int lanes_below() {
  unsigned int mask;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(mask));
  return mask;
}

// One bounce of a live path.  Returns true when the path ended; its
// radiance is then in (rx, ry, rz).  With kAux, ``aux`` describes the
// bounce; a miss has sidx -1 and cont and rr_scaled false.  ``table`` is the
// scene's shared rows (load_scene).
template <bool kAux>
__device__ __forceinline__ bool bounce(Path& s, const float* table, const float* cam,
                                       const Params& p, float& rx, float& ry, float& rz,
                                       BounceAux& aux) {
  PT_SEC_DECL();
  PT_SEC_BEGIN();
  // Bounce uniforms: purpose depth+1, blocks 0 and 1; the 4th word is the
  // reserved u_c (ops/rng.py).  Block 1 is drawn where it is read, in the
  // diffuse sampler: a warp with no diffuse hit skips its 13 rounds.
  const uint32_t purpose = static_cast<uint32_t>(s.depth + 1);
  uint32_t b0, b1, b2, b3;
  threefry2x32(s.k0, s.k1, purpose, 0u, b0, b1);
  const float u_rr = u01(b0), u_a = u01(b1);

  const float ox = s.ox, oy = s.oy, oz = s.oz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;

  // ---- intersect: every sphere, lowest index wins ties (strict <) ----
  const float a_quad = dx * dx + dy * dy + dz * dz;
  const float a_inv = 1.0f / a_quad;
  float t_best = p.inf;
  int best = -1, ties = 0;
  // One sphere a trip: groups of 2 to 8 spheres without a branch between
  // them, and a loop unrolled whole, measured no faster (PERF.md, Findings).
  for (int j = 0; j < p.n_spheres; ++j)
    hit_sphere<kAux>(table + j * kRowFloats, j, ox, oy, oz, dx, dy, dz, a_quad, a_inv, p, t_best,
                     best, ties);

  if constexpr (kAux) {
    aux.sidx = best;
    aux.ties = ties;
    aux.thr_x = s.thx;
    aux.thr_y = s.thy;
    aux.thr_z = s.thz;
    aux.cont = false;
    aux.rr_scaled = false;
  }

  // ---- miss: background gradient (src/main.cpp:115-120) ----
  PT_SEC_END(kSecIntersect);
  if (best < 0) {
    PT_SEC_BEGIN();
    const float dinv = rsqrt_safe(a_quad);  // 1/|d|: only the sky and the dielectric read it
    const float sky_t = (dy * dinv) * 0.5f + 0.5f;
    const float skx = cam[13] + sky_t * (cam[16] - cam[13]);
    const float sky = cam[14] + sky_t * (cam[17] - cam[14]);
    const float skz = cam[15] + sky_t * (cam[18] - cam[15]);
    if constexpr (kAux) {
      aux.sky_x = skx;
      aux.sky_y = sky;
      aux.sky_z = skz;
      aux.sky_t = sky_t;
    }
    rx = s.emx + s.thx * skx;
    ry = s.emy + s.thy * sky;
    rz = s.emz + s.thz * skz;
    PT_SEC_END(kSecMiss);
    return true;
  }

  PT_SEC_BEGIN();
  // ---- hit record: outward normal = normalized (hit - center) ----
  const float* hs = table + best * kRowFloats;
  const float hx = ox + t_best * dx, hy = oy + t_best * dy, hz = oz + t_best * dz;
  const float nrx = hx - hs[kColCenter], nry = hy - hs[kColCenter + 1],
              nrz = hz - hs[kColCenter + 2];
  const float ninv = rsqrt_safe(nrx * nrx + nry * nry + nrz * nrz);
  const float nox = nrx * ninv, noy = nry * ninv, noz = nrz * ninv;
  const float ndotd = nox * dx + noy * dy + noz * dz;
  const bool front = ndotd < 0.0f;
  const float fsign = front ? 1.0f : -1.0f;
  const float nx = nox * fsign, ny = noy * fsign, nz = noz * fsign;

  // ---- emission pickup, then Russian roulette (src/main.cpp:126-137) ----
  const float alx = hs[kColAlbedo], aly = hs[kColAlbedo + 1], alz = hs[kColAlbedo + 2];
  const float ehx = hs[kColEmission], ehy = hs[kColEmission + 1], ehz = hs[kColEmission + 2];
  if constexpr (kAux) {
    aux.eh_x = ehx;
    aux.eh_y = ehy;
    aux.eh_z = ehz;
  }
  s.emx = s.emx + s.thx * ehx;
  s.emy = s.emy + s.thy * ehy;
  s.emz = s.emz + s.thz * ehz;
  const float pmax = nan_max(alx, nan_max(aly, alz));  // uncapped
  const bool do_rr = s.depth > p.rr_depth;
  const bool survive = u_rr < pmax;
  PT_SEC_END(kSecShade);
  if (do_rr && !survive) {
    PT_SEC_BEGIN();
    rx = s.emx;
    ry = s.emy;
    rz = s.emz;
    PT_SEC_END(kSecRoulette);
    return true;
  }
  const float colf = do_rr ? 1.0f / (pmax > 0.0f ? pmax : 1.0f) : 1.0f;
  if constexpr (kAux) {
    aux.cont = true;  // the depth limit below ends the path after the update
    aux.rr_scaled = do_rr;
  }

  // ---- scatter (src/main.cpp:141-154) ----
  const float mcode = hs[kColMaterial];
  float dnx, dny, dnz;
  if (mcode < 0.5f) {
    PT_SEC_BEGIN();
    // diffuse: cosine-weighted hemisphere (src/main.cpp:44-58)
    threefry2x32(s.k0, s.k1, purpose, 1u, b2, b3);  // only this sampler reads block 1
    const float u_b = u01(b2);
    const float phi = kTwoPi * u_a;
    const float sin_t = sqrtf(u_b);
    const float cos_t = sqrtf(nan_max(1.0f - u_b, 0.0f));
    const bool ax_y = fabsf(nx) > 0.1f;
    const float ux_r = ax_y ? nz : 0.0f;
    const float uy_r = ax_y ? 0.0f : -nz;
    const float uz_r = ax_y ? -nx : ny;
    const float uinv = rsqrt_safe(ux_r * ux_r + uy_r * uy_r + uz_r * uz_r);
    const float ux = ux_r * uinv, uy = uy_r * uinv, uz = uz_r * uinv;
    const float vx = ny * uz - nz * uy;
    const float vy = nz * ux - nx * uz;
    const float vz = nx * uy - ny * ux;
    const float cp = cosf(phi), sp = sinf(phi);
    const float ddx = ux * cp * sin_t + vx * sp * sin_t + nx * cos_t;
    const float ddy = uy * cp * sin_t + vy * sp * sin_t + ny * cos_t;
    const float ddz = uz * cp * sin_t + vz * sp * sin_t + nz * cos_t;
    const float dinv2 = rsqrt_safe(ddx * ddx + ddy * ddy + ddz * ddz);
    dnx = ddx * dinv2;
    dny = ddy * dinv2;
    dnz = ddz * dinv2;
    PT_SEC_END(kSecDiffuse);
  } else {
    PT_SEC_BEGIN();
    // specular reflection about the outward normal (src/main.cpp:60-67)
    dnx = dx - 2.0f * nox * ndotd;
    dny = dy - 2.0f * noy * ndotd;
    dnz = dz - 2.0f * noz * ndotd;
    PT_SEC_END(kSecSpecular);
    if (mcode > 1.5f) {
      PT_SEC_BEGIN();
      // dielectric: Schlick reflect-or-refract lottery (src/main.cpp:69-97)
      const float dinv = rsqrt_safe(a_quad);
      const float ratio = front ? p.ratio_front : p.ratio_back;
      const float udx = dx * dinv, udy = dy * dinv, udz = dz * dinv;
      const float cos_d = nan_min(-(udx * nx + udy * ny + udz * nz), 1.0f);
      const float sin_d = sqrtf(nan_max(1.0f - cos_d * cos_d, 0.0f));
      const bool cannot = ratio * sin_d > 1.0f;
      float r0 = (1.0f - ratio) / (1.0f + ratio);
      r0 = r0 * r0;
      const float mm = nan_max(1.0f - cos_d, 0.0f);
      const float reflprob = r0 + (1.0f - r0) * (mm * mm * mm * mm * mm);
      if (!(cannot || reflprob > u_a)) {
        const float ppx = (udx + nx * cos_d) * ratio;
        const float ppy = (udy + ny * cos_d) * ratio;
        const float ppz = (udz + nz * cos_d) * ratio;
        const float kk = fabsf(1.0f - (ppx * ppx + ppy * ppy + ppz * ppz));
        const float neg_sqrt_k = -sqrtf(kk);
        dnx = ppx + nx * neg_sqrt_k;
        dny = ppy + ny * neg_sqrt_k;
        dnz = ppz + nz * neg_sqrt_k;
      }
      PT_SEC_END(kSecDielectric);
    }
  }

  PT_SEC_BEGIN();
  // ---- continue: move, damp throughput, count the bounce ----
  s.ox = hx;
  s.oy = hy;
  s.oz = hz;
  s.dx = dnx;
  s.dy = dny;
  s.dz = dnz;
  s.thx = s.thx * alx * colf;
  s.thy = s.thy * aly * colf;
  s.thz = s.thz * alz * colf;
  s.depth += 1;
  const bool exhausted = s.depth >= p.max_depth;  // depth exhaustion (src/main.cpp:157)
  if (exhausted) {
    rx = s.emx;
    ry = s.emy;
    rz = s.emz;
  }
  PT_SEC_END(kSecUpdate);
  return exhausted;
}

}  // namespace pt
