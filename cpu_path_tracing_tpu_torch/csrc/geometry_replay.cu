// Geometry and camera backward in one launch: the p0, radius and camera
// partials of sum(ct * render), the counterpart of what the JAX package
// computes by XLA's autodiff of its checkpointed scan
// (cpu_path_tracing_tpu/grad.py).  cpu_path_tracing_tpu_torch/ops/
// geometry_replay.py has the algebra and the plain version of every step.
//
// What it computes.  With the decisions detached, geometry and camera reach
// a path's value only through the sky lerp of its terminal miss direction.
// Each path is rendered again with the forward kernel's step math
// (start_path, bounce<true>: the same decisions bit for bit), recording each
// bounce's input ray, hit id and tie count; a path that ends on a miss then
// carries one seed, w = sum_c ct_c * thr_c * (bg1_c - bg0_c) times
// d(sky_t)/d(d), which it sweeps back through its bounces, newest first, by
// the hand-written VJP of the sampler of the material it hit, the hit record
// and the hit sphere's root.  Each bounce adds the hit sphere's p0 and
// radius terms; where m spheres' roots tie exactly at t, each takes g_t / m
// through its own root (jnp.min's and torch.amin's split), the hit record
// staying the hit sphere's.  The sweep ends in the VJP of the primary ray
// (lens disk, origin_advance).  A path that the roulette or the depth limit
// ends adds nothing.  Partials:
//   [0:3N)       p0, sphere-major
//   [3N:4N)      radius
//   [4N:4N+14)   position(3) lower_left(3) cam_x(3) cam_y(3) lens_radius
//                origin_advance (the floats of pack_camera)
// float32, as the replay kernel's.  A sweep recomputes a bounce's forward
// values from the record by the expressions of hit_sphere and bounce (so its
// decisions are the forward's), and keeps the scan VJP's guards: a tangent
// ray (disc == 0) and a tangent refraction (kk == 0) take a zero derivative
// there.
//
// Bound: the forward's FP32/integer work, as the replay kernel's, plus the
// sweeps' (a bounce's VJP costs about two forward bounces: its Threefry
// blocks, sine and cosine, square roots and divisions again).  What held the
// first design at 7-21x its bound, by the -DPT_SIMT_PROBE sections on an
// H100 (PERF.md, Findings): on an open scene the sweeps, 42% of
// the warps' cycles, run in the bounce phase by the lanes that had just
// missed while the rest of the warp waited, each as long as the longest
// path among them; on a closed one the record, 7 scattered 4-byte stores a
// bounce; and 112 registers (512 threads an SM).
//
// Design.  The replay kernel's skeleton (csrc/replay.cu): a persistent grid,
// one live path per thread, a refill phase the warp's idle lanes enter
// together, warp-owned chunks of 32 items (pt::item_at), the partials of a
// thread in shared memory laid out [k][thread] in a compile-time bucket of N
// (8, 16, 40).  Beside it:
//   * The record: [grid threads][max_depth][8] float32 in device memory,
//     sized by the grid, not the items (a thread's next path overwrites its
//     last).  A bounce is one 32-byte sector of its lane, two float4 stores
//     (o.xyz d.x before the bounce; d.yz, hit id, tie count after it, and
//     only if the path goes on) and two float4 loads when swept; a lane's
//     bounces fill its 128-byte lines in turn.  [max_depth][threads][8],
//     whose lanes at one depth share lines, measured 0.6-5% slower on a
//     box chunk in three runs on an H100.
//   * A sweep phase, the counterpart of the refill phase.  A lane whose
//     path ends on a miss computes its seed and parks, its path state in
//     registers and its adjoints (go, gd) in shared memory.  When
//     kSweepMin lanes of the warp have parked, or no lane is alive, every
//     parked lane sweeps one bounce back at once, each its own bounce; a
//     lane done with bounce 0 takes the primary ray's VJP and goes idle,
//     the others stay parked for the next sweep phase.  A parked lane
//     is refilled only after its sweep: its record is its own.  One bounce
//     a phase keeps the lanes of a phase busy whatever their paths'
//     lengths.  In two runs on an H100, against 16 parked lanes and one
//     bounce: whole paths in lockstep measured 35-52% slower on open
//     chunks, 2 bounces a phase 29-52%, 6 parked lanes 24-28%, 12 and 24
//     lanes 0.4-5.5%; a closed chunk, with no sweep, within 2%.  Those
//     designs were dropped.
//   * The sweep phase sits outside the bounce phase's code, and a parked
//     lane clears what its path no longer reads, so the two do not share a
//     live range: 94 registers, 640 threads an SM.  kMinBlocks holds that
//     residency; a build at 512 threads an SM (108 registers) measured 7%
//     slower on a simple chunk and 5% on a box one.
//
// Reduction, deterministic, as the replay kernel's: no atomics on floats,
// each thread adds its paths' partials in its own item order, and each
// block writes one row of a [blocks, 4N+14] buffer in a fixed order, which
// the wrapper sums in plain torch.  Two launches on the same inputs give
// bitwise-equal rows.
//
// Counters: segments, most bounce phases of a warp, bounces swept back,
// bounce phases summed over warps, paths swept, swept bounces whose root
// tied; with -DPT_SIMT_PROBE the probe's sums after them.

#include <cuda_runtime.h>

#include <cstdint>

#include "step_math.cuh"

namespace {

constexpr int kMaxSpheres = 40;  // MAX_REPLAY_SPHERES in ops/kernels/replay.py
constexpr int kCamPartials = 14;
constexpr int kCounterWords = 6;  // GEOMETRY_COUNTER_WORDS in ops/kernels/geometry_replay.py
constexpr unsigned int kFull = 0xffffffffu;

// Threads a block by bucket, as the replay kernel's.
template <int NB>
constexpr int kBlockThreads = NB <= 16 ? 128 : 64;

// Resident blocks an SM asked of the compiler: 5 blocks of 128 threads
// leave a thread 96 registers (640 threads an SM, the replay kernel's
// residency); the 40-sphere bucket keeps the compiler's own choice.
template <int NB>
constexpr int kMinBlocks = NB <= 16 ? 5 : 1;

// A warp's sweep phase starts when this many of its lanes have parked (or
// none is alive); measured on an H100 against 6, 12 and 24 (the design
// comment above).
constexpr int kSweepMin = 16;

// Floats of shared memory a block of bucket NB needs for n spheres: the
// scene, the partials and a parked path's adjoints, [k][thread].
template <int NB>
constexpr size_t smem_floats(int n_spheres) {
  return static_cast<size_t>(pt::scene_floats(n_spheres)) +
         (4 * NB + kCamPartials + 6) * kBlockThreads<NB>;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// VJP of y = x * inv, inv = 1/sqrt(x.x) (rsqrt_safe of a positive length).
__device__ __forceinline__ V3 normalize_vjp(V3 x, float inv, V3 g) {
  return g * inv - x * (dot(g, x) * inv * inv * inv);
}

// This thread's record of bounce k: two float4, [grid threads][max_depth][8].
__device__ __forceinline__ float4* record_slot(float4* rec, int k, size_t column,
                                               int max_depth) {
  return rec + 2 * (column * static_cast<size_t>(max_depth) + static_cast<size_t>(k));
}

// The screen coordinates and lens-disk uniforms of an item, by start_path's
// expressions (uniform jitter).
template <typename Index>
__device__ __forceinline__ void camera_sample(Index item, const pt::Params& p, float& scr_s,
                                              float& scr_t, float& du1, float& du2) {
  const Index n_cells = static_cast<Index>(p.n_cells);
  const Index smp_in_span = item / n_cells;
  const Index c_idx = item - smp_in_span * n_cells;
  const Index smp = static_cast<Index>(p.sample_start) + smp_in_span;
  const Index cell = min(static_cast<Index>(p.cell_start) + c_idx,
                         static_cast<Index>(p.total_cells - 1));
  uint32_t a0, a1, c0, c1;
  pt::threefry2x32(p.key0, p.key1, static_cast<uint32_t>(cell), static_cast<uint32_t>(smp), a0,
                   a1);
  pt::threefry2x32(a0, a1, 0u, 0u, c0, c1);
  const float jx = pt::u01(a0), jy = pt::u01(a1);
  du1 = pt::u01(c0);
  du2 = pt::u01(c1);
  const Index ns = static_cast<Index>(p.ns), ns2 = ns * ns, width = static_cast<Index>(p.width);
  const Index pix = cell / ns2, sub = cell - pix * ns2;
  const Index py_i = pix / width, sy_i = sub / ns;
  const float px = static_cast<float>(pix - py_i * width);
  const float py = static_cast<float>(py_i);
  const float sxf = static_cast<float>(sub - sy_i * ns);
  const float syf = static_cast<float>(sy_i);
  scr_s = (px + sxf * p.sub_len + jx * p.sub_len) * p.inv_w;
  scr_t = (py + syf * p.sub_len + jy * p.sub_len) * p.inv_h;
}

// One sphere's root for a ray, by hit_sphere's expressions, with what its
// VJP reads.
struct Root {
  V3 q;
  float b, c, qad, add, sq, qf, t;
  float w1, w2;  // t's weights on the two roots
  bool tangent;
};

__device__ __forceinline__ Root root_of(const float* row, V3 o, V3 d, float a, float a_inv,
                                        const pt::Params& p) {
  Root f;
  f.q = {o.x - row[0], o.y - row[1], o.z - row[2]};
  const float qd = f.q.x * d.x + f.q.y * d.y + f.q.z * d.z;
  f.add = row[3] * d.x + row[4] * d.y + row[5] * d.z;
  f.b = qd + row[6] * f.add;
  const float qq = f.q.x * f.q.x + f.q.y * f.q.y + f.q.z * f.q.z;
  f.qad = f.q.x * row[3] + f.q.y * row[4] + f.q.z * row[5];
  f.c = qq + row[7] * f.qad;
  const float disc = f.b * f.b - a * f.c;
  f.tangent = disc == 0.0f;
  f.sq = sqrtf(disc >= 0.0f ? disc : 1.0f);
  f.qf = -(f.b + (f.b >= 0.0f ? f.sq : -f.sq));
  const float r1 = f.qf * a_inv;
  const float r2 = f.qf != 0.0f ? f.c / f.qf : p.inf;
  const float c1 = r1 >= p.eps ? r1 : p.inf, c2 = r2 >= p.eps ? r2 : p.inf;
  f.t = disc >= 0.0f ? fminf(c1, c2) : p.inf;
  // torch.minimum / maximum split a double root's derivative evenly.
  f.w1 = r1 == r2 ? 0.5f : (c1 < c2 ? 1.0f : 0.0f);
  f.w2 = 1.0f - f.w1;
  return f;
}

// The root's VJP for its share g_t of t's adjoint: adds to the ray's
// adjoints (go through q = o - p0, gd) and to the sphere's p0 and radius
// partials (rows ``row_p0 + 3 h`` and ``row_r + h`` of ``part``).
template <int T>
__device__ __forceinline__ void root_vjp(const Root& f, const float* row, V3 d, float a,
                                         float a_inv, float g_t, int h, float* part, int row_p0,
                                         int row_r, V3& go, V3& gd) {
  const V3 ad = {row[3], row[4], row[5]};
  const float r = row[6];
  const float g_r1 = g_t * f.w1, g_r2 = g_t * f.w2;
  const float g_qf = g_r1 * a_inv - g_r2 * f.c / (f.qf * f.qf);
  float g_c = g_r2 / f.qf;
  float g_a = -(g_r1 * f.qf) * a_inv * a_inv;
  float g_b = -g_qf;
  const float sign_b = f.b >= 0.0f ? 1.0f : -1.0f;
  const float g_disc = f.tangent ? 0.0f : -sign_b * g_qf * 0.5f / f.sq;
  g_b = g_b + 2.0f * f.b * g_disc;
  g_a = g_a - f.c * g_disc;
  g_c = g_c - a * g_disc;
  const V3 g_q = d * g_b + f.q * (2.0f * g_c) + ad * (2.0f * r * g_c);
  gd = gd + f.q * g_b + ad * (g_b * r) + d * (2.0f * g_a);
  go = go + g_q;
  float* gp = part + (row_p0 + 3 * h) * T;
  gp[0] -= g_q.x;
  gp[T] -= g_q.y;
  gp[2 * T] -= g_q.z;
  part[(row_r + h) * T] += g_b * f.add + 2.0f * f.qad * g_c;
}

// One bounce of the sweep: the VJP of the hit bounce k of the path (input
// ray o, d from the record, sphere h, ``ties`` spheres at its t) for the
// adjoints (go, gd) of its outputs (the next origin and direction), which it
// replaces by those of its inputs; adds the spheres' p0 and radius terms to
// ``part``.
template <int T>
__device__ __forceinline__ void bounce_vjp(V3 o, V3 d, int h, int ties, int k, uint32_t k0,
                                           uint32_t k1, const float* table, const pt::Params& p,
                                           float* part, int row_p0, int row_r, V3& go, V3& gd) {
  const float* row = table + h * pt::kRowFloats;
  const V3 ad = {row[3], row[4], row[5]};
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  const float a_inv = 1.0f / a;
  const Root root = root_of(row, o, d, a, a_inv, p);
  const float t = root.t;

  // ---- the hit record, by bounce's expressions ----
  const V3 center = {row[pt::kColCenter], row[pt::kColCenter + 1], row[pt::kColCenter + 2]};
  const V3 hp = {o.x + t * d.x, o.y + t * d.y, o.z + t * d.z};
  const V3 nr = hp - center;
  const float ninv = pt::rsqrt_safe(nr.x * nr.x + nr.y * nr.y + nr.z * nr.z);
  const V3 no = nr * ninv;
  const float ndotd = no.x * d.x + no.y * d.y + no.z * d.z;
  const float fsign = ndotd < 0.0f ? 1.0f : -1.0f;
  const V3 n = no * fsign;

  // ---- the sampler of the hit material ----
  const uint32_t purpose = static_cast<uint32_t>(k + 1);
  uint32_t b0, b1, b2, b3;
  pt::threefry2x32(k0, k1, purpose, 0u, b0, b1);
  const float u_a = pt::u01(b1);
  const float mcode = row[pt::kColMaterial];
  V3 g_n = {0.0f, 0.0f, 0.0f}, g_no = {0.0f, 0.0f, 0.0f}, g_d = {0.0f, 0.0f, 0.0f};
  bool mirror = mcode >= 0.5f;  // specular, or the dielectric's reflection
  if (mcode < 0.5f) {
    // diffuse: sample_diffuse_c about n
    pt::threefry2x32(k0, k1, purpose, 1u, b2, b3);
    const float u_b = pt::u01(b2);
    const float phi = pt::kTwoPi * u_a;
    const float sin_t = sqrtf(u_b);
    const float cos_t = sqrtf(pt::nan_max(1.0f - u_b, 0.0f));
    const bool ax_y = fabsf(n.x) > 0.1f;
    const V3 u_r = {ax_y ? n.z : 0.0f, ax_y ? 0.0f : -n.z, ax_y ? -n.x : n.y};
    const float uinv = pt::rsqrt_safe(u_r.x * u_r.x + u_r.y * u_r.y + u_r.z * u_r.z);
    const V3 u = u_r * uinv;
    const V3 v = cross(n, u);
    const float cp = cosf(phi), sp = sinf(phi);
    const V3 dd = {u.x * cp * sin_t + v.x * sp * sin_t + n.x * cos_t,
                   u.y * cp * sin_t + v.y * sp * sin_t + n.y * cos_t,
                   u.z * cp * sin_t + v.z * sp * sin_t + n.z * cos_t};
    const float dinv2 = pt::rsqrt_safe(dd.x * dd.x + dd.y * dd.y + dd.z * dd.z);
    const V3 g_dd = normalize_vjp(dd, dinv2, gd);
    const V3 g_v = g_dd * (sp * sin_t);
    g_n = g_dd * cos_t + cross(u, g_v);
    const V3 g_ur = normalize_vjp(u_r, uinv, g_dd * (cp * sin_t) + cross(g_v, n));
    if (ax_y) {
      g_n.x -= g_ur.z;
      g_n.z += g_ur.x;
    } else {
      g_n.y += g_ur.z;
      g_n.z -= g_ur.y;
    }
  } else if (mcode > 1.5f) {
    // dielectric: the lottery again, then the refraction's VJP
    const float dinv = pt::rsqrt_safe(a);
    const float ratio = fsign > 0.0f ? p.ratio_front : p.ratio_back;
    const V3 ud = d * dinv;
    const float y = -(ud.x * n.x + ud.y * n.y + ud.z * n.z);
    const float cos_d = pt::nan_min(y, 1.0f);
    const float sin_d = sqrtf(pt::nan_max(1.0f - cos_d * cos_d, 0.0f));
    const bool cannot = ratio * sin_d > 1.0f;
    float r0 = (1.0f - ratio) / (1.0f + ratio);
    r0 = r0 * r0;
    const float mm = pt::nan_max(1.0f - cos_d, 0.0f);
    const float reflprob = r0 + (1.0f - r0) * (mm * mm * mm * mm * mm);
    if (!(cannot || reflprob > u_a)) {
      mirror = false;
      const V3 pp = {(ud.x + n.x * cos_d) * ratio, (ud.y + n.y * cos_d) * ratio,
                     (ud.z + n.z * cos_d) * ratio};
      const float x = 1.0f - (pp.x * pp.x + pp.y * pp.y + pp.z * pp.z);
      const float kk = fabsf(x);
      const float sqrt_k = sqrtf(kk);
      g_n = gd * (-sqrt_k);
      const float g_nsk = dot(gd, n);
      const float g_kk = kk == 0.0f ? 0.0f : -g_nsk * 0.5f / sqrt_k;
      const float g_x = x > 0.0f ? g_kk : (x < 0.0f ? -g_kk : 0.0f);
      const V3 g_pp = gd - pp * (2.0f * g_x);
      V3 g_ud = g_pp * ratio;
      g_n = g_n + g_ud * cos_d;
      const float g_cos = dot(g_ud, n);
      const float g_y = y < 1.0f ? g_cos : (y == 1.0f ? 0.5f * g_cos : 0.0f);
      g_ud = g_ud - n * g_y;
      g_n = g_n - ud * g_y;
      g_d = normalize_vjp(d, dinv, g_ud);
    }
  }
  if (mirror) {  // sample_specular_c about the outward normal
    const float s = dot(no, d);
    const float g_s = -2.0f * dot(no, gd);
    g_d = gd + no * g_s;
    g_no = gd * (-2.0f * s) + d * g_s;
  }
  g_no = g_no + g_n * fsign;

  // ---- the hit record's VJP: the center (p0 - r * ad) and t ----
  const V3 g_nr = normalize_vjp(nr, ninv, g_no);
  const V3 g_hp = go + g_nr;
  g_d = g_d + g_hp * t;
  const float g_t = dot(g_hp, d);
  float* gp = part + (row_p0 + 3 * h) * T;
  gp[0] -= g_nr.x;
  gp[T] -= g_nr.y;
  gp[2 * T] -= g_nr.z;
  part[(row_r + h) * T] += dot(g_nr, ad);

  // ---- the roots' VJPs: g_t / ties to each sphere whose root is t ----
  const float g_share = ties > 1 ? g_t / static_cast<float>(ties) : g_t;
  go = g_hp;
  root_vjp<T>(root, row, d, a, a_inv, g_share, h, part, row_p0, row_r, go, g_d);
  if (ties > 1) {
#pragma unroll 1
    for (int i = 0; i < p.n_spheres; ++i) {
      if (i == h) continue;
      const float* ri = table + i * pt::kRowFloats;
      const Root other = root_of(ri, o, d, a, a_inv, p);
      if (other.t == t) root_vjp<T>(other, ri, d, a, a_inv, g_share, i, part, row_p0, row_r, go, g_d);
    }
  }
  gd = g_d;
}

template <typename Index, int NB>
__global__ void __launch_bounds__(kBlockThreads<NB>, kMinBlocks<NB>)
geometry_replay_kernel(const float* __restrict__ table, const float* __restrict__ cam,
                       const float* __restrict__ ct, float* __restrict__ rows,
                       float4* __restrict__ rec, unsigned long long* __restrict__ counters,
                       const pt::Params p) {
  constexpr int T = kBlockThreads<NB>;
  // Rows of the partials in shared memory, by bucket: p0, radius, camera.
  constexpr int kP0 = 0, kR = 3 * NB, kCam = 4 * NB, kRows = 4 * NB + kCamPartials;
  extern __shared__ __align__(16) float smem[];
  const int n = p.n_spheres;
  const float* s_table = smem;
  const float* s_cam = pt::load_scene(smem, table, cam, n);
  float* part = smem + pt::scene_floats(n) + threadIdx.x;  // this thread's column
  // A parked path's adjoints go, gd between its sweep phases: [6][T].
  float* adj = part + kRows * T;
#pragma unroll 1
  for (int k = 0; k < kRows; ++k) part[k * T] = 0.0f;
#ifdef PT_SIMT_PROBE
  pt::simt_zero();
  const long long pt_warp_t = clock64();
#endif
  PT_SEC_DECL();

  // This thread's place in the record.
  const size_t column = static_cast<size_t>(blockIdx.x) * T + threadIdx.x;

  const Index warps = static_cast<Index>(gridDim.x) * (T / 32);
  const Index warp = static_cast<Index>(blockIdx.x) * (T / 32) + (threadIdx.x >> 5);
  Index next = 0;
  const Index end = pt::owned_positions<Index>(p.n_items, warp, warps);
  const Index n_items = static_cast<Index>(p.n_items);
  const unsigned int lane = threadIdx.x & 31;

  bool alive = false, parked = false;
  Index item = 0;
  float ctx = 0.0f, cty = 0.0f, ctz = 0.0f;
  unsigned int phases = 0;          // warp-uniform
  unsigned long long segments = 0;  // warp-uniform
  unsigned int swept = 0, missed = 0, tied = 0;  // this thread's
  pt::Path s;
  while (true) {
    const unsigned int parked_lanes = __ballot_sync(kFull, parked);
    const unsigned int alive_lanes = __ballot_sync(kFull, alive);
    // ---- the sweep phase: every parked lane at once ----
    if (parked_lanes != 0u && (__popc(parked_lanes) >= kSweepMin || alive_lanes == 0u)) {
      // A parked lane's s.depth counts the bounces it has still to sweep.
      if (parked) {
        PT_SEC_BEGIN();
        // What a parked path no longer reads (its next path overwrites it),
        // cleared so that the sweep's registers need not keep it.
        s.ox = s.oy = s.oz = s.thx = s.thy = s.thz = s.emx = s.emy = s.emz = 0.0f;
        ctx = cty = ctz = 0.0f;
        V3 go = {adj[0], adj[T], adj[2 * T]}, gd = {adj[3 * T], adj[4 * T], adj[5 * T]};
        V3 d0 = {s.dx, s.dy, s.dz};  // the primary direction once swept to bounce 0
        if (s.depth > 0) {
          const int j = s.depth - 1;
          const float4* slot = record_slot(rec, j, column, p.max_depth);
          const float4 r0 = slot[0], r1 = slot[1];
          const V3 o = {r0.x, r0.y, r0.z};
          d0 = {r0.w, r1.x, r1.y};
          const int ties = __float_as_int(r1.w);
          bounce_vjp<T>(o, d0, __float_as_int(r1.z), ties, j, s.k0, s.k1, s_table, p, part,
                        kP0, kR, go, gd);
          swept += 1;
          tied += ties > 1 ? 1u : 0u;
          s.depth = j;
        }
        PT_SEC_END(pt::kSecSweep);
        if (s.depth > 0) {  // more bounces to sweep: the adjoints wait in shared memory
          adj[0] = go.x;
          adj[T] = go.y;
          adj[2 * T] = go.z;
          adj[3 * T] = gd.x;
          adj[4 * T] = gd.y;
          adj[5 * T] = gd.z;
        } else {
          PT_SEC_BEGIN();
          // The primary ray's VJP (models/camera.get_rays).
          float scr_s, scr_t, du1, du2;
          camera_sample<Index>(item, p, scr_s, scr_t, du1, du2);
          const V3 g_dir = gd + go * s_cam[19];
          const V3 g_off = go - g_dir;
          const float th = pt::kTwoPi * du2;
          const float g_lens = (scr_s + scr_t) * (cosf(th) * g_off.x + sinf(th) * g_off.y);
          PT_SEC_END(pt::kSecCamera);
          PT_SEC_BEGIN();
          float* gc = part + kCam * T;
          const V3 g_pos = go - g_dir;
          gc[0] += g_pos.x;
          gc[T] += g_pos.y;
          gc[2 * T] += g_pos.z;
          gc[3 * T] += g_dir.x;
          gc[4 * T] += g_dir.y;
          gc[5 * T] += g_dir.z;
          gc[6 * T] += g_dir.x * scr_s;
          gc[7 * T] += g_dir.y * scr_s;
          gc[8 * T] += g_dir.z * scr_s;
          gc[9 * T] += g_dir.x * scr_t;
          gc[10 * T] += g_dir.y * scr_t;
          gc[11 * T] += g_dir.z * scr_t;
          gc[12 * T] += g_lens * sqrtf(du1);
          gc[13 * T] += dot(go, d0);
          PT_SEC_END(pt::kSecAccumulate);
          missed += 1;
          parked = false;
        }
      }
      continue;
    }

    // ---- the refill phase ----
    const unsigned int idle = ~(parked_lanes | alive_lanes);
    unsigned int live = alive_lanes;
    if (next < end && __popc(idle) >= pt::kRefillMin) {
      const Index at = next + static_cast<Index>(__popc(idle & pt::lanes_below()));
      const Index mine = pt::item_at<Index>(at, warp, warps);
      next += static_cast<Index>(__popc(idle));
      if (!alive && !parked && at < end && mine < n_items) {
        PT_SEC_BEGIN();
        const size_t c = static_cast<size_t>(pt::start_path<Index>(s, mine, s_cam, p));
        ctx = ct[3 * c];
        cty = ct[3 * c + 1];
        ctz = ct[3 * c + 2];
        item = mine;
        alive = true;
        PT_SEC_END(pt::kSecRegen);
      }
      live = __ballot_sync(kFull, alive);
    } else if (alive_lanes == 0u) {
      break;  // nothing parked (else the sweep phase ran), nothing left to start
    }

    // ---- the bounce phase ----
    ++phases;
    segments += __popc(live);
    if (alive) {
      PT_SEC_BEGIN();
      float4* slot = record_slot(rec, s.depth, column, p.max_depth);
      slot[0] = make_float4(s.ox, s.oy, s.oz, s.dx);
      const float dy = s.dy, dz = s.dz;
      PT_SEC_END(pt::kSecRecord);
      float rx, ry, rz;
      pt::BounceAux a;
      const bool done = pt::bounce<true>(s, s_table, s_cam, p, rx, ry, rz, a);
      if (!done) {  // only a bounce the path goes on from is ever swept
        PT_SEC_BEGIN();
        slot[1] = make_float4(dy, dz, __int_as_float(a.sidx), __int_as_float(a.ties));
        PT_SEC_END(pt::kSecRecord);
      } else {
        alive = false;
        if (a.sidx < 0) {  // a miss: the seed now, the sweep in sweep phases
          PT_SEC_BEGIN();
          parked = true;
          const float w = ctx * s.thx * (s_cam[16] - s_cam[13]) +
                          cty * s.thy * (s_cam[17] - s_cam[14]) +
                          ctz * s.thz * (s_cam[18] - s_cam[15]);
          const float dinv = pt::rsqrt_safe(s.dx * s.dx + s.dy * s.dy + s.dz * s.dz);
          const float h = 0.5f * w * dinv;
          const float gdy = -(h * s.dy * dinv * dinv);
          adj[0] = 0.0f;
          adj[T] = 0.0f;
          adj[2 * T] = 0.0f;
          adj[3 * T] = s.dx * gdy;
          adj[4 * T] = s.dy * gdy + h;
          adj[5 * T] = s.dz * gdy;
          PT_SEC_END(pt::kSecCamera);
        }
      }
    }
  }
#ifdef PT_SIMT_PROBE
  pt::simt_end(pt::kSecWarp, pt_warp_t);
  pt::simt_flush(counters + (kCounterWords - pt::kSimtBase));
#endif

  unsigned long long warp_swept = swept, warp_missed = missed, warp_tied = tied;
  for (int off = 16; off > 0; off >>= 1) {
    warp_swept += __shfl_down_sync(kFull, warp_swept, off);
    warp_missed += __shfl_down_sync(kFull, warp_missed, off);
    warp_tied += __shfl_down_sync(kFull, warp_tied, off);
  }
  if (lane == 0) {
    atomicAdd(&counters[0], segments);
    atomicMax(&counters[1], static_cast<unsigned long long>(phases));
    atomicAdd(&counters[2], warp_swept);
    atomicAdd(&counters[3], static_cast<unsigned long long>(phases));
    atomicAdd(&counters[4], warp_missed);
    atomicAdd(&counters[5], warp_tied);
  }

  // The block's row, as the replay kernel's: output k is the sum of a row of
  // the partials over the block's threads in a fixed order.
  __syncthreads();
  const float* all = smem + pt::scene_floats(n);
  const int m_total = 4 * n + kCamPartials;
  for (int k = threadIdx.x >> 5; k < m_total; k += T / 32) {
    const int kb = k < 3 * n ? kP0 + k : k < 4 * n ? kR + (k - 3 * n) : kCam + (k - 4 * n);
    float v = 0.0f;
#pragma unroll
    for (int t = 0; t < T; t += 32) v += all[kb * T + t + lane];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
    if (lane == 0) rows[static_cast<size_t>(blockIdx.x) * m_total + k] = v;
  }
}

using GeometryFn = void (*)(const float*, const float*, const float*, float*, float4*,
                            unsigned long long*, const pt::Params);

struct Launch {
  GeometryFn kernel;
  int threads;
  size_t smem;
};

template <int NB>
Launch launch_of(int index_bits, int n_spheres) {
  return {index_bits == 32 ? geometry_replay_kernel<uint32_t, NB>
                           : geometry_replay_kernel<long long, NB>,
          kBlockThreads<NB>, smem_floats<NB>(n_spheres) * sizeof(float)};
}

Launch pick(int index_bits, int n_spheres) {
  if (n_spheres <= 8) return launch_of<8>(index_bits, n_spheres);
  if (n_spheres <= 16) return launch_of<16>(index_bits, n_spheres);
  return launch_of<kMaxSpheres>(index_bits, n_spheres);
}

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

// The persistent grid for a geometry replay of n_items items over n_spheres
// spheres: as many blocks as fit on the card at once, fewer when there are
// fewer items.  Writes the blocks and threads per block; returns a
// cudaError_t.
int pt_geometry_grid(int n_spheres, long long n_items, int index_bits, long long* blocks,
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

// Launches the geometry replay on ``stream`` with ``blocks`` blocks
// (pt_geometry_grid, asked with the same ``index_bits``).  ``ct`` is
// [n_cells, 3] float32, ``rows`` [blocks, 4N+14] float32 (every row is
// written), ``rec`` at least max_depth * 8 * blocks * threads float32 of
// scratch, 32-byte aligned, ``counters`` 6 zeroed uint64 words.  Returns
// cudaGetLastError() after the launch.
int pt_geometry_replay(const float* table, const float* cam, const float* ct, float* rows,
                       float* rec, unsigned long long* counters, const pt::Params* params,
                       int index_bits, long long blocks, void* stream) {
  const pt::Params p = *params;
  if (bad_args(p.n_spheres, index_bits) || blocks < 1 || reinterpret_cast<std::uintptr_t>(rec) % 32)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = pick(index_bits, p.n_spheres);
  const cudaError_t err = allow_smem(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  l.kernel<<<static_cast<unsigned int>(blocks), l.threads, l.smem,
             static_cast<cudaStream_t>(stream)>>>(table, cam, ct, rows,
                                                  reinterpret_cast<float4*>(rec), counters, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
