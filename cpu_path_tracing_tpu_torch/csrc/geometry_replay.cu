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
// bounce's input ray and hit id; a path that ends on a miss then carries one
// seed, w = sum_c ct_c * thr_c * (bg1_c - bg0_c) times d(sky_t)/d(d), which
// it sweeps back through its bounces, newest first, by the hand-written VJP
// of the sampler of the material it hit, the hit record and the hit sphere's
// root.  Each bounce adds the hit sphere's p0 and radius terms; the sweep
// ends in the VJP of the primary ray (lens disk, origin_advance).  A path
// that the roulette or the depth limit ends adds nothing.  Partials:
//   [0:3N)       p0, sphere-major
//   [3N:4N)      radius
//   [4N:4N+14)   position(3) lower_left(3) cam_x(3) cam_y(3) lens_radius
//                origin_advance (the floats of pack_camera)
// float32, as the replay kernel's.  A sweep recomputes a bounce's forward
// values from the record for the recorded sphere alone, by the expressions
// of hit_sphere and bounce (so its decisions are the forward's), and keeps
// the scan VJP's guards: a tangent ray (disc == 0) and a tangent refraction
// (kk == 0) take a zero derivative there.
//
// Design.  The replay kernel's skeleton (csrc/replay.cu): a persistent grid,
// one live path per thread, a refill phase the warp's idle lanes enter
// together, warp-owned chunks of 32 items (pt::item_at), the partials of a
// thread in shared memory laid out [k][thread] in a compile-time bucket of N
// (8, 16, 40).  The record lives in device memory, [max_depth][7][threads of
// the grid] (7 words: o, d, hit id), sized by the grid, not the items: a
// thread's next path overwrites its last.  A sweep runs in the lane whose
// path missed, while the warp's other lanes wait for it.
//
// Reduction, deterministic, as the replay kernel's: no atomics on floats,
// each block writes one row of a [blocks, 4N+14] buffer in a fixed order,
// which the wrapper sums in plain torch.  Two launches on the same inputs
// give bitwise-equal rows.
//
// Counters: segments, most bounce phases of a warp, bounces swept back,
// bounce phases summed over warps, paths swept.

#include <cuda_runtime.h>

#include "step_math.cuh"

namespace {

constexpr int kMaxSpheres = 40;  // MAX_REPLAY_SPHERES in ops/kernels/replay.py
constexpr int kRecWords = 7;     // a bounce's record: o, d, hit id
constexpr int kCamPartials = 14;

// Threads a block by bucket, as the replay kernel's.
template <int NB>
constexpr int kBlockThreads = NB <= 16 ? 128 : 64;

template <int NB>
constexpr size_t smem_floats(int n_spheres) {
  return static_cast<size_t>(pt::scene_floats(n_spheres)) +
         (4 * NB + kCamPartials) * kBlockThreads<NB>;
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

// One bounce of the sweep: the VJP of the hit bounce k of the path (input
// ray o, d from the record, sphere h) for the adjoints (go, gd) of its
// outputs (the next origin and direction), which it replaces by those of
// its inputs; adds the sphere's p0 and radius terms to ``part``.
template <int T>
__device__ __forceinline__ void bounce_vjp(V3 o, V3 d, int h, int k, uint32_t k0, uint32_t k1,
                                           const float* table, const pt::Params& p,
                                           float* part, int row_p0, int row_r, V3& go, V3& gd) {
  const float* row = table + h * pt::kRowFloats;
  const V3 p0 = {row[0], row[1], row[2]};
  const V3 ad = {row[3], row[4], row[5]};
  const float r = row[6], r2x = row[7];
  // ---- the root, by hit_sphere's expressions ----
  const V3 q = o - p0;
  const float a = d.x * d.x + d.y * d.y + d.z * d.z;
  const float a_inv = 1.0f / a;
  const float qd = q.x * d.x + q.y * d.y + q.z * d.z;
  const float add = ad.x * d.x + ad.y * d.y + ad.z * d.z;
  const float b = qd + r * add;
  const float qq = q.x * q.x + q.y * q.y + q.z * q.z;
  const float qad = q.x * ad.x + q.y * ad.y + q.z * ad.z;
  const float c = qq + r2x * qad;
  const float disc = b * b - a * c;
  const bool tangent = disc == 0.0f;
  const float sq = sqrtf(disc >= 0.0f ? disc : 1.0f);
  const float sign_b = b >= 0.0f ? 1.0f : -1.0f;
  const float qf = -(b + (b >= 0.0f ? sq : -sq));
  const float r1 = qf * a_inv;
  const float rr2 = qf != 0.0f ? c / qf : p.inf;
  const float c1 = r1 >= p.eps ? r1 : p.inf, c2 = rr2 >= p.eps ? rr2 : p.inf;
  const float t = fminf(c1, c2);
  // torch.minimum / maximum split a double root's derivative evenly.
  const float w1 = r1 == rr2 ? 0.5f : (c1 < c2 ? 1.0f : 0.0f);
  const float w2 = 1.0f - w1;

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

  // ---- the hit record's VJP ----
  const V3 g_nr = normalize_vjp(nr, ninv, g_no);
  const V3 g_hp = go + g_nr;
  g_d = g_d + g_hp * t;
  const float g_t = dot(g_hp, d);

  // ---- the root's VJP ----
  const float g_r1 = g_t * w1, g_r2 = g_t * w2;
  const float g_qf = g_r1 * a_inv - g_r2 * c / (qf * qf);
  float g_c = g_r2 / qf;
  float g_a = -(g_r1 * qf) * a_inv * a_inv;
  float g_b = -g_qf;
  const float g_disc = tangent ? 0.0f : -sign_b * g_qf * 0.5f / sq;
  g_b = g_b + 2.0f * b * g_disc;
  g_a = g_a - c * g_disc;
  g_c = g_c - a * g_disc;
  const float g_rad = g_b * add + 2.0f * qad * g_c;
  const V3 g_q = d * g_b + q * (2.0f * g_c) + ad * (2.0f * r * g_c);
  g_d = g_d + q * g_b + ad * (g_b * r) + d * (2.0f * g_a);

  go = g_hp + g_q;
  gd = g_d;
  // p0 through q = o - p0 and the center p0 - r * ad; r through both.
  float* gp = part + (row_p0 + 3 * h) * T;
  gp[0] += -g_nr.x - g_q.x;
  gp[T] += -g_nr.y - g_q.y;
  gp[2 * T] += -g_nr.z - g_q.z;
  part[(row_r + h) * T] += g_rad + dot(g_nr, ad);
}

template <typename Index, int NB>
__global__ void __launch_bounds__(kBlockThreads<NB>)
geometry_replay_kernel(const float* __restrict__ table, const float* __restrict__ cam,
                       const float* __restrict__ ct, float* __restrict__ rows,
                       float* __restrict__ rec, unsigned long long* __restrict__ counters,
                       const pt::Params p) {
  constexpr int T = kBlockThreads<NB>;
  // Rows of the partials in shared memory, by bucket: p0, radius, camera.
  constexpr int kP0 = 0, kR = 3 * NB, kCam = 4 * NB, kRows = 4 * NB + kCamPartials;
  extern __shared__ __align__(16) float smem[];
  const int n = p.n_spheres;
  const float* s_table = smem;
  const float* s_cam = pt::load_scene(smem, table, cam, n);
  float* part = smem + pt::scene_floats(n) + threadIdx.x;  // this thread's column
#pragma unroll 1
  for (int k = 0; k < kRows; ++k) part[k * T] = 0.0f;

  // This thread's record: word w of bounce k at my_rec[(k * 7 + w) * stride].
  const size_t stride = static_cast<size_t>(gridDim.x) * T;
  float* my_rec = rec + static_cast<size_t>(blockIdx.x) * T + threadIdx.x;

  const Index warps = static_cast<Index>(gridDim.x) * (T / 32);
  const Index warp = static_cast<Index>(blockIdx.x) * (T / 32) + (threadIdx.x >> 5);
  Index next = 0;
  const Index end = pt::owned_positions<Index>(p.n_items, warp, warps);
  const Index n_items = static_cast<Index>(p.n_items);
  const unsigned int lane = threadIdx.x & 31;

  bool alive = false;
  Index item = 0;
  float ctx = 0.0f, cty = 0.0f, ctz = 0.0f;
  unsigned int phases = 0;          // warp-uniform
  unsigned long long segments = 0;  // warp-uniform
  unsigned long long swept = 0, missed = 0;  // this thread's
  pt::Path s;
  while (true) {
    const unsigned int idle = __ballot_sync(0xffffffffu, !alive);
    unsigned int live = ~idle;
    if (next < end && __popc(idle) >= pt::kRefillMin) {
      const Index at = next + static_cast<Index>(__popc(idle & pt::lanes_below()));
      const Index mine = pt::item_at<Index>(at, warp, warps);
      next += static_cast<Index>(__popc(idle));
      if (!alive && at < end && mine < n_items) {
        const size_t c = static_cast<size_t>(pt::start_path<Index>(s, mine, s_cam, p));
        ctx = ct[3 * c];
        cty = ct[3 * c + 1];
        ctz = ct[3 * c + 2];
        item = mine;
        alive = true;
      }
      live = __ballot_sync(0xffffffffu, alive);
    } else if (idle == 0xffffffffu) {
      break;
    }
    ++phases;
    segments += __popc(live);
    if (alive) {
      const int k = s.depth;
      float* slot = my_rec + static_cast<size_t>(k) * kRecWords * stride;
      slot[0] = s.ox;
      slot[stride] = s.oy;
      slot[2 * stride] = s.oz;
      slot[3 * stride] = s.dx;
      slot[4 * stride] = s.dy;
      slot[5 * stride] = s.dz;
      float rx, ry, rz;
      pt::BounceAux a;
      const bool done = pt::bounce<true>(s, s_table, s_cam, p, rx, ry, rz, a);
      slot[6 * stride] = __int_as_float(a.sidx);
      if (done) {
        alive = false;
        if (a.sidx < 0) {  // a miss at bounce k: the seed, then the sweep
          const float tcx = ctx * a.thr_x, tcy = cty * a.thr_y, tcz = ctz * a.thr_z;
          const float w = tcx * (s_cam[16] - s_cam[13]) + tcy * (s_cam[17] - s_cam[14]) +
                          tcz * (s_cam[18] - s_cam[15]);
          const V3 dk = {s.dx, s.dy, s.dz};
          const float dinv = pt::rsqrt_safe(dk.x * dk.x + dk.y * dk.y + dk.z * dk.z);
          const float h = 0.5f * w * dinv;
          V3 gd = dk * (-(h * dk.y * dinv * dinv));
          gd.y = gd.y + h;
          V3 go = {0.0f, 0.0f, 0.0f};
          for (int j = k - 1; j >= 0; --j) {
            const float* rj = my_rec + static_cast<size_t>(j) * kRecWords * stride;
            const V3 o = {rj[0], rj[stride], rj[2 * stride]};
            const V3 d = {rj[3 * stride], rj[4 * stride], rj[5 * stride]};
            bounce_vjp<T>(o, d, __float_as_int(rj[6 * stride]), j, s.k0, s.k1, s_table, p, part,
                          kP0, kR, go, gd);
          }
          // The primary ray's VJP (models/camera.get_rays).
          float scr_s, scr_t, du1, du2;
          camera_sample<Index>(item, p, scr_s, scr_t, du1, du2);
          const V3 d0 = {my_rec[3 * stride], my_rec[4 * stride], my_rec[5 * stride]};
          const V3 g_dir = gd + go * s_cam[19];
          const V3 g_off = go - g_dir;
          const float th = pt::kTwoPi * du2;
          const float g_lens = (scr_s + scr_t) * (cosf(th) * g_off.x + sinf(th) * g_off.y);
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
          swept += static_cast<unsigned long long>(k);
          missed += 1;
        }
      }
    }
  }

  for (int off = 16; off > 0; off >>= 1) {
    swept += __shfl_down_sync(0xffffffffu, swept, off);
    missed += __shfl_down_sync(0xffffffffu, missed, off);
  }
  if (lane == 0) {
    atomicAdd(&counters[0], segments);
    atomicMax(&counters[1], static_cast<unsigned long long>(phases));
    atomicAdd(&counters[2], swept);
    atomicAdd(&counters[3], static_cast<unsigned long long>(phases));
    atomicAdd(&counters[4], missed);
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
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) rows[static_cast<size_t>(blockIdx.x) * m_total + k] = v;
  }
}

using GeometryFn = void (*)(const float*, const float*, const float*, float*, float*,
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
// written), ``rec`` at least max_depth * 7 * blocks * threads float32 of
// scratch, ``counters`` 5 zeroed uint64 words.  Returns cudaGetLastError()
// after the launch.
int pt_geometry_replay(const float* table, const float* cam, const float* ct, float* rows,
                       float* rec, unsigned long long* counters, const pt::Params* params,
                       int index_bits, long long blocks, void* stream) {
  const pt::Params p = *params;
  if (bad_args(p.n_spheres, index_bits) || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Launch l = pick(index_bits, p.n_spheres);
  const cudaError_t err = allow_smem(l);
  if (err != cudaSuccess) return static_cast<int>(err);
  l.kernel<<<static_cast<unsigned int>(blocks), l.threads, l.smem,
             static_cast<cudaStream_t>(stream)>>>(table, cam, ct, rows, rec, counters, p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
