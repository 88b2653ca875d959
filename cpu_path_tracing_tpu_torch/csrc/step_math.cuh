// Per-path step math of the forward render: the CUDA counterpart of
// make_step_math in cpu_path_tracing_tpu/ops/pallas/megakernel.py.
//
// One thread owns one path.  start_path() is the regeneration block (item
// key, lens-disk draws, thin-lens camera ray); bounce() is one bounce:
// two Threefry blocks of uniforms, the N-sphere anchor-point intersect,
// sky on a miss, emission pickup, Russian roulette, the three material
// samplers and the depth limit.  The expressions are those of the plain
// PyTorch version (ops/intersect.py, ops/materials.py,
// ops/integrator.py), term for term, so that both round alike:
//   * 1/sqrtf(x), never rsqrtf: rsqrtf is not correctly rounded;
//   * precise sqrtf, division, sinf and cosf (the build never passes
//     --use_fast_math); min/max propagate NaN, as torch.minimum does;
//   * the intersect has no disc >= 0 guard: sqrtf of a negative is NaN,
//     every comparison with NaN is false, and the sphere falls through to
//     the miss sentinel, which is what the guarded form gives.
// Only the chosen material's sampler is computed.  The plain version
// blends all three with exact 0/1 masks, which gives the same direction.
//
// bounce<true> also fills a BounceAux with the internals the replay
// backward consumes (csrc/replay.cu; make_step_math(with_aux=True) in the
// JAX package); bounce<false>, the forward kernel's, compiles without them.

#pragma once

#include <cstdint>

namespace pt {

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
  float thr_x, thr_y, thr_z;  // throughput before this bounce's update
  float eh_x, eh_y, eh_z;     // the hit sphere's emission (hit only)
  float sky_x, sky_y, sky_z;  // background radiance (miss only)
  float sky_t;               // its lerp parameter (miss only)
  bool cont;                 // hit and not killed by the roulette
  bool rr_scaled;            // roulette applied and survived: colf = 1/p
};

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
// screen_coords + models/camera.py get_rays; uniform jitter).
__device__ __forceinline__ void start_path(Path& s, long long item, const float* cam,
                                           const Params& p) {
  const long long c_idx = item % p.n_cells;
  const long long smp = p.sample_start + item / p.n_cells;
  const long long cell = min(p.cell_start + c_idx, p.total_cells - 1);
  uint32_t a0, a1, c0, c1;
  threefry2x32(p.key0, p.key1, static_cast<uint32_t>(cell), static_cast<uint32_t>(smp), a0, a1);
  threefry2x32(a0, a1, 0u, 0u, c0, c1);  // purpose 0: the lens-disk pair
  const float jx = u01(a0), jy = u01(a1), du1 = u01(c0), du2 = u01(c1);

  const int ns2 = p.ns * p.ns;
  const long long sub = cell % ns2, pix = cell / ns2;
  const float px = static_cast<float>(pix % p.width);
  const float py = static_cast<float>(pix / p.width);
  const float sxf = static_cast<float>(sub % p.ns);
  const float syf = static_cast<float>(sub / p.ns);
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
}

// One bounce of a live path.  Returns true when the path ended; its
// radiance is then in (rx, ry, rz).  With kAux, ``aux`` describes the
// bounce; a miss has sidx -1 and cont and rr_scaled false.
template <bool kAux>
__device__ __forceinline__ bool bounce(Path& s, const float* table, const float* cam,
                                       const Params& p, float& rx, float& ry, float& rz,
                                       BounceAux& aux) {
  // Bounce uniforms: purpose depth+1, blocks 0 and 1; the 4th word is the
  // reserved u_c (ops/rng.py).
  const uint32_t purpose = static_cast<uint32_t>(s.depth + 1);
  uint32_t b0, b1, b2, b3;
  threefry2x32(s.k0, s.k1, purpose, 0u, b0, b1);
  threefry2x32(s.k0, s.k1, purpose, 1u, b2, b3);
  const float u_rr = u01(b0), u_a = u01(b1), u_b = u01(b2);

  const float ox = s.ox, oy = s.oy, oz = s.oz;
  const float dx = s.dx, dy = s.dy, dz = s.dz;

  // ---- intersect: every sphere, lowest index wins ties (strict <) ----
  const float a_quad = dx * dx + dy * dy + dz * dz;
  const float a_inv = 1.0f / a_quad;
  float t_best = p.inf;
  int best = -1;
  for (int j = 0; j < p.n_spheres; ++j) {
    const float* row = table + j * kTableCols;
    const float qx = ox - row[0], qy = oy - row[1], qz = oz - row[2];
    const float qd = qx * dx + qy * dy + qz * dz;
    const float add = row[3] * dx + row[4] * dy + row[5] * dz;
    const float b = qd + row[6] * add;
    const float qq = qx * qx + qy * qy + qz * qz;
    const float qad = qx * row[3] + qy * row[4] + qz * row[5];
    const float c = qq + 2.0f * row[6] * qad;
    const float disc = b * b - a_quad * c;
    const float sq = sqrtf(disc);  // NaN when there is no root: see above
    const float sgn = b >= 0.0f ? 1.0f : -1.0f;
    const float qf = -(b + sgn * sq);
    const float r1 = qf * a_inv;
    const float r2 = qf != 0.0f ? c / qf : p.inf;
    const float tn = nan_min(r1, r2), tf = nan_max(r1, r2);
    const float root = tn >= p.eps ? tn : (tf >= p.eps ? tf : p.inf);
    if (root < t_best) {
      t_best = root;
      best = j;
    }
  }

  if constexpr (kAux) {
    aux.sidx = best;
    aux.thr_x = s.thx;
    aux.thr_y = s.thy;
    aux.thr_z = s.thz;
    aux.cont = false;
    aux.rr_scaled = false;
  }

  // ---- miss: background gradient (src/main.cpp:115-120) ----
  const float dinv = rsqrt_safe(a_quad);
  if (best < 0) {
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
    return true;
  }

  // ---- hit record: outward normal = normalized (hit - center) ----
  const float* hs = table + best * kTableCols;
  const float hx = ox + t_best * dx, hy = oy + t_best * dy, hz = oz + t_best * dz;
  const float nrx = hx - hs[7], nry = hy - hs[8], nrz = hz - hs[9];
  const float ninv = rsqrt_safe(nrx * nrx + nry * nry + nrz * nrz);
  const float nox = nrx * ninv, noy = nry * ninv, noz = nrz * ninv;
  const float ndotd = nox * dx + noy * dy + noz * dz;
  const bool front = ndotd < 0.0f;
  const float fsign = front ? 1.0f : -1.0f;
  const float nx = nox * fsign, ny = noy * fsign, nz = noz * fsign;

  // ---- emission pickup, then Russian roulette (src/main.cpp:126-137) ----
  const float alx = hs[13], aly = hs[14], alz = hs[15];
  if constexpr (kAux) {
    aux.eh_x = hs[10];
    aux.eh_y = hs[11];
    aux.eh_z = hs[12];
  }
  s.emx = s.emx + s.thx * hs[10];
  s.emy = s.emy + s.thy * hs[11];
  s.emz = s.emz + s.thz * hs[12];
  const float pmax = nan_max(alx, nan_max(aly, alz));  // uncapped
  const bool do_rr = s.depth > p.rr_depth;
  const bool survive = u_rr < pmax;
  if (do_rr && !survive) {
    rx = s.emx;
    ry = s.emy;
    rz = s.emz;
    return true;
  }
  const float colf = do_rr ? 1.0f / (pmax > 0.0f ? pmax : 1.0f) : 1.0f;
  if constexpr (kAux) {
    aux.cont = true;  // the depth limit below ends the path after the update
    aux.rr_scaled = do_rr;
  }

  // ---- scatter (src/main.cpp:141-154) ----
  const float mcode = hs[16];
  float dnx, dny, dnz;
  if (mcode < 0.5f) {
    // diffuse: cosine-weighted hemisphere (src/main.cpp:44-58)
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
  } else {
    // specular reflection about the outward normal (src/main.cpp:60-67)
    dnx = dx - 2.0f * nox * ndotd;
    dny = dy - 2.0f * noy * ndotd;
    dnz = dz - 2.0f * noz * ndotd;
    if (mcode > 1.5f) {
      // dielectric: Schlick reflect-or-refract lottery (src/main.cpp:69-97)
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
    }
  }

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
  if (s.depth >= p.max_depth) {  // depth exhaustion (src/main.cpp:157)
    rx = s.emx;
    ry = s.emy;
    rz = s.emz;
    return true;
  }
  return false;
}

}  // namespace pt
