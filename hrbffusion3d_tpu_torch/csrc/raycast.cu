// Fused HRBF ray cast for Hopper (sm_90a), one thread per pixel.
//
// Replaces the TPU kernel hrbffusion3d_tpu/ops/pallas_kernels.py
// raycast_core / _raycast_kernel (predict_hrbf.frag): per pixel, keep the
// first K stable neighbours of the (2R+1)^2 ring-ordered window of the
// rendered attribute image, start at t0 = the nearest neighbour's projection
// onto the viewing ray, march a directed ladder until the HRBF field
//     f(x) = sum_k 20 (1 - r_k)^3 / T_k^2 * ((x - p_k) . 10 n_k),  r_k < 1
// changes sign, refine the root (false position, k-section or bisection),
// and return the HRBF gradient at the surface point plus the nearest tap.
//
// What bounds it on this card: the per-pixel evaluations of f, which are
// FLOPs (about 20 per tap per evaluation), not bytes: the input is 36 B per
// pixel and each pixel reads 49 taps of it, while one frame at 640x480 runs
// ~2 + |ladder| + refinement evaluations per pixel.  The TPU kernel had to
// evaluate all 49 taps under a mask in every evaluation because of its lane
// layout.  Here:
//   - each 16x16 block stages its (16+2R)^2 x 9-float halo tile in shared
//     memory once (17 KB at R=3), so the 49 tap reads hit shared memory;
//   - each thread compacts its <= K selected taps (position, Hermite-scaled
//     normal, T^2, 1/T^2, ring index) into registers once, so every field
//     evaluation loops over <= K taps instead of 49;
//   - each thread leaves the ladder as soon as it brackets the root.
// Semantics follow the Pallas kernel exactly (ring order, strict d2 < T2
// field mask, first-minimum nearest tap, bracket rules, 1e-30 guards).
// No library kernel is called.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kChannels = 9;   // pos(3) | nrm(3) | conf | radius | valid
constexpr int kMaxK = 16;      // neighbour cap (cfg.predict_max_neighbors)
constexpr int kMaxLadder = 64; // ladder taps (cfg.raycast_coarse_steps)
constexpr int kMaxRadius = 7;  // window radius (cfg.predict_window_multiplier)

struct Params {
  int h, w, radius, k, kmin, n_ladder, fp_iters, bis_iters;
  int ksec_b, ksec_p;  // k-section: points per pass (> 1 to use it), passes
  float conf_t, fx, fy, cx, cy;
  float ladder[kMaxLadder];  // offset * step, ascending, in metres
};

struct Taps {
  float px[kMaxK], py[kMaxK], pz[kMaxK];
  float cx[kMaxK], cy[kMaxK], cz[kMaxK];
  float t2[kMaxK], it2[kMaxK];
  int ring[kMaxK];
  int n;
};

// f at t * ray, and the number of taps whose support holds the point.
__device__ __forceinline__ float field(const Taps& T, float t, float rx,
                                       float ry, float rz, int* support) {
  const float qx = t * rx, qy = t * ry, qz = t * rz;
  float f = 0.f;
  int cnt = 0;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < T.n) {
      const float vx = qx - T.px[k];
      const float vy = qy - T.py[k];
      const float vz = qz - T.pz[k];
      const float d2 = vx * vx + vy * vy + vz * vz;
      if (d2 < T.t2[k]) {
        const float r = sqrtf(d2 * T.it2[k]);
        const float s = fmaxf(1.f - r, 0.f);
        const float vc = vx * T.cx[k] + vy * T.cy[k] + vz * T.cz[k];
        f += 20.f * (s * s * s) * T.it2[k] * vc;
        ++cnt;
      }
    }
  }
  if (support) *support = cnt;
  return f;
}

__device__ __forceinline__ float clipf(float x, float a, float b) {
  return fminf(fmaxf(x, fminf(a, b)), fmaxf(a, b));
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
raycast_kernel(const float* __restrict__ attr, float* __restrict__ p_surf,
               float* __restrict__ grad, int32_t* __restrict__ nearest,
               uint8_t* __restrict__ found, const Params p) {
  extern __shared__ float tile[];  // [(kBlockY+2R) x (kBlockX+2R) x 9]
  const int R = p.radius;
  const int tw = kBlockX + 2 * R;
  const int th = kBlockY + 2 * R;
  const int x0 = blockIdx.x * kBlockX - R;
  const int y0 = blockIdx.y * kBlockY - R;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  // stage the halo tile; outside the image is zero (valid = 0)
  for (int i = tid; i < tw * th * kChannels; i += kBlockX * kBlockY) {
    const int c = i % kChannels;
    const int xy = i / kChannels;
    const int gx = x0 + xy % tw;
    const int gy = y0 + xy / tw;
    float v = 0.f;
    if (gx >= 0 && gx < p.w && gy >= 0 && gy < p.h)
      v = attr[(static_cast<int64_t>(gy) * p.w + gx) * kChannels + c];
    tile[i] = v;
  }
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= p.w || y >= p.h) return;

  // viewing ray (pallas_kernels.py:221-224)
  float rx = (static_cast<float>(x) - p.cx) / p.fx;
  float ry = (static_cast<float>(y) - p.cy) / p.fy;
  const float rn = 1.f / sqrtf(rx * rx + ry * ry + 1.f);
  rx *= rn;
  ry *= rn;
  const float rz = rn;

  // stability filter + ring-order K cap + t0 (pallas_kernels.py:236-250);
  // rings by Chebyshev distance, (dy, dx) lexicographic within a ring
  Taps T;
  T.n = 0;
  float t0 = 1e6f;
  int j = 0;
  for (int ring = 0; ring <= R; ++ring) {
    for (int dy = -ring; dy <= ring; ++dy) {
      for (int dx = -ring; dx <= ring; ++dx) {
        if (max(abs(dy), abs(dx)) != ring) continue;
        const float* a = tile + ((threadIdx.y + R + dy) * tw +
                                 (threadIdx.x + R + dx)) * kChannels;
        const float px = a[0], py = a[1], pz = a[2];
        const float nx = a[3], ny = a[4], nz = a[5];
        const bool ok = a[8] > 0.5f && pz > 0.1f &&
                        nx * nx + ny * ny + nz * nz > 0.01f &&
                        a[6] >= p.conf_t && nz > 0.f;
        if (ok && T.n < p.k) {
          const float T2 = a[7] * a[7];
#pragma unroll
          for (int k = 0; k < kMaxK; ++k) {
            if (k == T.n) {
              T.px[k] = px; T.py[k] = py; T.pz[k] = pz;
              T.cx[k] = 10.f * nx; T.cy[k] = 10.f * ny; T.cz[k] = 10.f * nz;
              T.t2[k] = T2;
              T.it2[k] = 1.f / fmaxf(T2, 1e-12f);
              T.ring[k] = j;
            }
          }
          ++T.n;
          t0 = fminf(t0, fabsf(px * rx + py * ry + pz * rz));
        }
        ++j;
      }
    }
  }

  // f0 and the support count at t0 (l.297-311); enough gate (l.320)
  int ncnt = 0;
  const float f0 = field(T, t0, rx, ry, rz, &ncnt);
  const bool enough = T.n > p.kmin && ncnt > p.kmin;
  const bool go_back = f0 > 0.f;
  const float sgn = go_back ? -1.f : 1.f;

  // directed ladder: first sign change vs f0 brackets the root (l.327-360)
  bool fnd = false;
  float t_lo = 1e6f, t_hi = 1e6f, f_lo = 0.f, f_hi = 0.f;
  float f_prev = f0, prev = 0.f;
  for (int i = 0; i < p.n_ladder; ++i) {
    const float off = p.ladder[i];
    const float t_i = t0 + sgn * off;
    const float t_p = t0 + sgn * prev;
    const float fv = field(T, t_i, rx, ry, rz, nullptr);
    if (fv * sgn > 0.f) {
      t_lo = go_back ? t_i : t_p;
      t_hi = go_back ? t_p : t_i;
      f_lo = go_back ? fv : f_prev;
      f_hi = go_back ? f_prev : fv;
      fnd = true;
      break;
    }
    f_prev = fv;
    prev = off;
  }
  const bool is_found = enough && fnd;

  // root refinement (l.386-433)
  float t_surf;
  if (p.fp_iters > 0) {
    for (int it = 0; it < p.fp_iters; ++it) {
      float den = f_hi - f_lo;
      den = fabsf(den) > 1e-30f ? den : 1e-30f;
      const float mid = clipf(t_lo - f_lo * (t_hi - t_lo) / den, t_lo, t_hi);
      const float fm = field(T, mid, rx, ry, rz, nullptr);
      if (fm < 0.f) {
        t_lo = mid;
        f_lo = fm;
      } else {
        t_hi = mid;
        f_hi = fm;
      }
    }
    float den = f_hi - f_lo;
    den = fabsf(den) > 1e-30f ? den : 1e-30f;
    t_surf = clipf(t_lo - f_lo * (t_hi - t_lo) / den, t_lo, t_hi);
  } else if (p.ksec_b > 1) {
    // k-section (l.408-423): B interior points per pass; with the invariant
    // f(t_lo) < 0 <= f(t_hi) the crossing lies after the last negative one
    const float inv = 1.f / (static_cast<float>(p.ksec_b) + 1.f);
    for (int it = 0; it < p.ksec_p; ++it) {
      const float wdt = (t_hi - t_lo) * inv;
      int neg = 0;
      for (int k = 1; k <= p.ksec_b; ++k)
        if (field(T, t_lo + wdt * static_cast<float>(k), rx, ry, rz, nullptr) < 0.f) ++neg;
      t_lo = t_lo + static_cast<float>(neg) * wdt;
      t_hi = t_lo + wdt;
    }
    t_surf = 0.5f * (t_lo + t_hi);
  } else {
    for (int it = 0; it < p.bis_iters; ++it) {
      const float mid = 0.5f * (t_lo + t_hi);
      if (field(T, mid, rx, ry, rz, nullptr) < 0.f)
        t_lo = mid;
      else
        t_hi = mid;
    }
    t_surf = 0.5f * (t_lo + t_hi);
  }
  const float sx = t_surf * rx, sy = t_surf * ry, sz = t_surf * rz;

  // HRBF gradient at the surface point + first nearest tap (l.437-464)
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  float best_d2 = 1e12f;
  int best_j = 0;
#pragma unroll
  for (int k = 0; k < kMaxK; ++k) {
    if (k < T.n) {
      const float vx = sx - T.px[k];
      const float vy = sy - T.py[k];
      const float vz = sz - T.pz[k];
      const float d2 = vx * vx + vy * vy + vz * vz;
      const float it2 = T.it2[k];
      if (d2 <= T.t2[k] && d2 > 0.f) {
        const float r = sqrtf(d2 * it2);
        const float safe_r = fmaxf(r, 1e-20f);
        const float s = fmaxf(1.f - r, 0.f);
        const float vc = vx * T.cx[k] + vy * T.cy[k] + vz * T.cz[k];
        const float a = -20.f * (s * s * s) * it2;
        const float b = 60.f * (s * s / safe_r) * (it2 * it2);
        g0 -= a * T.cx[k] + b * vc * vx;
        g1 -= a * T.cy[k] + b * vc * vy;
        g2 -= a * T.cz[k] + b * vc * vz;
      } else if (d2 == 0.f) {
        const float a0 = -20.f * it2;
        g0 -= a0 * T.cx[k];
        g1 -= a0 * T.cy[k];
        g2 -= a0 * T.cz[k];
      }
      if (d2 < best_d2) {
        best_d2 = d2;
        best_j = T.ring[k];
      }
    }
  }

  const int64_t pix = static_cast<int64_t>(y) * p.w + x;
  p_surf[pix * 3 + 0] = sx;
  p_surf[pix * 3 + 1] = sy;
  p_surf[pix * 3 + 2] = sz;
  grad[pix * 3 + 0] = g0;
  grad[pix * 3 + 1] = g1;
  grad[pix * 3 + 2] = g2;
  nearest[pix] = best_j;
  found[pix] = is_found ? 1 : 0;
}

}  // namespace

// Plain C entry point (bound with ctypes).  ``ladder`` is a host array of
// ``n_ladder`` offsets in metres.  Refinement: false position when
// ``fp_iters`` > 0, else k-section when ``ksec_b`` > 1, else bisection.  Launches on ``stream`` and returns
// cudaGetLastError() of the launch (0 = success); returns
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int raycast_core_launch(
    const float* attr, float* p_surf, float* grad, int32_t* nearest,
    uint8_t* found, int h, int w, int radius, int k, int kmin, float conf_t,
    const float* ladder, int n_ladder, int fp_iters, int bis_iters,
    int ksec_b, int ksec_p, float fx, float fy, float cx, float cy,
    void* stream) {
  if (h <= 0 || w <= 0 || radius < 0 || radius > kMaxRadius || k < 0 ||
      k > kMaxK || n_ladder < 0 || n_ladder > kMaxLadder || fp_iters < 0 ||
      bis_iters < 0 || ksec_b < 1 || ksec_p < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.h = h; p.w = w; p.radius = radius; p.k = k; p.kmin = kmin;
  p.n_ladder = n_ladder; p.fp_iters = fp_iters; p.bis_iters = bis_iters;
  p.ksec_b = ksec_b; p.ksec_p = ksec_p;
  p.conf_t = conf_t; p.fx = fx; p.fy = fy; p.cx = cx; p.cy = cy;
  for (int i = 0; i < kMaxLadder; ++i) p.ladder[i] = i < n_ladder ? ladder[i] : 0.f;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  const size_t smem = static_cast<size_t>(kBlockX + 2 * radius) *
                      (kBlockY + 2 * radius) * kChannels * sizeof(float);
  raycast_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      attr, p_surf, grad, nearest, found, p);
  return static_cast<int>(cudaGetLastError());
}
