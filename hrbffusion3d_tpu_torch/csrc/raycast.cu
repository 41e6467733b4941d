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
// float32 instructions (about 11 per tap per evaluation, and a MUFU square
// root), not bytes: the input is 36 B per pixel, while a pixel runs
// ~2 + |ladder| + refinement evaluations over <= K taps.  Each evaluation
// depends on the one before it, so the kernel runs at the latency of those
// chains unless enough warps are resident and each chain has independent
// work in it; registers decide the first.  This design:
//   - templates the kernel on the tap cap (10, the configured K, and 16),
//     and launch-bounds the K = 10 instance to two blocks of 256 threads
//     per SM (<= 128 registers, 16 warps);
//   - stages the (16+2R)^2 halo tile in shared memory once per block, as
//     structure-of-arrays planes of what every tap needs and that does not
//     depend on the centre pixel: position, the Hermite coefficient with
//     the field's weight folded in (h = 20/T^2 * 10 n), T^2 and 1/T^2, and
//     the stability flag, so the one division per tap is made per tile
//     pixel, not per tap;
//   - walks the ring table (built by the wrapper from ring_taps(R), passed
//     in the kernel parameters) once and stops at K selections; the
//     selected taps' tile offsets and ring indices go to shared memory;
//   - keeps each selected tap in registers as 6 floats seen from the ray
//     relative to t0 (Taps below), not 8 of world geometry: with 8 the
//     K = 10 instance spilled at 128 registers, and an evaluation now costs
//     3 multiply-adds instead of 9 to form |v|^2 and v.h;
//   - evaluates the ladder kLadderBatch taps at a time: the loop over taps
//     is outside, so each tap's registers feed that many independent
//     accumulators; the first sign change is then taken in ladder order, so
//     the bracket is the serial walk's.  The k-section's points per pass
//     are evaluated the same way;
//   - forms the gradient and the nearest tap once, from the tile;
//   - lets a pixel with no stable tap write its (exact) empty result at once.
// Semantics follow the Pallas kernel (ring order, strict d2 < T2 field mask,
// first-minimum nearest tap, bracket rules, 1e-30 guards); folding 20/T^2
// into h and forming |v|^2 from t0 change the rounding of f, not its rules.
// No library kernel is called.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 16;
constexpr int kBlockY = 16;
constexpr int kThreads = kBlockX * kBlockY;
constexpr int kChannels = 9;     // input: pos(3) | nrm(3) | conf | radius | valid
constexpr int kPlanes = 8;       // tile: pos(3) | h(3) | T^2 | 1/T^2
constexpr int kMaxLadder = 64;   // ladder taps (cfg.raycast_coarse_steps)
constexpr int kMaxRadius = 7;    // window radius (cfg.predict_window_multiplier)
constexpr int kMaxRing = (2 * kMaxRadius + 1) * (2 * kMaxRadius + 1);
constexpr int kLadderBatch = 4;  // ladder / k-section points per tap pass
constexpr int kRingGroup = 8;    // ring taps tested per pass of the walk

struct Params {
  int h, w, radius, k, kmin, n_ladder, fp_iters, bis_iters;
  int ksec_b, ksec_p;  // k-section: points per pass (> 1 to use it), passes
  float conf_t, fx, fy, cx, cy;
  float ladder[kMaxLadder];    // offset * step, ascending, in metres
  int16_t ring_off[kMaxRing];  // tile offset of each ring-ordered tap
};

// The selected taps seen from the ray, relative to t0: with w = t0 ray - p
// and h = 20/T^2 10 n, the point t ray = (t0 + u) ray of the ray has
//   v = w + u ray,  |v|^2 = |w|^2 + u (2 w.ray + u),  v.h = w.h + u ray.h,
// so a tap needs 6 floats in registers and an evaluation 2 multiply-adds
// for |v|^2 and one for v.h.  Every term is of the size of the support
// (cm), not of the depth (m), so this loses no more to rounding than
// t ray - p does.
// sqrt.approx: one MUFU instruction, relative error below 2^-22, where
// sqrtf's IEEE rounding costs ~8 instructions; an evaluation of f feeds
// only a sign test and a secant, which that rounding moves by far less
// than the check's 1e-4 m
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

template <int KM>
struct Taps {
  float e[KM];         // |w|^2
  float a2[KM];        // 2 w.ray
  float wh[KM], rh[KM];  // w.h, ray.h
  float t2[KM], it2[KM];  // T^2 (-1 for an empty slot), 1 / T^2
};

// f at (t0 + u[g]) ray for G points; each tap's registers are read once
// for all of them.
template <int KM, int G>
__device__ __forceinline__ void field(const Taps<KM>& T, const float (&u)[G],
                                      float (&f)[G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) f[g] = 0.f;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float d2 = fmaxf(T.e[k] + u[g] * (T.a2[k] + u[g]), 0.f);
      const float r = sqrt_approx(d2 * T.it2[k]);
      const float s = d2 < T.t2[k] ? fmaxf(1.f - r, 0.f) : 0.f;
      f[g] += (s * s * s) * (T.wh[k] + u[g] * T.rh[k]);
    }
  }
}

template <int KM>
__device__ __forceinline__ float field1(const Taps<KM>& T, float u) {
  const float us[1] = {u};
  float f[1];
  field<KM, 1>(T, us, f);
  return f[0];
}

__device__ __forceinline__ float clipf(float x, float a, float b) {
  return fminf(fmaxf(x, fminf(a, b)), fmaxf(a, b));
}

__host__ __device__ constexpr int tile_pixels(int radius) {
  return (kBlockX + 2 * radius) * (kBlockY + 2 * radius);
}

// dynamic shared memory: kPlanes float planes, the selected taps' tile
// offsets (uint16) and ring indices (uint8), one stability byte per pixel
__host__ __device__ constexpr size_t smem_bytes(int radius, int km) {
  return static_cast<size_t>(tile_pixels(radius)) * (kPlanes * 4 + 1) +
         static_cast<size_t>(km) * kThreads * 3;
}

template <int KM>
__global__ void __launch_bounds__(kThreads, KM <= 10 ? 2 : 1)
raycast_kernel(const float* __restrict__ attr, float* __restrict__ p_surf,
               float* __restrict__ grad, int32_t* __restrict__ nearest,
               uint8_t* __restrict__ found, const Params p) {
  extern __shared__ float smem[];
  const int R = p.radius;
  const int tw = kBlockX + 2 * R;
  const int n_pix = tile_pixels(R);
  float* s_px = smem;
  float* s_py = s_px + n_pix;
  float* s_pz = s_py + n_pix;
  float* s_hx = s_pz + n_pix;
  float* s_hy = s_hx + n_pix;
  float* s_hz = s_hy + n_pix;
  float* s_t2 = s_hz + n_pix;
  float* s_it2 = s_t2 + n_pix;
  uint16_t* s_sel = reinterpret_cast<uint16_t*>(s_it2 + n_pix);  // [KM][threads]
  uint8_t* s_ring = reinterpret_cast<uint8_t*>(s_sel + KM * kThreads);
  uint8_t* s_ok = s_ring + KM * kThreads;                       // [n_pix]
  const int x0 = blockIdx.x * kBlockX - R;
  const int y0 = blockIdx.y * kBlockY - R;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;

  // stage the halo tile: the centre-independent per-tap terms; outside the
  // image a tap is unstable (valid = 0)
  for (int i = tid; i < n_pix; i += kThreads) {
    const int gx = x0 + i % tw;
    const int gy = y0 + i / tw;
    float a[kChannels] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (gx >= 0 && gx < p.w && gy >= 0 && gy < p.h) {
      const float* src = attr + (static_cast<int64_t>(gy) * p.w + gx) * kChannels;
#pragma unroll
      for (int c = 0; c < kChannels; ++c) a[c] = src[c];
    }
    const float nx = a[3], ny = a[4], nz = a[5];
    s_ok[i] = a[8] > 0.5f && a[2] > 0.1f && nx * nx + ny * ny + nz * nz > 0.01f &&
              a[6] >= p.conf_t && nz > 0.f;
    const float T2 = a[7] * a[7];
    const float it2 = 1.f / fmaxf(T2, 1e-12f);
    const float w20 = 20.f * it2;
    s_px[i] = a[0]; s_py[i] = a[1]; s_pz[i] = a[2];
    s_hx[i] = w20 * (10.f * nx); s_hy[i] = w20 * (10.f * ny); s_hz[i] = w20 * (10.f * nz);
    s_t2[i] = T2;
    s_it2[i] = it2;
  }
  __syncthreads();

  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  if (x >= p.w || y >= p.h) return;
  const int64_t pix = static_cast<int64_t>(y) * p.w + x;

  // viewing ray (pallas_kernels.py:221-224)
  float rx = (static_cast<float>(x) - p.cx) / p.fx;
  float ry = (static_cast<float>(y) - p.cy) / p.fy;
  const float rn = 1.f / sqrtf(rx * rx + ry * ry + 1.f);
  rx *= rn;
  ry *= rn;
  const float rz = rn;

  // stability filter + ring-order K cap + t0 (pallas_kernels.py:236-250):
  // the first K stable taps in ring order; no later tap changes the result
  const int ci = (threadIdx.y + R) * tw + threadIdx.x + R;
  const int n_ring = (2 * R + 1) * (2 * R + 1);
  int n = 0;
  float t0 = 1e6f;
  // kRingGroup flags are read together, so their loads overlap
  for (int j0 = 0; j0 < n_ring && n < p.k; j0 += kRingGroup) {
    bool ok[kRingGroup];
#pragma unroll
    for (int q = 0; q < kRingGroup; ++q)
      ok[q] = j0 + q < n_ring && s_ok[ci + p.ring_off[j0 + q]];
#pragma unroll
    for (int q = 0; q < kRingGroup; ++q) {
      if (!ok[q] || n >= p.k) continue;
      const int o = ci + p.ring_off[j0 + q];
      s_sel[n * kThreads + tid] = static_cast<uint16_t>(o);
      s_ring[n * kThreads + tid] = static_cast<uint8_t>(j0 + q);
      ++n;
      t0 = fminf(t0, fabsf(s_px[o] * rx + s_py[o] * ry + s_pz[o] * rz));
    }
  }
  if (n == 0) {
    // no tap: f = 0 everywhere, nothing brackets, every refinement leaves
    // t = 1e6, the gradient is 0 and the nearest tap 0
    p_surf[pix * 3 + 0] = 1e6f * rx;
    p_surf[pix * 3 + 1] = 1e6f * ry;
    p_surf[pix * 3 + 2] = 1e6f * rz;
    grad[pix * 3 + 0] = 0.f;
    grad[pix * 3 + 1] = 0.f;
    grad[pix * 3 + 2] = 0.f;
    nearest[pix] = 0;
    found[pix] = 0;
    return;
  }

  // the taps from the ray (Taps); the support count at t0 on the way
  Taps<KM> T;
  int ncnt = 0;
  const float qx = t0 * rx, qy = t0 * ry, qz = t0 * rz;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    const bool used = k < n;
    const int o = used ? s_sel[k * kThreads + tid] : ci;
    const float wx = qx - s_px[o], wy = qy - s_py[o], wz = qz - s_pz[o];
    const float hx = s_hx[o], hy = s_hy[o], hz = s_hz[o];
    const float e = wx * wx + wy * wy + wz * wz;
    T.e[k] = used ? e : 0.f;
    T.a2[k] = used ? 2.f * (wx * rx + wy * ry + wz * rz) : 0.f;
    T.wh[k] = used ? wx * hx + wy * hy + wz * hz : 0.f;
    T.rh[k] = used ? rx * hx + ry * hy + rz * hz : 0.f;
    T.it2[k] = used ? s_it2[o] : 0.f;
    T.t2[k] = used ? s_t2[o] : -1.f;  // an empty slot is outside every test
    ncnt += used && e < T.t2[k] ? 1 : 0;
  }

  // f0 and the support count at t0 (l.297-311); enough gate (l.320)
  const float f0 = field1(T, 0.f);
  const bool enough = n > p.kmin && ncnt > p.kmin;
  const bool go_back = f0 > 0.f;
  const float sgn = go_back ? -1.f : 1.f;

  // directed ladder, kLadderBatch taps per pass: the first sign change vs
  // f0, in ladder order, brackets the root (l.327-360)
  bool fnd = false;
  float t_lo = 1e6f, t_hi = 1e6f, f_lo = 0.f, f_hi = 0.f;
  float f_prev = f0, prev = 0.f;
  for (int b = 0; b < p.n_ladder && !fnd; b += kLadderBatch) {
    float tb[kLadderBatch], ub[kLadderBatch], fb[kLadderBatch];
#pragma unroll
    for (int g = 0; g < kLadderBatch; ++g) {
      tb[g] = t0 + sgn * p.ladder[min(b + g, p.n_ladder - 1)];
      ub[g] = tb[g] - t0;
    }
    field<KM, kLadderBatch>(T, ub, fb);
#pragma unroll
    for (int g = 0; g < kLadderBatch; ++g) {
      if (fnd || b + g >= p.n_ladder) continue;
      if (fb[g] * sgn > 0.f) {
        const float t_p = t0 + sgn * prev;
        t_lo = go_back ? tb[g] : t_p;
        t_hi = go_back ? t_p : tb[g];
        f_lo = go_back ? fb[g] : f_prev;
        f_hi = go_back ? f_prev : fb[g];
        fnd = true;
      } else {
        f_prev = fb[g];
        prev = p.ladder[b + g];
      }
    }
  }
  const bool is_found = enough && fnd;

  // root refinement (l.386-433)
  float t_surf;
  if (p.fp_iters > 0) {
    for (int it = 0; it < p.fp_iters; ++it) {
      float den = f_hi - f_lo;
      den = fabsf(den) > 1e-30f ? den : 1e-30f;
      const float mid = clipf(t_lo - f_lo * (t_hi - t_lo) / den, t_lo, t_hi);
      const float fm = field1(T, mid - t0);
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
    // k-section (l.408-423): B interior points per pass, kLadderBatch per
    // tap pass; with the invariant f(t_lo) < 0 <= f(t_hi) the crossing lies
    // after the last negative one
    const float inv = 1.f / (static_cast<float>(p.ksec_b) + 1.f);
    for (int it = 0; it < p.ksec_p; ++it) {
      const float wdt = (t_hi - t_lo) * inv;
      int neg = 0;
      for (int k0 = 1; k0 <= p.ksec_b; k0 += kLadderBatch) {
        float ub[kLadderBatch], fb[kLadderBatch];
#pragma unroll
        for (int g = 0; g < kLadderBatch; ++g)
          ub[g] = t_lo + wdt * static_cast<float>(min(k0 + g, p.ksec_b)) - t0;
        field<KM, kLadderBatch>(T, ub, fb);
#pragma unroll
        for (int g = 0; g < kLadderBatch; ++g)
          neg += k0 + g <= p.ksec_b && fb[g] < 0.f ? 1 : 0;
      }
      t_lo = t_lo + static_cast<float>(neg) * wdt;
      t_hi = t_lo + wdt;
    }
    t_surf = 0.5f * (t_lo + t_hi);
  } else {
    for (int it = 0; it < p.bis_iters; ++it) {
      const float mid = 0.5f * (t_lo + t_hi);
      if (field1(T, mid - t0) < 0.f)
        t_lo = mid;
      else
        t_hi = mid;
    }
    t_surf = 0.5f * (t_lo + t_hi);
  }
  const float sx = t_surf * rx, sy = t_surf * ry, sz = t_surf * rz;

  // HRBF gradient at the surface point + first nearest tap (l.437-464),
  // from the tile (v = x - p as the TPU kernel forms it); with
  // h = 20/T^2 c:  a c = -s^3 h,  b (v.c) v = 3 (s^2/r) / T^2 (v.h) v
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  float best_d2 = 1e12f;
  int best_k = 0;
#pragma unroll
  for (int k = 0; k < KM; ++k) {
    if (k >= n) continue;
    const int o = s_sel[k * kThreads + tid];
    const float vx = sx - s_px[o];
    const float vy = sy - s_py[o];
    const float vz = sz - s_pz[o];
    const float hx = s_hx[o], hy = s_hy[o], hz = s_hz[o];
    const float t2 = s_t2[o], it2 = s_it2[o];
    const float d2 = vx * vx + vy * vy + vz * vz;
    if (d2 <= t2 && d2 > 0.f) {
      const float r = sqrtf(d2 * it2);
      const float s = fmaxf(1.f - r, 0.f);
      const float s3 = s * s * s;
      const float b = 3.f * (s * s / fmaxf(r, 1e-20f)) * it2 * (vx * hx + vy * hy + vz * hz);
      g0 += s3 * hx - b * vx;
      g1 += s3 * hy - b * vy;
      g2 += s3 * hz - b * vz;
    } else if (d2 == 0.f) {
      g0 += hx;
      g1 += hy;
      g2 += hz;
    }
    if (d2 < best_d2) {
      best_d2 = d2;
      best_k = k;
    }
  }

  p_surf[pix * 3 + 0] = sx;
  p_surf[pix * 3 + 1] = sy;
  p_surf[pix * 3 + 2] = sz;
  grad[pix * 3 + 0] = g0;
  grad[pix * 3 + 1] = g1;
  grad[pix * 3 + 2] = g2;
  nearest[pix] = best_d2 < 1e12f ? s_ring[best_k * kThreads + tid] : 0;
  found[pix] = is_found ? 1 : 0;
}

// the kernel instance for tap cap ``k`` and its shared memory, or nullptr
using Kernel = void (*)(const float*, float*, float*, int32_t*, uint8_t*, const Params);

Kernel pick(int k, int radius, size_t* smem) {
  if (k >= 0 && k <= 10) {
    *smem = smem_bytes(radius, 10);
    return raycast_kernel<10>;
  }
  if (k > 10 && k <= 16) {
    *smem = smem_bytes(radius, 16);
    return raycast_kernel<16>;
  }
  return nullptr;
}

}  // namespace

// Plain C entry point (bound with ctypes).  ``ladder`` is a host array of
// ``n_ladder`` offsets in metres; ``ring`` a host array of (dy, dx) int8
// pairs, the (2R+1)^2 window offsets in ring order.  Refinement: false
// position when ``fp_iters`` > 0, else k-section when ``ksec_b`` > 1, else
// bisection.  Launches on ``stream`` and returns cudaGetLastError() of the
// launch (0 = success); returns cudaErrorInvalidValue for arguments the
// kernel does not take (k > 16, radius > 7, more than 64 ladder taps, a ring
// table of the wrong size or with an offset outside the window).
extern "C" int raycast_core_launch(
    const float* attr, float* p_surf, float* grad, int32_t* nearest,
    uint8_t* found, int h, int w, int radius, int k, int kmin, float conf_t,
    const float* ladder, int n_ladder, const int8_t* ring, int n_ring,
    int fp_iters, int bis_iters, int ksec_b, int ksec_p, float fx, float fy,
    float cx, float cy, void* stream) {
  size_t smem = 0;
  const Kernel kernel = pick(k, radius, &smem);
  if (kernel == nullptr || h <= 0 || w <= 0 || radius < 0 || radius > kMaxRadius ||
      n_ladder < 0 || n_ladder > kMaxLadder || fp_iters < 0 || bis_iters < 0 ||
      ksec_b < 1 || ksec_p < 0 || n_ring != (2 * radius + 1) * (2 * radius + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.h = h; p.w = w; p.radius = radius; p.k = k; p.kmin = kmin;
  p.n_ladder = n_ladder; p.fp_iters = fp_iters; p.bis_iters = bis_iters;
  p.ksec_b = ksec_b; p.ksec_p = ksec_p;
  p.conf_t = conf_t; p.fx = fx; p.fy = fy; p.cx = cx; p.cy = cy;
  for (int i = 0; i < kMaxLadder; ++i) p.ladder[i] = i < n_ladder ? ladder[i] : 0.f;
  const int tw = kBlockX + 2 * radius;
  for (int j = 0; j < kMaxRing; ++j) {
    p.ring_off[j] = 0;
    if (j >= n_ring) continue;
    const int dy = ring[2 * j], dx = ring[2 * j + 1];
    if (dy < -radius || dy > radius || dx < -radius || dx > radius)
      return static_cast<int>(cudaErrorInvalidValue);
    p.ring_off[j] = static_cast<int16_t>(dy * tw + dx);
  }
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((w + kBlockX - 1) / kBlockX, (h + kBlockY - 1) / kBlockY);
  kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      attr, p_surf, grad, nearest, found, p);
  return static_cast<int>(cudaGetLastError());
}

// What the instance for tap cap ``k`` at window radius ``radius`` compiled
// to: out[0] registers per thread, out[1] local (spilled) bytes per thread,
// out[2] resident blocks of 256 threads per SM.  Returns a cudaError_t.
extern "C" int raycast_core_attributes(int k, int radius, int* out) {
  size_t smem = 0;
  const Kernel kernel = pick(k, radius, &smem);
  if (kernel == nullptr || radius < 0 || radius > kMaxRadius)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kThreads, smem));
}
