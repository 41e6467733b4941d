// Preprocessing stencils for Hopper (sm_90a): the bilateral depth filter,
// PCA normals and the HRBF curvature pass.  Each block stages one halo tile
// in shared memory; the bilateral and PCA threads each own a column of
// several output pixels, the curvature threads one pixel.
//
// Replaces three TPU kernels of hrbffusion3d_tpu/ops/pallas_kernels.py:
//   bilateral_filter   / _bilateral_kernel  -> bilateral_kernel
//   normal_pca         / _pca_kernel        -> pca_kernel (eigen-solve fused)
//   curvature_gradient / _curv_kernel       -> curvature_kernel (window sums
//                      and the epilogue that the TPU wrapper runs in XLA,
//                      l.637-663, fused)
// The plain PyTorch versions in ops/preprocess.py are the one place where the
// semantics are written; these kernels follow them tap for tap.
//
// What bounds them on this card: arithmetic, not bytes.  Each reads a few
// floats per pixel and writes 1, 3 or 14 (under 20 MB per call at 640x480),
// while each pixel does
//   bilateral: 169 taps of one exponential each: the MUFU unit, 16 lanes
//              per SM per clock against 128 for float32, is the limit;
//   pca:       49 taps of a test and, where it passes, 12 float32 ops,
//              then a 3x3 eigen-solve;
//   curvature: 49 taps of ~10 FP32 ops (mask, v, d2), and ~65 more plus a
//              square root and a reciprocal where the tap is inside its
//              support, then ~100 and ~30 divisions and roots per pixel.
// What the designs do about it is written above each kernel.  Common to
// all: every tap reads the block's halo tile in shared memory (staged once
// from device memory), so device memory is read about once; accumulators
// live in registers; the window's tap loops are unrolled at compile time.
// Where a kernel takes an approximate (one MUFU instruction) root,
// reciprocal, exponential or sine, its note says so and why the result
// stays within the tolerance that chip_smoke.py holds it to; the build
// line has no fast-math switch (the compiler may still contract products
// and sums into fused multiply-adds, which the plain versions' separate
// torch ops do not).  No library kernel is called.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;

// Output rows per thread of the bilateral and PCA kernels, so a block's
// tile is 32 x 8*ROWS pixels.  2 rows beat 4 on the H100 (PERF.md): 600
// tiles of 32x16 spread over 132 SMs more evenly than 300 of 32x32.
constexpr int kBilateralR = 6;   // depth_bilateral.frag window radius
constexpr int kBilateralRows = 2;
constexpr int kPcaR = 3;         // depth_vertex_normal_radius.frag winMultiply
constexpr int kPcaRows = 2;
constexpr int kMaxCurvR = 7;     // cfg.curv_window cap (28 KB of halo tile)

// one MUFU instruction each (relative error below 2^-22), where IEEE
// rounding costs ~8
__device__ __forceinline__ float sqrt_approx(float x) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ float rsqrt_approx(float x) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// 2^x; -inf and arguments below -126 give 0
__device__ __forceinline__ float exp2_approx(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ bool in_image(int x, int y, int w, int h) {
  return x >= 0 && x < w && y >= 0 && y < h;
}

dim3 grid_for(int h, int w, int tile_y) {
  return dim3((w + kTileX - 1) / kTileX, (h + tile_y - 1) / tile_y);
}

// ---------------------------------------------------------------------------
// bilateral filter
// ---------------------------------------------------------------------------

// depth_bilateral.frag's constants, rounded to float32 as the plain version
// rounds them: 0.5 / sigma^2 with sigma_space 4.5 px and sigma_color 30 mm
constexpr double kLog2e = 1.4426950408889634;
constexpr float kSpaceHalfInv = 0.024691358f;   // px^-2
constexpr float kColorHalfInv = 555.556f;       // m^-2 (0.000555556 * 1e6)
// the exponent of each weight in base 2: -(space2 * ss + c^2 * sc) log2(e)
constexpr float kColorExp2 = static_cast<float>(-kColorHalfInv * kLog2e);

__device__ constexpr float space_exp2(int dy, int dx) {
  return static_cast<float>(-(dy * dy + dx * dx) * static_cast<double>(kSpaceHalfInv) * kLog2e);
}

// A tap that must not count, staged in place of its depth: its c = d - nb
// is ~1e10, so c^2 * kColorExp2 is ~-8e22 and its weight exactly 0.
constexpr float kAbsent = -1e10f;

// Depths outside (depth_min, depth_cutoff] are zeroed first; each tap of the
// 13x13 window weighs its neighbour by exp(-(spatial + (d - nb)^2 * sc)).
// Denominator:
//   shader form (pallas_form = 0): every in-image neighbour, valid or not;
//   Pallas form (pallas_form = 1): neighbours with depth > 0 only.
// Design, against the MUFU limit (PERF.md section 6):
//   - sigma_space and sigma_color are compile-time constants with log2(e)
//     folded in, so each unrolled tap's spatial term is an immediate and
//     its weight is one ex2.approx of one fused multiply-add: with the
//     subtract, the square and the two sums, 5 float32 instructions and 1
//     MUFU per tap, the least a design that takes its exponentials from
//     the MUFU needs.  ex2.approx's relative error (~2^-22) moves an
//     output by under 1e-7 m; its flush of weights below 2^-126 to 0 moves
//     none beyond float rounding, since the centre tap's weight is exactly
//     1 (den >= 1 wherever d > 0);
//   - both denominators and the image border are settled once per staged
//     pixel, not per tap: a neighbour that must not count (outside the
//     image; in the Pallas form also depth 0) is staged as kAbsent, whose
//     weight is exactly 0.  Every block, at the border or not, then runs
//     the same tap loop with no test and no select in it;
//   - each thread owns kBilateralRows vertically stacked output pixels and
//     walks their union window row by row: each neighbour is read from
//     shared memory once into a register and used for every output that
//     needs it (14 rows x 13 loads for 2 x 169 taps at 2 rows);
//   - a thread none of whose pixels has a valid depth skips the taps.
__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out,
                 int h, int w, float depth_min, float depth_cutoff,
                 int pallas_form) {
  constexpr int R = kBilateralR;
  constexpr int D = 2 * R + 1;
  constexpr int ROWS = kBilateralRows;
  constexpr int TW = kTileX + 2 * R;
  constexpr int TH = kTileY * ROWS + 2 * R;
  __shared__ float tile[TH * TW];
  const int x0 = blockIdx.x * kTileX - R;
  const int y0 = blockIdx.y * kTileY * ROWS - R;
  const int tid = threadIdx.y * kTileX + threadIdx.x;
  const float invalid = pallas_form ? kAbsent : 0.f;

  // all of a thread's loads are issued before the first is used, so the
  // block waits for device memory once, not once per staged pixel
  constexpr int S = (TH * TW + kThreads - 1) / kThreads;
  float v[S];
  bool in[S];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = tid + k * kThreads;
    const int gx = x0 + i % TW;
    const int gy = y0 + i / TW;
    in[k] = i < TH * TW && in_image(gx, gy, w, h);
    v[k] = in[k] ? depth[static_cast<int64_t>(gy) * w + gx] : 0.f;
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = tid + k * kThreads;
    if (i < TH * TW)
      tile[i] = !in[k] ? kAbsent : (v[k] > depth_min && v[k] <= depth_cutoff) ? v[k] : invalid;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY * ROWS + threadIdx.y * ROWS;
  if (x >= w || y >= h) return;
  // the top-left corner of this thread's union window
  const float* win = tile + threadIdx.y * ROWS * TW + threadIdx.x;
  float d[ROWS], num[ROWS], den[ROWS];
  bool any = false;
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    d[k] = win[(k + R) * TW + R];
    num[k] = 0.f;
    den[k] = 0.f;
    any |= d[k] > 0.f;
  }
  if (any) {
#pragma unroll
    for (int r = 0; r < ROWS + 2 * R; ++r) {
#pragma unroll
      for (int dx = 0; dx < D; ++dx) {
        const float nb = win[r * TW + dx];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
          const int dy = r - k;   // fixed at compile time
          if (dy < 0 || dy >= D) continue;
          const float c = d[k] - nb;
          const float wgt = exp2_approx(fmaf(c * c, kColorExp2, space_exp2(dy - R, dx - R)));
          num[k] = fmaf(nb, wgt, num[k]);
          den[k] += wgt;
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (y + k < h) out[static_cast<int64_t>(y + k) * w + x] = d[k] > 0.f ? num[k] / den[k] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// PCA normals
// ---------------------------------------------------------------------------

// Eigenvector of the smallest eigenvalue of the symmetric 3x3 matrix
// [a00 a01 a02; a01 a11 a12; a02 a12 a22]: Smith's trigonometric roots and
// the cross-product null space (preprocess._smallest_eigvec_3x3), unit
// length.  theta = atan2(.) / 3 lies in [0, pi/3], inside the range where
// the MUFU sine and cosine are accurate to 2^-21 absolute, so __sincosf
// takes them; the two square roots and the final normalisation are one
// MUFU instruction each.  atan2f stays IEEE: no MUFU instruction computes
// it, and it is one call per pixel against 49 taps.
__device__ __forceinline__ void smallest_eigvec(float a00, float a01, float a02, float a11,
                                                float a12, float a22, float* n) {
  const float c0 = a00 * a11 * a22 + 2.f * a01 * a02 * a12 - a00 * a12 * a12 -
                   a11 * a02 * a02 - a22 * a01 * a01;
  const float c1 = a00 * a11 - a01 * a01 + a00 * a22 - a02 * a02 + a11 * a22 -
                   a12 * a12;
  const float c2 = a00 + a11 + a22;
  const float inv3 = 1.f / 3.f;
  const float c2o3 = c2 * inv3;
  const float ao3 = fminf((c1 - c2 * c2o3) * inv3, 0.f);
  const float half_b = 0.5f * (c0 + c2o3 * (2.f * c2o3 * c2o3 - c1));
  const float q = fminf(half_b * half_b + ao3 * ao3 * ao3, 0.f);
  const float rho = sqrt_approx(-ao3);
  const float theta = atan2f(sqrt_approx(-q), half_b) * inv3;
  const float sqrt3 = 1.7320508075688772f;
  float st, ct;
  __sincosf(theta, &st, &ct);
  float lam = c2o3 - rho * (ct + sqrt3 * st);
  lam = fminf(lam, c2o3 - rho * (ct - sqrt3 * st));
  lam = fminf(lam, c2o3 + 2.f * rho * ct);
  const float b00 = a00 - lam, b11 = a11 - lam, b22 = a22 - lam;
  // rows r0 = (b00, a01, a02), r1 = (a01, b11, a12), r2 = (a02, a12, b22)
  const float v1x = a01 * a12 - a02 * b11, v1y = a02 * a01 - b00 * a12,
              v1z = b00 * b11 - a01 * a01;                       // r0 x r1
  const float v2x = a01 * b22 - a02 * a12, v2y = a02 * a02 - b00 * b22,
              v2z = b00 * a12 - a01 * a02;                       // r0 x r2
  const float v3x = b11 * b22 - a12 * a12, v3y = a12 * a02 - a01 * b22,
              v3z = a01 * a12 - b11 * a02;                       // r1 x r2
  const float l1 = v1x * v1x + v1y * v1y + v1z * v1z;
  const float l2 = v2x * v2x + v2y * v2y + v2z * v2z;
  const float l3 = v3x * v3x + v3y * v3y + v3z * v3z;
  const bool p1 = l1 >= l2 && l1 >= l3, p2 = l2 >= l3;
  const float vx = p1 ? v1x : p2 ? v2x : v3x;
  const float vy = p1 ? v1y : p2 ? v2y : v3y;
  const float vz = p1 ? v1z : p2 ? v2z : v3z;
  const float len2 = p1 ? l1 : p2 ? l2 : l3;
  // 1 / max(|v|, 1e-20) as the plain version clamps it, where |v|^2 is a
  // normal float (the MUFU flushes smaller ones to 0)
  const float inv = rsqrt_approx(fmaxf(len2, 1.17549435e-38f));
  n[0] = vx * inv;
  n[1] = vy * inv;
  n[2] = vz * inv;
}

// 7x7 window of the filtered vertex map: neighbours with z > depth_min and
// |dz| < 0.05 add (1, q, q q^T) with q = p_nb - p_centre (centre-relative:
// raw coordinates would lose ~6 digits in the float32 moment subtraction);
// >= 8 of them and z > depth_min give the normal, flipped to n_z >= 0.
// Design, against the float32 work of the taps:
//   - the halo tile is three planes (x, y, z), and z is staged as NaN where
//     it fails z > depth_min, so a tap's whole test is |z - pz| < 0.05
//     (false for NaN); a centre that fails it accepts no tap and is 0;
//   - the mask selects q and the count's 1 (no branch, so a warp does not
//     split at depth edges); a tap is one subtract and compare, two more
//     subtracts, the selects, four adds and six multiply-adds;
//   - each thread owns kPcaRows vertically stacked output pixels and walks
//     their union window row by row, loading each tap's (x, y, z) from
//     shared memory once for every output that needs it;
//   - the epilogue multiplies by one reciprocal of the count where the
//     plain version divides nine times, and solves the eigenvector with
//     the MUFU forms above.
__global__ void __launch_bounds__(kThreads)
pca_kernel(const float* __restrict__ vertex, float* __restrict__ normal,
           int h, int w, float depth_min) {
  constexpr int R = kPcaR;
  constexpr int D = 2 * R + 1;
  constexpr int ROWS = kPcaRows;
  constexpr int TW = kTileX + 2 * R;
  constexpr int TH = kTileY * ROWS + 2 * R;
  constexpr int NP = TW * TH;
  __shared__ float tile[3 * NP];
  float* s_x = tile;
  float* s_y = tile + NP;
  float* s_z = tile + 2 * NP;   // z where z > depth_min, else NaN
  const int x0 = blockIdx.x * kTileX - R;
  const int y0 = blockIdx.y * kTileY * ROWS - R;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  // all loads first, as in the bilateral kernel
  constexpr int S = (NP + kThreads - 1) / kThreads;
  float v[S][3];
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = tid + k * kThreads;
    const int gx = x0 + i % TW;
    const int gy = y0 + i / TW;
    const bool in = i < NP && in_image(gx, gy, w, h);
    const float* p = vertex + (static_cast<int64_t>(gy) * w + gx) * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[k][c] = in ? p[c] : 0.f;   // the plain version's zero padding
  }
#pragma unroll
  for (int k = 0; k < S; ++k) {
    const int i = tid + k * kThreads;
    if (i < NP) {
      s_x[i] = v[k][0];
      s_y[i] = v[k][1];
      s_z[i] = v[k][2] > depth_min ? v[k][2] : __int_as_float(0x7fc00000);
    }
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY * ROWS + threadIdx.y * ROWS;
  if (x >= w || y >= h) return;
  const int win = threadIdx.y * ROWS * TW + threadIdx.x;   // union window corner
  float px[ROWS], py[ROWS], pz[ROWS], cnt[ROWS], s0[ROWS], s1[ROWS], s2[ROWS];
  float m00[ROWS], m01[ROWS], m02[ROWS], m11[ROWS], m12[ROWS], m22[ROWS];
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    const int c = win + (k + R) * TW + R;
    px[k] = s_x[c];
    py[k] = s_y[c];
    pz[k] = s_z[c];
    cnt[k] = s0[k] = s1[k] = s2[k] = 0.f;
    m00[k] = m01[k] = m02[k] = m11[k] = m12[k] = m22[k] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < ROWS + 2 * R; ++r) {
#pragma unroll
    for (int dx = 0; dx < D; ++dx) {
      const int j = win + r * TW + dx;
      const float nx = s_x[j], ny = s_y[j], nz = s_z[j];
#pragma unroll
      for (int k = 0; k < ROWS; ++k) {
        const int dy = r - k;   // fixed at compile time
        if (dy < 0 || dy >= D) continue;
        const float dz = nz - pz[k];
        const bool ok = fabsf(dz) < 0.05f;
        const float q0 = ok ? nx - px[k] : 0.f;
        const float q1 = ok ? ny - py[k] : 0.f;
        const float q2 = ok ? dz : 0.f;
        cnt[k] += ok ? 1.f : 0.f;
        s0[k] += q0;
        s1[k] += q1;
        s2[k] += q2;
        m00[k] = fmaf(q0, q0, m00[k]);
        m01[k] = fmaf(q0, q1, m01[k]);
        m02[k] = fmaf(q0, q2, m02[k]);
        m11[k] = fmaf(q1, q1, m11[k]);
        m12[k] = fmaf(q1, q2, m12[k]);
        m22[k] = fmaf(q2, q2, m22[k]);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < ROWS; ++k) {
    if (y + k >= h) break;
    const float inv = rcp_approx(fmaxf(cnt[k], 1.f));
    const float mx = s0[k] * inv, my = s1[k] * inv, mz = s2[k] * inv;
    float n[3];
    smallest_eigvec(m00[k] * inv - mx * mx, m01[k] * inv - mx * my,
                    m02[k] * inv - mx * mz, m11[k] * inv - my * my,
                    m12[k] * inv - my * mz, m22[k] * inv - mz * mz, n);
    // cnt >= 8 implies pz passed z > depth_min (a NaN centre accepts none)
    const bool ok = cnt[k] >= 8.f;
    const float flip = n[2] < 0.f ? -1.f : 1.f;
    float* o = normal + (static_cast<int64_t>(y + k) * w + x) * 3;
    o[0] = ok ? n[0] * flip : 0.f;
    o[1] = ok ? n[1] * flip : 0.f;
    o[2] = ok ? n[2] * flip : 0.f;
  }
}

// ---------------------------------------------------------------------------
// HRBF curvature: window sums and the per-pixel epilogue, fused
// ---------------------------------------------------------------------------

// Principal curvatures and directions of the implicit's Monge patch from
// the gradient g and the Hessian h6 (hrbf.principal_curvatures,
// depth_curvature_gradient.frag:95-137).  Clamps keep a NaN as torch.clamp
// does (x < lo ? lo : x), so an invalid value stays invalid.
struct Curvature {
  float k1, k2, d1[3], d2[3];
  bool valid;
};

__device__ __forceinline__ float clamp_min(float x, float lo) { return x < lo ? lo : x; }

// unit principal direction r_u + lam r_v = (1, lam, h_x + lam h_y) of k
__device__ __forceinline__ void direction(float k, float M, float F, float N,
                                          float G, float hx, float hy, float* d) {
  const float dd = N - k * G;
  const float lam = -(M - k * F) / (fabsf(dd) > 1e-9f ? dd : 1e-9f);
  const float vz = hx + lam * hy;
  const float len = clamp_min(sqrtf(1.f + lam * lam + vz * vz), 1e-12f);
  d[0] = 1.f / len;
  d[1] = lam / len;
  d[2] = vz / len;
}

__device__ __forceinline__ void principal_curvatures(
    float gx, float gy, float gz, float h00, float h01, float h02, float h11,
    float h12, float h22, Curvature* c) {
  const float sgz = fabsf(gz) > 1e-9f ? gz : 1e-9f;
  const float hx = -gx / sgz;
  const float hy = -gy / sgz;
  const float gz3 = sgz * sgz * sgz;
  const float hxx = (2.f * gx * gz * h02 - gx * gx * h22 - gz * gz * h00) / gz3;
  const float hxy = (gx * gz * h12 + gy * gz * h02 - gx * gy * h22 - gz * gz * h01) / gz3;
  const float hyy = (2.f * gy * gz * h12 - gy * gy * h22 - gz * gz * h11) / gz3;
  const float E = 1.f + hx * hx;
  const float F = hx * hy;
  const float G = 1.f + hy * hy;
  const float ln = sqrtf(hx * hx + hy * hy + 1.f);
  const float L = hxx / ln, M = hxy / ln, N = hyy / ln;
  const float den = E * G - F * F;
  const float sden = fabsf(den) > 1e-12f ? den : 1e-12f;
  const float kg = (L * N - M * M) / sden;
  const float km = (E * N + G * L - 2.f * F * M) / (2.f * sden);
  const float sq = sqrtf(clamp_min(km * km - kg, 0.f));
  c->k1 = km + sq;
  c->k2 = km - sq;
  direction(c->k1, M, F, N, G, hx, hy, c->d1);
  direction(c->k2, M, F, N, G, hx, hy, c->d2);
  c->valid = isfinite(c->k1) && isfinite(c->k2);
}

// Per centre vertex, over the (2R+1)^2 window: masked neighbours (|dz| <
// 0.10, z > depth_min, |n|^2 > 0.64) add their direct HRBF gradient and
// Hessian terms (hrbf.grad_hess_direct, Hermite coefficient c = 10 n):
//   inside the support (0 < d2 <= T^2), with r = |v| / T, s = 1 - r:
//     g -= a c + b2 (v.c) v,       a = -20 s^3 / T^2, b2 = 60 s^2 / (r T^4)
//     h -= cb (c v^T + v c^T + (v.c) I) - ck v v^T,
//          cb = 60 s^2 / (r T^4), ck = 60 (2s + s^2/r) (v.c) / (r^2 T^6)
//   at the neighbour itself (d2 == 0, T^2 > 0): g += (20 / T^2) c.
// Every masked neighbour counts, inside its support or not.  The staged
// tile holds each pixel's centre-independent terms once: x, y, the z of a
// pixel that passes the centre-independent part of the mask (NaN where it
// fails, so the |dz| test rejects it), c, T^2, 1/T^2 and 60/T^4; a tap
// inside its support then needs one square root and one reciprocal (1/r),
// one MUFU instruction each.
// The thread that holds the sums finishes the pixel (preprocess.
// _curvature_epilogue): principal curvatures, |<g, n>|, the normalised
// gradient as normal, its surfel radius, validity (count > 15, finite
// curvatures, z > depth_min, |n| > 0.5) and the k = 1000 sentinel.
// Outputs: ``fields`` planes [k1 | k2 | dir1(3) | dir2(3) | |<g,n>| |
// normal_opt(3) | radius_opt] of h*w (3-vectors interleaved), ``valid``,
// and, when ``sums`` is not null, [g(3) | h00 h01 h02 h11 h12 h22 | count].
// RW > 0 fixes the window radius at compile time (the tap loops unroll);
// RW = 0 takes it from ``window``.
template <int RW>
__global__ void __launch_bounds__(kThreads)
curvature_kernel(const float* __restrict__ vertex, const float* __restrict__ normal,
                 const float* __restrict__ radius, float* __restrict__ fields,
                 uint8_t* __restrict__ valid, float* __restrict__ sums, int h,
                 int w, int window, float depth_min, float rad_scale, float rad_mult) {
  const int R = RW > 0 ? RW : window;
  extern __shared__ float smem[];
  const int TW = kTileX + 2 * R;
  const int TH = kTileY + 2 * R;
  const int n_pix = TW * TH;
  float* s_x = smem;
  float* s_y = s_x + n_pix;
  float* s_zm = s_y + n_pix;    // z where |n|^2 > 0.64 and z > depth_min, else NaN
  float* s_cx = s_zm + n_pix;
  float* s_cy = s_cx + n_pix;
  float* s_cz = s_cy + n_pix;
  float* s_t2 = s_cz + n_pix;
  float* s_it2 = s_t2 + n_pix;  // 1 / max(T^2, 1e-12)
  float* s_c60 = s_it2 + n_pix; // 60 / max(T^2, 1e-12)^2
  const int x0 = blockIdx.x * kTileX - R;
  const int y0 = blockIdx.y * kTileY - R;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  for (int i = tid; i < n_pix; i += kThreads) {
    const int gx = x0 + i % TW;
    const int gy = y0 + i / TW;
    float v[3] = {0.f, 0.f, 0.f}, n[3] = {0.f, 0.f, 0.f}, T = 0.f;
    if (in_image(gx, gy, w, h)) {
      const int64_t g = static_cast<int64_t>(gy) * w + gx;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        v[c] = vertex[g * 3 + c];
        n[c] = normal[g * 3 + c];
      }
      T = radius[g];
    }
    const bool keep = n[0] * n[0] + n[1] * n[1] + n[2] * n[2] > 0.64f && v[2] > depth_min;
    const float T2 = T * T;
    const float sT2 = fmaxf(T2, 1e-12f);
    s_x[i] = v[0];
    s_y[i] = v[1];
    s_zm[i] = keep ? v[2] : __int_as_float(0x7fc00000);
    s_cx[i] = 10.f * n[0];
    s_cy[i] = 10.f * n[1];
    s_cz[i] = 10.f * n[2];
    s_t2[i] = T2;
    s_it2[i] = 1.f / sT2;
    s_c60[i] = 60.f / (sT2 * sT2);
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int64_t pix = static_cast<int64_t>(y) * w + x;
  const float px = vertex[pix * 3], py = vertex[pix * 3 + 1], pz = vertex[pix * 3 + 2];
  const int ci = (threadIdx.y + R) * TW + threadIdx.x + R;
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  float h00 = 0.f, h01 = 0.f, h02 = 0.f, h11 = 0.f, h12 = 0.f, h22 = 0.f;
  int cnt = 0;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const int j = ci + dy * TW + dx;
      const float qz = s_zm[j];
      if (!(fabsf(qz - pz) < 0.10f)) continue;
      ++cnt;
      const float vx = px - s_x[j], vy = py - s_y[j], vz = pz - qz;
      const float d2 = vx * vx + vy * vy + vz * vz;
      const float T2 = s_t2[j];
      if (d2 <= T2 && d2 > 0.f) {
        const float it2 = s_it2[j];
        const float c60 = s_c60[j];
        const float cx = s_cx[j], cy = s_cy[j], cz = s_cz[j];
        const float r = sqrt_approx(d2 * it2);
        const float ir = rcp_approx(fmaxf(r, 1e-20f));
        const float s = fmaxf(1.f - r, 0.f);
        const float b = s * s * ir;
        const float vc = vx * cx + vy * cy + vz * cz;
        const float ma = 20.f * (s * s * s) * it2;  // -a
        const float bvc = c60 * b * vc;
        g0 += ma * cx - bvc * vx;
        g1 += ma * cy - bvc * vy;
        g2 += ma * cz - bvc * vz;
        const float k = (2.f * s + b) * it2 * ir * ir;
        const float cb = c60 * b;
        const float ck = c60 * k * vc;
        const float cbvc = cb * vc;
        h00 += -(cb * 2.f * cx * vx + cbvc - ck * vx * vx);
        h01 += -(cb * (cx * vy + cy * vx) - ck * vx * vy);
        h02 += -(cb * (cx * vz + cz * vx) - ck * vx * vz);
        h11 += -(cb * 2.f * cy * vy + cbvc - ck * vy * vy);
        h12 += -(cb * (cy * vz + cz * vy) - ck * vy * vz);
        h22 += -(cb * 2.f * cz * vz + cbvc - ck * vz * vz);
      } else if (d2 == 0.f && T2 > 0.f) {
        const float a0 = 20.f * s_it2[j];
        g0 += a0 * s_cx[j];
        g1 += a0 * s_cy[j];
        g2 += a0 * s_cz[j];
      }
    }
  }
  if (sums != nullptr) {
    float* o = sums + pix * 10;
    o[0] = g0; o[1] = g1; o[2] = g2;
    o[3] = h00; o[4] = h01; o[5] = h02; o[6] = h11; o[7] = h12; o[8] = h22;
    o[9] = static_cast<float>(cnt);
  }

  Curvature c;
  principal_curvatures(g0, g1, g2, h00, h01, h02, h11, h12, h22, &c);
  const float nx = normal[pix * 3], ny = normal[pix * 3 + 1], nz = normal[pix * 3 + 2];
  const float glen = clamp_min(sqrtf(g0 * g0 + g1 * g1 + g2 * g2), 1e-20f);
  const bool ok = cnt > 15 && c.valid && pz > depth_min &&
                  sqrtf(nx * nx + ny * ny + nz * nz) > 0.5f;
  const float gn[3] = {ok ? g0 / glen : 0.f, ok ? g1 / glen : 0.f, ok ? g2 / glen : 0.f};
  // surfel_radius: sqrt2 z / mean focal, slanted by 1 / |n_z|, capped at 2x
  const float base = pz * rad_scale;
  const float slant = base / fmaxf(fabsf(gn[2]), 1e-6f);
  const int64_t P = static_cast<int64_t>(h) * w;
  fields[pix] = ok ? c.k1 : 1000.f;
  fields[P + pix] = ok ? c.k2 : 1000.f;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    fields[2 * P + pix * 3 + i] = ok ? c.d1[i] : 0.f;
    fields[5 * P + pix * 3 + i] = ok ? c.d2[i] : 0.f;
    fields[9 * P + pix * 3 + i] = gn[i];
  }
  fields[8 * P + pix] = ok ? fabsf(g0 * nx + g1 * ny + g2 * nz) : 0.f;
  fields[12 * P + pix] = ok ? fminf(2.f * base, slant) * rad_mult : 0.f;
  valid[pix] = ok ? 1 : 0;
}

// the curvature kernel's instance for ``window`` (the configured 3
// unrolled)
using CurvatureKernel = void (*)(const float*, const float*, const float*, float*,
                                 uint8_t*, float*, int, int, int, float, float, float);

CurvatureKernel curvature_for(int window) {
  return window == 3 ? curvature_kernel<3> : curvature_kernel<0>;
}

size_t curvature_smem(int window) {
  return static_cast<size_t>(kTileX + 2 * window) * (kTileY + 2 * window) * 9 *
         sizeof(float);
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on ``stream`` and
// returns cudaGetLastError() of the launch (0 = success), or
// cudaErrorInvalidValue for arguments the kernel does not take.  Inputs and
// outputs are contiguous float32 device arrays.

// depth (h, w) -> out (h, w); sigma_space 4.5 px, sigma_color 30 mm.
extern "C" int bilateral_filter_launch(const float* depth, float* out, int h,
                                       int w, float depth_min,
                                       float depth_cutoff, int pallas_form,
                                       void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  bilateral_kernel<<<grid_for(h, w, kTileY * kBilateralRows), dim3(kTileX, kTileY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      depth, out, h, w, depth_min, depth_cutoff, pallas_form ? 1 : 0);
  return static_cast<int>(cudaGetLastError());
}

// filtered vertex map (h, w, 3) -> normal (h, w, 3), 0 where invalid.
extern "C" int normal_pca_launch(const float* vertex, float* normal, int h,
                                 int w, float depth_min, void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pca_kernel<<<grid_for(h, w, kTileY * kPcaRows), dim3(kTileX, kTileY), 0,
               static_cast<cudaStream_t>(stream)>>>(vertex, normal, h, w,
                                                    depth_min);
  return static_cast<int>(cudaGetLastError());
}

// vertex (h, w, 3), normal (h, w, 3), radius (h, w) -> fields (13, h, w)
// planes [k1 | k2 | dir1(3) | dir2(3) | gradient_mag | normal_opt(3) |
// radius_opt], valid (h, w) uint8 and, unless ``sums`` is null, the window
// sums (h, w, 10).  ``rad_scale`` = sqrt2 / mean focal length.
extern "C" int curvature_gradient_launch(const float* vertex, const float* normal,
                                         const float* radius, float* fields,
                                         uint8_t* valid, float* sums, int h,
                                         int w, int window, float depth_min,
                                         float rad_scale, float rad_mult,
                                         void* stream) {
  if (h <= 0 || w <= 0 || window < 0 || window > kMaxCurvR)
    return static_cast<int>(cudaErrorInvalidValue);
  curvature_for(window)<<<grid_for(h, w, kTileY), dim3(kTileX, kTileY), curvature_smem(window),
                          static_cast<cudaStream_t>(stream)>>>(
      vertex, normal, radius, fields, valid, sums, h, w, window, depth_min,
      rad_scale, rad_mult);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// registers, spilled bytes and resident 256-thread blocks per SM of
// ``kernel`` (launched with ``smem`` bytes of dynamic shared memory) into
// out[0..2]; returns a cudaError_t
template <typename Kernel>
int attributes(Kernel kernel, size_t smem, int* out) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[2], kernel, kThreads, smem));
}

}  // namespace

// What each kernel compiled to (the curvature kernel's at window radius
// ``window``): out[0] registers per thread, out[1] local (spilled) bytes
// per thread, out[2] resident blocks of 256 threads per SM.  Each returns
// a cudaError_t.
extern "C" int bilateral_filter_attributes(int* out) {
  return attributes(bilateral_kernel, 0, out);
}

extern "C" int normal_pca_attributes(int* out) { return attributes(pca_kernel, 0, out); }

extern "C" int curvature_gradient_attributes(int window, int* out) {
  if (window < 0 || window > kMaxCurvR) return static_cast<int>(cudaErrorInvalidValue);
  return attributes(curvature_for(window), curvature_smem(window), out);
}
