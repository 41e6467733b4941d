// Preprocessing stencils for Hopper (sm_90a): the bilateral depth filter,
// PCA normals and the HRBF curvature window sums.  One thread per output
// pixel, one 32x8 block per tile, and one shared-memory halo tile per block.
//
// Replaces three TPU kernels of hrbffusion3d_tpu/ops/pallas_kernels.py:
//   bilateral_filter   / _bilateral_kernel  -> bilateral_kernel
//   normal_pca         / _pca_kernel        -> pca_kernel (eigen-solve fused)
//   curvature_gradient / _curv_kernel       -> curvature_kernel
// The plain PyTorch versions in ops/preprocess.py are the one place where the
// semantics are written; these kernels follow them tap for tap.
//
// What bounds them on this card: arithmetic, not bytes.  Each reads a few
// floats per pixel and writes 1, 3 or 10 (under 10 MB per call at 640x480),
// while each pixel does
//   bilateral: 169 taps with one expf each (the MUFU unit's exp2 plus a few
//              FP32 ops): 51.9 M exponentials per frame;
//   pca:       49 taps of ~20 FP32 ops (test, subtract, 9 multiply-adds);
//   curvature: 49 taps of ~70 FP32 ops plus a sqrtf and three divisions
//              where the tap is inside its support.
// What the design does about it: every tap reads the block's halo tile in
// shared memory (staged once from device memory, zero outside the image),
// so device memory is read about once; the tap loops are unrolled for the
// fixed radii; accumulators live in registers; the PCA eigen-solve (which
// the Pallas kernel left to XLA because Mosaic cannot lower atan2) runs in
// the same thread.  No fast-math: expf, sqrtf, atan2f and true division
// keep the results within float rounding of the plain versions (the
// compiler may contract products and sums into fused multiply-adds, which
// the plain versions' separate torch ops do not).  No library kernel is
// called.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;
constexpr int kTileY = 8;
constexpr int kThreads = kTileX * kTileY;

constexpr int kBilateralR = 6;   // depth_bilateral.frag window radius
constexpr int kBilateralD = 2 * kBilateralR + 1;
constexpr int kPcaR = 3;         // depth_vertex_normal_radius.frag winMultiply
constexpr int kMaxCurvR = 7;     // cfg.curv_window cap (28 KB of halo tile)

__device__ __forceinline__ bool in_image(int x, int y, int w, int h) {
  return x >= 0 && x < w && y >= 0 && y < h;
}

// ---------------------------------------------------------------------------
// bilateral filter
// ---------------------------------------------------------------------------

// Depths outside (depth_min, depth_cutoff] are zeroed first.  The spatial
// term (dy^2 + dx^2) * ss of the 169 taps comes from a shared table; the
// weight is expf(-(spatial + (d - nb)^2 * sc)).  Denominator:
//   shader form (pallas_form = 0): every in-image neighbour, valid or not;
//   Pallas form (pallas_form = 1): neighbours with depth > 0 only.
__global__ void __launch_bounds__(kThreads)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out,
                 int h, int w, float depth_min, float depth_cutoff,
                 int pallas_form, float ss, float sc) {
  constexpr int R = kBilateralR;
  constexpr int TW = kTileX + 2 * R;
  constexpr int TH = kTileY + 2 * R;
  __shared__ float tile[TH * TW];
  __shared__ float space[kBilateralD * kBilateralD];
  const int x0 = blockIdx.x * kTileX - R;
  const int y0 = blockIdx.y * kTileY - R;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  for (int i = tid; i < TH * TW; i += kThreads) {
    const int gx = x0 + i % TW;
    const int gy = y0 + i / TW;
    float v = 0.f;
    if (in_image(gx, gy, w, h)) {
      v = depth[static_cast<int64_t>(gy) * w + gx];
      v = (v > depth_min && v <= depth_cutoff) ? v : 0.f;
    }
    tile[i] = v;
  }
  for (int i = tid; i < kBilateralD * kBilateralD; i += kThreads) {
    const int dy = i / kBilateralD - R;
    const int dx = i % kBilateralD - R;
    space[i] = static_cast<float>(dy * dy + dx * dx) * ss;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float d = tile[(threadIdx.y + R) * TW + threadIdx.x + R];
  float num = 0.f, den = 0.f;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
    const bool row_in = y + dy >= 0 && y + dy < h;
    const float* row = tile + (threadIdx.y + R + dy) * TW + threadIdx.x + R;
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const float nb = row[dx];
      const bool keep = pallas_form ? nb > 0.f
                                    : (row_in && x + dx >= 0 && x + dx < w);
      if (keep) {
        const float c = d - nb;
        const float wgt =
            expf(-(space[(dy + R) * kBilateralD + dx + R] + c * c * sc));
        num += nb * wgt;
        den += wgt;
      }
    }
  }
  out[static_cast<int64_t>(y) * w + x] = d > 0.f ? num / fmaxf(den, 1e-12f) : 0.f;
}

// ---------------------------------------------------------------------------
// PCA normals
// ---------------------------------------------------------------------------

// Eigenvector of the smallest eigenvalue of the symmetric 3x3 matrix
// [a00 a01 a02; a01 a11 a12; a02 a12 a22]: Smith's trigonometric roots and
// the cross-product null space (preprocess._smallest_eigvec_3x3).
__device__ void smallest_eigvec(float a00, float a01, float a02, float a11,
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
  const float rho = sqrtf(-ao3);
  const float theta = atan2f(sqrtf(-q), half_b) * inv3;
  const float sqrt3 = 1.7320508075688772f;
  const float ct = cosf(theta), st = sinf(theta);
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
  float vx, vy, vz;
  if (l1 >= l2 && l1 >= l3) {
    vx = v1x; vy = v1y; vz = v1z;
  } else if (l2 >= l3) {
    vx = v2x; vy = v2y; vz = v2z;
  } else {
    vx = v3x; vy = v3y; vz = v3z;
  }
  const float len = fmaxf(sqrtf(vx * vx + vy * vy + vz * vz), 1e-20f);
  n[0] = vx / len;
  n[1] = vy / len;
  n[2] = vz / len;
}

// 7x7 window of the filtered vertex map: neighbours with z > depth_min and
// |dz| < 0.05 add (1, q, q q^T) with q = p_nb - p_centre (centre-relative:
// raw coordinates would lose ~6 digits in the float32 moment subtraction);
// >= 8 of them and z > depth_min give the normal, flipped to n_z >= 0.
__global__ void __launch_bounds__(kThreads)
pca_kernel(const float* __restrict__ vertex, float* __restrict__ normal,
           int h, int w, float depth_min) {
  constexpr int R = kPcaR;
  constexpr int TW = kTileX + 2 * R;
  constexpr int TH = kTileY + 2 * R;
  __shared__ float tile[TH * TW * 3];
  const int x0 = blockIdx.x * kTileX - R;
  const int y0 = blockIdx.y * kTileY - R;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  for (int i = tid; i < TH * TW * 3; i += kThreads) {
    const int xy = i / 3;
    const int gx = x0 + xy % TW;
    const int gy = y0 + xy / TW;
    tile[i] = in_image(gx, gy, w, h)
                  ? vertex[(static_cast<int64_t>(gy) * w + gx) * 3 + i % 3]
                  : 0.f;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  const float* cen = tile + ((threadIdx.y + R) * TW + threadIdx.x + R) * 3;
  const float px = cen[0], py = cen[1], pz = cen[2];
  int cnt = 0;
  float s0 = 0.f, s1 = 0.f, s2 = 0.f;
  float m00 = 0.f, m01 = 0.f, m02 = 0.f, m11 = 0.f, m12 = 0.f, m22 = 0.f;
#pragma unroll
  for (int dy = -R; dy <= R; ++dy) {
#pragma unroll
    for (int dx = -R; dx <= R; ++dx) {
      const float* nb = cen + (dy * TW + dx) * 3;
      const float zn = nb[2];
      if (zn > depth_min && fabsf(zn - pz) < 0.05f) {
        const float q0 = nb[0] - px, q1 = nb[1] - py, q2 = zn - pz;
        ++cnt;
        s0 += q0; s1 += q1; s2 += q2;
        m00 += q0 * q0; m01 += q0 * q1; m02 += q0 * q2;
        m11 += q1 * q1; m12 += q1 * q2; m22 += q2 * q2;
      }
    }
  }
  const float denom = static_cast<float>(cnt > 1 ? cnt : 1);
  const float mx = s0 / denom, my = s1 / denom, mz = s2 / denom;
  float n[3];
  smallest_eigvec(m00 / denom - mx * mx, m01 / denom - mx * my,
                  m02 / denom - mx * mz, m11 / denom - my * my,
                  m12 / denom - my * mz, m22 / denom - mz * mz, n);
  const float flip = n[2] < 0.f ? -1.f : 1.f;
  const bool ok = cnt >= 8 && pz > depth_min;
  float* o = normal + (static_cast<int64_t>(y) * w + x) * 3;
  o[0] = ok ? n[0] * flip : 0.f;
  o[1] = ok ? n[1] * flip : 0.f;
  o[2] = ok ? n[2] * flip : 0.f;
}

// ---------------------------------------------------------------------------
// HRBF curvature window sums
// ---------------------------------------------------------------------------

// (2R+1)^2 window at each centre vertex: masked neighbours (|dz| < 0.10,
// z > depth_min, |n|^2 > 0.64) add their direct HRBF gradient and Hessian
// terms (hrbf.grad_hess_direct, Hermite coefficient 10 n):
//   inside the support (0 < d2 <= T^2), with r = |v| / T, s = 1 - r:
//     g -= a c + b2 (v.c) v,       a = -20 s^3 / T^2, b2 = 60 s^2 / (r T^4)
//     h -= cb (c v^T + v c^T + (v.c) I) - ck v v^T,
//          cb = 60 s^2 / (r T^4), ck = 60 (2s + s^2/r) (v.c) / (r^2 T^6)
//   at the neighbour itself (d2 == 0, T^2 > 0): g += (20 / T^2) c.
// Every masked neighbour counts, inside its support or not.  Output per
// pixel: [g(3) | h00 h01 h02 h11 h12 h22 | count].
__global__ void __launch_bounds__(kThreads)
curvature_kernel(const float* __restrict__ vertex, const float* __restrict__ normal,
                 const float* __restrict__ radius, float* __restrict__ out,
                 int h, int w, int R, float depth_min) {
  extern __shared__ float smem[];
  const int TW = kTileX + 2 * R;
  const int TH = kTileY + 2 * R;
  const int n_pix = TW * TH;
  float* tv = smem;              // [n_pix][3] vertex
  float* tn = smem + 3 * n_pix;  // [n_pix][3] normal
  float* tr = smem + 6 * n_pix;  // [n_pix] support radius
  const int x0 = blockIdx.x * kTileX - R;
  const int y0 = blockIdx.y * kTileY - R;
  const int tid = threadIdx.y * kTileX + threadIdx.x;

  for (int i = tid; i < n_pix; i += kThreads) {
    const int gx = x0 + i % TW;
    const int gy = y0 + i / TW;
    const bool in = in_image(gx, gy, w, h);
    const int64_t g = static_cast<int64_t>(gy) * w + gx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      tv[i * 3 + c] = in ? vertex[g * 3 + c] : 0.f;
      tn[i * 3 + c] = in ? normal[g * 3 + c] : 0.f;
    }
    tr[i] = in ? radius[g] : 0.f;
  }
  __syncthreads();

  const int x = blockIdx.x * kTileX + threadIdx.x;
  const int y = blockIdx.y * kTileY + threadIdx.y;
  if (x >= w || y >= h) return;
  const int ci = (threadIdx.y + R) * TW + threadIdx.x + R;
  const float px = tv[ci * 3], py = tv[ci * 3 + 1], pz = tv[ci * 3 + 2];
  float g0 = 0.f, g1 = 0.f, g2 = 0.f;
  float h00 = 0.f, h01 = 0.f, h02 = 0.f, h11 = 0.f, h12 = 0.f, h22 = 0.f;
  int cnt = 0;
  for (int dy = -R; dy <= R; ++dy) {
    for (int dx = -R; dx <= R; ++dx) {
      const int j = ci + dy * TW + dx;
      const float qz = tv[j * 3 + 2];
      const float nx = tn[j * 3], ny = tn[j * 3 + 1], nz = tn[j * 3 + 2];
      if (!(fabsf(qz - pz) < 0.10f && qz > depth_min &&
            nx * nx + ny * ny + nz * nz > 0.64f))
        continue;
      ++cnt;
      const float vx = px - tv[j * 3], vy = py - tv[j * 3 + 1], vz = pz - qz;
      const float d2 = vx * vx + vy * vy + vz * vz;
      const float T = tr[j];
      const float T2 = T * T;
      const float sT2 = fmaxf(T2, 1e-12f);
      const float cx = 10.f * nx, cy = 10.f * ny, cz = 10.f * nz;
      if (d2 <= T2 && d2 > 0.f) {
        const float r = sqrtf(fmaxf(d2, 0.f) / sT2);
        const float sr = fmaxf(r, 1e-20f);
        const float s = fmaxf(1.f - r, 0.f);
        const float b = s * s / sr;
        const float vc = vx * cx + vy * cy + vz * cz;
        const float a = -20.f * (s * s * s) / sT2;
        const float bvc = (60.f * b / (sT2 * sT2)) * vc;
        g0 += -a * cx - bvc * vx;
        g1 += -a * cy - bvc * vy;
        g2 += -a * cz - bvc * vz;
        const float c60 = 60.f / (sT2 * sT2);
        const float k = (2.f * s + b) / (sT2 * sr * sr);
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
        const float a0 = 20.f / sT2;
        g0 += a0 * cx;
        g1 += a0 * cy;
        g2 += a0 * cz;
      }
    }
  }
  float* o = out + (static_cast<int64_t>(y) * w + x) * 10;
  o[0] = g0; o[1] = g1; o[2] = g2;
  o[3] = h00; o[4] = h01; o[5] = h02; o[6] = h11; o[7] = h12; o[8] = h22;
  o[9] = static_cast<float>(cnt);
}

dim3 grid_for(int h, int w) {
  return dim3((w + kTileX - 1) / kTileX, (h + kTileY - 1) / kTileY);
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
  // the plain version's constants, rounded to float32 as it rounds them
  const float ss = static_cast<float>(0.024691358);          // 0.5 / 4.5^2 px^-2
  const float sc = static_cast<float>(0.000555556 * 1e6);    // 0.5 / 0.03^2 m^-2
  bilateral_kernel<<<grid_for(h, w), dim3(kTileX, kTileY), 0,
                     static_cast<cudaStream_t>(stream)>>>(
      depth, out, h, w, depth_min, depth_cutoff, pallas_form ? 1 : 0, ss, sc);
  return static_cast<int>(cudaGetLastError());
}

// filtered vertex map (h, w, 3) -> normal (h, w, 3), 0 where invalid.
extern "C" int normal_pca_launch(const float* vertex, float* normal, int h,
                                 int w, float depth_min, void* stream) {
  if (h <= 0 || w <= 0) return static_cast<int>(cudaErrorInvalidValue);
  pca_kernel<<<grid_for(h, w), dim3(kTileX, kTileY), 0,
               static_cast<cudaStream_t>(stream)>>>(vertex, normal, h, w,
                                                    depth_min);
  return static_cast<int>(cudaGetLastError());
}

// vertex (h, w, 3), normal (h, w, 3), radius (h, w) -> out (h, w, 10).
extern "C" int curvature_sums_launch(const float* vertex, const float* normal,
                                     const float* radius, float* out, int h,
                                     int w, int window, float depth_min,
                                     void* stream) {
  if (h <= 0 || w <= 0 || window < 0 || window > kMaxCurvR)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kTileX + 2 * window) *
                      (kTileY + 2 * window) * 7 * sizeof(float);
  curvature_kernel<<<grid_for(h, w), dim3(kTileX, kTileY), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      vertex, normal, radius, out, h, w, window, depth_min);
  return static_cast<int>(cudaGetLastError());
}
