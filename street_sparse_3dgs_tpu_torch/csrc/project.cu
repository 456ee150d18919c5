// project: the per-row projection chain and its backward, one thread a row.
//
// Replaces no Pallas kernel: street_sparse_3dgs_tpu/ops/preprocess.py
// project_gaussians is XLA's fusion of the chain, and its backward XLA's
// VJP.  The port ran the same chain in PyTorch (ops/preprocess.py: about
// 320 kernel launches forward over [N] tensors, and a backward graph of 438
// autograd nodes, about 850 launches), 4.7-4.9 device ms a request at 1M
// rows plus the host's dispatch of every op.
//
// Forward, for row i (every row, inactive padding included):
//   view / clip  p_view = V [x; 1], p_clip = P [x; 1], w_safe, NDC, pixels;
//   covariance   q / max(|q|, 1e-12) -> R, s = scales * scale_modifier,
//                a = W R diag(s), Sigma = a a^T (W the view's rotation);
//   EWA          the 1.3 tan-fov clamps, J, J Sigma J^T + LOW_PASS;
//   conic        det, the inverse, radius = ceil(3 sqrt(lambda_max));
//   validity     depth > NEAR_CULL, det > 0, the mask, in the image,
//                radius > 0;
//   colour       SH of degree D (a template) at the unit view direction,
//                + 0.5, clamped at 0;
// and the masked depth, inverse depth, radius and opacity.  Every float
// operation is ops/preprocess.py's, in its order and rounding: the build
// has no FMA contraction (-fmad=false) and no fast math (IEEE division and
// sqrtf); clamps propagate NaN as torch.clamp does.  The plain path's
// [N, 4] @ [4, 4] products and the SH sum go through cuBLAS in another
// summation order, so the two agree to a few ulp, not bit for bit.
//
// Backward: each thread recomputes its row's forward in registers from
// the saved inputs (nothing is stored between the passes) and applies the
// chain rule with autograd's conventions at branch points: a clamp passes
// the gradient at its inclusive bounds, each select sends it to its chosen
// branch only, ceil and the masks pass none, SH coefficients past
// (D + 1)^2 get zero.  ops/preprocess.py project_backward_plain is the
// same computation in PyTorch, line for line.  Rows are independent: no
// atomics, so reruns are bit-identical.
//
// Bound on the card: bytes.  Forward ~286 B a row (means, scales, quats,
// opacity, 16 SH coefficients and the mask in, 49 B out), backward ~525 B
// (the inputs, the cotangents, the five gradients).  Design:
// - one thread a row, 128-thread blocks (8192 blocks at 1M rows);
// - a warp's SH rows (32 rows of K x 3 floats, one contiguous run) are
//   staged through shared memory with coalesced 16-byte loads, and the
//   backward's SH gradients leave the same way, zeros past (D + 1)^2
//   included; the shared rows have an odd pitch, so a thread's walk along
//   its own row hits 32 banks;
// - the camera (two 4x4 matrices, centre, tan-fov and focal values) is
//   read by pointer from its device tensors into shared memory once a
//   block; width, height, D, K and the scale modifier are launch
//   arguments, so no host copy precedes the launch.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// ops/preprocess.py NEAR_CULL and core/covariance.py LOW_PASS.
constexpr float kNearCull = 0.2f;
constexpr float kLowPass = 0.3f;

// core/sh.py's constants, as float32 (PyTorch rounds a Python float
// multiplying a float32 tensor to float32).
constexpr float C0 = 0.28209479177387814f;
constexpr float C1 = 0.4886025119029199f;
constexpr float C2_0 = 1.0925484305920792f, C2_1 = -1.0925484305920792f,
                C2_2 = 0.31539156525252005f, C2_3 = -1.0925484305920792f,
                C2_4 = 0.5462742152960396f;
constexpr float C3_0 = -0.5900435899266435f, C3_1 = 2.890611442640554f,
                C3_2 = -0.4570457994644658f, C3_3 = 0.3731763325901154f,
                C3_4 = -0.4570457994644658f, C3_5 = 1.445305721320277f,
                C3_6 = -0.5900435899266435f;
constexpr float C4_0 = 2.5033429417967046f, C4_1 = -1.7701307697799304f,
                C4_2 = 0.9461746957575601f, C4_3 = -0.6690465435572892f,
                C4_4 = 0.10578554691520431f, C4_5 = -0.6690465435572892f,
                C4_6 = 0.47308734787878004f, C4_7 = -1.7701307697799304f,
                C4_8 = 0.6258357354491761f;

// torch.clamp: NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : (v < lo ? lo : v);
}

__device__ __forceinline__ float clamp_both(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// Row i of a [N, 4] array: one 16-byte load where the array is aligned.
__device__ __forceinline__ float4 load4(const float* p, long long i) {
  if ((reinterpret_cast<std::uintptr_t>(p) & 15) == 0)
    return __ldg(reinterpret_cast<const float4*>(p) + i);
  return make_float4(p[4 * i], p[4 * i + 1], p[4 * i + 2], p[4 * i + 3]);
}

struct Camera {
  float view[16];
  float proj[16];
  float campos[3];
  float tan_fovx, tan_fovy, focal_x, focal_y;
};

// The camera into shared memory, once a block (every thread then reaches
// the __syncthreads).
__device__ __forceinline__ void load_camera(
    Camera& cam, const float* view, const float* proj, const float* campos,
    const float* tan_fovx, const float* tan_fovy, const float* focal_x,
    const float* focal_y) {
  const int t = threadIdx.x;
  if (t < 16) {
    cam.view[t] = __ldg(view + t);
    cam.proj[t] = __ldg(proj + t);
  } else if (t < 19) {
    cam.campos[t - 16] = __ldg(campos + t - 16);
  } else if (t == 19) {
    cam.tan_fovx = __ldg(tan_fovx);
    cam.tan_fovy = __ldg(tan_fovy);
    cam.focal_x = __ldg(focal_x);
    cam.focal_y = __ldg(focal_y);
  }
  __syncthreads();
}

// One row's forward up to the colour: every intermediate the backward
// reads again.
struct Geometry {
  float vx, vy, vz;              // p_view[:3] (vz is the depth)
  float cx, cy, cw, ws;          // p_clip x, y, w and w_safe
  float m2x, m2y;                // mean2d
  float qn, qc;                  // |q| and its clamp
  float qw, qx, qy, qz;          // the normalised quaternion
  float R[9];                    // rotation, row-major
  float s[3];                    // scales * scale_modifier
  float a[9];                    // W R diag(s), row-major
  float c00, c01, c02, c11, c12, c22;   // camera-space covariance
  float lim_x, lim_y, tzs, ux, uy, cux, cuy, txz, tyz;
  float inv_z, inv_z2, j00, j02, j11, j12;
  float t00, t01, t02, t10, t11, t12;
  float cxx, cxy, cyy, det, inv_det;
  float radius;                  // before the mask
  bool valid;
};

__device__ __forceinline__ void geometry(
    const Camera& cam, float x, float y, float z, float sx, float sy,
    float sz, float4 q, bool active, float width, float height,
    float scale_modifier, Geometry& g) {
  const float* V = cam.view;
  const float* P = cam.proj;
  g.vx = V[0] * x + V[1] * y + V[2] * z + V[3];
  g.vy = V[4] * x + V[5] * y + V[6] * z + V[7];
  g.vz = V[8] * x + V[9] * y + V[10] * z + V[11];
  g.cx = P[0] * x + P[1] * y + P[2] * z + P[3];
  g.cy = P[4] * x + P[5] * y + P[6] * z + P[7];
  g.cw = P[12] * x + P[13] * y + P[14] * z + P[15];
  g.ws = fabsf(g.cw) > 1e-7f ? g.cw : 1e-7f;
  const float ndc_x = g.cx / g.ws;
  const float ndc_y = g.cy / g.ws;
  g.m2x = ((ndc_x + 1.0f) * width - 1.0f) * 0.5f;
  g.m2y = ((ndc_y + 1.0f) * height - 1.0f) * 0.5f;

  // core/quaternion.py normalize and to_rotation_matrix.
  g.qn = sqrtf(q.x * q.x + q.y * q.y + q.z * q.z + q.w * q.w);
  g.qc = clamp_min(g.qn, 1e-12f);
  const float w = q.x / g.qc, qx = q.y / g.qc, qy = q.z / g.qc,
              qz = q.w / g.qc;
  g.qw = w;
  g.qx = qx;
  g.qy = qy;
  g.qz = qz;
  float* R = g.R;
  R[0] = 1.0f - 2.0f * (qy * qy + qz * qz);
  R[1] = 2.0f * (qx * qy - w * qz);
  R[2] = 2.0f * (qx * qz + w * qy);
  R[3] = 2.0f * (qx * qy + w * qz);
  R[4] = 1.0f - 2.0f * (qx * qx + qz * qz);
  R[5] = 2.0f * (qy * qz - w * qx);
  R[6] = 2.0f * (qx * qz - w * qy);
  R[7] = 2.0f * (qy * qz + w * qx);
  R[8] = 1.0f - 2.0f * (qx * qx + qy * qy);

  // core/covariance.py camera_cov3d.
  g.s[0] = sx * scale_modifier;
  g.s[1] = sy * scale_modifier;
  g.s[2] = sz * scale_modifier;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g.a[3 * i + j] = V[4 * i] * R[j] * g.s[j] +
                       V[4 * i + 1] * R[3 + j] * g.s[j] +
                       V[4 * i + 2] * R[6 + j] * g.s[j];
    }
  }
  const float* a = g.a;
  g.c00 = a[0] * a[0] + a[1] * a[1] + a[2] * a[2];
  g.c01 = a[0] * a[3] + a[1] * a[4] + a[2] * a[5];
  g.c02 = a[0] * a[6] + a[1] * a[7] + a[2] * a[8];
  g.c11 = a[3] * a[3] + a[4] * a[4] + a[5] * a[5];
  g.c12 = a[3] * a[6] + a[4] * a[7] + a[5] * a[8];
  g.c22 = a[6] * a[6] + a[7] * a[7] + a[8] * a[8];

  // core/covariance.py project_cov3d (c10 = c01, c20 = c02, c21 = c12).
  g.lim_x = 1.3f * cam.tan_fovx;
  g.lim_y = 1.3f * cam.tan_fovy;
  g.tzs = clamp_min(g.vz, 1e-6f);
  g.ux = g.vx / g.tzs;
  g.uy = g.vy / g.tzs;
  g.cux = clamp_both(g.ux, -g.lim_x, g.lim_x);
  g.cuy = clamp_both(g.uy, -g.lim_y, g.lim_y);
  g.txz = g.cux * g.tzs;
  g.tyz = g.cuy * g.tzs;
  g.inv_z = 1.0f / g.tzs;
  g.inv_z2 = g.inv_z * g.inv_z;
  g.j00 = cam.focal_x * g.inv_z;
  g.j02 = -cam.focal_x * g.txz * g.inv_z2;
  g.j11 = cam.focal_y * g.inv_z;
  g.j12 = -cam.focal_y * g.tyz * g.inv_z2;
  g.t00 = g.j00 * g.c00 + g.j02 * g.c02;
  g.t01 = g.j00 * g.c01 + g.j02 * g.c12;
  g.t02 = g.j00 * g.c02 + g.j02 * g.c22;
  g.t10 = g.j11 * g.c01 + g.j12 * g.c02;
  g.t11 = g.j11 * g.c11 + g.j12 * g.c12;
  g.t12 = g.j11 * g.c12 + g.j12 * g.c22;
  g.cxx = g.t00 * g.j00 + g.t02 * g.j02 + kLowPass;
  g.cxy = g.t00 * 0.0f + g.t01 * g.j11 + g.t02 * g.j12;
  g.cyy = g.t10 * 0.0f + g.t11 * g.j11 + g.t12 * g.j12 + kLowPass;

  // core/covariance.py conic_and_radius.
  g.det = g.cxx * g.cyy - g.cxy * g.cxy;
  const float det_safe = g.det > 0.0f ? g.det : 1.0f;
  g.inv_det = 1.0f / det_safe;
  const float mid = 0.5f * (g.cxx + g.cyy);
  const float disc = sqrtf(clamp_min(mid * mid - g.det, 0.1f));
  const float lambda1 = mid + disc;
  g.radius = ceilf(3.0f * sqrtf(clamp_min(lambda1, 0.0f)));

  const float r = g.radius;
  const bool in_image = (g.m2x + r >= 0.0f) && (g.m2x - r <= width) &&
                        (g.m2y + r >= 0.0f) && (g.m2y - r <= height);
  g.valid = (g.vz > kNearCull) && (g.det > 0.0f) && active && in_image &&
            (r > 0.0f);
}

// core/sh.py sh_basis, D the degree; b holds (D + 1)^2 values.
template <int D>
__device__ __forceinline__ void sh_basis(float x, float y, float z,
                                         float* b) {
  b[0] = C0;
  if (D >= 1) {
    b[1] = -C1 * y;
    b[2] = C1 * z;
    b[3] = -C1 * x;
  }
  if (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, yz = y * z, xz = x * z;
    b[4] = C2_0 * xy;
    b[5] = C2_1 * yz;
    b[6] = C2_2 * (2.0f * zz - xx - yy);
    b[7] = C2_3 * xz;
    b[8] = C2_4 * (xx - yy);
    if (D >= 3) {
      b[9] = C3_0 * y * (3.0f * xx - yy);
      b[10] = C3_1 * xy * z;
      b[11] = C3_2 * y * (4.0f * zz - xx - yy);
      b[12] = C3_3 * z * (2.0f * zz - 3.0f * xx - 3.0f * yy);
      b[13] = C3_4 * x * (4.0f * zz - xx - yy);
      b[14] = C3_5 * z * (xx - yy);
      b[15] = C3_6 * x * (xx - 3.0f * yy);
    }
    if (D >= 4) {
      b[16] = C4_0 * xy * (xx - yy);
      b[17] = C4_1 * yz * (3.0f * xx - yy);
      b[18] = C4_2 * xy * (7.0f * zz - 1.0f);
      b[19] = C4_3 * yz * (7.0f * zz - 3.0f);
      b[20] = C4_4 * (zz * (35.0f * zz - 30.0f) + 3.0f);
      b[21] = C4_5 * xz * (7.0f * zz - 3.0f);
      b[22] = C4_6 * (xx - yy) * (7.0f * zz - 1.0f);
      b[23] = C4_7 * xz * (xx - 3.0f * yy);
      b[24] = C4_8 * (xx * (xx - 3.0f * yy) - yy * (3.0f * xx - yy));
    }
  }
}

// The gradient of sum_k gb[k] * b_k(x, y, z) with respect to (x, y, z):
// each basis polynomial's partial derivatives.
template <int D>
__device__ __forceinline__ void sh_basis_grad(float x, float y, float z,
                                              const float* gb, float& gx,
                                              float& gy, float& gz) {
  gx = 0.0f;
  gy = 0.0f;
  gz = 0.0f;
  if (D >= 1) {
    gy += gb[1] * -C1;
    gz += gb[2] * C1;
    gx += gb[3] * -C1;
  }
  if (D >= 2) {
    const float xx = x * x, yy = y * y, zz = z * z;
    gx += gb[4] * (C2_0 * y);
    gy += gb[4] * (C2_0 * x);
    gy += gb[5] * (C2_1 * z);
    gz += gb[5] * (C2_1 * y);
    gx += gb[6] * (C2_2 * (-2.0f * x));
    gy += gb[6] * (C2_2 * (-2.0f * y));
    gz += gb[6] * (C2_2 * (4.0f * z));
    gx += gb[7] * (C2_3 * z);
    gz += gb[7] * (C2_3 * x);
    gx += gb[8] * (C2_4 * (2.0f * x));
    gy += gb[8] * (C2_4 * (-2.0f * y));
    if (D >= 3) {
      gx += gb[9] * (C3_0 * (6.0f * x * y));
      gy += gb[9] * (C3_0 * (3.0f * xx - 3.0f * yy));
      gx += gb[10] * (C3_1 * (y * z));
      gy += gb[10] * (C3_1 * (x * z));
      gz += gb[10] * (C3_1 * (x * y));
      gx += gb[11] * (C3_2 * (-2.0f * x * y));
      gy += gb[11] * (C3_2 * (4.0f * zz - xx - 3.0f * yy));
      gz += gb[11] * (C3_2 * (8.0f * y * z));
      gx += gb[12] * (C3_3 * (-6.0f * x * z));
      gy += gb[12] * (C3_3 * (-6.0f * y * z));
      gz += gb[12] * (C3_3 * (6.0f * zz - 3.0f * xx - 3.0f * yy));
      gx += gb[13] * (C3_4 * (4.0f * zz - 3.0f * xx - yy));
      gy += gb[13] * (C3_4 * (-2.0f * x * y));
      gz += gb[13] * (C3_4 * (8.0f * x * z));
      gx += gb[14] * (C3_5 * (2.0f * x * z));
      gy += gb[14] * (C3_5 * (-2.0f * y * z));
      gz += gb[14] * (C3_5 * (xx - yy));
      gx += gb[15] * (C3_6 * (3.0f * xx - 3.0f * yy));
      gy += gb[15] * (C3_6 * (-6.0f * x * y));
    }
    if (D >= 4) {
      gx += gb[16] * (C4_0 * (y * (3.0f * xx - yy)));
      gy += gb[16] * (C4_0 * (x * (xx - 3.0f * yy)));
      gx += gb[17] * (C4_1 * (6.0f * x * y * z));
      gy += gb[17] * (C4_1 * (3.0f * z * (xx - yy)));
      gz += gb[17] * (C4_1 * (y * (3.0f * xx - yy)));
      gx += gb[18] * (C4_2 * (y * (7.0f * zz - 1.0f)));
      gy += gb[18] * (C4_2 * (x * (7.0f * zz - 1.0f)));
      gz += gb[18] * (C4_2 * (14.0f * x * y * z));
      gy += gb[19] * (C4_3 * (z * (7.0f * zz - 3.0f)));
      gz += gb[19] * (C4_3 * (y * (21.0f * zz - 3.0f)));
      gz += gb[20] * (C4_4 * (z * (140.0f * zz - 60.0f)));
      gx += gb[21] * (C4_5 * (z * (7.0f * zz - 3.0f)));
      gz += gb[21] * (C4_5 * (x * (21.0f * zz - 3.0f)));
      gx += gb[22] * (C4_6 * (2.0f * x * (7.0f * zz - 1.0f)));
      gy += gb[22] * (C4_6 * (-2.0f * y * (7.0f * zz - 1.0f)));
      gz += gb[22] * (C4_6 * (14.0f * z * (xx - yy)));
      gx += gb[23] * (C4_7 * (3.0f * z * (xx - yy)));
      gy += gb[23] * (C4_7 * (-6.0f * x * y * z));
      gz += gb[23] * (C4_7 * (x * (xx - 3.0f * yy)));
      gx += gb[24] * (C4_8 * (4.0f * x * (xx - 3.0f * yy)));
      gy += gb[24] * (C4_8 * (4.0f * y * (yy - 3.0f * xx)));
    }
  }
}

// The unit view direction of core/sh.py sh_to_color.
struct Direction {
  float dx, dy, dz;    // means - campos
  float n, nc;         // |d| and its clamp
  float x, y, z;       // d / nc
};

__device__ __forceinline__ Direction direction(const Camera& cam, float x,
                                               float y, float z) {
  Direction d;
  d.dx = x - cam.campos[0];
  d.dy = y - cam.campos[1];
  d.dz = z - cam.campos[2];
  d.n = sqrtf(d.dx * d.dx + d.dy * d.dy + d.dz * d.dz);
  d.nc = clamp_min(d.n, 1e-12f);
  d.x = d.dx / d.nc;
  d.y = d.dy / d.nc;
  d.z = d.dz / d.nc;
  return d;
}

// The first COLS floats of each of the warp's rows [row0, row0 + nrows)
// of a [N, row_len] array (COLS <= row_len) into shared rows of PITCH
// floats: 16-byte loads over the warp's contiguous run where the rows are
// whole and the run is aligned, else a coalesced walk row by row.
template <int COLS, int PITCH>
__device__ __forceinline__ void stage_in(const float* __restrict__ src,
                                         long long row0, int nrows,
                                         int row_len, float* sm, int lane) {
  const float* base = src + row0 * row_len;
  if (row_len == COLS &&
      (reinterpret_cast<std::uintptr_t>(base) & 15) == 0) {
    const int total = nrows * COLS;
    const int n4 = total >> 2;
    const float4* b4 = reinterpret_cast<const float4*>(base);
    for (int v = lane; v < n4; v += 32) {
      const float4 q = __ldg(b4 + v);
      const float vals[4] = {q.x, q.y, q.z, q.w};
      int r = (4 * v) / COLS;
      int off = 4 * v - r * COLS;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        sm[r * PITCH + off] = vals[u];
        if (++off == COLS) {
          off = 0;
          ++r;
        }
      }
    }
    for (int f = 4 * n4 + lane; f < total; f += 32) {
      const int r = f / COLS;
      sm[r * PITCH + f - r * COLS] = __ldg(base + f);
    }
  } else {
    for (int r = 0; r < nrows; ++r) {
      for (int off = lane; off < COLS; off += 32) {
        sm[r * PITCH + off] = __ldg(base + static_cast<long long>(r) *
                                               row_len + off);
      }
    }
  }
}

// The reverse of stage_in for a gradient: each of the warp's rows of a
// [N, row_len] array gets its COLS shared values, then zeros to row_len.
template <int COLS, int PITCH>
__device__ __forceinline__ void stage_out(float* __restrict__ dst,
                                          long long row0, int nrows,
                                          int row_len, const float* sm,
                                          int lane) {
  float* base = dst + row0 * row_len;
  if (row_len == COLS &&
      (reinterpret_cast<std::uintptr_t>(base) & 15) == 0) {
    const int total = nrows * COLS;
    const int n4 = total >> 2;
    float4* b4 = reinterpret_cast<float4*>(base);
    for (int v = lane; v < n4; v += 32) {
      float vals[4];
      int r = (4 * v) / COLS;
      int off = 4 * v - r * COLS;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        vals[u] = sm[r * PITCH + off];
        if (++off == COLS) {
          off = 0;
          ++r;
        }
      }
      b4[v] = make_float4(vals[0], vals[1], vals[2], vals[3]);
    }
    for (int f = 4 * n4 + lane; f < total; f += 32) {
      const int r = f / COLS;
      base[f] = sm[r * PITCH + f - r * COLS];
    }
  } else {
    for (int r = 0; r < nrows; ++r) {
      for (int off = lane; off < row_len; off += 32) {
        base[static_cast<long long>(r) * row_len + off] =
            off < COLS ? sm[r * PITCH + off] : 0.0f;
      }
    }
  }
}

struct Inputs {
  const float* means;           // [N, 3]
  const float* scales;          // [N, 3]
  const float* quats;           // [N, 4]
  const float* opacities;       // [N] (the forward's alone)
  const float* sh;              // [N, K, 3]
  const unsigned char* mask;    // [N] or null (every row active)
  int n, k;
  float width, height, scale_modifier;
};

struct ForwardOut {
  float* mean2d;                // [N, 2]
  float* depth;                 // [N]
  float* inv_depth;             // [N]
  float* conic;                 // [N, 3]
  float* radius;                // [N]
  float* color;                 // [N, 3]
  float* opacity;               // [N]
  unsigned char* valid;         // [N]
};

// Cotangents (each may be null: zero) and gradients (each may be null:
// not wanted).
struct BackwardIO {
  const float* g_mean2d;
  const float* g_depth;
  const float* g_inv_depth;
  const float* g_conic;
  const float* g_color;
  const float* g_opacity;
  float* d_means;
  float* d_scales;
  float* d_quats;
  float* d_opacities;
  float* d_sh;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
project_fwd_kernel(Inputs in, ForwardOut out, const float* view,
                   const float* proj, const float* campos,
                   const float* tan_fovx, const float* tan_fovy,
                   const float* focal_x, const float* focal_y) {
  constexpr int KD = (D + 1) * (D + 1);
  constexpr int COLS = 3 * KD;
  constexpr int PITCH = COLS | 1;
  __shared__ Camera cam;
  __shared__ float sh_rows[kWarps * 32 * PITCH];
  load_camera(cam, view, proj, campos, tan_fovx, tan_fovy, focal_x,
              focal_y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  const int nrows = static_cast<int>(
      min(32LL, max(0LL, static_cast<long long>(in.n) - row0)));
  float* sm = sh_rows + warp * 32 * PITCH;
  stage_in<COLS, PITCH>(in.sh, row0, nrows, in.k * 3, sm, lane);
  __syncwarp();
  if (lane >= nrows) return;
  const long long i = row0 + lane;

  const float x = in.means[3 * i], y = in.means[3 * i + 1],
              z = in.means[3 * i + 2];
  const float4 q = load4(in.quats, i);
  const bool active = in.mask == nullptr || in.mask[i] != 0;
  Geometry g;
  geometry(cam, x, y, z, in.scales[3 * i], in.scales[3 * i + 1],
           in.scales[3 * i + 2], q, active, in.width, in.height,
           in.scale_modifier, g);

  const Direction d = direction(cam, x, y, z);
  float b[KD];
  sh_basis<D>(d.x, d.y, d.z, b);
  const float* c = sm + lane * PITCH;
  float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
#pragma unroll
  for (int k = 0; k < KD; ++k) {
    e0 = e0 + b[k] * c[3 * k];
    e1 = e1 + b[k] * c[3 * k + 1];
    e2 = e2 + b[k] * c[3 * k + 2];
  }

  reinterpret_cast<float2*>(out.mean2d)[i] = make_float2(g.m2x, g.m2y);
  out.depth[i] = g.valid ? g.vz : __int_as_float(0x7f800000);
  out.inv_depth[i] = g.valid ? 1.0f / clamp_min(g.vz, 1e-6f) : 0.0f;
  out.conic[3 * i] = g.cyy * g.inv_det;
  out.conic[3 * i + 1] = -g.cxy * g.inv_det;
  out.conic[3 * i + 2] = g.cxx * g.inv_det;
  out.radius[i] = g.valid ? g.radius : 0.0f;
  out.color[3 * i] = clamp_min(e0 + 0.5f, 0.0f);
  out.color[3 * i + 1] = clamp_min(e1 + 0.5f, 0.0f);
  out.color[3 * i + 2] = clamp_min(e2 + 0.5f, 0.0f);
  out.opacity[i] = g.valid ? in.opacities[i] : 0.0f;
  out.valid[i] = g.valid ? 1 : 0;
}

__device__ __forceinline__ float load_or_zero(const float* p, long long i) {
  return p == nullptr ? 0.0f : p[i];
}

template <int D>
__global__ void __launch_bounds__(kThreads)
project_bwd_kernel(Inputs in, BackwardIO io, const float* view,
                   const float* proj, const float* campos,
                   const float* tan_fovx, const float* tan_fovy,
                   const float* focal_x, const float* focal_y) {
  constexpr int KD = (D + 1) * (D + 1);
  constexpr int COLS = 3 * KD;
  constexpr int PITCH = COLS | 1;
  __shared__ Camera cam;
  __shared__ float sh_rows[kWarps * 32 * PITCH];
  load_camera(cam, view, proj, campos, tan_fovx, tan_fovy, focal_x,
              focal_y);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row0 =
      static_cast<long long>(blockIdx.x) * kThreads + warp * 32;
  const int nrows = static_cast<int>(
      min(32LL, max(0LL, static_cast<long long>(in.n) - row0)));
  float* sm = sh_rows + warp * 32 * PITCH;
  stage_in<COLS, PITCH>(in.sh, row0, nrows, in.k * 3, sm, lane);
  __syncwarp();

  if (lane < nrows) {
    const long long i = row0 + lane;
    const float x = in.means[3 * i], y = in.means[3 * i + 1],
                z = in.means[3 * i + 2];
    const float4 q = load4(in.quats, i);
    const bool active = in.mask == nullptr || in.mask[i] != 0;
    Geometry g;
    geometry(cam, x, y, z, in.scales[3 * i], in.scales[3 * i + 1],
             in.scales[3 * i + 2], q, active, in.width, in.height,
             in.scale_modifier, g);
    const float* V = cam.view;
    const float* P = cam.proj;

    // Masked outputs: opacity, depth, inverse depth.
    if (io.d_opacities != nullptr)
      io.d_opacities[i] = g.valid ? load_or_zero(io.g_opacity, i) : 0.0f;
    float g_vz = 0.0f;
    if (g.valid) {
      g_vz = g_vz + load_or_zero(io.g_depth, i);
      const float ds = clamp_min(g.vz, 1e-6f);
      const float inv_d = 1.0f / ds;
      const float g_ds = -load_or_zero(io.g_inv_depth, i) * (inv_d * inv_d);
      g_vz = g_vz + (g.vz >= 1e-6f ? g_ds : 0.0f);
    }

    // mean2d -> NDC -> clip.
    float g_m2x = 0.0f, g_m2y = 0.0f;
    if (io.g_mean2d != nullptr) {
      g_m2x = io.g_mean2d[2 * i];
      g_m2y = io.g_mean2d[2 * i + 1];
    }
    const float g_ndc_x = g_m2x * 0.5f * in.width;
    const float g_ndc_y = g_m2y * 0.5f * in.height;
    const float g_cx = g_ndc_x / g.ws;
    const float g_cy = g_ndc_y / g.ws;
    const float ws2 = g.ws * g.ws;
    const float g_ws = -g_ndc_x * g.cx / ws2 + -g_ndc_y * g.cy / ws2;
    const float g_cw = fabsf(g.cw) > 1e-7f ? g_ws : 0.0f;

    // conic -> packed 2D covariance.
    float g_c0 = 0.0f, g_c1 = 0.0f, g_c2 = 0.0f;
    if (io.g_conic != nullptr) {
      g_c0 = io.g_conic[3 * i];
      g_c1 = io.g_conic[3 * i + 1];
      g_c2 = io.g_conic[3 * i + 2];
    }
    const float g_inv_det = g_c0 * g.cyy + g_c1 * -g.cxy + g_c2 * g.cxx;
    float g_cyy = g_c0 * g.inv_det;
    float g_cxy = -(g_c1 * g.inv_det);
    float g_cxx = g_c2 * g.inv_det;
    const float g_det_safe = -g_inv_det * (g.inv_det * g.inv_det);
    const float g_det = g.det > 0.0f ? g_det_safe : 0.0f;
    g_cxx = g_cxx + g_det * g.cyy;
    g_cyy = g_cyy + g_det * g.cxx;
    g_cxy = g_cxy - 2.0f * (g_det * g.cxy);

    // EWA: J and the camera-space covariance.
    const float g_t00 = g_cxx * g.j00 + g_cxy * 0.0f;
    const float g_t02 = g_cxx * g.j02 + g_cxy * g.j12;
    const float g_t01 = g_cxy * g.j11;
    const float g_t10 = g_cyy * 0.0f;
    const float g_t11 = g_cyy * g.j11;
    const float g_t12 = g_cyy * g.j12;
    const float g_j00 = g_cxx * g.t00 + g_t00 * g.c00 + g_t01 * g.c01 +
                        g_t02 * g.c02;
    const float g_j02 = g_cxx * g.t02 + g_t00 * g.c02 + g_t01 * g.c12 +
                        g_t02 * g.c22;
    const float g_j11 = g_cxy * g.t01 + g_cyy * g.t11 + g_t10 * g.c01 +
                        g_t11 * g.c11 + g_t12 * g.c12;
    const float g_j12 = g_cxy * g.t02 + g_cyy * g.t12 + g_t10 * g.c02 +
                        g_t11 * g.c12 + g_t12 * g.c22;
    // Sigma is symmetric: (i, j) and (j, i) are one entry.
    const float g_d00 = g_t00 * g.j00;
    const float g_d01 = g_t01 * g.j00 + g_t10 * g.j11;
    const float g_d02 = g_t02 * g.j00 + (g_t00 * g.j02 + g_t10 * g.j12);
    const float g_d11 = g_t11 * g.j11;
    const float g_d12 = g_t12 * g.j11 + (g_t01 * g.j02 + g_t11 * g.j12);
    const float g_d22 = g_t02 * g.j02 + g_t12 * g.j12;

    const float fx = cam.focal_x, fy = cam.focal_y;
    const float g_inv_z2 = g_j02 * (-fx * g.txz) + g_j12 * (-fy * g.tyz);
    const float g_txz = g_j02 * g.inv_z2 * -fx;
    const float g_tyz = g_j12 * g.inv_z2 * -fy;
    const float g_inv_z =
        g_j00 * fx + g_j11 * fy + 2.0f * (g_inv_z2 * g.inv_z);
    float g_tzs = -g_inv_z * (g.inv_z * g.inv_z);
    g_tzs = g_tzs + g_txz * g.cux + g_tyz * g.cuy;
    const float g_ux =
        (g.ux >= -g.lim_x && g.ux <= g.lim_x) ? g_txz * g.tzs : 0.0f;
    const float g_uy =
        (g.uy >= -g.lim_y && g.uy <= g.lim_y) ? g_tyz * g.tzs : 0.0f;
    const float tzs2 = g.tzs * g.tzs;
    const float g_vx = g_ux / g.tzs;
    const float g_vy = g_uy / g.tzs;
    g_tzs = g_tzs + (-g_ux * g.vx / tzs2 + -g_uy * g.vy / tzs2);
    g_vz = g_vz + (g.vz >= 1e-6f ? g_tzs : 0.0f);

    // Sigma = a a^T -> a -> (R, s).
    const float gd[9] = {g_d00, g_d01, g_d02, g_d01, g_d11, g_d12,
                         g_d02, g_d12, g_d22};
    float g_a[9];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        g_a[3 * r + k] = 2.0f * (gd[4 * r] * g.a[3 * r + k]);
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          if (j != r) g_a[3 * r + k] += gd[3 * r + j] * g.a[3 * j + k];
        }
      }
    }
    float g_R[9];
    float g_s[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      g_s[j] = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) g_R[3 * k + j] = 0.0f;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const float ga = g_a[3 * r + j];
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          g_R[3 * k + j] += ga * g.s[j] * V[4 * r + k];
          g_s[j] += ga * (V[4 * r + k] * g.R[3 * k + j]);
        }
      }
    }
    if (io.d_scales != nullptr) {
      io.d_scales[3 * i] = g_s[0] * in.scale_modifier;
      io.d_scales[3 * i + 1] = g_s[1] * in.scale_modifier;
      io.d_scales[3 * i + 2] = g_s[2] * in.scale_modifier;
    }

    // R -> the normalised quaternion -> q.
    if (io.d_quats != nullptr) {
      const float w = g.qw, qx = g.qx, qy = g.qy, qz = g.qz;
      const float* gR = g_R;
      const float g_w = 2.0f * (-qz * gR[1] + qy * gR[2] + qz * gR[3] -
                                qx * gR[5] - qy * gR[6] + qx * gR[7]);
      const float g_x = 2.0f * (qy * gR[1] + qz * gR[2] + qy * gR[3] -
                                2.0f * qx * gR[4] - w * gR[5] +
                                qz * gR[6] + w * gR[7] -
                                2.0f * qx * gR[8]);
      const float g_y = 2.0f * (-2.0f * qy * gR[0] + qx * gR[1] +
                                w * gR[2] + qx * gR[3] + qz * gR[5] -
                                w * gR[6] + qz * gR[7] -
                                2.0f * qy * gR[8]);
      const float g_z = 2.0f * (-2.0f * qz * gR[0] - w * gR[1] +
                                qx * gR[2] + w * gR[3] -
                                2.0f * qz * gR[4] + qy * gR[5] +
                                qx * gR[6] + qy * gR[7]);
      const float qc2 = g.qc * g.qc;
      const float g_qc = -(g_w * q.x + g_x * q.y + g_y * q.z + g_z * q.w) /
                         qc2;
      const float g_qn = g.qn >= 1e-12f ? g_qc : 0.0f;
      const float norm_scale = g.qn != 0.0f ? g_qn / g.qn : 0.0f;
      reinterpret_cast<float4*>(io.d_quats)[i] =
          make_float4(g_w / g.qc + q.x * norm_scale,
                      g_x / g.qc + q.y * norm_scale,
                      g_y / g.qc + q.z * norm_scale,
                      g_z / g.qc + q.w * norm_scale);
    }

    // Colour: clamp, SH sum, basis, unit direction.
    const Direction d = direction(cam, x, y, z);
    float b[KD];
    sh_basis<D>(d.x, d.y, d.z, b);
    float* c = sm + lane * PITCH;
    float e0 = 0.0f, e1 = 0.0f, e2 = 0.0f;
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      e0 = e0 + b[k] * c[3 * k];
      e1 = e1 + b[k] * c[3 * k + 1];
      e2 = e2 + b[k] * c[3 * k + 2];
    }
    float ge0 = 0.0f, ge1 = 0.0f, ge2 = 0.0f;
    if (io.g_color != nullptr) {
      ge0 = e0 + 0.5f >= 0.0f ? io.g_color[3 * i] : 0.0f;
      ge1 = e1 + 0.5f >= 0.0f ? io.g_color[3 * i + 1] : 0.0f;
      ge2 = e2 + 0.5f >= 0.0f ? io.g_color[3 * i + 2] : 0.0f;
    }
    float gb[KD];
#pragma unroll
    for (int k = 0; k < KD; ++k) {
      gb[k] = ge0 * c[3 * k] + ge1 * c[3 * k + 1] + ge2 * c[3 * k + 2];
      c[3 * k] = ge0 * b[k];          // the row's SH gradient, in place
      c[3 * k + 1] = ge1 * b[k];
      c[3 * k + 2] = ge2 * b[k];
    }
    float g_ux_dir, g_uy_dir, g_uz_dir;
    sh_basis_grad<D>(d.x, d.y, d.z, gb, g_ux_dir, g_uy_dir, g_uz_dir);
    const float nc2 = d.nc * d.nc;
    const float g_nc = -(g_ux_dir * d.dx + g_uy_dir * d.dy +
                         g_uz_dir * d.dz) / nc2;
    const float g_n = d.n >= 1e-12f ? g_nc : 0.0f;
    const float n_scale = d.n != 0.0f ? g_n / d.n : 0.0f;
    const float g_dx = g_ux_dir / d.nc + d.dx * n_scale;
    const float g_dy = g_uy_dir / d.nc + d.dy * n_scale;
    const float g_dz = g_uz_dir / d.nc + d.dz * n_scale;

    if (io.d_means != nullptr) {
      // p_view = V [x; 1], p_clip = P [x; 1]: rows 0-2 of V and 0, 1, 3 of
      // P reach the outputs.
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        io.d_means[3 * i + k] =
            (g_vx * V[k] + g_vy * V[4 + k] + g_vz * V[8 + k]) +
            (g_cx * P[k] + g_cy * P[4 + k] + g_cw * P[12 + k]) +
            (k == 0 ? g_dx : k == 1 ? g_dy : g_dz);
      }
    }
  }
  if (io.d_sh != nullptr) {
    __syncwarp();
    stage_out<COLS, PITCH>(io.d_sh, row0, nrows, in.k * 3, sm, lane);
  }
}

template <int D>
cudaError_t launch_fwd(const Inputs& in, const ForwardOut& out,
                       const float* const* cam, cudaStream_t s) {
  const int blocks = (in.n + kThreads - 1) / kThreads;
  project_fwd_kernel<D><<<blocks, kThreads, 0, s>>>(
      in, out, cam[0], cam[1], cam[2], cam[3], cam[4], cam[5], cam[6]);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bwd(const Inputs& in, const BackwardIO& io,
                       const float* const* cam, cudaStream_t s) {
  const int blocks = (in.n + kThreads - 1) / kThreads;
  project_bwd_kernel<D><<<blocks, kThreads, 0, s>>>(
      in, io, cam[0], cam[1], cam[2], cam[3], cam[4], cam[5], cam[6]);
  return cudaGetLastError();
}

}  // namespace

// Forward.  camera: view [4, 4], proj [4, 4], campos [3], tan_fovx,
// tan_fovy, focal_x, focal_y (0-d), all float32 on the device.  mask may
// be null.  Returns cudaErrorInvalidValue for a degree outside 0..4 or
// k < (degree + 1)^2.
extern "C" int project_fwd_launch(
    const float* means, const float* scales, const float* quats,
    const float* opacities, const float* sh, const unsigned char* mask,
    const float* view, const float* proj, const float* campos,
    const float* tan_fovx, const float* tan_fovy, const float* focal_x,
    const float* focal_y, int n, int k, int degree, int width, int height,
    float scale_modifier, float* mean2d, float* depth, float* inv_depth,
    float* conic, float* radius, float* color, float* opacity,
    unsigned char* valid, void* stream) {
  if (degree < 0 || degree > 4 || k < (degree + 1) * (degree + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Inputs in{means, scales, quats, opacities, sh, mask, n, k,
                  static_cast<float>(width), static_cast<float>(height),
                  scale_modifier};
  const ForwardOut out{mean2d, depth, inv_depth, conic, radius, color,
                       opacity, valid};
  const float* cam[7] = {view, proj, campos, tan_fovx, tan_fovy, focal_x,
                         focal_y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (degree) {
    case 0: rc = launch_fwd<0>(in, out, cam, s); break;
    case 1: rc = launch_fwd<1>(in, out, cam, s); break;
    case 2: rc = launch_fwd<2>(in, out, cam, s); break;
    case 3: rc = launch_fwd<3>(in, out, cam, s); break;
    default: rc = launch_fwd<4>(in, out, cam, s); break;
  }
  return static_cast<int>(rc);
}

// Backward.  The cotangents g_* may each be null (zero); each gradient
// d_* may be null (not written).  d_sh is [N, K, 3], zero past
// (degree + 1)^2.
extern "C" int project_bwd_launch(
    const float* means, const float* scales, const float* quats,
    const float* sh, const unsigned char* mask, const float* view,
    const float* proj, const float* campos, const float* tan_fovx,
    const float* tan_fovy, const float* focal_x, const float* focal_y,
    int n, int k, int degree, int width, int height, float scale_modifier,
    const float* g_mean2d, const float* g_depth, const float* g_inv_depth,
    const float* g_conic, const float* g_color, const float* g_opacity,
    float* d_means, float* d_scales, float* d_quats, float* d_opacities,
    float* d_sh, void* stream) {
  if (degree < 0 || degree > 4 || k < (degree + 1) * (degree + 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const Inputs in{means, scales, quats, nullptr, sh, mask, n, k,
                  static_cast<float>(width), static_cast<float>(height),
                  scale_modifier};
  const BackwardIO io{g_mean2d, g_depth, g_inv_depth, g_conic, g_color,
                      g_opacity, d_means, d_scales, d_quats, d_opacities,
                      d_sh};
  const float* cam[7] = {view, proj, campos, tan_fovx, tan_fovy, focal_x,
                         focal_y};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  switch (degree) {
    case 0: rc = launch_bwd<0>(in, io, cam, s); break;
    case 1: rc = launch_bwd<1>(in, io, cam, s); break;
    case 2: rc = launch_bwd<2>(in, io, cam, s); break;
    case 3: rc = launch_bwd<3>(in, io, cam, s); break;
    default: rc = launch_bwd<4>(in, io, cam, s); break;
  }
  return static_cast<int>(rc);
}
