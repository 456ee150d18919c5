// Shared per-pixel blend steps of the blend kernels: forward (K1 padded,
// K3 exact; their walk is blend_fwd.cuh) and backward (K2 padded, K4
// exact; their walk is blend_bwd.cuh), which share one alpha test
// (``eval_slot``).  The rules are those of ops/oracle.py and of the TPU
// kernels in street_sparse_3dgs_tpu/ops/pallas_blend.py (_fwd_one_tile,
// _bwd_one_tile):
//
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy
//   alpha = min(0.99, opacity * exp(min(power, 0)))
//   skip the slot if power > 0 or alpha < 1/255
//   stop (for good) at the first slot with tlog + log1p(-alpha) < log(1e-4)
//   w = alpha * exp(tlog);  tlog += log1p(-alpha)
//
// Transmittance lives in log space, as on the TPU, so the termination test
// is the same comparison.  Constants are the float32 roundings of the
// double values the JAX package uses.  Build without --use_fast_math
// (expf/log1pf must stay the accurate versions the termination test sits
// on) and with -fmad=false: a fused multiply-add rounds ``power`` otherwise
// than the plain version's separate products, which moves alpha by an ulp
// and flips slots that sit on the 1/255 skip threshold (1/255 in a pixel).
#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // 256 pixels, one thread each
constexpr int kCh = 10;               // mx my ca cb cc r g b op invd
constexpr int kOut = 8;               // R G B invdepth alpha logT n_contrib pad
constexpr int kChunk = 256;           // slots staged in shared memory per round

enum { MX, MY, CA, CB, CC, CR, CG, CBL, OP, ID };

constexpr float kAlphaMin = static_cast<float>(1.0 / 255.0);
constexpr float kAlphaMax = static_cast<float>(0.99);
constexpr float kLogEps = static_cast<float>(-9.210340371976182);  // log(1e-4)

struct Pixel {
  float tlog = 0.f, nc = 0.f, r = 0.f, g = 0.f, b = 0.f, ivd = 0.f, acc = 0.f;
  bool alive = true;
};

// The alpha test of one slot at one pixel.  ``s(c)`` reads channel c.
struct SlotEval {
  float dx, dy, expp, raw, alpha;  // expp = exp(min(power, 0)), raw = op*expp
  bool ok;                         // power <= 0 and alpha >= 1/255
};

template <typename Slot>
__device__ __forceinline__ float slot_power(const Slot& s, float dx,
                                            float dy) {
  return -0.5f * (s(CA) * dx * dx + s(CC) * dy * dy) - s(CB) * dx * dy;
}

// The rest of the test once ``power`` (slot_power at dx, dy) is known.
template <typename Slot>
__device__ __forceinline__ SlotEval alpha_test(const Slot& s, float dx,
                                               float dy, float power) {
  SlotEval e;
  e.dx = dx;
  e.dy = dy;
  e.expp = expf(fminf(power, 0.f));
  e.raw = s(OP) * e.expp;
  e.alpha = fminf(kAlphaMax, e.raw);
  e.ok = power <= 0.f && e.alpha >= kAlphaMin;
  return e;
}

template <typename Slot>
__device__ __forceinline__ SlotEval eval_slot(const Slot& s, float px,
                                              float py) {
  const float dx = px - s(MX);
  const float dy = py - s(MY);
  return alpha_test(s, dx, dy, slot_power(s, dx, dy));
}

// Output rows of a tile [8, 256]: final background composite included.
__device__ __forceinline__ void write_pixel(float* out_tile, int pix,
                                            const Pixel& st,
                                            const float* bg) {
  const float tf = expf(st.tlog);
  out_tile[0 * kPix + pix] = st.r + tf * bg[0];
  out_tile[1 * kPix + pix] = st.g + tf * bg[1];
  out_tile[2 * kPix + pix] = st.b + tf * bg[2];
  out_tile[3 * kPix + pix] = st.ivd;
  out_tile[4 * kPix + pix] = st.acc;
  out_tile[5 * kPix + pix] = st.tlog;
  out_tile[6 * kPix + pix] = st.nc;
  out_tile[7 * kPix + pix] = 0.f;
}

}  // namespace blend
