// Shared per-pixel blend step of the forward blend kernels (K1 padded,
// K3 exact).  The rules are those of ops/oracle.py and of the TPU kernels
// in street_sparse_3dgs_tpu/ops/pallas_blend.py (_fwd_one_tile):
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

// One slot for one pixel.  ``s(c)`` reads channel c of the slot.
template <typename Slot>
__device__ __forceinline__ void blend_slot(const Slot& s, float px, float py,
                                           Pixel& st) {
  const float dx = px - s(MX);
  const float dy = py - s(MY);
  const float power = -0.5f * (s(CA) * dx * dx + s(CC) * dy * dy)
                      - s(CB) * dx * dy;
  const float alpha = fminf(kAlphaMax, s(OP) * expf(fminf(power, 0.f)));
  if (power <= 0.f && alpha >= kAlphaMin) {
    const float lom = log1pf(-alpha);
    if (st.tlog + lom < kLogEps) {
      st.alive = false;
      return;
    }
    const float w = alpha * expf(st.tlog);
    st.r += w * s(CR);
    st.g += w * s(CG);
    st.b += w * s(CBL);
    st.ivd += w * s(ID);
    st.acc += w;
    st.tlog += lom;
  }
  // A skipped slot has alpha 0 and cannot fail; it counts as passed, as in
  // the TPU kernel's n_contrib.
  st.nc += 1.f;
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
