// Shared per-pixel blend steps of the blend kernels: forward (K1 padded,
// K3 exact; their walk is blend_fwd.cuh) and backward (K2 padded, K4
// exact), which share one alpha test (``eval_slot``).  The rules are those of ops/oracle.py and of the TPU
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

// ---- backward ----------------------------------------------------------
//
// The reverse walk of one pixel (pallas_blend.py _bwd_one_tile :258-343).
// It starts from the saved final log T and, going from the last slot to the
// first, rebuilds the log transmittance before each slot by subtraction
// (log space, no division), keeping the suffix sum of w * (g . c) of the
// slots behind it:
//
//   t_excl  = exp(tlog_after - log1p(-alpha))
//   g_alpha = t_excl * pg - (suffix + g_tfinal) / max(1 - alpha, 1e-4)
//
// with pg = g . (r, g, b, invdepth, 1) and g_tfinal = (g_rgb . bg) * T_final.
// g_alpha is zero where the slot was skipped (!ok) or alpha was clamped at
// 0.99.  Only the first n_contrib slots count, as in the forward.

constexpr int kBwdChunk = 32;          // slots staged and reduced per round
constexpr int kWarps = kPix / 32;

struct BwdPixel {
  float px, py, tlog_after, suffix, gr, gg, gb, gi, ga, gtf;
  int nc;
};

// Pixel ``pix`` of a tile: its saved rows and cotangent rows [8, 256].  The
// cotangents of rows log T, n_contrib and pad are ignored.
__device__ __forceinline__ BwdPixel bwd_pixel(const float* saved,
                                              const float* g_out, int pix,
                                              const float* bg, float px,
                                              float py) {
  BwdPixel st;
  st.px = px;
  st.py = py;
  st.tlog_after = saved[5 * kPix + pix];
  st.nc = static_cast<int>(saved[6 * kPix + pix]);
  st.suffix = 0.f;
  st.gr = g_out[0 * kPix + pix];
  st.gg = g_out[1 * kPix + pix];
  st.gb = g_out[2 * kPix + pix];
  st.gi = g_out[3 * kPix + pix];
  st.ga = g_out[4 * kPix + pix];
  st.gtf = (st.gr * bg[0] + st.gg * bg[1] + st.gb * bg[2])
           * expf(st.tlog_after);
  return st;
}

// Slot ``k`` (index within the pixel's slot list) for one pixel, backward:
// the ten per-slot partials go to ``d``.
template <typename Slot>
__device__ __forceinline__ void blend_slot_bwd(const Slot& s, int k,
                                               BwdPixel& st, float* d) {
#pragma unroll
  for (int c = 0; c < kCh; ++c) d[c] = 0.f;
  if (k >= st.nc) return;
  const SlotEval e = eval_slot(s, st.px, st.py);
  if (!e.ok) return;                 // alpha 0: log1p(-0) = 0, nothing moves
  const float alpha = e.alpha;
  const float lom = log1pf(-alpha);
  const float tlog_before = st.tlog_after - lom;
  const float t_excl = expf(tlog_before);
  const float w = alpha * t_excl;
  const float pg = st.gr * s(CR) + st.gg * s(CG) + st.gb * s(CBL)
                   + st.gi * s(ID) + st.ga;
  float g_alpha = 0.f;
  if (e.raw < kAlphaMax) {
    const float one_m = fmaxf(1.f - alpha, 1e-4f);
    g_alpha = t_excl * pg - (st.suffix + st.gtf) / one_m;
  }
  const float g_power = alpha * g_alpha;
  d[MX] = g_power * (s(CA) * e.dx + s(CB) * e.dy);
  d[MY] = g_power * (s(CC) * e.dy + s(CB) * e.dx);
  d[CA] = g_power * (-0.5f * e.dx * e.dx);
  d[CB] = g_power * (-e.dx * e.dy);
  d[CC] = g_power * (-0.5f * e.dy * e.dy);
  d[CR] = st.gr * w;
  d[CG] = st.gg * w;
  d[CBL] = st.gb * w;
  d[OP] = e.expp * g_alpha;
  d[ID] = w * st.gi;
  st.suffix += w * pg;
  st.tlog_after = tlog_before;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Reverse walk over ``n`` staged slots (local index j, slot-list index
// k0 + j) of one chunk.  Each warp reduces the ten partials of every slot
// over its 32 pixels with shuffles (a fixed order) and lane 0 writes them to
// ``part[warp][j][c]``; a warp in which no pixel reaches slot j writes
// zeros without evaluating it.
template <typename SlotAt>
__device__ __forceinline__ void walk_chunk_bwd(const SlotAt& slot_at, int n,
                                               int k0, BwdPixel& st,
                                               float (*part)[kBwdChunk][kCh]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int j = n - 1; j >= 0; --j) {
    float d[kCh];
    if (__any_sync(0xffffffffu, k0 + j < st.nc)) {
      blend_slot_bwd(slot_at(j), k0 + j, st, d);
#pragma unroll
      for (int c = 0; c < kCh; ++c) d[c] = warp_sum(d[c]);
    } else {
#pragma unroll
      for (int c = 0; c < kCh; ++c) d[c] = 0.f;
    }
    if (lane == 0) {
#pragma unroll
      for (int c = 0; c < kCh; ++c) part[warp][j][c] = d[c];
    }
  }
}

// Sum of the eight warp partials of slot j, channel c, in warp order.
__device__ __forceinline__ float block_sum(float (*part)[kBwdChunk][kCh],
                                           int j, int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w][j][c];
  return s;
}

}  // namespace blend
