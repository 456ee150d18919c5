// The backward walk shared by K2 (blend_padded_bwd.cu) and K4
// (blend_exact_bwd.cu).
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
// g_alpha is zero where the slot was skipped (alpha test failed) or alpha
// was clamped at 0.99.  Only the first n_contrib slots count, as in the
// forward.
//
// A block of 256 threads (one pixel each) walks the slots of one chunk in
// reverse and leaves each slot's ten grads summed over the block's pixels in
// a fixed order (no atomics: reruns are bit-identical).  What the walk does
// about the per-slot reduction over 256 pixels (not in the bound) and the
// chain of latencies of a serial walk:
// - a vote first: a warp in which no pixel passes the alpha test of a slot
//   writes zero partials and does neither the rest of that slot's backward
//   nor a reduction (exact: its partials are 0);
// - one transpose-reduction per contributing warp-slot instead of ten
//   butterflies: a recursive-halving reduce-scatter of the ten partials
//   (padded to 16) over the lanes, 12 shuffles where ten butterflies take
//   50, after which lane c holds the warp's sum of channel c;
// - two slots a round, as one straight run: their alpha tests, logs, exps
//   and reductions are independent and overlap, which shortens the chain a
//   warp waits on per slot;
// - kBwdChunk slots a round staged and reduced: one barrier pair and one
//   pass of warp-partial sums (part_sum) per chunk;
// - no skip ahead of expf: most walked warp-slots of the backward have a
//   passing pixel (80% at the 512x512 bench shape), so a vote on the
//   forward's per-slot threshold before the alpha tests costs more than the
//   alpha tests it saves.
// The gradient arithmetic after the alpha test uses explicit fused
// multiply-adds and a fast division by max(1 - alpha, 1e-4) (2 ulp); the
// alpha test itself keeps the separate products of eval_slot, as the
// build's -fmad=false asks, and log1p and exp stay the accurate ones: log T
// is rebuilt by subtracting them slot after slot.
#pragma once

#include "blend_common.cuh"

namespace blend {

constexpr int kBwdChunk = 64;          // slots staged and reduced per round
constexpr int kWarps = kPix / 32;
constexpr unsigned kFull = 0xffffffffu;

// Each warp's sums of each staged slot's ten grads.
using BwdPart = float[kWarps][kBwdChunk][kCh];

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

// The backward of one slot for one pixel after its alpha test ``e``: the
// ten partials to ``d`` and the carry updated.  ``live`` (slot index below
// n_contrib and the alpha test passed) gates it lane by lane with selects,
// not branches, so that two slots' backwards form one straight run: a slot
// that does not contribute gets zero partials and leaves the carry as it
// is (its alpha counts as 0, and log1p(-0) = 0).
template <typename Slot>
__device__ __forceinline__ void slot_bwd(const Slot& s, const SlotEval& e,
                                         bool live, BwdPixel& st, float* d) {
  const float alpha = live ? e.alpha : 0.f;
  const float tlog_before = st.tlog_after - log1pf(-alpha);
  const float t_excl = expf(tlog_before);
  const float w = alpha * t_excl;
  const float pg = fmaf(st.gr, s(CR), fmaf(st.gg, s(CG), fmaf(
      st.gb, s(CBL), fmaf(st.gi, s(ID), st.ga))));
  const float g_alpha =
      live && e.raw < kAlphaMax
          ? fmaf(t_excl, pg, -__fdividef(st.suffix + st.gtf,
                                         fmaxf(1.f - alpha, 1e-4f)))
          : 0.f;
  const float g_power = alpha * g_alpha;
  const float dx = e.dx, dy = e.dy;
  d[MX] = g_power * fmaf(s(CA), dx, s(CB) * dy);
  d[MY] = g_power * fmaf(s(CC), dy, s(CB) * dx);
  d[CA] = g_power * (-0.5f * dx * dx);
  d[CB] = g_power * (-dx * dy);
  d[CC] = g_power * (-0.5f * dy * dy);
  d[CR] = st.gr * w;
  d[CG] = st.gg * w;
  d[CBL] = st.gb * w;
  d[OP] = e.expp * g_alpha;
  d[ID] = w * st.gi;
  if (live) st.suffix = fmaf(w, pg, st.suffix);
  st.tlog_after = tlog_before;
}

// One halving step: the lane whose ``bit`` is set keeps ``hi`` and sends
// ``lo`` to its partner ``off`` lanes away, the other keeps ``lo`` and
// sends ``hi``; each adds what it receives to what it keeps.
__device__ __forceinline__ float halve(float lo, float hi, bool bit,
                                       int off) {
  const float keep = bit ? hi : lo;
  const float send = bit ? lo : hi;
  return keep + __shfl_xor_sync(kFull, send, off);
}

// Reduce-scatter of the ten partials over the warp: returns, in lane c and
// lane c + 16, the warp's sum of channel c (c < 10; lanes 10-15 and 26-31
// get zeros).  Step i halves the channels by channel bit i against lane
// bit i; the last step adds the two half-warps.  A fixed order of sums.
__device__ __forceinline__ float reduce_scatter(const float* d, int lane) {
  const bool b0 = lane & 1, b1 = lane & 2, b2 = lane & 4, b3 = lane & 8;
  // a_i: channel 2i + b0
  const float a0 = halve(d[0], d[1], b0, 1), a1 = halve(d[2], d[3], b0, 1),
              a2 = halve(d[4], d[5], b0, 1), a3 = halve(d[6], d[7], b0, 1),
              a4 = halve(d[8], d[9], b0, 1);
  // c_i: channel 4i + 2 b1 + b0
  const float c0 = halve(a0, a1, b1, 2), c1 = halve(a2, a3, b1, 2),
              c2 = halve(a4, 0.f, b1, 2);
  // e_i: channel 8i + 4 b2 + 2 b1 + b0
  const float e0 = halve(c0, c1, b2, 4), e1 = halve(c2, 0.f, b2, 4);
  // channel lane & 15
  const float f = halve(e0, e1, b3, 8);
  return f + __shfl_xor_sync(kFull, f, 16);
}

// Reverse walk over ``n`` staged slots (local index j, slot-list index
// k0 + j) of one chunk, two a round (j, then j - 1; the first slot alone
// when n is odd); the warp's sums of slot j go to part[warp][j][c].
// ``load(j)`` reads staged slot j into registers.
template <typename Load>
__device__ __forceinline__ void walk_chunk(Load load, int n, int k0,
                                           BwdPixel& st, BwdPart& part) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int j = n - 1;
  for (; j >= 1; j -= 2) {
    float ra = 0.f, rb = 0.f;
    if (__any_sync(kFull, k0 + j - 1 < st.nc)) {
      const auto sa = load(j), sb = load(j - 1);
      const SlotEval ea = eval_slot(sa, st.px, st.py);
      const SlotEval eb = eval_slot(sb, st.px, st.py);
      const bool la = k0 + j < st.nc && ea.ok;
      const bool lb = k0 + j - 1 < st.nc && eb.ok;
      const unsigned ba = __ballot_sync(kFull, la);
      const unsigned bb = __ballot_sync(kFull, lb);
      float da[kCh], db[kCh];
      if (ba && bb) {
        slot_bwd(sa, ea, la, st, da);
        slot_bwd(sb, eb, lb, st, db);
        ra = reduce_scatter(da, lane);
        rb = reduce_scatter(db, lane);
      } else if (ba) {
        slot_bwd(sa, ea, la, st, da);
        ra = reduce_scatter(da, lane);
      } else if (bb) {
        slot_bwd(sb, eb, lb, st, db);
        rb = reduce_scatter(db, lane);
      }
    }
    if (lane < kCh) {
      part[warp][j][lane] = ra;
      part[warp][j - 1][lane] = rb;
    }
  }
  if (j == 0) {
    float r = 0.f;
    if (__any_sync(kFull, k0 < st.nc)) {
      const auto s = load(0);
      const SlotEval e = eval_slot(s, st.px, st.py);
      const bool l = k0 < st.nc && e.ok;
      if (__ballot_sync(kFull, l)) {
        float d[kCh];
        slot_bwd(s, e, l, st, d);
        r = reduce_scatter(d, lane);
      }
    }
    if (lane < kCh) part[warp][0][lane] = r;
  }
}

// The block's sum of staged slot j, channel c: the warp sums in warp order.
__device__ __forceinline__ float part_sum(const BwdPart& part, int j,
                                          int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += part[w][j][c];
  return s;
}

}  // namespace blend
