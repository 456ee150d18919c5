// K4: exact (virtual-tile) backward blend.
//
// Replaces street_sparse_3dgs_tpu/ops/pallas_blend.py _make_bwd_kernel_exact
// (launched by _blend_exact_bwd).  The TPU kernel runs the virtual tiles in
// descending order and carries (log T after, grad suffix) across a tile's
// windows in scratch, starting it from the saved final log T at the tile's
// last window; that needs the broadcast of the per-tile saved and cotangent
// rows onto [T_v, 8, 256].  Here, as in K3, ONE block owns each real tile:
// it reads the tile's saved and cotangent rows [T, 8, 256] directly and
// loops over its windows v = last_v[t] down to last_v[t] - wt[last_v[t]],
// with the carry in registers, walking each window's slots in reverse.
// Slot k of window w counts as included when w * K + k < n_contrib.
//
// Output: pair-major [T_v, K, 10], every slot of a tile's windows written
// (zeros past the window count and for slots no pixel reached); budget
// windows no tile uses, and tiles left out of ``order``, are never touched,
// so the caller passes a zeroed buffer.  No atomics: each slot's grads are
// summed over the tile's pixels in a fixed order, so reruns are
// bit-identical.
//
// Bound on the card: as K3, the special-function units (three per walked
// slot-pixel step); bytes are the pair attrs, the saved and cotangent rows
// read once and the grads written once.  What the design does about the
// rest of the work (the per-slot reduction over 256 pixels, which is not in
// the bound, and the serial walk of deep tiles):
// - a vote first: a warp in which no pixel passes the alpha test of a slot
//   writes zero partials and does neither the rest of that slot's
//   backward nor a reduction (exact: its partials are 0);
// - one transpose-reduction per contributing warp-slot instead of ten
//   butterflies: a recursive-halving reduce-scatter of the ten partials
//   (padded to 16) over the lanes, 12 shuffles where ten butterflies take
//   50, after which lane c holds the warp's sum of channel c;
// - two slots a round, as one straight run: their alpha tests, logs, exps
//   and reductions are independent and overlap, which shortens the chain
//   of latencies a warp waits on per slot (what sets the time of a deep
//   tile, whose block runs mostly alone at the end of the launch);
// - 64 slots staged and reduced a round: one barrier pair and one pass of
//   warp-partial sums per 64 slots;
// - blocks take the tiles deepest first (``order``, from the wrapper), so
//   the tiles with the most windows do not start last and set the tail.
// The gradient arithmetic after the alpha test uses explicit fused
// multiply-adds and a fast division by max(1 - alpha, 1e-4) (2 ulp); the
// alpha test itself (power, alpha, the skip test) keeps the separate
// products of eval_slot, as the build's -fmad=false asks, and log1p and exp
// stay the accurate ones: log T is rebuilt by subtracting them slot after
// slot.
//
// K2 (blend_padded_bwd.cu) keeps the shared walk of blend_common.cuh.

#include "blend_common.cuh"

using namespace blend;

namespace {

constexpr int kChunk4 = 64;            // slots staged and reduced per round
constexpr unsigned kFull = 0xffffffffu;

// A staged slot's ten channels, read from shared memory into registers.
struct Staged {
  float v[kCh];
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};

__device__ __forceinline__ Staged load_slot(const float* sh, int j) {
  Staged s;
#pragma unroll
  for (int c = 0; c < kCh; ++c) s.v[c] = sh[j * kCh + c];
  return s;
}

// The backward of one slot for one pixel after its alpha test ``e``: the
// ten partials to ``d`` and the carry updated (the formulas of
// blend_common.cuh blend_slot_bwd).  ``live`` (slot index below n_contrib
// and the alpha test passed) gates it lane by lane with selects, not
// branches, so that two slots' backwards form one straight run: a slot
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
__device__ __forceinline__ void walk_chunk(const float* sh, int n, int k0,
                                           BwdPixel& st,
                                           float (*part)[kChunk4][kCh]) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int j = n - 1;
  for (; j >= 1; j -= 2) {
    float ra = 0.f, rb = 0.f;
    if (__any_sync(kFull, k0 + j - 1 < st.nc)) {
      const Staged sa = load_slot(sh, j), sb = load_slot(sh, j - 1);
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
      const Staged s = load_slot(sh, 0);
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

__global__ void __launch_bounds__(kPix)
blend_exact_bwd_kernel(const float* __restrict__ attrs,
                       const int* __restrict__ vcounts,
                       const int* __restrict__ wt,
                       const int* __restrict__ last_v,
                       const int* __restrict__ order,
                       const float* __restrict__ bg, int K, int tiles_x,
                       int t_mod, const float* __restrict__ saved,
                       const float* __restrict__ g_out,
                       float* __restrict__ d_attrs) {
  __shared__ float sh[kChunk4 * kCh];
  __shared__ float part[kWarps][kChunk4][kCh];
  const int t = order[blockIdx.x];
  const int pix = threadIdx.x;
  const int tl = t_mod ? t % t_mod : t;
  const float px = static_cast<float>((tl % tiles_x) * kTile)
                   + static_cast<float>(pix % kTile);
  const float py = static_cast<float>((tl / tiles_x) * kTile)
                   + static_cast<float>(pix / kTile);
  const int v_last = last_v[t];
  const int v_first = v_last - wt[v_last];
  BwdPixel st = bwd_pixel(saved + static_cast<size_t>(t) * kOut * kPix,
                          g_out + static_cast<size_t>(t) * kOut * kPix, pix,
                          bg, px, py);

  for (int v = v_last; v >= v_first; --v) {
    const int count = min(vcounts[v], K);
    const int k_win = (v - v_first) * K;     // slot-list index of slot 0
    const float* a = attrs + static_cast<size_t>(v) * K * kCh;
    float* d = d_attrs + static_cast<size_t>(v) * K * kCh;
    for (int i = count * kCh + pix; i < K * kCh; i += kPix) d[i] = 0.f;
    for (int base = (count - 1) / kChunk4 * kChunk4;
         base >= 0 && count > 0; base -= kChunk4) {
      const int n = min(kChunk4, count - base);
      // Also the barrier after the previous chunk's reads of sh and part.
      if (__syncthreads_count(st.nc > k_win + base) == 0) {
        for (int i = pix; i < n * kCh; i += kPix) d[base * kCh + i] = 0.f;
        continue;
      }
      for (int i = pix; i < n * kCh; i += kPix) sh[i] = a[base * kCh + i];
      __syncthreads();
      walk_chunk(sh, n, k_win + base, st, part);
      __syncthreads();
      for (int i = pix; i < n * kCh; i += kPix) {
        const int j = i / kCh, c = i - j * kCh;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += part[w][j][c];
        d[base * kCh + i] = s;
      }
    }
  }
}

}  // namespace

extern "C" int blend_exact_bwd_launch(const float* attrs, const int* vcounts,
                                      const int* wt, const int* last_v,
                                      const int* order, const float* bg,
                                      int n_order, int K, int tiles_x,
                                      int t_mod, const float* saved,
                                      const float* g_out, float* d_attrs,
                                      void* stream) {
  if (n_order > 0) {
    blend_exact_bwd_kernel<<<n_order, kPix, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        attrs, vcounts, wt, last_v, order, bg, K, tiles_x, t_mod, saved,
        g_out, d_attrs);
  }
  return static_cast<int>(cudaGetLastError());
}
