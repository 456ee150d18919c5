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
// with the carry in registers, walking each window's slots in reverse
// (blend_common.cuh, blend_slot_bwd).  Slot k of window w counts as included
// when w * K + k < n_contrib.  Deep tiles serialise in one block, as in K3.
//
// Output: pair-major [T_v, K, 10], every slot of a tile's windows written
// (zeros past the window count and for slots no pixel reached); budget
// windows no tile uses are never touched, so the caller passes a zeroed
// buffer.  Reduction over pixels as in K2: warp shuffles, then the eight
// warp partials in warp order, no atomics, bit-identical across runs.
//
// Bound on the card: as K3, the special-function units (three per walked
// slot-pixel step); bytes are the pair attrs, the saved and cotangent rows
// read once and the grads written once.  Each window's staging copy and
// each chunk's result are contiguous runs (10 floats a slot).

#include "blend_common.cuh"

using namespace blend;

__global__ void __launch_bounds__(kPix)
blend_exact_bwd_kernel(const float* __restrict__ attrs,
                       const int* __restrict__ vcounts,
                       const int* __restrict__ wt,
                       const int* __restrict__ last_v,
                       const float* __restrict__ bg, int K, int tiles_x,
                       int t_mod, const float* __restrict__ saved,
                       const float* __restrict__ g_out,
                       float* __restrict__ d_attrs) {
  __shared__ float sh[kBwdChunk * kCh];
  __shared__ float part[kWarps][kBwdChunk][kCh];
  const int t = blockIdx.x;
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
  const float* shp = sh;
  const auto slot_at = [shp](int j) {
    return [shp, j](int c) { return shp[j * kCh + c]; };
  };

  for (int v = v_last; v >= v_first; --v) {
    const int count = min(vcounts[v], K);
    const int k_win = (v - v_first) * K;     // slot-list index of slot 0
    const float* a = attrs + static_cast<size_t>(v) * K * kCh;
    float* d = d_attrs + static_cast<size_t>(v) * K * kCh;
    for (int i = count * kCh + pix; i < K * kCh; i += kPix) d[i] = 0.f;
    for (int base = (count - 1) / kBwdChunk * kBwdChunk;
         base >= 0 && count > 0; base -= kBwdChunk) {
      const int n = min(kBwdChunk, count - base);
      // Also the barrier after the previous chunk's reads of sh and part.
      if (__syncthreads_count(st.nc > k_win + base) == 0) {
        for (int i = pix; i < n * kCh; i += kPix) d[base * kCh + i] = 0.f;
        continue;
      }
      for (int i = pix; i < n * kCh; i += kPix) sh[i] = a[base * kCh + i];
      __syncthreads();
      walk_chunk_bwd(slot_at, n, k_win + base, st, part);
      __syncthreads();
      for (int i = pix; i < n * kCh; i += kPix) {
        const int j = i / kCh, c = i - j * kCh;
        d[(base + j) * kCh + c] = block_sum(part, j, c);
      }
    }
  }
}

extern "C" int blend_exact_bwd_launch(const float* attrs, const int* vcounts,
                                      const int* wt, const int* last_v,
                                      const float* bg, int T, int K,
                                      int tiles_x, int t_mod,
                                      const float* saved, const float* g_out,
                                      float* d_attrs, void* stream) {
  if (T > 0) {
    blend_exact_bwd_kernel<<<T, kPix, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        attrs, vcounts, wt, last_v, bg, K, tiles_x, t_mod, saved, g_out,
        d_attrs);
  }
  return static_cast<int>(cudaGetLastError());
}
