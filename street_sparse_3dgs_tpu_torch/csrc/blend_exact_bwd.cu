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
// Bound on the card: the work the data needs is, per walked slot-pixel
// step (a slot below the pixel's n_contrib), the power (11 f32
// operations), and per step that passes the alpha test three
// special-function results (expf(power), log1pf(-alpha), exp(log T
// before)) and 50 f32 operations (the ten partials and the carry); bytes
// are the pair attrs, the saved and cotangent rows read once and the grads
// written once (chip_smoke.py FLOPS_PER_WALK, SFU_PER_PASS,
// BWD_FLOPS_PER_PASS; it takes the largest of the three per call).  The
// rest of the work (the per-slot reduction over 256 pixels, which is not
// in the bound, and the serial walk of deep tiles) is what the design
// addresses: the walk of blend_bwd.cuh (a vote before each slot, one
// reduce-scatter of the ten partials, two slots a round, 64 slots staged
// and reduced a round; shared with K2), and blocks that take the tiles
// deepest first (``order``, from the wrapper), so that the tiles with the
// most windows do not start last and set the tail.  K4 stages each chunk
// synchronously as ten floats a slot and takes no skip ahead of expf.

#include "blend_bwd.cuh"

using namespace blend;

namespace {

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
  __shared__ float sh[kBwdChunk * kCh];
  __shared__ BwdPart part;
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

  const float* shp = sh;
  const auto load = [shp](int j) { return load_slot(shp, j); };
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
      walk_chunk(load, n, k_win + base, st, part);
      __syncthreads();
      for (int i = pix; i < n * kCh; i += kPix) {
        const int j = i / kCh;
        d[base * kCh + i] = part_sum(part, j, i - j * kCh);
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
