// K2: padded backward blend.
//
// Replaces street_sparse_3dgs_tpu/ops/pallas_blend.py _make_bwd_kernel /
// _bwd_one_tile (launched by _blend_packed_bwd).  One block of 256 threads
// per 16x16 tile, one pixel per thread, the K1 layout: attrs channel-major
// [T, 10, K], per-tile bg optional, tile ids ``g + tile0`` wrapped by
// ``t_mod``.  Each thread reads its saved final log T, its n_contrib and its
// five cotangent rows, and walks the tile's slots in reverse
// (blend_common.cuh, blend_slot_bwd).  The TPU kernel's triangular-matmul
// suffix sums and bf16 hi/lo splits are MXU devices and are not carried
// over: here the suffix is a running register sum.
//
// Output: per-slot grads [T, 10, K] of (mx, my, ca, cb, cc, r, g, b,
// opacity, invdepth), every slot written (zeros past the count and for
// slots no pixel reached).  Each slot's ten channels are summed over the
// 256 pixels in a fixed order (warp shuffles, then the eight warp partials
// in shared memory), with no atomics, so a rerun is bit-identical.  Slots
// are staged and reduced in chunks of 32: two barriers per chunk, not per
// slot.  Chunks above every pixel's n_contrib are found with
// __syncthreads_count and only zeroed.
//
// Bound on the card: as K1, the special-function units (exp(power),
// log1p(-alpha), exp(tlog_before) per walked slot-pixel step); bytes are
// attrs and the saved and cotangent rows read once, the grads written once.
// The ten warp reductions per slot (50 shuffles) are this first version's
// main overhead beyond that bound.

#include "blend_common.cuh"

using namespace blend;

__global__ void __launch_bounds__(kPix)
blend_padded_bwd_kernel(const float* __restrict__ attrs,
                        const int* __restrict__ counts,
                        const float* __restrict__ bg, int bg_per_tile, int K,
                        int tiles_x, int tile0, int t_mod,
                        const float* __restrict__ saved,
                        const float* __restrict__ g_out,
                        float* __restrict__ d_attrs) {
  __shared__ float sh[kCh * kBwdChunk];
  __shared__ float part[kWarps][kBwdChunk][kCh];
  const int g = blockIdx.x;
  const int pix = threadIdx.x;
  int t = g + tile0;
  if (t_mod) t %= t_mod;
  const float px = static_cast<float>((t % tiles_x) * kTile)
                   + static_cast<float>(pix % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile)
                   + static_cast<float>(pix / kTile);
  const int count = min(counts[g], K);
  const float* a = attrs + static_cast<size_t>(g) * kCh * K;
  float* d = d_attrs + static_cast<size_t>(g) * kCh * K;
  BwdPixel st = bwd_pixel(saved + static_cast<size_t>(g) * kOut * kPix,
                          g_out + static_cast<size_t>(g) * kOut * kPix, pix,
                          bg + (bg_per_tile ? 3 * g : 0), px, py);

  // Slots past the count: zeros.
  const int rest = K - count;
  for (int i = pix; i < kCh * rest; i += kPix) {
    d[(i / rest) * K + count + i % rest] = 0.f;
  }
  const float* shp = sh;
  const auto slot_at = [shp](int j) {
    return [shp, j](int c) { return shp[c * kBwdChunk + j]; };
  };
  for (int base = (count - 1) / kBwdChunk * kBwdChunk; base >= 0 && count > 0;
       base -= kBwdChunk) {
    const int n = min(kBwdChunk, count - base);
    // Also the barrier after the previous chunk's reads of sh and part.
    if (__syncthreads_count(st.nc > base) == 0) {
      for (int i = pix; i < kCh * n; i += kPix) {
        d[(i / n) * K + base + i % n] = 0.f;
      }
      continue;
    }
    for (int i = pix; i < kCh * n; i += kPix) {
      const int c = i / n, j = i - c * n;
      sh[c * kBwdChunk + j] = a[c * K + base + j];
    }
    __syncthreads();
    walk_chunk_bwd(slot_at, n, base, st, part);
    __syncthreads();
    for (int i = pix; i < kCh * n; i += kPix) {
      const int c = i / n, j = i - c * n;
      d[c * K + base + j] = block_sum(part, j, c);
    }
  }
}

extern "C" int blend_padded_bwd_launch(const float* attrs, const int* counts,
                                       const float* bg, int bg_per_tile,
                                       int T, int K, int tiles_x, int tile0,
                                       int t_mod, const float* saved,
                                       const float* g_out, float* d_attrs,
                                       void* stream) {
  if (T > 0) {
    blend_padded_bwd_kernel<<<T, kPix, 0,
                              static_cast<cudaStream_t>(stream)>>>(
        attrs, counts, bg, bg_per_tile, K, tiles_x, tile0, t_mod, saved,
        g_out, d_attrs);
  }
  return static_cast<int>(cudaGetLastError());
}
