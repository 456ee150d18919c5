// K1: padded forward blend.
//
// Replaces street_sparse_3dgs_tpu/ops/pallas_blend.py _make_fwd_kernel /
// _fwd_one_tile (launched by _blend_packed_fwd).  One block of 256 threads
// per 16x16 tile, one pixel per thread.  The tile's min(count, K) slots are
// staged through shared memory in chunks of 256 slots x 10 channels; attrs
// are channel-major [T, 10, K], so each channel's chunk is one coalesced
// read.  Every thread then walks the chunk front to back (blend_common.cuh)
// and latches its own termination; the block stops once no thread is alive.
//
// Bound on the card: the special-function units.  Each live (slot, pixel)
// evaluation costs expf + log1pf + expf; the bytes (10 floats per slot read
// once, 8 floats per pixel written once) are small beside that.  This first
// version is plain: no cp.async double buffering and no warp-level skip of
// slots whose footprint misses the warp's pixels.

#include "blend_common.cuh"

using namespace blend;

__global__ void __launch_bounds__(kPix)
blend_padded_kernel(const float* __restrict__ attrs,
                    const int* __restrict__ counts,
                    const float* __restrict__ bg, int bg_per_tile, int K,
                    int tiles_x, int tile0, int t_mod,
                    float* __restrict__ out) {
  __shared__ float sh[kCh * kChunk];
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

  Pixel st;
  for (int base = 0; base < count; base += kChunk) {
    const int n = min(kChunk, count - base);
    for (int i = pix; i < kCh * kChunk; i += kPix) {
      const int c = i / kChunk, j = i - c * kChunk;
      if (j < n) sh[i] = a[c * K + base + j];
    }
    __syncthreads();
    if (st.alive) {
      for (int j = 0; j < n; ++j) {
        blend_slot([&](int c) { return sh[c * kChunk + j]; }, px, py, st);
        if (!st.alive) break;
      }
    }
    // Also the barrier that lets the next round overwrite ``sh``.
    if (__syncthreads_count(st.alive) == 0) break;
  }
  write_pixel(out + static_cast<size_t>(g) * kOut * kPix, pix, st,
              bg + (bg_per_tile ? 3 * g : 0));
}

extern "C" int blend_padded_launch(const float* attrs, const int* counts,
                                   const float* bg, int bg_per_tile, int T,
                                   int K, int tiles_x, int tile0, int t_mod,
                                   float* out, void* stream) {
  if (T > 0) {
    blend_padded_kernel<<<T, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        attrs, counts, bg, bg_per_tile, K, tiles_x, tile0, t_mod, out);
  }
  return static_cast<int>(cudaGetLastError());
}
