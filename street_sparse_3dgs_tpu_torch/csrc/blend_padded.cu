// K1: padded forward blend.
//
// Replaces street_sparse_3dgs_tpu/ops/pallas_blend.py _make_fwd_kernel /
// _fwd_one_tile (launched by _blend_packed_fwd).  One block of 256 threads
// per 16x16 tile, one pixel per thread, over the tile's min(count, K)
// slots of the channel-major attrs [T, 10, K]; the block stops once no
// pixel is alive.
//
// Bound on the card: the work the data needs is, per walked slot-pixel
// step, the power (about 11 f32 operations), and per step that passes the
// alpha test three special-function results (expf(power), log1pf(-alpha),
// expf(log T)) and about 15 f32 operations more; the bytes are 10 floats
// per live slot read once and 8 floats per pixel written once
// (chip_smoke.py takes the largest of the three per call).  The walk
// is blend_fwd.cuh's, shared with K3: cp.async double-buffered staging
// (each channel of a chunk one coalesced run, transposed into the
// pair-major shared layout, only the chunk's live slots copied) and a
// skip ahead of expf from a per-slot threshold.  A tile stops at K slots,
// so no tile is much deeper than the others: K1 keeps one block per tile
// in tile order.

#include "blend_fwd.cuh"

using namespace blend;

namespace {

// The chunks of one tile's slots [0, count) in the channel-major attrs.
struct TileSlots {
  const float* a;
  int K, count, base;
  __device__ __forceinline__ bool settle() const { return base < count; }
  __device__ __forceinline__ int n() const {
    return min(kChunk, count - base);
  }
  __device__ __forceinline__ void step() { base += kChunk; }
  __device__ __forceinline__ void stage(float* buf) const {
    stage_channel_major(buf, a + base, K, n());
  }
};

__global__ void __launch_bounds__(kPix)
blend_padded_kernel(const float* __restrict__ attrs,
                    const int* __restrict__ counts,
                    const float* __restrict__ bg, int bg_per_tile, int K,
                    int tiles_x, int tile0, int t_mod,
                    float* __restrict__ out) {
  __shared__ __align__(16) FwdBuf buf;
  const int g = blockIdx.x;
  const int pix = threadIdx.x;
  int t = g + tile0;
  if (t_mod) t %= t_mod;
  const float px = static_cast<float>((t % tiles_x) * kTile)
                   + static_cast<float>(pix % kTile);
  const float py = static_cast<float>((t / tiles_x) * kTile)
                   + static_cast<float>(pix / kTile);
  Pixel st;
  walk_chunks(buf,
              TileSlots{attrs + static_cast<size_t>(g) * kCh * K, K,
                        min(counts[g], K), 0},
              [&](const float* b, int n) {
                walk_fwd(b, n, px, py, st);
                return st.alive;
              });
  write_pixel(out + static_cast<size_t>(g) * kOut * kPix, pix, st,
              bg + (bg_per_tile ? 3 * g : 0));
}

}  // namespace

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
