// K2: padded backward blend.
//
// Replaces street_sparse_3dgs_tpu/ops/pallas_blend.py _make_bwd_kernel /
// _bwd_one_tile (launched by _blend_packed_bwd).  One block of 256 threads
// per 16x16 tile, one pixel per thread, the K1 layout: attrs channel-major
// [T, 10, K], per-tile bg optional, tile ids ``g + tile0`` wrapped by
// ``t_mod``.  Each thread reads its saved final log T, its n_contrib and its
// five cotangent rows, and walks the tile's slots in reverse.  The TPU
// kernel's triangular-matmul suffix sums and bf16 hi/lo splits are MXU
// devices and are not carried over: here the suffix is a running register
// sum.
//
// Output: per-slot grads [T, 10, K] of (mx, my, ca, cb, cc, r, g, b,
// opacity, invdepth), every slot written: zeros past the count and in the
// chunks above every pixel's n_contrib (found with __syncthreads_count and
// only zeroed).  Each slot's ten channels are summed over the 256 pixels in
// a fixed order, with no atomics, so a rerun is bit-identical.
//
// Bound on the card: the work the data needs is, per walked slot-pixel
// step (a slot below the pixel's n_contrib), the power (11 f32
// operations), and per step that passes the alpha test three
// special-function results (expf(power), log1pf(-alpha), exp(log T
// before)) and 50 f32 operations; bytes are the live attrs, the saved and
// cotangent rows read once and the grads written once (chip_smoke.py
// takes the largest of the three per call).  The design, K4's walk on K1's
// staging:
// - the walk of blend_bwd.cuh, shared with K4 (a vote before each slot, one
//   reduce-scatter of the ten partials: 12 shuffles where ten butterflies
//   take 50; two slots a round as one straight run; 64 slots staged and
//   reduced a round);
// - the chunks staged from the top down with blend_fwd.cuh's cp.async
//   double buffer and stage_channel_major (one coalesced run per channel,
//   transposed into the 12-float pair-major shared layout, only live slots
//   copied): the next chunk's copy is in flight while one is walked;
// - no skip ahead of expf (blend_bwd.cuh says why); the staging still
//   computes the forward's per-slot threshold when a chunk lands, which
//   the walk does not read;
// - each chunk's grads summed over the warps from shared memory and stored
//   channel by channel, each channel's run one coalesced store.
// A 64x64 image is 16 tiles, so there the launch is one tile's serial walk:
// the shorter chain per slot is what helps.  Tiles are not split over
// blocks (a split needs each group's carry: the drop in log T and the
// suffix sum at its end).

#include "blend_bwd.cuh"
#include "blend_fwd.cuh"

using namespace blend;

namespace {

using BwdBuf = float[2][kBwdChunk * kStride];

// The kBwdChunk-aligned chunks of one tile's slots [0, count) of the
// channel-major attrs, from the one at ``base`` down to slot 0.
struct ReverseSlots {
  const float* a;
  int K, count, base;
  __device__ __forceinline__ bool settle() const { return base >= 0; }
  __device__ __forceinline__ int n() const {
    return min(kBwdChunk, count - base);
  }
  __device__ __forceinline__ void step() { base -= kBwdChunk; }
  __device__ __forceinline__ void stage(float* buf) const {
    stage_channel_major(buf, a + base, K, n());
  }
};

__global__ void __launch_bounds__(kPix)
blend_padded_bwd_kernel(const float* __restrict__ attrs,
                        const int* __restrict__ counts,
                        const float* __restrict__ bg, int bg_per_tile, int K,
                        int tiles_x, int tile0, int t_mod,
                        const float* __restrict__ saved,
                        const float* __restrict__ g_out,
                        float* __restrict__ d_attrs) {
  __shared__ __align__(16) BwdBuf buf;
  __shared__ BwdPart part;
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
  // Chunks above every pixel's n_contrib: zeros.
  int base = count > 0 ? (count - 1) / kBwdChunk * kBwdChunk : -1;
  for (; base >= 0 && __syncthreads_count(st.nc > base) == 0;
       base -= kBwdChunk) {
    const int n = min(kBwdChunk, count - base);
    for (int i = pix; i < kCh * n; i += kPix) {
      d[(i / n) * K + base + i % n] = 0.f;
    }
  }
  // The rest, chunk by chunk down to slot 0.  The barrier that ends each
  // round in walk_chunks also orders this chunk's reads of ``part`` before
  // the next chunk's writes.
  int k0 = base;
  walk_chunks(buf, ReverseSlots{a, K, count, base},
              [&](const float* b, int n) {
                walk_chunk([b](int j) { return load_staged(b, j); }, n,
                                 k0, st, part);
                __syncthreads();
                for (int i = pix; i < kCh * n; i += kPix) {
                  const int c = i / n, j = i - c * n;
                  d[c * K + k0 + j] = part_sum(part, j, c);
                }
                k0 -= kBwdChunk;
                return true;
              });
}

}  // namespace

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
