// K3: exact (virtual-tile) forward blend.
//
// Replaces street_sparse_3dgs_tpu/ops/pallas_blend.py _make_fwd_kernel_exact
// (launched by _blend_exact_fwd).  A real tile whose pair count exceeds K
// owns ceil(count / K) consecutive K-wide windows of the pair-major attrs
// [T_v, K, 10].  The TPU kernel carries per-pixel state across windows in
// scratch, because its grid runs in order; CUDA blocks run in no order, so
// here ONE block owns each real tile and loops over its windows
// v = last_v[t] - wt[last_v[t]] .. last_v[t], keeping the state (log T,
// n_contrib, rgb, invdepth, alpha, alive) in registers.  The result goes
// straight to [T, 8, 256]: no [T_v, 8, 256] buffer and no last_v gather.
// Budget windows no tile uses (t_of_v == T) are never read.
//
// Each window's vcounts[v] slots are contiguous (10 floats each), so the
// staging copy into shared memory is one coalesced run.
//
// Bound on the card: as K1, the special-function units (three
// transcendentals per live slot-pixel evaluation); bytes are the pair
// attrs read once and the [T, 8, 256] output written once.

#include "blend_common.cuh"

using namespace blend;

__global__ void __launch_bounds__(kPix)
blend_exact_kernel(const float* __restrict__ attrs,
                   const int* __restrict__ vcounts,
                   const int* __restrict__ wt,
                   const int* __restrict__ last_v,
                   const float* __restrict__ bg, int K, int tiles_x,
                   int t_mod, float* __restrict__ out) {
  __shared__ float sh[kChunk * kCh];
  const int t = blockIdx.x;
  const int pix = threadIdx.x;
  const int tl = t_mod ? t % t_mod : t;
  const float px = static_cast<float>((tl % tiles_x) * kTile)
                   + static_cast<float>(pix % kTile);
  const float py = static_cast<float>((tl / tiles_x) * kTile)
                   + static_cast<float>(pix / kTile);
  const int v_last = last_v[t];
  const int v_first = v_last - wt[v_last];

  Pixel st;
  bool done = false;
  for (int v = v_first; v <= v_last && !done; ++v) {
    const int count = min(vcounts[v], K);
    const float* a = attrs + static_cast<size_t>(v) * K * kCh;
    for (int base = 0; base < count; base += kChunk) {
      const int n = min(kChunk, count - base);
      for (int i = pix; i < n * kCh; i += kPix) sh[i] = a[base * kCh + i];
      __syncthreads();
      if (st.alive) {
        for (int j = 0; j < n; ++j) {
          const float* s = sh + j * kCh;
          blend_slot([&](int c) { return s[c]; }, px, py, st);
          if (!st.alive) break;
        }
      }
      if (__syncthreads_count(st.alive) == 0) {
        done = true;
        break;
      }
    }
  }
  write_pixel(out + static_cast<size_t>(t) * kOut * kPix, pix, st, bg);
}

extern "C" int blend_exact_launch(const float* attrs, const int* vcounts,
                                  const int* wt, const int* last_v,
                                  const float* bg, int T, int K, int tiles_x,
                                  int t_mod, float* out, void* stream) {
  if (T > 0) {
    blend_exact_kernel<<<T, kPix, 0, static_cast<cudaStream_t>(stream)>>>(
        attrs, vcounts, wt, last_v, bg, K, tiles_x, t_mod, out);
  }
  return static_cast<int>(cudaGetLastError());
}
