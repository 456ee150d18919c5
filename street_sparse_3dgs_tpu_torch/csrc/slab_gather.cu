// K5: slab gather — the [T, K] per-tile table of depth ranks.
//
// Replaces street_sparse_3dgs_tpu/ops/binning.py _make_slab_kernel
// (launched by _slab_gather).  The TPU kernel DMAs 1024-aligned windows and
// funnel-shifts them into place with rolls; on Hopper each tile's segment
// is already one contiguous run of keys.  The binning epilogue is fused:
// the rank is extracted from the packed int64 key (low rank_bits) and slots
// at or past min(count, K) get the sentinel rank.
//
//   out[t, k] = k < min(counts[t], K) ? vals[starts[t] + k] & rank_mask
//                                     : sentinel
//
// Bound on the card: bytes (8 per live key read, 4 per table entry
// written).  The design keeps the instructions per byte low:
// - one warp per table row (8 rows a 256-thread block): the row index
//   comes from the block and warp ids, with no per-element division, and
//   all index arithmetic is 32-bit except the offset into vals;
// - the row's start and count are read by one lane and broadcast with a
//   shuffle;
// - each lane takes 4 consecutive slots a round (a round covers 128
//   slots): four 8-byte loads, which together are one contiguous 1 KB run
//   across the warp, and one 16-byte store;
// - slots past min(count, K), and whole rows of count 0 (budget windows no
//   tile uses), store the sentinel without a load.
// When K is not a multiple of 4 the rows are not 16-byte aligned and every
// slot takes the scalar path.  Only live slots are read, so vals needs no
// padding.

#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 8;
constexpr int kThreads = kRowsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int rank_of(const long long* p,
                                       long long rank_mask) {
  return static_cast<int>(__ldg(p) & rank_mask);
}

__global__ void __launch_bounds__(kThreads)
slab_gather_kernel(const long long* __restrict__ vals,
                   const int* __restrict__ starts,
                   const int* __restrict__ counts, int T, int K,
                   long long rank_mask, int sentinel, int* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (t >= T) return;                      // whole warps leave together
  int start = 0, count = 0;
  if (lane == 0) {
    start = starts[t];
    count = counts[t];
  }
  start = __shfl_sync(kFull, start, 0);
  count = min(__shfl_sync(kFull, count, 0), K);
  const long long* src = vals + start;
  int* dst = out + static_cast<size_t>(t) * K;

  const int k_vec = (K & 3) == 0 ? K : 0;  // slots stored as int4
  for (int k = lane * 4; k < k_vec; k += 128) {
    int4 r = make_int4(sentinel, sentinel, sentinel, sentinel);
    if (k + 4 <= count) {
      r.x = rank_of(src + k, rank_mask);
      r.y = rank_of(src + k + 1, rank_mask);
      r.z = rank_of(src + k + 2, rank_mask);
      r.w = rank_of(src + k + 3, rank_mask);
    } else if (k < count) {                // the row's one partial group
      r.x = rank_of(src + k, rank_mask);
      if (k + 1 < count) r.y = rank_of(src + k + 1, rank_mask);
      if (k + 2 < count) r.z = rank_of(src + k + 2, rank_mask);
    }
    *reinterpret_cast<int4*>(dst + k) = r;
  }
  for (int k = k_vec + lane; k < K; k += 32) {
    dst[k] = k < count ? rank_of(src + k, rank_mask) : sentinel;
  }
}

}  // namespace

extern "C" int slab_gather_launch(const long long* vals, const int* starts,
                                  const int* counts, int T, int K,
                                  long long rank_mask, int sentinel, int* out,
                                  void* stream) {
  if (T > 0 && K > 0) {
    const int blocks = (T + kRowsPerBlock - 1) / kRowsPerBlock;
    slab_gather_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        vals, starts, counts, T, K, rank_mask, sentinel, out);
  }
  return static_cast<int>(cudaGetLastError());
}
