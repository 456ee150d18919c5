// K5: slab gather — the [T, K] per-tile table of depth ranks.
//
// Replaces street_sparse_3dgs_tpu/ops/binning.py _make_slab_kernel
// (launched by _slab_gather).  The TPU kernel DMAs 1024-aligned windows and
// funnel-shifts them into place with rolls; on Hopper a plain copy is
// already coalesced: one thread per output element, consecutive threads on
// consecutive k of one tile's contiguous segment.  The binning epilogue is
// fused: the rank is extracted from the packed int64 key (low rank_bits)
// and slots at or past min(count, K) get the sentinel rank.
//
//   out[t, k] = k < min(counts[t], K) ? vals[starts[t] + k] & rank_mask
//                                     : sentinel
//
// Bound on the card: bytes (8 per live key read, 4 per table entry
// written).  Only live slots are read, so no padding of vals is needed.

#include <cuda_runtime.h>

__global__ void slab_gather_kernel(const long long* __restrict__ vals,
                                   const int* __restrict__ starts,
                                   const int* __restrict__ counts,
                                   long long total, int K,
                                   long long rank_mask, int sentinel,
                                   int* __restrict__ out) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int t = static_cast<int>(i / K);
  const int k = static_cast<int>(i - static_cast<long long>(t) * K);
  const int c = min(counts[t], K);
  out[i] = k < c ? static_cast<int>(vals[static_cast<long long>(starts[t]) + k]
                                    & rank_mask)
                 : sentinel;
}

extern "C" int slab_gather_launch(const long long* vals, const int* starts,
                                  const int* counts, int T, int K,
                                  long long rank_mask, int sentinel, int* out,
                                  void* stream) {
  const long long total = static_cast<long long>(T) * K;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    slab_gather_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        vals, starts, counts, total, K, rank_mask, sentinel, out);
  }
  return static_cast<int>(cudaGetLastError());
}
