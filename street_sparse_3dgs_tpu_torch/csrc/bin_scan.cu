// bin_scan: the binning's slot scan and per-row tile compaction in one pass.
//
// Replaces no TPU kernel: street_sparse_3dgs_tpu/ops/binning.py builds the
// same table from XLA ops over [N, S] temporaries (the slot math,
// _tile_qmin's four edges, the keep test), then sorts each row.  The port
// did the same in PyTorch (ops/binning.py bin_scan_plain): a hundred
// broadcast kernels over [N, S] and a per-row radix sort, 24 ms at 1M rows
// and S = 64 on an H100, against a bound of about 0.09 ms (each row's
// attributes read once, the [N, S] table written once).
//
// For row i (S = scan, T the sentinel 2^31 - 1):
//   rect    x0, y0, x1, y1 as tile_rect (NaN -> 0, clamp, truncate);
//   nx, ny  x1 - x0, y1 - y0 where valid, else 0; coverage = nx * ny;
//   slot s  sy = floor((s + 0.5) * (1 / max(nx, 1))), sx = s - sy * max(nx, 1),
//           tile (y0 + sy) * tiles_x + x0 + sx, kept iff s < min(coverage, S)
//           and _tile_qmin(tile) <= qcap[i];
//   out     kept[i], coverage[i], and row i of tile_id: the kept tiles in
//           slot order, then T.
// A kept slot's tile id strictly increases with s (sx < nx <= tiles_x - x0),
// so slot order is the ascending order the plain version's per-row sort
// gives: the table is that sort's, bit for bit, with no sort.
//
// Every float operation is the plain version's, in its order and rounding:
// the build has no FMA contraction (-fmad=false) and no fast math, so
// divisions are IEEE-exact; min and max propagate NaN as torch.minimum and
// torch.maximum do (fminf/fmaxf would drop it and keep a NaN row's slots).
//
// Bound on the card: bytes (about 30 read and 4 S written a row).  Design:
// - a group of G lanes takes one row, G the power of two >= S, at most 32
//   (S = 8: four rows a warp; S = 64 or 256: one row a warp, rounds of 32
//   slots); the warp runs as many rounds as its widest row's covered slots
//   need, so a row that covers one tile costs one round;
// - a kept slot's place is a ballot and the count of the group's kept lanes
//   below it: deterministic, no atomics; a round's stores land in one run of
//   the row, and the sentinel tail is stored as one coalesced run;
// - no [N, S] temporary: slots live in registers between the test and the
//   store.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 16;
constexpr int kSentinel = 0x7fffffff;

__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

// ops/binning.py _tile_index: NaN -> 0, floor(x / 16), clamp to [0, hi].
__device__ __forceinline__ int tile_index(float x, int hi) {
  x = x != x ? 0.0f : x;
  const float t = floorf(x / static_cast<float>(kTile));
  return static_cast<int>(fminf(fmaxf(t, 0.0f), static_cast<float>(hi)));
}

// ops/binning.py _tile_qmin's edge_x and edge_y, each in its own order of
// operations: Q = a·dx² + 2b·dx·dy + c·dy² on one edge of the tile's pixel
// box, the other coordinate clamped to the box from the line of minima.
__device__ __forceinline__ float edge_x(float a, float b, float b2, float c,
                                        float inv_c, float x, float dyb,
                                        float dyt) {
  const float dy = nan_min(nan_max(-b * x * inv_c, dyb), dyt);
  return a * x * x + b2 * x * dy + c * dy * dy;
}

__device__ __forceinline__ float edge_y(float a, float b, float b2, float c,
                                        float inv_a, float y, float dxl,
                                        float dxr) {
  const float dx = nan_min(nan_max(-b * y * inv_a, dxl), dxr);
  return a * dx * dx + b2 * dx * y + c * y * y;
}

template <int G>
__global__ void __launch_bounds__(kThreads)
bin_scan_kernel(const float* __restrict__ mean2d,
                const float* __restrict__ conic,
                const float* __restrict__ radius,
                const unsigned char* __restrict__ valid,
                const float* __restrict__ qcap, int n, int tiles_x,
                int tiles_y, int scan, int* __restrict__ kept,
                int* __restrict__ coverage, int* __restrict__ tile_id) {
  const int lane = threadIdx.x & 31;
  const int j = lane & (G - 1);              // slot within a round
  const int first = lane & ~(G - 1);         // the group's first lane
  const long long row =
      static_cast<long long>(blockIdx.x) * (kThreads / G) + threadIdx.x / G;
  const bool live = row < n;

  float mx = 0.0f, my = 0.0f, a = 0.0f, b = 0.0f, c = 0.0f, qc = 0.0f;
  int x0 = 0, y0 = 0, nx_safe = 1, cov = 0, covered = 0;
  if (live) {
    mx = mean2d[2 * row];
    my = mean2d[2 * row + 1];
    const float r = radius[row];
    x0 = tile_index(mx - r, tiles_x);
    y0 = tile_index(my - r, tiles_y);
    const int x1 = max(tile_index(mx + r + 16.0f - 1.0f, tiles_x), x0);
    const int y1 = max(tile_index(my + r + 16.0f - 1.0f, tiles_y), y0);
    const bool v = valid[row] != 0;
    const int nx = v ? x1 - x0 : 0;
    const int ny = v ? y1 - y0 : 0;
    cov = nx * ny;
    covered = min(cov, scan);
    nx_safe = max(nx, 1);
    a = conic[3 * row];
    b = conic[3 * row + 1];
    c = conic[3 * row + 2];
    qc = qcap[row];
  }
  const float inv_nx = 1.0f / static_cast<float>(nx_safe);
  const float inv_a = 1.0f / a;
  const float inv_c = 1.0f / c;
  const float b2 = 2.0f * b;

  const unsigned gmask = G == 32 ? kFull : (1u << G) - 1u;
  const unsigned below = (1u << j) - 1u;
  int* dst = tile_id + (live ? row : 0) * static_cast<long long>(scan);
  const int rounds_end = __reduce_max_sync(kFull, covered);
  int off = 0;
  for (int base = 0; base < rounds_end; base += G) {
    const int s = base + j;
    bool keep = false;
    int tid = 0;
    if (s < covered) {
      const int sy = static_cast<int>(
          floorf((static_cast<float>(s) + 0.5f) * inv_nx));
      const int tx = x0 + (s - sy * nx_safe);
      const int ty = y0 + sy;
      tid = ty * tiles_x + tx;
      const float dxl = static_cast<float>(tx * kTile) - mx;
      const float dxr = dxl + static_cast<float>(kTile - 1);
      const float dyb = static_cast<float>(ty * kTile) - my;
      const float dyt = dyb + static_cast<float>(kTile - 1);
      const bool inside = dxl <= 0.0f && dxr >= 0.0f && dyb <= 0.0f &&
                          dyt >= 0.0f;
      const float q = nan_min(
          nan_min(edge_x(a, b, b2, c, inv_c, dxl, dyb, dyt),
                  edge_x(a, b, b2, c, inv_c, dxr, dyb, dyt)),
          nan_min(edge_y(a, b, b2, c, inv_a, dyb, dxl, dxr),
                  edge_y(a, b, b2, c, inv_a, dyt, dxl, dxr)));
      keep = (inside ? 0.0f : q) <= qc;
    }
    const unsigned grp = (__ballot_sync(kFull, keep) >> first) & gmask;
    if (keep) dst[off + __popc(grp & below)] = tid;
    off += __popc(grp);
  }
  if (live) {
    for (int p = off + j; p < scan; p += G) dst[p] = kSentinel;
    if (j == 0) {
      kept[row] = off;
      coverage[row] = cov;
    }
  }
}

}  // namespace

extern "C" int bin_scan_launch(const float* mean2d, const float* conic,
                               const float* radius, const unsigned char* valid,
                               const float* qcap, int n, int tiles_x,
                               int tiles_y, int scan, int* kept,
                               int* coverage, int* tile_id, void* stream) {
  if (n > 0 && scan > 0) {
    const int g = scan <= 4 ? 4 : scan <= 8 ? 8 : scan <= 16 ? 16 : 32;
    const int rows_per_block = kThreads / g;
    const int blocks = static_cast<int>(
        (static_cast<long long>(n) + rows_per_block - 1) / rows_per_block);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define BIN_SCAN_LAUNCH(G)                                                \
  bin_scan_kernel<G><<<blocks, kThreads, 0, s>>>(                         \
      mean2d, conic, radius, valid, qcap, n, tiles_x, tiles_y, scan, kept, \
      coverage, tile_id)
    switch (g) {
      case 4: BIN_SCAN_LAUNCH(4); break;
      case 8: BIN_SCAN_LAUNCH(8); break;
      case 16: BIN_SCAN_LAUNCH(16); break;
      default: BIN_SCAN_LAUNCH(32); break;
    }
#undef BIN_SCAN_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
