// D1-D3: K3's window mechanics with the blend math replaced (kernel-floor
// probes).
//
// Replaces tools/kernel_floor_tpu.py _make_stub_kernel (D1 channel-major
// input, levels 2, 1, 0, -1, -2; D3 its level 0 swept over the TPU tile
// batch) and _make_stub_kernel_t (D2, pair-major input, levels 2, 0, -1).
// Those TPU stubs keep the exact forward kernel's per-window mechanics and
// swap its blend math for less and less work, so their times split the
// kernel's time into window mechanics, loads and math.  Here the stubs keep
// THIS port's K3 mechanics (blend_exact.cu): one block of 256 threads, one
// pixel each, per real tile; the loop over the tile's windows
// v = last_v[t] - wt[last_v[t]] .. last_v[t]; each window's slots staged in
// shared memory in kChunk-slot rounds between barriers; the per-slot loop;
// the __syncthreads_count barrier after each round (it never fires: a stub
// does not terminate); the direct [T, 8, 256] write.  Only blend_slot is
// replaced by the level's body.  Per window, with B_v = ceil(min(c_v, K) /
// 128) live 128-slot blocks (the TPU's lane blocks), each pixel adds
//
//   L2   sum over the slots of the live blocks of sum_c px * a[slot][c]
//        (ten products a slot-pixel);
//   L1   px * (sum_c a[slot][c]) per slot: the channel sum is taken once a
//        slot while staging, then one product a slot-pixel;
//   L0   px per slot of the live blocks (no attrs read);
//   L-1  B_v (no pixel coordinates, no per-slot loop);
//   L-2  K / 128, on every window, empty ones included.
//
// and the tile's last window writes acc + bg[0] to all eight output rows.
// Layout (the D1 / D2 question): channel-major attrs [T_v, 10, K] are staged
// as ten strided runs, pair-major [T_v, K, 10] as one coalesced run (as K3).
// ``tiles_per_block`` (D3): one block walks that many consecutive real tiles
// in turn, trading per-block scheduling cost against tail imbalance.
//
// Bound on the card: L2 and L1 read the live blocks' attrs once (bytes) and
// do 10 or 1 products a slot-pixel (operations); L0 and below move only the
// output and the window metadata.

#include "blend_common.cuh"

using namespace blend;

namespace {

constexpr int kBlock = 128;   // the TPU stubs' lane block (KB)

template <int kLevel, bool kPairMajor>
__global__ void __launch_bounds__(kPix)
blend_exact_stub_kernel(const float* __restrict__ attrs,
                        const int* __restrict__ vcounts,
                        const int* __restrict__ wt,
                        const int* __restrict__ last_v,
                        const float* __restrict__ bg, int T, int K,
                        int tiles_x, int tiles_per_block,
                        float* __restrict__ out) {
  __shared__ float sh[kChunk * kCh];
  __shared__ float tot[kChunk];
  const int pix = threadIdx.x;
  const int t_end = min(T, (blockIdx.x + 1) * tiles_per_block);
  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    float px = 0.f;
    if (kLevel >= 0) {
      px = static_cast<float>((t % tiles_x) * kTile)
           + static_cast<float>(pix % kTile);
    }
    const int v_last = last_v[t];
    const int v_first = v_last - wt[v_last];
    const bool alive = true;
    bool done = false;
    float acc = 0.f;
    for (int v = v_first; v <= v_last && !done; ++v) {
      const int count = min(vcounts[v], K);
      const int n_slots =
          kLevel <= -2 ? K : (count + kBlock - 1) / kBlock * kBlock;
      const float* a = attrs + static_cast<size_t>(v) * K * kCh;
      for (int base = 0; base < n_slots; base += kChunk) {
        const int n = min(kChunk, n_slots - base);
        float s = 0.f;
        if (kLevel >= 1) {
          for (int i = pix; i < n * kCh; i += kPix) {
            if (kPairMajor) {
              sh[i] = a[base * kCh + i];
            } else {
              const int c = i / n, j = i - c * n;
              sh[j * kCh + c] = a[c * K + base + j];
            }
          }
          __syncthreads();
          if (kLevel == 2) {
            // Each slot's ten products summed first, then the slots: the
            // sum's rounding error stays that of L1's (per-slot sums).
            for (int j = 0; j < n; ++j) {
              const float* q = sh + j * kCh;
              float part = px * q[0];
#pragma unroll
              for (int c = 1; c < kCh; ++c) part += px * q[c];
              s += part;
            }
          } else {
            if (pix < n) {
              float sum = sh[pix * kCh];
#pragma unroll
              for (int c = 1; c < kCh; ++c) sum += sh[pix * kCh + c];
              tot[pix] = sum;
            }
            __syncthreads();
            for (int j = 0; j < n; ++j) s += px * tot[j];
          }
        } else if (kLevel == 0) {
          for (int j = 0; j < n; ++j) s += px;
        } else {
          s = static_cast<float>(n / kBlock);
        }
        acc += s;
        if (__syncthreads_count(alive) == 0) {
          done = true;
          break;
        }
      }
    }
    float* o = out + static_cast<size_t>(t) * kOut * kPix;
#pragma unroll
    for (int r = 0; r < kOut; ++r) o[r * kPix + pix] = acc + bg[0];
  }
}

template <int kLevel>
void launch_level(bool pair_major, int blocks, cudaStream_t stream,
                  const float* attrs, const int* vcounts, const int* wt,
                  const int* last_v, const float* bg, int T, int K,
                  int tiles_x, int tiles_per_block, float* out) {
  if (pair_major) {
    blend_exact_stub_kernel<kLevel, true><<<blocks, kPix, 0, stream>>>(
        attrs, vcounts, wt, last_v, bg, T, K, tiles_x, tiles_per_block, out);
  } else {
    blend_exact_stub_kernel<kLevel, false><<<blocks, kPix, 0, stream>>>(
        attrs, vcounts, wt, last_v, bg, T, K, tiles_x, tiles_per_block, out);
  }
}

}  // namespace

// Returns cudaErrorInvalidValue for a level outside -2..2 or a
// tiles_per_block below 1.
extern "C" int blend_exact_stub_launch(const float* attrs, const int* vcounts,
                                       const int* wt, const int* last_v,
                                       const float* bg, int T, int K,
                                       int tiles_x, int level, int pair_major,
                                       int tiles_per_block, float* out,
                                       void* stream) {
  if (tiles_per_block < 1 || level < -2 || level > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (T > 0) {
    const int blocks = (T + tiles_per_block - 1) / tiles_per_block;
    const auto s = static_cast<cudaStream_t>(stream);
    const bool pm = pair_major != 0;
    switch (level) {
      case 2:
        launch_level<2>(pm, blocks, s, attrs, vcounts, wt, last_v, bg, T, K,
                        tiles_x, tiles_per_block, out);
        break;
      case 1:
        launch_level<1>(pm, blocks, s, attrs, vcounts, wt, last_v, bg, T, K,
                        tiles_x, tiles_per_block, out);
        break;
      case 0:
        launch_level<0>(pm, blocks, s, attrs, vcounts, wt, last_v, bg, T, K,
                        tiles_x, tiles_per_block, out);
        break;
      case -1:
        launch_level<-1>(pm, blocks, s, attrs, vcounts, wt, last_v, bg, T, K,
                         tiles_x, tiles_per_block, out);
        break;
      default:
        launch_level<-2>(pm, blocks, s, attrs, vcounts, wt, last_v, bg, T, K,
                         tiles_x, tiles_per_block, out);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
