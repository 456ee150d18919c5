// D1-D3: K3's own kernels with the blend math replaced (kernel-floor
// probes).
//
// Replaces tools/kernel_floor_tpu.py _make_stub_kernel (D1 channel-major
// input, levels 2, 1, 0, -1, -2; D3 its level 0 swept over the TPU tile
// batch) and _make_stub_kernel_t (D2, pair-major input, levels 2, 0, -1).
// Those TPU stubs keep the exact forward kernel's per-window mechanics and
// swap its blend math for less and less work, so their times split the
// kernel's time into window mechanics, loads and math.  Here each stub is a
// Body of K3's kernels (blend_exact.cuh), so the probes launch what K3
// launches: the same plan kernel and block tables, the same tile order, the
// same split of tiles of more than ``group`` windows (pass 1, phase A,
// pass 2, the combine), the same cp.async double-buffered staging with the
// per-slot threshold computed when a chunk lands.  Only the Body differs:
// what a block does with each staged chunk, the rows it writes and what
// the combine sums.  Per window, with B_v = ceil(min(c_v, K) / 128) live
// 128-slot blocks (the TPU's lane blocks), each pixel adds
//
//   L2   sum over the slots of the live blocks of sum_c px * a[slot][c]
//        (ten products a slot-pixel);
//   L1   px * (sum_c a[slot][c]) per slot: the channel sum is taken once a
//        slot (a thread a slot, then a barrier), then one product a
//        slot-pixel;
//   L0   px per slot of the live blocks (the staged attrs are not read);
//   L-1  B_v (no pixel coordinates, no per-slot loop);
//   L-2  K / 128, on every window, empty ones included.
//
// Every level stages the slots it walks (the live blocks, or K at L-2).  A
// stub never terminates: a tile walked whole writes acc + bg[0] to all
// eight output rows; a group writes its own sum to its partial rows 0-6
// (and the sum of its tile's earlier drops, which pass 2 reads as K3 does,
// to row 7), group 0 and phase A write their sums as drops, and the
// combine sums each split tile's group partials in group order and writes
// that + bg[0] to all eight rows.
// Layout (the D1 / D2 question): D2 stages pair-major [T_v, K, 10] attrs
// (K3's stage_pair_major), D1 channel-major [T_v, 10, K] (K1's
// stage_channel_major: one coalesced run per channel).
// ``tiles_per_block`` (D3): one block of pass 1 walks that many
// consecutive rows of the block table in turn (stub_rows_kernel; a row is
// a tile walked whole or one group of a split tile), trading per-block
// scheduling cost against tail imbalance.  K3's own pass kernel walks one
// row a block.
//
// Bound on the card: L2 and L1 read the live blocks' attrs once (bytes) and
// do 10 or 1 products a slot-pixel (operations) over the split's walk
// (phase A walks the middle groups a second time); L0 one addition a
// slot-pixel; below that only the output and the window metadata.

#include "blend_exact.cuh"

using namespace blend;

namespace {

constexpr int kBlock = 128;   // the TPU stubs' lane block (KB)

template <int kLevel, bool kPM>
struct Stub {
  static constexpr bool kPairMajor = kPM;
  __device__ __forceinline__ static int window_slots(int vcount, int K) {
    return kLevel <= -2 ? K : (min(vcount, K) + kBlock - 1) / kBlock * kBlock;
  }

  float px, acc = 0.f, entry = 0.f;
  __device__ __forceinline__ Stub(float x, float)
      : px(kLevel >= 0 ? x : 0.f) {}
  __device__ __forceinline__ bool walk(const float* b, int n) {
    float s = 0.f;
    if constexpr (kLevel == 2) {
      // Each slot's ten products summed first, then the slots: the sum's
      // rounding error stays that of L1's (per-slot sums).
      for (int j = 0; j < n; ++j) {
        const StagedSlot q = load_staged(b, j);
        float part = px * q(0);
#pragma unroll
        for (int c = 1; c < kCh; ++c) part += px * q(c);
        s += part;
      }
    } else if constexpr (kLevel == 1) {
      // Each slot's channel sum once, by one thread; every thread of the
      // block walks each chunk, and the barriers of walk_chunks order the
      // next chunk's sums after this chunk's reads.
      __shared__ float sums[kChunk];
      if (static_cast<int>(threadIdx.x) < n) {
        const StagedSlot q = load_staged(b, threadIdx.x);
        float sum = q(0);
#pragma unroll
        for (int c = 1; c < kCh; ++c) sum += q(c);
        sums[threadIdx.x] = sum;
      }
      __syncthreads();
      for (int j = 0; j < n; ++j) s += px * sums[j];
    } else if constexpr (kLevel == 0) {
      for (int j = 0; j < n; ++j) s += px;
    } else {
      s = static_cast<float>(n / kBlock);
    }
    acc += s;
    return true;
  }
  __device__ __forceinline__ void enter(float s) { entry = s; }
  __device__ __forceinline__ float end_drop() const { return acc; }
  __device__ __forceinline__ void write_out(float* o, int pix,
                                            const float* bg) const {
#pragma unroll
    for (int r = 0; r < kOut; ++r) o[r * kPix + pix] = acc + bg[0];
  }
  __device__ __forceinline__ void write_part(float* p, int pix) const {
#pragma unroll
    for (int r = 0; r < kOut - 1; ++r) p[r * kPix + pix] = acc;
    p[(kOut - 1) * kPix + pix] = entry;
  }
  // Phase A walks the group with the level's body; its sum is the drop.
  struct Drop {
    Stub st;
    __device__ __forceinline__ Drop(float x, float y) : st(x, y) {}
    __device__ __forceinline__ bool walk(const float* b, int n) {
      return st.walk(b, n);
    }
    __device__ __forceinline__ float value() const { return st.acc; }
  };
  __device__ __forceinline__ static void combine(const float* part, int q0,
                                                 int ng, int pix,
                                                 float* rows,
                                                 const float* bg) {
    float total = 0.f;
    for (int h = 0; h < ng; ++h) {
      total += part[static_cast<size_t>(q0 + h) * kOut * kPix + pix];
    }
#pragma unroll
    for (int r = 0; r < kOut; ++r) rows[r * kPix + pix] = total + bg[0];
  }
};

struct Args {
  const float* attrs;
  const int *vcounts, *wt, *last_v;
  const float* bg;
  int T, K, tiles_x, group, tiles_per_block;
  int *table, n_table, *pass2, *combine, n_extra;
  float *drop, *part, *out;
  cudaStream_t stream;
};

// Pass 1 with rows [b * rows_per_block, (b + 1) * rows_per_block) of the
// ``n_rows`` of ``table`` for block b, in turn (D3).
template <typename Body>
__global__ void __launch_bounds__(kPix)
stub_rows_kernel(const float* __restrict__ attrs,
                 const int* __restrict__ vcounts, const int* __restrict__ wt,
                 const int* __restrict__ last_v,
                 const int4* __restrict__ table, int n_rows,
                 int rows_per_block, float* __restrict__ drop,
                 const float* __restrict__ bg, int K, int group, int tiles_x,
                 float* __restrict__ part, float* __restrict__ out) {
  __shared__ __align__(16) FwdBuf buf;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(n_rows, r0 + rows_per_block);
  for (int r = r0; r < r1; ++r) {
    exact_pass_row<Body, 1>(buf, table[r], attrs, vcounts, wt, last_v, drop,
                            bg, K, group, tiles_x, 0, part, out);
  }
}

template <typename Body>
int launch_body(const Args& a) {
  if (a.tiles_per_block == 1) {
    return exact_launch<Body>(a.attrs, a.vcounts, a.wt, a.last_v, nullptr,
                              a.T, a.bg, a.K, a.group, a.tiles_x, 0,
                              a.table, a.n_table, a.pass2, a.combine,
                              a.n_extra, a.drop, a.part, a.out, a.stream);
  }
  // K3's launches with stub_rows_kernel as pass 1.
  int4* tab = reinterpret_cast<int4*>(a.table);
  int4* tab2 = reinterpret_cast<int4*>(a.pass2);
  if (a.T > 0) {
    exact_plan_kernel<<<1, kPlan, 0, a.stream>>>(
        nullptr, a.wt, a.last_v, a.T, a.group, a.n_table, a.n_extra, tab,
        tab2, a.combine);
    const int blocks = (a.n_table + a.tiles_per_block - 1)
                       / a.tiles_per_block;
    stub_rows_kernel<Body><<<blocks, kPix, 0, a.stream>>>(
        a.attrs, a.vcounts, a.wt, a.last_v, tab, a.n_table,
        a.tiles_per_block, a.drop, a.bg, a.K, a.group, a.tiles_x, a.part,
        a.out);
    if (a.n_extra > 0) {
      exact_split_tail<Body>(a.attrs, a.vcounts, a.wt, a.last_v, a.bg, a.K,
                             a.group, a.tiles_x, 0, tab2, a.combine,
                             a.n_extra, a.drop, a.part, a.out, a.stream);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kLevel>
int launch_level(bool pair_major, const Args& a) {
  return pair_major ? launch_body<Stub<kLevel, true>>(a)
                    : launch_body<Stub<kLevel, false>>(a);
}

}  // namespace

// The stub of ``level`` over the T real tiles in tile order, windows split
// in groups of ``group`` (0: no split).  ``table`` [n_table], ``pass2`` and
// ``combine`` [n_extra] rows, filled by the plan; ``drop`` and ``part``
// the split's scratch, sized as for K3.  Returns cudaErrorInvalidValue for
// a level outside -2..2 or a tiles_per_block below 1.
extern "C" int blend_exact_stub_launch(
    const float* attrs, const int* vcounts, const int* wt, const int* last_v,
    const float* bg, int T, int K, int tiles_x, int level, int pair_major,
    int tiles_per_block, int group, int* table, int n_table, int* pass2,
    int* combine, int n_extra, float* drop, float* part, float* out,
    void* stream) {
  if (tiles_per_block < 1 || level < -2 || level > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{attrs, vcounts, wt, last_v, bg, T, K, tiles_x, group,
               tiles_per_block, table, n_table, pass2, combine, n_extra,
               drop, part, out, static_cast<cudaStream_t>(stream)};
  const bool pm = pair_major != 0;
  switch (level) {
    case 2: return launch_level<2>(pm, a);
    case 1: return launch_level<1>(pm, a);
    case 0: return launch_level<0>(pm, a);
    case -1: return launch_level<-1>(pm, a);
    default: return launch_level<-2>(pm, a);
  }
}
