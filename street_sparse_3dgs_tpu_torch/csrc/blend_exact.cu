// K3: exact (virtual-tile) forward blend.
//
// Replaces street_sparse_3dgs_tpu/ops/pallas_blend.py _make_fwd_kernel_exact
// (launched by _blend_exact_fwd).  A real tile whose pair count exceeds K
// owns ceil(count / K) consecutive K-wide windows of the pair-major attrs
// [T_v, K, 10].  The TPU kernel carries per-pixel state across windows in
// scratch, because its grid runs in order.  CUDA blocks run in no order.
//
// Bound on the card: the work the data needs is, per walked slot-pixel
// step, the power (about 11 f32 operations), and per step that passes the
// alpha test three special-function results (expf(power), log1pf(-alpha),
// expf(log T)) and about 15 f32 operations more; bytes are the pair attrs
// read once and the [T, 8, 256] output written once (chip_smoke.py takes
// the largest of the three per call).  What sets the time besides: the
// deepest tiles.  A street view has tiles of up to ~70 windows; one block
// walking such a tile's windows in series runs alone at the end of the
// launch.  The design:
//
// - The walk of blend_fwd.cuh (cp.async double-buffered staging, a skip
//   ahead of expf from a per-slot threshold).
// - Blocks take the real tiles in tile order, or in the caller's
//   ``order`` (a subset, e.g. one tile alone), from block tables that one
//   small block builds on the card (exact_plan_kernel; no host read, no
//   torch launches).
// - A tile with more than G windows (the wrapper's ``group``) is split into
//   groups of G consecutive windows, one block each:
//   A. group g >= 1 but the tile's last: each pixel's drop in log T over
//      the group (walk_drop: log1pf(-alpha) of every passing slot in slot
//      order, no termination), to ``drop`` [Q, 256].  Group 0 needs no
//      such walk: it enters at log T 0, so its own walk's end log T is its
//      drop, or it terminated (drop -inf);
//   B. group g walks its windows from S_g, the sum of the earlier groups'
//      drops in group order, and is dead on entry iff S_g < log(1e-4):
//      each log1pf(-alpha) is <= 0 and a rounded sum of non-positive floats
//      never rises, so a prefix that fell below the threshold stays below
//      in any grouping (phase A may stop a pixel's sum there).  A
//      dead-on-entry group still walks to its first passing slot, which
//      ends it at once, so its count of skipped slots before that slot is
//      known.  Groups write partial rows to ``part`` [Q, 8, 256]: R, G, B,
//      invdepth, alpha (no background), log T at the end, n_contrib and a
//      flag (1 terminated inside the group, 2 dead on entry);
//   C. per split tile, its groups in order: colours and n_contrib summed,
//      log T taken from the last group that was alive on entry, stop after
//      the first group that terminated; then the background composite.
//   Launches: the plan; pass 1 (tiles walked whole, which write their
//   rows, group 0 of each split tile, and phase A), so that the shallow
//   tiles fill the card while phase A runs; pass 2 (phase B of groups
//   1 .., from a table of their own); C.  The path of a deep tile is two
//   groups' walks, not all its windows.  The tables and the scratch are
//   sized from the shapes (cuda_blend._split_sizes): with E = T_v - T
//   windows beyond one a tile, at most E / G groups follow a group 0 and
//   at most E / G tiles are split, so pass 2 and C are launched on E / G
//   blocks, those with no work leaving at once.
//   This is a result that a sequential walk gives under some rounding of
//   log T: where phase A's sum and phase B's running sum fall on opposite
//   sides of the threshold, either the group before terminated (C stops
//   there) or the group is dead on entry (its first passing slot ends the
//   walk, as it would a walk that entered with log T within rounding of
//   the threshold).  Fixed orders and no atomics: two launches are
//   bit-identical.  K4 reads only the saved final log T and n_contrib,
//   which stay consistent with the rows.
//   G: see cuda_blend.EXACT_GROUP.
// Budget windows no tile uses (t_of_v == T) are never read.

#include "blend_fwd.cuh"

using namespace blend;

namespace {

// The chunks of windows [v, v_end) of the pair-major attrs.
struct Windows {
  const float* attrs;
  const int* vcounts;
  int K, v, v_end, base;
  __device__ __forceinline__ int count() const { return min(vcounts[v], K); }
  __device__ __forceinline__ bool settle() {
    while (v < v_end && base >= count()) {
      ++v;
      base = 0;
    }
    return v < v_end;
  }
  __device__ __forceinline__ int n() const {
    return min(kChunk, count() - base);
  }
  __device__ __forceinline__ void step() { base += kChunk; }
  __device__ __forceinline__ void stage(float* buf) const {
    stage_pair_major(buf, attrs + (static_cast<size_t>(v) * K + base) * kCh,
                     n());
  }
};

// One row of the block table: real tile (-1: no work), first window,
// windows, scratch slot q of a group (-1: the tile is walked whole).
struct Entry {
  int tile, v0, nw, q;
};

__device__ __forceinline__ Entry entry(const int4* table) {
  const int4 e = table[blockIdx.x];
  return {e.x, e.y, e.z, e.w};
}

__device__ __forceinline__ void pixel_xy(int t, int tiles_x, int t_mod,
                                         float& px, float& py) {
  const int tl = t_mod ? t % t_mod : t;
  px = static_cast<float>((tl % tiles_x) * kTile)
       + static_cast<float>(threadIdx.x % kTile);
  py = static_cast<float>((tl / tiles_x) * kTile)
       + static_cast<float>(threadIdx.x / kTile);
}

constexpr float kTerminated = 1.f, kDeadOnEntry = 2.f;

// The block tables (the kernel twin of cuda_blend.exact_split_plan), one
// block of kPlan threads, over the tiles of ``order`` (tile order where it
// is null): per tile its blocks in ``table`` (ng groups of ``group``
// windows, or one block) at the running prefix of ng; per split tile its
// scratch slots at the running prefix of ng over split tiles, its groups
// after group 0 in ``pass2`` at the running prefix of ng - 1, and a row of
// ``combine`` at the running count of split tiles; rows past those -1.
constexpr int kPlan = 1024;
constexpr int kScans = 4;     // blocks, split tiles, scratch slots, pass 2
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int warp_incl_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

__global__ void __launch_bounds__(kPlan)
exact_plan_kernel(const int* __restrict__ order, const int* __restrict__ wt,
                  const int* __restrict__ last_v, int n, int group,
                  int n_table, int n_extra, int4* __restrict__ table,
                  int4* __restrict__ pass2, int* __restrict__ combine) {
  __shared__ int part_sums[kScans][kPlan / 32];
  __shared__ int carry[kScans];     // each scan's total so far
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kScans) carry[threadIdx.x] = 0;
  __syncthreads();
  for (int base = 0; base < n; base += kPlan) {
    const int i = base + threadIdx.x;
    int t = -1, first = 0, nw = 0, ng = 0, sp = 0;
    if (i < n) {
      t = order ? order[i] : i;
      const int vl = last_v[t];
      nw = wt[vl] + 1;
      first = vl - nw + 1;
      sp = group > 0 && nw > group;
      ng = sp ? (nw + group - 1) / group : 1;
    }
    const int own[kScans] = {ng, sp, sp ? ng : 0, sp ? ng - 1 : 0};
    int incl[kScans];
#pragma unroll
    for (int k = 0; k < kScans; ++k) {
      incl[k] = warp_incl_scan(own[k], lane);
      if (lane == 31) part_sums[k][warp] = incl[k];
    }
    __syncthreads();          // also orders the carry reset / update
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < kScans; ++k) {
        part_sums[k][lane] = warp_incl_scan(part_sums[k][lane], lane);
      }
    }
    __syncthreads();
    int at[kScans];
#pragma unroll
    for (int k = 0; k < kScans; ++k) {
      at[k] = carry[k] + (warp ? part_sums[k][warp - 1] : 0) + incl[k]
              - own[k];
    }
    if (i < n) {
      if (!sp) {
        table[at[0]] = make_int4(t, first, nw, -1);
      } else {
        for (int g = 0; g < ng; ++g) {
          const int4 row = make_int4(t, first + g * group,
                                     min(group, nw - g * group), at[2] + g);
          table[at[0] + g] = row;
          if (g > 0) pass2[at[3] + g - 1] = row;
        }
        combine[3 * at[1]] = t;
        combine[3 * at[1] + 1] = at[2];
        combine[3 * at[1] + 2] = ng;
      }
    }
    __syncthreads();
    if (threadIdx.x < kScans) {
      carry[threadIdx.x] += part_sums[threadIdx.x][31];
    }
    __syncthreads();
  }
  for (int b = carry[0] + threadIdx.x; b < n_table; b += kPlan) {
    table[b] = make_int4(-1, 0, 0, -1);
  }
  for (int b = carry[3] + threadIdx.x; b < n_extra; b += kPlan) {
    pass2[b] = make_int4(-1, 0, 0, -1);
  }
  for (int c = carry[1] + threadIdx.x; c < n_extra; c += kPlan) {
    combine[3 * c] = -1;
  }
}

// Writes a group's partial rows.
__device__ __forceinline__ void write_partial(float* p, int pix,
                                              const Pixel& st,
                                              bool dead_on_entry) {
  p[0 * kPix + pix] = st.r;
  p[1 * kPix + pix] = st.g;
  p[2 * kPix + pix] = st.b;
  p[3 * kPix + pix] = st.ivd;
  p[4 * kPix + pix] = st.acc;
  p[5 * kPix + pix] = st.tlog;
  p[6 * kPix + pix] = st.nc;
  p[7 * kPix + pix] = (st.alive ? 0.f : kTerminated)
                      + (dead_on_entry ? kDeadOnEntry : 0.f);
}

// Pass 1 (``table``): tiles walked whole (rows out), group 0 of each split
// tile (its partial rows, and as its drop its end log T, or -inf where it
// terminated: group 0 enters at log T 0, so its running sum is the drop
// with termination where the drop falls below the threshold), and phase A
// for groups 1 .. ng - 2.  Pass 2 (``pass2``): groups 1 .. ng - 1
// (phase B).
template <int kPass>
__global__ void __launch_bounds__(kPix)
exact_pass_kernel(const float* __restrict__ attrs,
                  const int* __restrict__ vcounts,
                  const int* __restrict__ wt,
                  const int* __restrict__ last_v,
                  const int4* __restrict__ table, float* __restrict__ drop,
                  const float* __restrict__ bg, int K, int group,
                  int tiles_x, int t_mod, float* __restrict__ part,
                  float* __restrict__ out) {
  __shared__ __align__(16) FwdBuf buf;
  const Entry e = entry(table);
  if (e.tile < 0 || (kPass == 2 && e.q < 0)) return;
  const int pix = threadIdx.x;
  const Windows wins{attrs, vcounts, K, e.v0, e.v0 + e.nw, 0};
  int g = 0;
  if (e.q >= 0) {
    const int v_last = last_v[e.tile];
    g = (e.v0 - (v_last - wt[v_last])) / group;
    if (kPass == 1 && g > 0) {
      if (e.v0 + e.nw > v_last) return;          // the last group: pass 2
      float px, py;
      pixel_xy(e.tile, tiles_x, t_mod, px, py);
      float d = 0.f;
      bool open = true;
      walk_chunks(buf, wins, [&](const float* b, int n) {
        walk_drop(b, n, px, py, d, open);
        return open;
      });
      drop[static_cast<size_t>(e.q) * kPix + pix] = d;
      return;
    }
  }
  float px, py;
  pixel_xy(e.tile, tiles_x, t_mod, px, py);
  Pixel st;
  bool dead_on_entry = false;
  if (g > 0) {
    float s = 0.f;
    for (int h = 0; h < g; ++h) {
      s += drop[static_cast<size_t>(e.q - g + h) * kPix + pix];
    }
    st.tlog = s;
    dead_on_entry = s < kLogEps;
  }
  walk_chunks(buf, wins, [&](const float* b, int n) {
    walk_fwd(b, n, px, py, st);
    return st.alive;
  });
  if (e.q < 0) {
    write_pixel(out + static_cast<size_t>(e.tile) * kOut * kPix, pix, st,
                bg);
    return;
  }
  write_partial(part + static_cast<size_t>(e.q) * kOut * kPix, pix, st,
                dead_on_entry);
  if (g == 0) {
    drop[static_cast<size_t>(e.q) * kPix + pix] =
        st.alive ? st.tlog : -__int_as_float(0x7f800000);
  }
}

// Phase C: combine[i] = (tile, first scratch slot, groups), tile -1: none.
__global__ void __launch_bounds__(kPix)
exact_combine_kernel(const int* __restrict__ combine,
                     const float* __restrict__ part,
                     const float* __restrict__ bg,
                     float* __restrict__ out) {
  const int t = combine[3 * blockIdx.x];
  if (t < 0) return;
  const int q0 = combine[3 * blockIdx.x + 1];
  const int ng = combine[3 * blockIdx.x + 2];
  const int pix = threadIdx.x;
  Pixel st;
  for (int h = 0; h < ng; ++h) {
    const float* p = part + static_cast<size_t>(q0 + h) * kOut * kPix;
    const float flag = p[7 * kPix + pix];
    st.r += p[0 * kPix + pix];
    st.g += p[1 * kPix + pix];
    st.b += p[2 * kPix + pix];
    st.ivd += p[3 * kPix + pix];
    st.acc += p[4 * kPix + pix];
    st.nc += p[6 * kPix + pix];
    if (flag < kDeadOnEntry) st.tlog = p[5 * kPix + pix];
    if (flag == kTerminated || flag == kTerminated + kDeadOnEntry) break;
  }
  write_pixel(out + static_cast<size_t>(t) * kOut * kPix, pix, st, bg);
}

}  // namespace

// ``order`` null: the n_order tiles in tile order.  ``table`` [n_table],
// ``pass2`` and ``combine`` [n_extra] rows, filled by the plan.
extern "C" int blend_exact_launch(const float* attrs, const int* vcounts,
                                  const int* wt, const int* last_v,
                                  const int* order, int n_order,
                                  const float* bg, int K, int group,
                                  int tiles_x, int t_mod, int* table,
                                  int n_table, int* pass2, int* combine,
                                  int n_extra, float* drop, float* part,
                                  float* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int4* tab = reinterpret_cast<int4*>(table);
  int4* tab2 = reinterpret_cast<int4*>(pass2);
  if (n_order > 0) {
    exact_plan_kernel<<<1, kPlan, 0, s>>>(order, wt, last_v, n_order, group,
                                          n_table, n_extra, tab, tab2,
                                          combine);
    exact_pass_kernel<1><<<n_table, kPix, 0, s>>>(
        attrs, vcounts, wt, last_v, tab, drop, bg, K, group, tiles_x, t_mod,
        part, out);
  }
  if (n_order > 0 && n_extra > 0) {
    exact_pass_kernel<2><<<n_extra, kPix, 0, s>>>(
        attrs, vcounts, wt, last_v, tab2, drop, bg, K, group, tiles_x, t_mod,
        part, out);
    exact_combine_kernel<<<n_extra, kPix, 0, s>>>(combine, part, bg, out);
  }
  return static_cast<int>(cudaGetLastError());
}
