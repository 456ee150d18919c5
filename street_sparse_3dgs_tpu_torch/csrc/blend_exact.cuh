// K3's kernels (blend_exact.cu has the design), templated on what a block
// does with each staged chunk: the plan, pass 1 (tiles walked whole, group
// 0 of each split tile, phase A of the middle groups), pass 2 (phase B of
// the later groups) and the combine.  K3 is one instantiation (ExactBlend
// in blend_exact.cu); the kernel-floor stubs D1-D3 (blend_exact_stub.cu)
// are the others, so that the probes run K3's own plan, tables, tile
// order, window split, cp.async staging and per-slot threshold.
//
// A ``Body`` is a pixel's state over a run of windows:
//   static constexpr bool kPairMajor;         attrs [T_v, K, 10] (else
//                                             [T_v, 10, K])
//   static int window_slots(int vcount, int K);  slots walked in a window
//   Body(float px, float py);
//   bool walk(const float* buf, int n);       one staged chunk; false once
//                                             the pixel wants no more
//   void enter(float s);                      pass 2: the sum S_g of the
//                                             tile's earlier drops
//   float end_drop() const;                   group 0's drop
//   void write_out(float* rows, int pix, const float* bg) const;
//   void write_part(float* rows, int pix) const;
//   using Drop;   phase A: Drop(px, py), bool walk(buf, n), float value()
//   static void combine(const float* part, int q0, int ng, int pix,
//                       float* rows, const float* bg);
//
// The templates take their internal linkage from the bodies (each .cu
// defines its bodies in an anonymous namespace); the plan kernel is static.
#pragma once

#include "blend_fwd.cuh"

namespace blend {

// The chunks of windows [v, v_end) of the attrs, Body::window_slots slots
// of each.
template <typename Body>
struct Windows {
  const float* attrs;
  const int* vcounts;
  int K, v, v_end, base;
  __device__ __forceinline__ int count() const {
    return Body::window_slots(vcounts[v], K);
  }
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
    if constexpr (Body::kPairMajor) {
      stage_pair_major(buf, attrs + (static_cast<size_t>(v) * K + base) * kCh,
                       n());
    } else {
      stage_channel_major(buf, attrs + static_cast<size_t>(v) * kCh * K
                               + base, K, n());
    }
  }
};

// One row of a block table: real tile (-1: no work), first window,
// windows, scratch slot q of a group (-1: the tile is walked whole).
struct Entry {
  int tile, v0, nw, q;
};

__device__ __forceinline__ void pixel_xy(int t, int tiles_x, int t_mod,
                                         float& px, float& py) {
  const int tl = t_mod ? t % t_mod : t;
  px = static_cast<float>((tl % tiles_x) * kTile)
       + static_cast<float>(threadIdx.x % kTile);
  py = static_cast<float>((tl / tiles_x) * kTile)
       + static_cast<float>(threadIdx.x / kTile);
}

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

static __global__ void __launch_bounds__(kPlan)
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

// One table row of pass 1 (tiles walked whole: rows out; group 0 of each
// split tile: its partial rows and its drop, Body::end_drop; phase A for
// groups 1 .. ng - 2: the drop of Body::Drop's walk) or of pass 2 (groups
// 1 .. ng - 1, phase B: entered with the sum of the tile's earlier drops
// in group order).
template <typename Body, int kPass>
__device__ __forceinline__ void exact_pass_row(
    FwdBuf& buf, const int4 row, const float* __restrict__ attrs,
    const int* __restrict__ vcounts, const int* __restrict__ wt,
    const int* __restrict__ last_v, float* __restrict__ drop,
    const float* __restrict__ bg, int K, int group, int tiles_x, int t_mod,
    float* __restrict__ part, float* __restrict__ out) {
  const Entry e{row.x, row.y, row.z, row.w};
  if (e.tile < 0 || (kPass == 2 && e.q < 0)) return;
  const int pix = threadIdx.x;
  const Windows<Body> wins{attrs, vcounts, K, e.v0, e.v0 + e.nw, 0};
  float px, py;
  pixel_xy(e.tile, tiles_x, t_mod, px, py);
  int g = 0;
  if (e.q >= 0) {
    const int v_last = last_v[e.tile];
    g = (e.v0 - (v_last - wt[v_last])) / group;
    if (kPass == 1 && g > 0) {
      if (e.v0 + e.nw > v_last) return;          // the last group: pass 2
      typename Body::Drop a(px, py);
      walk_chunks(buf, wins, [&](const float* b, int n) {
        return a.walk(b, n);
      });
      drop[static_cast<size_t>(e.q) * kPix + pix] = a.value();
      return;
    }
  }
  Body st(px, py);
  if (g > 0) {
    float s = 0.f;
    for (int h = 0; h < g; ++h) {
      s += drop[static_cast<size_t>(e.q - g + h) * kPix + pix];
    }
    st.enter(s);
  }
  walk_chunks(buf, wins, [&](const float* b, int n) {
    return st.walk(b, n);
  });
  if (e.q < 0) {
    st.write_out(out + static_cast<size_t>(e.tile) * kOut * kPix, pix, bg);
    return;
  }
  st.write_part(part + static_cast<size_t>(e.q) * kOut * kPix, pix);
  if (g == 0) drop[static_cast<size_t>(e.q) * kPix + pix] = st.end_drop();
}

// Row b of ``table`` for block b.
template <typename Body, int kPass>
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
  exact_pass_row<Body, kPass>(buf, table[blockIdx.x], attrs, vcounts, wt,
                              last_v, drop, bg, K, group, tiles_x, t_mod,
                              part, out);
}

// Phase C: combine[i] = (tile, first scratch slot, groups), tile -1: none.
template <typename Body>
__global__ void __launch_bounds__(kPix)
exact_combine_kernel(const int* __restrict__ combine,
                     const float* __restrict__ part,
                     const float* __restrict__ bg,
                     float* __restrict__ out) {
  const int t = combine[3 * blockIdx.x];
  if (t < 0) return;
  Body::combine(part, combine[3 * blockIdx.x + 1],
                combine[3 * blockIdx.x + 2], threadIdx.x,
                out + static_cast<size_t>(t) * kOut * kPix, bg);
}

// Pass 2 on ``pass2`` and the combine on ``combine`` [n_extra] rows, after
// the plan and pass 1 (n_extra > 0).
template <typename Body>
void exact_split_tail(const float* attrs, const int* vcounts, const int* wt,
                      const int* last_v, const float* bg, int K, int group,
                      int tiles_x, int t_mod, const int4* pass2,
                      const int* combine, int n_extra, float* drop,
                      float* part, float* out, cudaStream_t s) {
  exact_pass_kernel<Body, 2><<<n_extra, kPix, 0, s>>>(
      attrs, vcounts, wt, last_v, pass2, drop, bg, K, group, tiles_x, t_mod,
      part, out);
  exact_combine_kernel<Body><<<n_extra, kPix, 0, s>>>(combine, part, bg,
                                                      out);
}

// The launches of one blend over the tiles of ``order`` (null: the n_order
// tiles in tile order): the plan, pass 1 on ``table`` [n_table] rows, one
// a block, and, where n_extra > 0, exact_split_tail.  ``group`` 0: no
// split.
template <typename Body>
int exact_launch(const float* attrs, const int* vcounts, const int* wt,
                 const int* last_v, const int* order, int n_order,
                 const float* bg, int K, int group, int tiles_x, int t_mod,
                 int* table, int n_table, int* pass2, int* combine,
                 int n_extra, float* drop, float* part, float* out,
                 cudaStream_t s) {
  int4* tab = reinterpret_cast<int4*>(table);
  int4* tab2 = reinterpret_cast<int4*>(pass2);
  if (n_order > 0) {
    exact_plan_kernel<<<1, kPlan, 0, s>>>(order, wt, last_v, n_order, group,
                                          n_table, n_extra, tab, tab2,
                                          combine);
    exact_pass_kernel<Body, 1><<<n_table, kPix, 0, s>>>(
        attrs, vcounts, wt, last_v, tab, drop, bg, K, group, tiles_x, t_mod,
        part, out);
    if (n_extra > 0) {
      exact_split_tail<Body>(attrs, vcounts, wt, last_v, bg, K, group,
                             tiles_x, t_mod, tab2, combine, n_extra, drop,
                             part, out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace blend
