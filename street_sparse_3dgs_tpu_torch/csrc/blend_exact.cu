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
// The plan, pass and combine kernels are blend_exact.cuh's, templated on
// the per-chunk body: K3 is ExactBlend below, the kernel-floor stubs D1-D3
// (blend_exact_stub.cu) are other bodies on the same kernels.

#include "blend_exact.cuh"

using namespace blend;

namespace {

constexpr float kTerminated = 1.f, kDeadOnEntry = 2.f;

// A pixel's blend over a run of windows (the Body of blend_exact.cuh).
struct ExactBlend {
  static constexpr bool kPairMajor = true;
  __device__ __forceinline__ static int window_slots(int vcount, int K) {
    return min(vcount, K);
  }

  float px, py;
  Pixel st;
  bool dead_on_entry = false;
  __device__ __forceinline__ ExactBlend(float x, float y) : px(x), py(y) {}
  __device__ __forceinline__ bool walk(const float* b, int n) {
    walk_fwd(b, n, px, py, st);
    return st.alive;
  }
  // Phase B: enter at S_g, dead iff S_g < log(1e-4).
  __device__ __forceinline__ void enter(float s) {
    st.tlog = s;
    dead_on_entry = s < kLogEps;
  }
  // Group 0 enters at log T 0, so its end log T is its drop, or -inf where
  // it terminated.
  __device__ __forceinline__ float end_drop() const {
    return st.alive ? st.tlog : -__int_as_float(0x7f800000);
  }
  __device__ __forceinline__ void write_out(float* o, int pix,
                                            const float* bg) const {
    write_pixel(o, pix, st, bg);
  }
  // A group's partial rows: R, G, B, invdepth, alpha (no background), log T
  // at the end, n_contrib and a flag (1 terminated inside the group, 2
  // dead on entry).
  __device__ __forceinline__ void write_part(float* p, int pix) const {
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

  // Phase A: the drop in log T over a group (walk_drop).
  struct Drop {
    float px, py, d = 0.f;
    bool open = true;
    __device__ __forceinline__ Drop(float x, float y) : px(x), py(y) {}
    __device__ __forceinline__ bool walk(const float* b, int n) {
      walk_drop(b, n, px, py, d, open);
      return open;
    }
    __device__ __forceinline__ float value() const { return d; }
  };

  // Phase C of one split tile: colours and n_contrib summed over its
  // groups, log T from the last group alive on entry, stop after the first
  // group that terminated; then the background composite.
  __device__ __forceinline__ static void combine(const float* part, int q0,
                                                 int ng, int pix,
                                                 float* rows,
                                                 const float* bg) {
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
    write_pixel(rows, pix, st, bg);
  }
};

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
  return exact_launch<ExactBlend>(
      attrs, vcounts, wt, last_v, order, n_order, bg, K, group, tiles_x,
      t_mod, table, n_table, pass2, combine, n_extra, drop, part, out,
      static_cast<cudaStream_t>(stream));
}
