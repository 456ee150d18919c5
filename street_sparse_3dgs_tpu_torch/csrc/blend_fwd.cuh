// The forward walk shared by K1 (blend_padded.cu) and K3 (blend_exact.cu).
//
// A block of 256 threads (one pixel each) walks a list of slots staged in
// shared memory, front to back, with the rules of blend_common.cuh.  What
// the walk does about the card's limits (the per-slot path is bound by the
// special-function units and by its chain of latencies, not by bytes):
//
// - Slots are staged in chunks of kChunk with cp.async, double-buffered:
//   the next chunk's copy is in flight while the current one is walked.
//   Each staged slot is 12 floats (the 10 channels, its skip threshold,
//   a pad), read back as three 16-byte loads.  K1's channel-major global
//   layout is transposed on the way in: one coalesced run per channel.
// - A warp skip ahead of expf: once per slot (not per pixel), when the
//   chunk lands, thr = logf(kAlphaMin / op) - kSkipDelta (+inf when
//   op < kAlphaMin).  A slot passes the alpha test only if
//   op * expf(power) >= kAlphaMin after rounding; expf is within 2 ulp,
//   the product and the division round once each and logf is within
//   1 ulp on [-5.6, 0], so a passing slot has power above
//   ln(kAlphaMin / op) - 1e-6 > thr.  A pixel whose power is < thr or > 0
//   therefore skips the slot (it counts in n_contrib, as any skipped slot
//   does), and a warp in which every live pixel skips branches past
//   expf, log1pf and the sums.  Any other pixel runs alpha_test, bit for
//   bit eval_slot's test, which K2 and K4 repeat when they recount the
//   forward's n_contrib slots.
// - Lane by lane, with no warp votes: a pixel leaves the walk at its
//   termination, and the hardware skips a branch that no lane of the warp
//   takes.  (A vote per slot, and two slots a round, each lengthened the
//   launch on the card.)
#pragma once

#include <cuda_pipeline.h>

#include "blend_common.cuh"

namespace blend {

constexpr int kStride = 12;           // floats per staged slot
constexpr int kThr = 10;              // index of the skip threshold
constexpr float kSkipDelta = 1e-4f;

using FwdBuf = float[2][kChunk * kStride];

// One float into shared memory, copied asynchronously.
__device__ __forceinline__ void copy4(float* dst, const float* src) {
  __pipeline_memcpy_async(dst, src, 4);
}

__device__ __forceinline__ float skip_threshold(float op) {
  return op < kAlphaMin ? __int_as_float(0x7f800000)
                        : logf(kAlphaMin / op) - kSkipDelta;
}

// Asynchronous copies of ``n`` pair-major slots (10 floats each) at ``a``.
__device__ __forceinline__ void stage_pair_major(float* buf, const float* a,
                                                 int n) {
  for (int i = threadIdx.x; i < n * kCh; i += kPix) {
    const int j = i / kCh;
    copy4(buf + j * kStride + (i - j * kCh), a + i);
  }
}

// The same for channel-major slots: channel c of slot j at a[c * K + j].
__device__ __forceinline__ void stage_channel_major(float* buf,
                                                    const float* a, int K,
                                                    int n) {
  const int j = threadIdx.x;
  if (j < n) {
#pragma unroll
    for (int c = 0; c < kCh; ++c) {
      copy4(buf + j * kStride + c, a + c * K + j);
    }
  }
}

struct StagedSlot {
  float v[kStride];
  __device__ __forceinline__ float operator()(int c) const { return v[c]; }
};

__device__ __forceinline__ StagedSlot load_staged(const float* buf, int j) {
  StagedSlot s;
  const float4* p = reinterpret_cast<const float4*>(buf + j * kStride);
#pragma unroll
  for (int i = 0; i < kStride / 4; ++i) {
    const float4 q = p[i];
    s.v[4 * i] = q.x;
    s.v[4 * i + 1] = q.y;
    s.v[4 * i + 2] = q.z;
    s.v[4 * i + 3] = q.w;
  }
  return s;
}

// Drives a source of chunks through the two buffers (each kN floats: kN /
// kStride slots).  ``src`` has ``bool settle()`` (move to the next
// non-empty chunk; false when none is left), ``int n()``, ``void step()``
// and ``void stage(float* buf)``; ``walk(buf, n)`` walks one staged chunk
// and returns whether this thread still wants slots.  All threads of the
// block call it alike.  When a chunk lands, each slot gets its skip
// threshold.
template <int kN, typename Source, typename Walk>
__device__ __forceinline__ void walk_chunks(float (&buf)[2][kN], Source src,
                                            Walk walk) {
  if (!src.settle()) return;
  src.stage(buf[0]);
  __pipeline_commit();
  int cur = 0;
  while (true) {
    const int n = src.n();
    src.step();
    const bool more = src.settle();
    if (more) src.stage(buf[cur ^ 1]);
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    if (threadIdx.x < n) {
      float* s = buf[cur] + threadIdx.x * kStride;
      s[kThr] = skip_threshold(s[OP]);
    }
    __syncthreads();
    const bool want = walk(buf[cur], n);
    // Also the barrier after which buf[cur] may be staged again.
    if (__syncthreads_count(want) == 0 || !more) break;
    cur ^= 1;
  }
  __pipeline_wait_prior(0);
}

// Whether a live pixel can pass the alpha test of a slot with power ``p``
// and threshold ``thr`` (false for NaN-free p outside [thr, 0]).
__device__ __forceinline__ bool may_pass(float p, float thr) {
  return !(p < thr || p > 0.f);
}

// Walk of ``n`` staged slots for one pixel: blend_common.cuh's rules, the
// alpha test behind the skip test.
__device__ __forceinline__ void walk_fwd(const float* buf, int n, float px,
                                         float py, Pixel& st) {
  if (!st.alive) return;
  for (int j = 0; j < n; ++j) {
    const StagedSlot s = load_staged(buf, j);
    const float dx = px - s(MX), dy = py - s(MY);
    const float power = slot_power(s, dx, dy);
    if (may_pass(power, s(kThr))) {
      const SlotEval e = alpha_test(s, dx, dy, power);
      if (e.ok) {
        const float lom = log1pf(-e.alpha);
        if (st.tlog + lom < kLogEps) {
          st.alive = false;
          return;
        }
        const float w = e.alpha * expf(st.tlog);
        st.r += w * s(CR);
        st.g += w * s(CG);
        st.b += w * s(CBL);
        st.ivd += w * s(ID);
        st.acc += w;
        st.tlog += lom;
      }
    }
    // A skipped slot has alpha 0 and cannot fail; it counts as passed, as
    // in the TPU kernel's n_contrib.
    st.nc += 1.f;
  }
}

// The drop in log T of one pixel over ``n`` staged slots: ``drop`` plus
// log1pf(-alpha) of every slot that passes the alpha test, in slot order,
// with no termination.  ``open`` turns false once drop < log(1e-4): the
// pixel then adds nothing more, as any later prefix stays below too.
__device__ __forceinline__ void walk_drop(const float* buf, int n, float px,
                                          float py, float& drop,
                                          bool& open) {
  if (!open) return;
  for (int j = 0; j < n; ++j) {
    const StagedSlot s = load_staged(buf, j);
    const float dx = px - s(MX), dy = py - s(MY);
    const float power = slot_power(s, dx, dy);
    if (may_pass(power, s(kThr))) {
      const SlotEval e = alpha_test(s, dx, dy, power);
      if (e.ok) {
        drop += log1pf(-e.alpha);
        if (drop < kLogEps) {
          open = false;
          return;
        }
      }
    }
  }
}

}  // namespace blend
