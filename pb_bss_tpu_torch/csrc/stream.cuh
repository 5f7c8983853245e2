// The streamed statistics pass shared by the streamed cACGMM kernel
// (em_stream.cu, K4), the streamed Watson and Bingham kernel
// (mm_stream.cu, K7) and the E-step scatter (em_estep.cu, K11): the walk
// of a CTA's span of frames, the cp.async ring of tiles, the register sums
// and the cross-warp reduction. What each kernel adds is its model (set up
// once per segment), the E-step of one frame and where a segment's sums
// go. The walk of the spans (segment) and the in-launch sum of a bin split
// over CTAs (sum_split_bin) also serve the integration statistics pass
// (integration_em.cu, K10), which walks the same plan with its own ring.
//
// Replaces the sequential time grid of the JAX package's Pallas TPU
// kernels (pb_bss_tpu/ops/pallas_em_stream.py, pallas_mm_stream.py),
// which carried the sums from one time block to the next in VMEM; on the
// H100 the CTAs run in parallel with nothing carried between them:
//
//   work    a grid of whole waves (from the occupancy query;
//           ops/_plan.py), each CTA owning an equal span of `span` frames
//           of the bins laid end to end (bin n's frames are n T .. n T +
//           T - 1): every CTA does the same work, so there is no nearly
//           empty last wave. A span covers the tail of a bin, whole bins
//           and the head of another (or a piece of one bin); each piece of
//           a bin (a segment) has its own slot, slot = CTA index - the
//           first CTA on the bin (< `slots`). K4 and K7 write a segment's
//           partial sums to its slot and the wrapper adds a bin's slots in
//           a fixed order; K10 and K11 write a bin that one CTA covers
//           whole straight out, and the last CTA to finish a split bin (a
//           ticket on the bin's counter) adds its slots in slot order in
//           the same launch. Either way there are no float atomics and
//           runs repeat bit for bit.
//   copies  y streams through a two-stage ring of tiles of a frame a
//           thread in shared memory with cp.async: the next tile is in
//           flight while this one computes, and a segment's first tile
//           while its model is set up. The tile keeps y's (channel, frame)
//           layout with an odd row stride (threads + 1), so the D channels
//           of one frame fall in distinct banks for the scatter.
//   E-step  a thread per frame (the kernel's `frame`), D a template
//           parameter, so the frame can sit in registers; it returns each
//           class's posterior a (saliency applied; summed here in
//           registers) and scatter weight w, which goes to shared memory.
//   sums    lanes over upper-triangle entries, warps over frames: lane j
//           owns entries r = j, j + 32, ... and adds w_k y_d conj(y_e) of
//           its warp's frames into registers, for a group of kGroup
//           classes (more classes take another pass over the segment). No
//           shuffle reduction per tile: one cross-warp reduction through
//           shared memory per segment, in a fixed order.
//
// Tensor cores are not used: one tile's scatter is at most 32 x 32 in real
// terms, below wgmma's 64-row tile, and TF32 would round it to ~1e-3,
// which the EM amplifies. There is no padding: loops run over the real
// frames of each segment, so no padded frame can feed 0 * inf into a sum.
//
// Output layouts of pass (K4, K7): scatter (slots, N, K, D, D) complex64,
// the full Hermitian partial sums, or with UPPER (slots, N, K, D(D+1)/2),
// their row-major upper triangles (the caller mirrors them); and asum
// (slots, N, K). All are zeroed by the caller (a bin with fewer segments
// leaves its last slots 0). pass_to hands each sum to the kernel's own
// output instead.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace stream {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 256;  // frames per tile: one per thread in the E-step
constexpr int kRow = kTile + 1;  // the tile's row stride, odd
constexpr int kStages = 2;
constexpr int kGroup = 4;  // classes accumulated in registers at once

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Upper-triangle entries per class and per lane.
__host__ __device__ constexpr int entries(int D) { return D * (D + 1) / 2; }
__host__ __device__ constexpr int per_lane(int D) {
  return (entries(D) + 31) / 32;
}

// Float-sized words at the start of a CTA's shared memory: the ring of
// tiles of `threads` frames, which the cross-warp reduction reuses as its
// scratch; a multiple of 4, so what follows is 16-byte aligned.
__host__ __device__ constexpr size_t ring_words(int D, int threads = kThreads) {
  return size_t(kStages) * D * (threads + 1) * 2 >
                 size_t(threads / 32) * kGroup * per_lane(D) * 32 * 2
             ? size_t(kStages) * D * (threads + 1) * 2
             : size_t(threads / 32) * kGroup * per_lane(D) * 32 * 2;
}

// Words the pass itself takes besides the ring: the scatter weights of a
// tile (threads x kGroup, right after the ring, 16-byte aligned for float4
// reads) and the affiliation sums of the reduction (warps x kGroup).
__host__ __device__ constexpr size_t pass_words(int threads = kThreads) {
  return size_t(threads) * kGroup + size_t(threads / 32) * kGroup;
}
constexpr size_t kPassWords = pass_words();

// The piece of bin n that a CTA's span covers: frames t_begin .. t_end - 1;
// the CTAs on bin n are first .. first + nseg - 1, and this one has the
// bin's slot `slot`.
struct Segment {
  int n, t_begin, t_end, nseg, slot;
};

// The segment that starts at frame `pos` of the bins laid end to end, in
// this CTA's span, which ends at `end`.
__device__ __forceinline__ Segment segment(long long pos, long long end,
                                           int T, long long span) {
  Segment s;
  s.n = static_cast<int>(pos / T);
  const long long bin_begin = static_cast<long long>(s.n) * T;
  s.t_begin = static_cast<int>(pos - bin_begin);
  s.t_end = static_cast<int>((end < bin_begin + T ? end : bin_begin + T) -
                             bin_begin);
  const int first = static_cast<int>(bin_begin / span);
  s.nseg = static_cast<int>((bin_begin + T - 1) / span) - first + 1;
  s.slot = static_cast<int>(blockIdx.x) - first;
  return s;
}

// body(s) for each segment of this CTA's span, in frame order.
template <class Body>
__device__ __forceinline__ void for_each_segment(int N, int T,
                                                 long long span, Body body) {
  const long long total = static_cast<long long>(N) * T;
  const long long begin = static_cast<long long>(blockIdx.x) * span;
  const long long end = begin + span < total ? begin + span : total;
  for (long long pos = begin; pos < end;) {
    const Segment s = segment(pos, end, T, span);
    pos = static_cast<long long>(s.n) * T + s.t_end;
    body(s);
  }
}

// A bin split over CTAs, by the whole CTA once its slot of bin s.n holds
// its partial sums (slots: (slots, N, K, I) float2, I items a class): the
// CTA that finishes the bin last (a ticket on counters[s.n]; flag, an int
// of shared memory) adds the bin's slots in slot order, from L2, and hands
// item r of class k to out(k, r, v). It puts the counter back to 0 for the
// next launch. Nothing for a bin that one CTA covers whole.
template <class Out>
__device__ __forceinline__ void sum_split_bin(const Segment& s,
                                              const float2* slots,
                                              int* counters, int* flag,
                                              int N, int K, int I, Out out) {
  if (s.nseg == 1) return;
  __threadfence();  // this CTA's slot, visible before its ticket
  __syncthreads();
  if (threadIdx.x == 0) *flag = atomicAdd(counters + s.n, 1) == s.nseg - 1;
  __syncthreads();
  if (!*flag) return;
  __threadfence();
  const size_t items = size_t(K) * I;
  for (int id = threadIdx.x; id < K * I; id += blockDim.x) {
    float2 v = __ldcg(slots + size_t(s.n) * items + id);
    for (int q = 1; q < s.nseg; ++q)
      v = c_add(v, __ldcg(slots + (size_t(q) * N + s.n) * items + id));
    out(id / I, id % I, v);
  }
  if (threadIdx.x == 0) counters[s.n] = 0;  // ready for the next launch
}

// One statistics pass over this CTA's span, by the whole CTA of THREADS
// threads. ring: the first ring_words(D, THREADS) words of shared memory;
// wq: the THREADS * kGroup words after them; red_a: THREADS / 32 * kGroup
// words. `setup(n)` builds the model of bin n in shared memory (every
// thread calls it; the pass synchronizes before and after). `frame(n, ys,
// t, g, s, g0, G, a, w)` is the E-step of frame g of bin n, column t of
// the tile ys (row stride THREADS + 1), saliency s, for the classes g0 ..
// g0 + G - 1: it sets a[c] (the posterior, saliency applied) and w[c]
// (its scatter weight) for c < G. `emit(seg, k, r, v)` takes the sums of
// class k of the segment: r < D(D+1)/2 the row-major upper-triangle entry
// r of sum_t w y y^H, r = D(D+1)/2 the affiliation sum (in v.x).
// `finish(seg)` runs on the whole CTA once a segment's sums are emitted.
template <int D, int THREADS, class Setup, class Frame, class Emit,
          class Finish>
__device__ __forceinline__ void pass_to(const float2* __restrict__ y,
                                        const float* __restrict__ sal,
                                        float2* ring, float* wq,
                                        float* red_a, int N, int K, int T,
                                        long long span, Setup setup,
                                        Frame frame, Emit emit,
                                        Finish finish) {
  constexpr int P = entries(D);
  constexpr int E = per_lane(D);
  constexpr int kRowT = THREADS + 1;
  constexpr int kWarpsT = THREADS / 32;
  float2* scratch = ring;  // reused once a segment's tiles are done
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // this lane's upper-triangle entries (d_j, e_j); entries past P point
  // at (0, 0) and are never written out
  int ed[E], ee[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int r = lane + 32 * j;
    upper_entry(r < P ? r : 0, D, &ed[j], &ee[j]);
  }

  for_each_segment(N, T, span, [&](const Segment& seg) {
    const int n = seg.n;
    const int t_begin = seg.t_begin;
    const int t_end = seg.t_end;
    const int tiles = (t_end - t_begin + THREADS - 1) / THREADS;
    const float2* yn = y + static_cast<size_t>(n) * D * T;
    auto issue = [&](int i) {
      const int t0 = t_begin + i * THREADS;
      const int nt = min(THREADS, t_end - t0);
      float2* dst = ring + (i % kStages) * D * kRowT;
      if (tid < nt) {
#pragma unroll
        for (int d = 0; d < D; ++d)
          cp_async8(dst + d * kRowT + tid, yn + static_cast<size_t>(d) * T +
                                               t0 + tid);
      }
      cp_async_commit();
    };

    __syncthreads();  // the previous segment is done with the model, scratch
    issue(0);  // the first tile's copy overlaps the model's set-up
    setup(n);
    __syncthreads();

    for (int g0 = 0; g0 < K; g0 += kGroup) {
      const int G = min(kGroup, K - g0);
      if (g0 > 0) issue(0);
      float2 acc[E][kGroup];
      float asum[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        asum[c] = 0.f;
#pragma unroll
        for (int j = 0; j < E; ++j) acc[j][c] = make_float2(0.f, 0.f);
      }

      for (int i = 0; i < tiles; ++i) {
        if (i + 1 < tiles) issue(i + 1);
        else cp_async_commit();  // empty: keeps the group count
        cp_async_wait<1>();
        __syncthreads();
        const float2* ys = ring + (i % kStages) * D * kRowT;
        const int t0 = t_begin + i * THREADS;
        const int nt = min(THREADS, t_end - t0);

        // ---- E-step: a thread per frame --------------------------------
        if (tid < nt) {
          const size_t g = static_cast<size_t>(t0) + tid;
          const float s = (sal != nullptr)
              ? sal[static_cast<size_t>(n) * T + g] : 1.f;
          float a[kGroup], w[kGroup];
          frame(n, ys, tid, g, s, g0, G, a, w);
#pragma unroll
          for (int c = 0; c < kGroup; ++c) {
            if (c < G) asum[c] += a[c];
            wq[tid * kGroup + c] = c < G ? w[c] : 0.f;
          }
        }
        __syncthreads();

        // ---- sums: lanes over entries, warps over frames ----------------
#pragma unroll 4
        for (int t = warp; t < nt; t += kWarpsT) {
          const float4 w4 = *reinterpret_cast<const float4*>(wq + t * kGroup);
          const float w[kGroup] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const float2 p = c_mul_conj(ys[ed[j] * kRowT + t],
                                        ys[ee[j] * kRowT + t]);
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              acc[j][c].x = fmaf(w[c], p.x, acc[j][c].x);
              acc[j][c].y = fmaf(w[c], p.y, acc[j][c].y);
            }
          }
        }
        __syncthreads();  // this stage is free for the tile after next
      }
      cp_async_wait<0>();

      // ---- one cross-warp reduction for the segment, in warp order -------
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
#pragma unroll
        for (int j = 0; j < E; ++j)
          scratch[((warp * kGroup + c) * E + j) * 32 + lane] = acc[j][c];
        const float a = warp_sum(asum[c]);
        if (lane == 0) red_a[warp * kGroup + c] = a;
      }
      __syncthreads();
      for (int id = tid; id < G * (P + 1); id += THREADS) {
        const int c = id / (P + 1);
        const int r = id - c * (P + 1);
        float2 v = make_float2(0.f, 0.f);
        if (r < P) {
          const int j = r / 32;
          const int l = r - 32 * j;
          for (int w = 0; w < kWarpsT; ++w)
            v = c_add(v, scratch[((w * kGroup + c) * E + j) * 32 + l]);
        } else {
          for (int w = 0; w < kWarpsT; ++w) v.x += red_a[w * kGroup + c];
        }
        emit(seg, g0 + c, r, v);
      }
      __syncthreads();  // scratch (the ring) is free again
    }
    finish(seg);
  });
}

// pass_to with the slot outputs of K4 and K7 (the layouts above), on
// kThreads threads a CTA.
template <int D, bool UPPER, class Setup, class Frame>
__device__ __forceinline__ void pass(const float2* __restrict__ y,
                                     const float* __restrict__ sal,
                                     float2* ring, float* wq, float* red_a,
                                     float2* __restrict__ scatter_out,
                                     float* __restrict__ asum_out, int N,
                                     int K, int T, long long span,
                                     Setup setup, Frame frame) {
  constexpr int P = entries(D);
  constexpr int kOut = UPPER ? P : D * D;  // words a class
  auto emit = [&](const Segment& seg, int k, int r, float2 v) {
    const size_t nk = (static_cast<size_t>(seg.slot) * N + seg.n) * K + k;
    if (r == P) {
      asum_out[nk] = v.x;
      return;
    }
    int d, e;
    upper_entry(r, D, &d, &e);
    float2* Sk = scatter_out + nk * kOut;
    if (UPPER) {
      Sk[r] = d == e ? make_float2(v.x, 0.f) : v;
    } else if (d == e) {
      Sk[d * D + d] = make_float2(v.x, 0.f);
    } else {
      Sk[d * D + e] = v;
      Sk[e * D + d] = c_conj(v);
    }
  };
  pass_to<D, kThreads>(y, sal, ring, wq, red_a, N, K, T, span, setup, frame,
                       emit, [](const Segment&) {});
}

}  // namespace stream

// Calls CALL(D) for the runtime D in 1..16 (the streamed kernels'
// instantiations, K4, K7 and K11).
#define STREAM_DISPATCH(D, CALL)                                         \
  switch (D) {                                                           \
    case 1: return CALL(1); case 2: return CALL(2);                      \
    case 3: return CALL(3); case 4: return CALL(4);                      \
    case 5: return CALL(5); case 6: return CALL(6);                      \
    case 7: return CALL(7); case 8: return CALL(8);                      \
    case 9: return CALL(9); case 10: return CALL(10);                    \
    case 11: return CALL(11); case 12: return CALL(12);                  \
    case 13: return CALL(13); case 14: return CALL(14);                  \
    case 15: return CALL(15); case 16: return CALL(16);                  \
    default: return cudaErrorInvalidValue;                               \
  }
