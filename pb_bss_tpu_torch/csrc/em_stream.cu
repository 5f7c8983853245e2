// Streamed cACGMM EM statistics: one pass of E-step + M-step sums over
// a long signal, for signals too long for the whole-fit kernel.
//
// Replaces pb_bss_tpu/ops/pallas_em_stream.py:cacgmm_em_long (its
// _e_stats_stream_kernel, the Pallas TPU kernel). The TPU walked a
// sequential grid of (frequency tile, time block) and carried the sums
// from one time block to the next in VMEM. On the H100 the CTAs run in
// parallel with nothing carried between them.
//
// What bounds it on the H100: y is read once per pass (185 MB for four
// 60 s recordings at D=6: ~55 us at 3.35 TB/s), and each frame costs, per
// class, the projection of the quadratic form (D^2 complex multiply-adds),
// a log and an exp, plus the D(D+1)/2 pair products of the scatter shared
// by the classes: ~1,300 float32 operations a frame at D=6, K=3, ~75 us at
// 67 TFLOP/s. The two are close, so the design keeps the copies of y off
// the critical path and spends as few instructions a frame as it can:
//
//   work    a grid of whole waves (four times the CTAs resident at once,
//           from the occupancy query; ops/em_stream.py), each CTA owning
//           an equal span of `span` frames of the bins laid end to end
//           (bin n's frames are n T .. n T + T - 1): every CTA does the
//           same work, so there is no nearly empty last wave. A span
//           covers the tail of a bin, whole bins and the head of another
//           (or a piece of one bin); each piece of a bin
//           (a segment) writes its partial sums to its own slot, slot =
//           CTA index - the first CTA on the bin (< `slots`). The wrapper
//           adds a bin's slots in a fixed order (a deterministic two-pass
//           reduction, no float atomics), so runs repeat bit for bit.
//   copies  y streams through a two-stage ring of kTile-frame tiles in
//           shared memory with cp.async: the next tile is in flight while
//           this one computes. The tile keeps y's (channel, frame) layout
//           with an odd row stride (kTile + 1), so the D channels of one
//           frame fall in distinct banks for the scatter.
//   E-step  a thread per frame, D a template parameter: the frame in
//           registers, for each class the projection
//           q = sum_i |(W^H y)_i|^2 on the scaled eigenbasis
//           W = V diag(l^{-1/2}) (built once per segment in shared memory,
//           read as broadcasts), max(q, tiny), the log-pdf, the max-shift
//           softmax with the mixture weight, the source-activity mask on
//           the numerators, max(den, tiny), the clip to [eps, 1 - eps]
//           (model mode); or the given posteriors and quadratic forms
//           (from_init mode). Saliency multiplies the posterior; the
//           thread keeps the affiliation sums in registers and writes the
//           scatter weights w = a / max(q, 10 tiny) to shared memory.
//   sums    lanes over upper-triangle entries, warps over frames: lane
//           j owns entries r = j, j + 32, ... and adds w_k y_d conj(y_e)
//           of its warp's frames into registers, for a group of kGroup
//           classes (more classes take another pass over the segment).
//           No shuffle reduction per tile: one cross-warp reduction
//           through shared memory per segment, in a fixed order.
//
// Tensor cores are not used: one tile's scatter is at most 32 x 32 in
// real terms, below wgmma's 64-row tile, and TF32 would round it to
// ~1e-3, which the EM amplifies.
//
// There is no padding: loops run over the real frames of each segment,
// so no padded frame can feed 0 * inf into a sum.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2;
// aff0/qf0/mask (N, K, T) float; sal (N, T) float; eigval (N, K, D);
// eigvec (N, K, D, D) complex64, eigenvectors in columns; weight (N, K);
// scatter (slots, N, K, D, D) complex64, the full Hermitian partial sums,
// and asum (slots, N, K), both zeroed by the caller (a bin with fewer
// segments leaves its last slots 0).
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

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

// Shared memory of one CTA, in float-sized words: the ring (also the
// cross-warp reduction's scratch), the scatter weights of a tile
// (kTile x kGroup, 16-byte aligned for float4 reads), the log-pdfs and
// quadratic forms of a tile (K x kTile each), the scaled eigenbases,
// log-determinants, weights, and the affiliation sums of the reduction.
__host__ __device__ inline size_t ring_words(int D) {
  const size_t ring = size_t(kStages) * D * kRow * 2;
  const size_t scratch = size_t(kWarps) * kGroup * per_lane(D) * 32 * 2;
  return ring > scratch ? ring : scratch;
}

inline size_t stream_smem_bytes(int D, int K) {
  const size_t words = ring_words(D) + size_t(K) * D * D * 2 +
                       size_t(kTile) * kGroup + 2 * size_t(K) * kTile +
                       2 * size_t(K) + kWarps * kGroup;
  return 4 * words;
}

// Registers: up to 64 a thread for D <= 8, four CTAs (32 warps) an SM;
// more for larger D.
template <int D>
__global__ void __launch_bounds__(kThreads, D <= 8 ? 4 : 2)
em_stream_kernel(const float2* __restrict__ y,
                 const float* __restrict__ aff0,
                 const float* __restrict__ qf0,
                 const float* __restrict__ eigval,
                 const float2* __restrict__ eigvec,
                 const float* __restrict__ weight,
                 const float* __restrict__ sal,
                 const float* __restrict__ mask,
                 float2* __restrict__ scatter_out,
                 float* __restrict__ asum_out, int N, int K, int T,
                 long long span, float affiliation_eps) {
  constexpr int P = entries(D);
  constexpr int E = per_lane(D);
  constexpr int DD = D * D;
  extern __shared__ float4 smem_raw[];
  float2* ring = reinterpret_cast<float2*>(smem_raw);
  float2* scratch = ring;  // reused once a segment's tiles are done
  float* wq = reinterpret_cast<float*>(smem_raw) + ring_words(D);
  float* lp = wq + kTile * kGroup;                     // K * kTile
  float* qv = lp + K * kTile;                          // K * kTile
  float2* Wh = reinterpret_cast<float2*>(qv + K * kTile);  // K * DD
  float* logdet = reinterpret_cast<float*>(Wh + K * DD);   // K
  float* wgt = logdet + K;                                 // K
  float* red_a = wgt + K;                            // kWarps * kGroup

  const bool from_init = aff0 != nullptr;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const float tiny = FLT_MIN;

  // this lane's upper-triangle entries (d_j, e_j); entries past P point
  // at (0, 0) and are never written out
  int ed[E], ee[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const int r = lane + 32 * j;
    upper_entry(r < P ? r : 0, D, &ed[j], &ee[j]);
  }

  const long long total = static_cast<long long>(N) * T;
  const long long begin = static_cast<long long>(blockIdx.x) * span;
  const long long end = begin + span < total ? begin + span : total;

  for (long long pos = begin; pos < end;) {
    const int n = static_cast<int>(pos / T);
    const int t_begin = static_cast<int>(pos - static_cast<long long>(n) * T);
    const long long bin_end = static_cast<long long>(n + 1) * T;
    const int t_end = static_cast<int>((end < bin_end ? end : bin_end) -
                                       static_cast<long long>(n) * T);
    const int slot = blockIdx.x -
                     static_cast<int>(static_cast<long long>(n) * T / span);
    pos = static_cast<long long>(n) * T + t_end;

    // ---- the segment's model: scaled eigenbases, log-determinants,
    // weights ---------------------------------------------------------------
    __syncthreads();  // the previous segment is done with Wh and scratch
    if (!from_init) {
      for (int id = tid; id < K * DD; id += kThreads) {
        const int k = id / DD;
        const int i = (id - k * DD) / D;
        const int d = id - k * DD - i * D;
        const size_t nk = static_cast<size_t>(n) * K + k;
        Wh[id] = c_scale(1.f / sqrtf(eigval[nk * D + i]),
                         c_conj(eigvec[nk * DD + d * D + i]));
      }
      for (int k = tid; k < K; k += kThreads) {
        const float* lk = eigval + (static_cast<size_t>(n) * K + k) * D;
        float ld = 0.f;
        for (int i = 0; i < D; ++i) ld += logf(lk[i]);
        logdet[k] = ld;
        wgt[k] = weight[static_cast<size_t>(n) * K + k];
      }
    }
    __syncthreads();

    const int tiles = (t_end - t_begin + kTile - 1) / kTile;
    const float2* yn = y + static_cast<size_t>(n) * D * T;
    auto issue = [&](int i) {
      const int t0 = t_begin + i * kTile;
      const int nt = min(kTile, t_end - t0);
      float2* dst = ring + (i % kStages) * D * kRow;
      if (tid < nt) {
#pragma unroll
        for (int d = 0; d < D; ++d)
          cp_async8(dst + d * kRow + tid, yn + static_cast<size_t>(d) * T +
                                              t0 + tid);
      }
    };

    for (int g0 = 0; g0 < K; g0 += kGroup) {
      const int G = min(kGroup, K - g0);
      float2 acc[E][kGroup];
      float asum[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        asum[c] = 0.f;
#pragma unroll
        for (int j = 0; j < E; ++j) acc[j][c] = make_float2(0.f, 0.f);
      }

      issue(0);
      cp_async_commit();
      for (int i = 0; i < tiles; ++i) {
        if (i + 1 < tiles) issue(i + 1);
        cp_async_commit();  // possibly empty: keeps the group count
        cp_async_wait<1>();
        __syncthreads();
        const float2* ys = ring + (i % kStages) * D * kRow;
        const int t0 = t_begin + i * kTile;
        const int nt = min(kTile, t_end - t0);

        // ---- E-step: a thread per frame ------------------------------
        if (tid < nt) {
          const int t = tid;
          const size_t g = static_cast<size_t>(t0) + t;
          const float s = (sal != nullptr)
              ? sal[static_cast<size_t>(n) * T + g] : 1.f;
          if (from_init) {
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              float w = 0.f;
              if (c < G) {
                const size_t at =
                    (static_cast<size_t>(n) * K + g0 + c) * T + g;
                const float a = aff0[at] * s;
                asum[c] += a;
                w = a / fmaxf(qf0[at], 10.f * tiny);
              }
              wq[t * kGroup + c] = w;
            }
          } else {
            float2 yf[D];
#pragma unroll
            for (int d = 0; d < D; ++d) yf[d] = ys[d * kRow + t];
            e_step_frame(
                [&](int k) { return projection_form<D>(yf, Wh + k * DD); },
                logdet, wgt,
                mask == nullptr
                    ? nullptr
                    : mask + static_cast<size_t>(n) * K * T + g,
                T, affiliation_eps, lp + t, qv + t, kTile, D, K);
#pragma unroll
            for (int c = 0; c < kGroup; ++c) {
              float w = 0.f;
              if (c < G) {
                const float a = lp[(g0 + c) * kTile + t] * s;
                asum[c] += a;
                w = a / fmaxf(qv[(g0 + c) * kTile + t], 10.f * tiny);
              }
              wq[t * kGroup + c] = w;
            }
          }
        }
        __syncthreads();

        // ---- sums: lanes over entries, warps over frames --------------
#pragma unroll 4
        for (int t = warp; t < nt; t += kWarps) {
          const float4 w4 = *reinterpret_cast<const float4*>(wq + t * kGroup);
          const float w[kGroup] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int j = 0; j < E; ++j) {
            const float2 p = c_mul_conj(ys[ed[j] * kRow + t],
                                        ys[ee[j] * kRow + t]);
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

      // ---- one cross-warp reduction for the segment, in warp order -----
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
#pragma unroll
        for (int j = 0; j < E; ++j)
          scratch[((warp * kGroup + c) * E + j) * 32 + lane] = acc[j][c];
        const float a = warp_sum(asum[c]);
        if (lane == 0) red_a[warp * kGroup + c] = a;
      }
      __syncthreads();
      float2* out = scatter_out +
                    (static_cast<size_t>(slot) * N + n) * K * DD;
      for (int id = tid; id < G * P; id += kThreads) {
        const int c = id / P;
        const int r = id - c * P;
        const int j = r / 32;
        const int l = r - 32 * j;
        float2 v = make_float2(0.f, 0.f);
        for (int w = 0; w < kWarps; ++w)
          v = c_add(v, scratch[((w * kGroup + c) * E + j) * 32 + l]);
        int d, e;
        upper_entry(r, D, &d, &e);
        float2* Sk = out + (g0 + c) * DD;
        if (d == e) {
          Sk[d * D + d] = make_float2(v.x, 0.f);
        } else {
          Sk[d * D + e] = v;
          Sk[e * D + d] = c_conj(v);
        }
      }
      if (tid < G) {
        float a = 0.f;
        for (int w = 0; w < kWarps; ++w) a += red_a[w * kGroup + tid];
        asum_out[(static_cast<size_t>(slot) * N + n) * K + g0 + tid] = a;
      }
      __syncthreads();  // scratch (the ring) is free again
    }
  }
}

template <int D>
cudaError_t prepare(size_t bytes) {
  return cudaFuncSetAttribute(em_stream_kernel<D>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int D>
cudaError_t resident(size_t bytes, int* blocks) {
  cudaError_t err = prepare<D>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, em_stream_kernel<D>, kThreads, bytes);
}

template <int D>
cudaError_t launch(int ctas, size_t bytes, cudaStream_t stream,
                   const void* y, const void* aff0, const void* qf0,
                   const void* eigval, const void* eigvec,
                   const void* weight, const void* sal, const void* mask,
                   void* scatter, void* asum, int N, int K, int T,
                   long long span, float affiliation_eps) {
  cudaError_t err = prepare<D>(bytes);
  if (err != cudaSuccess) return err;
  em_stream_kernel<D><<<ctas, kThreads, bytes, stream>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(qf0), static_cast<const float*>(eigval),
      static_cast<const float2*>(eigvec), static_cast<const float*>(weight),
      static_cast<const float*>(sal), static_cast<const float*>(mask),
      static_cast<float2*>(scatter), static_cast<float*>(asum), N, K, T,
      span, affiliation_eps);
  return cudaGetLastError();
}

// Calls f.template operator()<D>() for the runtime D in 1..16.
#define EM_STREAM_DISPATCH(D, CALL)                                      \
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

cudaError_t resident_any(int D, size_t bytes, int* blocks) {
#define CALL(DV) resident<DV>(bytes, blocks)
  EM_STREAM_DISPATCH(D, CALL)
#undef CALL
}

}  // namespace

// CTAs of one pass that are resident on the whole card at once for
// (D, K): blocks per SM from the occupancy query times the SMs. Returns
// a negative cudaError_t on failure.
extern "C" int em_stream_capacity(int D, int K) {
  int blocks = 0, device = 0, sms = 0;
  cudaError_t err = resident_any(D, stream_smem_bytes(D, K), &blocks);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return -int(err);
  return blocks * sms;
}

// Launch one statistics pass on `stream`: `ctas` CTAs, each over `span`
// frames of the N bins of T frames laid end to end. from_init mode when
// aff0 is non-null (then qf0 too; eigval/eigvec/weight unused), model mode
// otherwise. sal and mask may be null. Returns a cudaError_t (0 on
// success); neither synchronizes nor allocates.
extern "C" int em_stream_launch(
    const void* y, const void* aff0, const void* qf0, const void* eigval,
    const void* eigvec, const void* weight, const void* sal,
    const void* mask, void* scatter, void* asum, int N, int D, int K, int T,
    int ctas, long long span, float affiliation_eps, void* stream) {
  const size_t bytes = stream_smem_bytes(D, K);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                          \
  int(launch<DV>(ctas, bytes, s, y, aff0, qf0, eigval, eigvec, weight,    \
                 sal, mask, scatter, asum, N, K, T, span, affiliation_eps))
  EM_STREAM_DISPATCH(D, CALL)
#undef CALL
}
