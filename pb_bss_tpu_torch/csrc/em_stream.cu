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
// the critical path and spends as few instructions a frame as it can: the
// streamed pass of stream.cuh (whole waves of equal spans, a cp.async
// ring of tiles, register sums, one fixed-order reduction a segment; its
// grid from ops/_plan.py, four times the CTAs resident at once), with
// this kernel's E-step:
//
//   E-step  a thread per frame, D a template parameter: the frame in
//           registers, for each class the projection
//           q = sum_i |(W^H y)_i|^2 on the scaled eigenbasis
//           W = V diag(l^{-1/2}) (built once per segment in shared memory,
//           read as broadcasts), max(q, tiny), the log-pdf, the max-shift
//           softmax with the mixture weight, the source-activity mask on
//           the numerators, max(den, tiny), the clip to [eps, 1 - eps]
//           (model mode); or the given posteriors and quadratic forms
//           (from_init mode). Saliency multiplies the posterior; the
//           scatter weight is w = a / max(q, 10 tiny).
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
#include "stream.cuh"

namespace {

using stream::kGroup;
using stream::kRow;
using stream::kThreads;
using stream::kTile;

// Shared memory of one CTA, in float-sized words: the pass's ring, scatter
// weights and reduction (stream.cuh), the log-pdfs and quadratic forms of
// a tile (K x kTile each), the scaled eigenbases, log-determinants and
// weights.
inline size_t stream_smem_bytes(int D, int K) {
  const size_t words = stream::ring_words(D) + stream::kPassWords +
                       size_t(K) * D * D * 2 + 2 * size_t(K) * kTile +
                       2 * size_t(K);
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
  constexpr int DD = D * D;
  extern __shared__ float4 smem_raw[];
  float2* ring = reinterpret_cast<float2*>(smem_raw);
  float* wq = reinterpret_cast<float*>(smem_raw) + stream::ring_words(D);
  float* lp = wq + kTile * kGroup;                     // K * kTile
  float* qv = lp + K * kTile;                          // K * kTile
  float2* Wh = reinterpret_cast<float2*>(qv + K * kTile);  // K * DD
  float* logdet = reinterpret_cast<float*>(Wh + K * DD);   // K
  float* wgt = logdet + K;                                 // K
  float* red_a = wgt + K;                      // kWarps * kGroup

  const bool from_init = aff0 != nullptr;
  const int tid = threadIdx.x;
  const float tiny = FLT_MIN;

  // ---- the segment's model: scaled eigenbases, log-determinants, weights
  auto setup = [&](int n) {
    if (from_init) return;
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
  };

  // ---- E-step of one frame -------------------------------------------
  auto frame = [&](int n, const float2* ys, int t, size_t g, float s, int g0,
                   int G, float (&a)[kGroup], float (&w)[kGroup]) {
    if (from_init) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        if (c < G) {
          const size_t at = (static_cast<size_t>(n) * K + g0 + c) * T + g;
          a[c] = aff0[at] * s;
          w[c] = a[c] / fmaxf(qf0[at], 10.f * tiny);
        }
      }
      return;
    }
    float2 yf[D];
#pragma unroll
    for (int d = 0; d < D; ++d) yf[d] = ys[d * kRow + t];
    e_step_frame(
        [&](int k) { return projection_form<D>(yf, Wh + k * DD); },
        logdet, wgt,
        mask == nullptr ? nullptr
                        : mask + static_cast<size_t>(n) * K * T + g,
        T, affiliation_eps, lp + t, qv + t, kTile, D, K);
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      if (c < G) {
        a[c] = lp[(g0 + c) * kTile + t] * s;
        w[c] = a[c] / fmaxf(qv[(g0 + c) * kTile + t], 10.f * tiny);
      }
    }
  };

  stream::pass<D, false>(y, sal, ring, wq, red_a, scatter_out, asum_out, N,
                         K, T, span, setup, frame);
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

cudaError_t resident_any(int D, size_t bytes, int* blocks) {
#define CALL(DV) resident<DV>(bytes, blocks)
  STREAM_DISPATCH(D, CALL)
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
  STREAM_DISPATCH(D, CALL)
#undef CALL
}
