// Streamed mixture statistics: one pass of E-step + M-step sums over a
// long signal, for the complex Watson and complex Bingham fits the
// whole-fit kernels (cwmm_loop.cu, cbmm_loop.cu) do not take:
// frequency-constant weights at any T, and per-bin weights past their
// gates.
//
// Replaces pb_bss_tpu/ops/pallas_mm_stream.py:_stream_machinery /
// _mm_stats_stream_kernel as launched by cwmm_em_long and cbmm_em_long
// (the Pallas TPU kernel, both families). The TPU walked a sequential grid
// of (frequency tile, time block), carried the sums from block to block in
// VMEM and shrank the from-init time block to fit VMEM. Here the pass is
// the streamed cACGMM kernel's (stream.cuh: whole waves of CTAs over equal
// spans of the bins' frames laid end to end, from the occupancy query; y
// through a two-stage cp.async ring of tiles with an odd row stride;
// register sums, lanes over upper-triangle entries and warps over frames;
// one fixed-order cross-warp reduction a segment; each segment's partial
// sums in its own slot, added by the wrapper in a fixed order), with this
// kernel's E-step, a thread per frame and the frame in registers (D a
// template parameter, 1..16):
//
//   Watson   kappa |<y, m>|^2 - log Z per class (watson.cuh), the modes,
//            concentrations and log-norms of the segment's bin in shared
//            memory, read as broadcasts;
//   Bingham  y^H B y - log c per class with the Hermitian forms
//            B_k = V diag(lambda) V^H built once per segment in shared
//            memory (a warp per class, bingham.cuh), then the clip to
//            [eps, 1 - eps] when eps != 0;
//   both     the max-shift softmax with the mixture weight (per bin, or
//            frequency-constant: the weight of bin n is
//            weight[n / bins_per_weight]), max(den, tiny); from-init mode
//            takes the given affiliations instead. Saliency multiplies
//            the posteriors, which are the scatter weights.
//
// Output: the upper triangle of each class's Hermitian scatter sum_t a y
// y^H and the affiliation sums, per slot; the wrapper adds the slots and
// mirrors the triangle. The M-step finish (normalization, eigh, and
// the concentration table or the Bingham moment inversion, weight) runs in
// PyTorch.
//
// What bounds it on the H100: y is read once per pass (98.5 MB at one
// T=4000 recording of 513 bins, D=6; ~29 us at 3.35 TB/s). A frame costs
// the D(D+1)/2 pair products of the scatter, K D(D+1)/2 complex
// multiply-adds into the sums, and the E-step: K rank-1 forms (Watson) or
// K quadratic forms over the upper triangle (Bingham), a log-density and
// an exp each: ~600-900 float32 operations a frame at D=6, K=3, and more
// instructions than that, so the pass is bound by the issue of its sums
// and E-step, not by the bytes; the design keeps every CTA busy and the
// copies of y off the critical path.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; aff0
// (N, K, T); sal (N, T); mode (N, K, D) complex64; kappa (N, K); vec
// (N, K, D, D) complex64 (eigenvectors in columns); lam (N, K, D); logz
// (N, K) (log Z or log c); weight (N / bins_per_weight, K); scatter
// (slots, N, K, D(D+1)/2) complex64 (row-major upper triangles) and asum
// (slots, N, K), zeroed by the caller.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "bingham.cuh"
#include "em_common.cuh"
#include "stream.cuh"
#include "watson.cuh"

namespace {

using stream::kGroup;
using stream::kRow;
using stream::kThreads;
using stream::kTile;

// Shared memory of one CTA, in float-sized words: the pass's ring, scatter
// weights and reduction (stream.cuh), the posteriors of a tile (K x
// kTile), the model (Watson: the K modes; Bingham: the K forms) and the
// log-norms, concentrations and weights.
inline size_t mm_smem_bytes(int D, int K, bool bingham) {
  const size_t model = bingham ? size_t(K) * D * D : size_t(K) * D;
  return 4 * (stream::ring_words(D) + stream::kPassWords +
              size_t(K) * kTile + 2 * model + 3 * size_t(K));
}

// BINGHAM: the Bingham step mode (from-init mode runs either family).
// Registers: up to 64 a thread for D <= 8, four CTAs (32 warps) an SM;
// more for larger D.
template <int D, bool BINGHAM>
__global__ void __launch_bounds__(kThreads, D <= 8 ? 4 : 2)
mm_stream_kernel(const float2* __restrict__ y,
                 const float* __restrict__ aff0,
                 const float2* __restrict__ mode_in,
                 const float* __restrict__ kappa_in,
                 const float* __restrict__ logz_in,
                 const float* __restrict__ weight,
                 const float* __restrict__ sal,
                 const float2* __restrict__ vec_in,
                 const float* __restrict__ lam_in,
                 float2* __restrict__ scatter_out,
                 float* __restrict__ asum_out, int N, int K, int T,
                 long long span, int bins_per_weight, float eps) {
  constexpr int DD = D * D;
  extern __shared__ float4 smem_raw[];
  float2* ring = reinterpret_cast<float2*>(smem_raw);
  float* wq = reinterpret_cast<float*>(smem_raw) + stream::ring_words(D);
  float* aff = wq + kTile * kGroup;                        // K * kTile
  float2* model = reinterpret_cast<float2*>(aff + K * kTile);
  float* logz = reinterpret_cast<float*>(model + (BINGHAM ? K * DD : K * D));
  float* kappa = logz + K;                                 // K
  float* wgt = kappa + K;                                  // K
  float* red_a = wgt + K;                      // kWarps * kGroup

  const bool from_init = aff0 != nullptr;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  // ---- the segment's model ----------------------------------------------
  auto setup = [&](int n) {
    if (from_init) return;
    const size_t nk = static_cast<size_t>(n) * K;
    if (BINGHAM) {
      for (int k = warp; k < K; k += stream::kWarps)
        warp_bingham_form(vec_in + (nk + k) * DD, lam_in + (nk + k) * D,
                          model + k * DD, D);
    } else {
      for (int i = tid; i < K * D; i += kThreads)
        model[i] = mode_in[nk * D + i];
    }
    for (int k = tid; k < K; k += kThreads) {
      if (!BINGHAM) kappa[k] = kappa_in[nk + k];
      logz[k] = logz_in[nk + k];
      wgt[k] = weight[static_cast<size_t>(n / bins_per_weight) * K + k];
    }
  };

  // ---- E-step of one frame (or the given affiliations), saliency --------
  auto frame = [&](int n, const float2* ys, int t, size_t g, float s, int g0,
                   int G, float (&a)[kGroup], float (&w)[kGroup]) {
    if (from_init) {
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c < G)
          a[c] = aff0[(static_cast<size_t>(n) * K + g0 + c) * T + g] * s;
    } else {
      float2 yf[D];
#pragma unroll
      for (int d = 0; d < D; ++d) yf[d] = ys[d * kRow + t];
      if (BINGHAM)
        bingham_e_step_frame([&](int d) { return yf[d]; }, model, logz, wgt,
                             eps, aff + t, kTile, D, K);
      else
        watson_e_step_frame([&](int d) { return yf[d]; }, model, kappa, logz,
                            wgt, aff + t, kTile, D, K);
#pragma unroll
      for (int c = 0; c < kGroup; ++c)
        if (c < G) a[c] = aff[(g0 + c) * kTile + t] * s;
    }
#pragma unroll
    for (int c = 0; c < kGroup; ++c) w[c] = a[c];
  };

  stream::pass<D, true>(y, sal, ring, wq, red_a, scatter_out, asum_out, N,
                         K, T, span, setup, frame);
}

template <int D, bool BINGHAM>
cudaError_t prepare(size_t bytes) {
  return cudaFuncSetAttribute(mm_stream_kernel<D, BINGHAM>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              int(bytes));
}

template <int D, bool BINGHAM>
cudaError_t resident(size_t bytes, int* blocks) {
  cudaError_t err = prepare<D, BINGHAM>(bytes);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, mm_stream_kernel<D, BINGHAM>, kThreads, bytes);
}

template <int D, bool BINGHAM>
cudaError_t launch(int ctas, size_t bytes, cudaStream_t stream,
                   const void* y, const void* aff0, const void* mode,
                   const void* kappa, const void* logz, const void* weight,
                   const void* sal, const void* vec, const void* lam,
                   void* scatter, void* asum, int N, int K, int T,
                   long long span, int bins_per_weight, float eps) {
  cudaError_t err = prepare<D, BINGHAM>(bytes);
  if (err != cudaSuccess) return err;
  mm_stream_kernel<D, BINGHAM><<<ctas, kThreads, bytes, stream>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float2*>(mode), static_cast<const float*>(kappa),
      static_cast<const float*>(logz), static_cast<const float*>(weight),
      static_cast<const float*>(sal), static_cast<const float2*>(vec),
      static_cast<const float*>(lam), static_cast<float2*>(scatter),
      static_cast<float*>(asum), N, K, T, span, bins_per_weight, eps);
  return cudaGetLastError();
}

cudaError_t resident_any(int D, bool bingham, size_t bytes, int* blocks) {
#define CALL(DV)                                    \
  (bingham ? resident<DV, true>(bytes, blocks)      \
           : resident<DV, false>(bytes, blocks))
  STREAM_DISPATCH(D, CALL)
#undef CALL
}

}  // namespace

// CTAs of one pass that are resident on the whole card at once for
// (D, K) in the Bingham step mode (bingham != 0) or the other modes:
// blocks per SM from the occupancy query times the SMs. Returns a negative
// cudaError_t on failure.
extern "C" int mm_stream_capacity(int D, int K, int bingham) {
  int blocks = 0, device = 0, sms = 0;
  cudaError_t err = resident_any(D, bingham != 0,
                                 mm_smem_bytes(D, K, bingham != 0), &blocks);
  if (err == cudaSuccess) err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err != cudaSuccess) return -int(err);
  return blocks * sms;
}

// Launch one statistics pass on `stream`: `ctas` CTAs, each over `span`
// frames of the N bins of T frames laid end to end. From-init mode when
// aff0 is non-null (the model pointers unused); otherwise Bingham step mode
// when vec is non-null (vec, lam, logz = log c, weight, eps; mode and kappa
// unused), else Watson step mode (mode, kappa, logz, weight). sal may be
// null. Returns a cudaError_t (0 on success); neither synchronizes nor
// allocates.
extern "C" int mm_stream_launch(const void* y, const void* aff0,
                                const void* mode, const void* kappa,
                                const void* logz, const void* weight,
                                const void* sal, const void* vec,
                                const void* lam, void* scatter, void* asum,
                                int N, int D, int K, int T, int ctas,
                                long long span, int bins_per_weight,
                                float eps, void* stream) {
  const bool bingham = aff0 == nullptr && vec != nullptr;
  const size_t bytes = mm_smem_bytes(D, K, bingham);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                          \
  int(bingham ? launch<DV, true>(ctas, bytes, s, y, aff0, mode, kappa,   \
                                 logz, weight, sal, vec, lam, scatter,   \
                                 asum, N, K, T, span, bins_per_weight,   \
                                 eps)                                    \
              : launch<DV, false>(ctas, bytes, s, y, aff0, mode, kappa,  \
                                  logz, weight, sal, vec, lam, scatter,  \
                                  asum, N, K, T, span, bins_per_weight,  \
                                  eps))
  STREAM_DISPATCH(D, CALL)
#undef CALL
}
