// Whole-fit complex Watson mixture EM: every EM iteration of a fit in ONE
// launch (K6).
//
// Replaces pb_bss_tpu/ops/pallas_cwmm_loop.py:cwmm_em_full (the Pallas
// TPU kernel). Frequency bins are independent, so one CTA owns one
// (utterance, bin) and runs all iterations for it, with y, the posterior
// and the model of the bin in shared memory. The iteration body is the
// whole-fit cACGMM kernel's (em_iter.cuh), templated on D so that every
// loop over the channels unrolls. Per iteration:
//
//   M-step  a = posterior * saliency; lanes over the upper-triangle
//           entries of y y^H (and one more lane for the affiliation sum),
//           warps over frames, a group of classes summed in registers,
//           then one cross-warp reduction in a fixed order (scatter_sums;
//           Watson weighs the scatter by a, it has no 1 / q), the scatter
//           sum / max(asum, tiny) (covariance_from_sums: a division, never
//           a multiply by 1 / max(asum, tiny)), the mixture weight (the
//           mean over T, or with saliency the sums L1-normalized over
//           classes).
//   eigh    the column Jacobi in registers (column_eigh: a lane owns one
//           column of A and of V of one class, floor(32 / D) classes to a
//           warp) in the plain twin's cyclic order, its rotations in
//           2 D - 3 steps of disjoint ones (the wavefront): cold from the
//           identity at `sweeps` in iteration 0, then warm from the
//           previous eigenbasis (A = V^H S V) at `warm_sweeps`. Two sweeps
//           from a matrix that the new statistics moved need not converge,
//           and the order decides what they leave off the diagonal, so the
//           kernel keeps the twin's (the parallel round-robin order of the
//           cACGMM kernel parts from it by up to 1.6e-3 in a posterior
//           after a warm step).
//   Watson  the dominant eigenpair from the column lanes (ties to the
//           highest index, as a stable ascending sort's last), its
//           column of V the mode,
//           the concentration from the uniform ratio table (one pair of
//           loads) and the switched log-norm (watson.cuh).
//   E-step  a thread per frame, the frame in registers:
//           kappa |<y, m>|^2 - log Z, max-shift softmax with the weight,
//           max(den, tiny); then the saliency for the next M-step. The
//           last one is CWMM.predict (no clipping), written straight to
//           device memory, so the fit returns its posterior with no extra
//           pass.
//
// What bounds it on the H100: y is read from device memory once per fit,
// so the kernel is bound by its instructions: the scatter's pair products,
// the E-step's D complex multiply-adds per class and frame, and the
// Jacobi's latency chain. So it sums in registers with one reduction an
// iteration (not a warp reduction per sum), runs a bin's K Jacobis on one
// warp in registers (not a class a warp, serially in shared memory) with
// the cyclic order's disjoint rotations at once, and unrolls over D. The
// CTA's warps are the host's choice (ops/cwmm_loop._threads, as the
// cACGMM kernel picks them), from the bin's shared memory. (A bin of a
// minute's frames is alone on its SM; 30 warps for it took 4% more time
// than the rule's 8 on an H100.)
//
// Shared memory: y (D x Tp complex, Tp = T rounded up to odd so that the
// channels of a frame fall in distinct banks), the scatter and the
// eigenvectors (K x D x D complex each), the upper-triangle sums
// (K x D (D + 1) / 2 complex), the modes (K x D complex), the posterior
// times saliency (K x T), the saliency (T, with saliency) and four
// per-class scalars: ops/cwmm_loop.smem_bytes, the gate's formula.
//
// There is no padding: loops run over the real T and the grid has
// exactly one CTA per bin, so no padded frame reaches a sum.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; aff0/aff
// (N, K, T) float; sal (N, T); table (G) float; weight/kappa (N, K);
// mode (N, K, D) complex64; vec (N, K, D, D) complex64, eigenvectors in
// columns.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_iter.cuh"
#include "watson.cuh"

namespace {

constexpr int kMaxThreads = 256;

__host__ __device__ constexpr int row_stride(int D, int T) {
  return D == 1 ? T : (T | 1);
}

inline size_t cwmm_smem_bytes(int D, int K, int T, bool has_sal) {
  const size_t DD = size_t(D) * D;
  const size_t P = size_t(D) * (D + 1) / 2;
  return sizeof(float2) * (size_t(D) * row_stride(D, T) + 2 * K * DD +
                           K * P + size_t(K) * D) +
         sizeof(float) * (size_t(K) * T + (has_sal ? size_t(T) : 0) + 4 * K);
}

// Registers: up to 64 a thread for D <= 6, as the whole-fit cACGMM kernel.
template <int D>
__global__ void __launch_bounds__(kMaxThreads, D <= 6 ? 4 : (D <= 10 ? 3 : 2))
cwmm_em_full_kernel(const float2* __restrict__ y,
                    const float* __restrict__ aff0,
                    const float* __restrict__ sal_in,
                    const float* __restrict__ table,
                    float* __restrict__ weight_out,
                    float2* __restrict__ mode_out,
                    float* __restrict__ kappa_out,
                    float* __restrict__ aff_out,
                    float2* __restrict__ vec_out, int K, int T,
                    int iterations, int sweeps, int warm_sweeps, float r0,
                    float dr, int table_size, float log2pi_d,
                    float lgamma_d) {
  constexpr int DD = D * D;
  constexpr int P = D * (D + 1) / 2;
  extern __shared__ float4 smem_raw[];
  const int Tp = row_stride(D, T);
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * Tp
  float2* S = ys + size_t(D) * Tp;                   // K * DD scatter
  float2* V = S + K * DD;                            // K * DD eigvecs
  float2* Su = V + K * DD;                           // K * P sums
  float2* mode = Su + K * P;                         // K * D
  float* aw = reinterpret_cast<float*>(mode + K * D);  // K * T a * saliency
  float* sal = aw + size_t(K) * T;  // T, with saliency
  float* wsum = sal + (sal_in != nullptr ? T : 0);  // K
  float* wgt = wsum + K;                            // K
  float* kappa = wgt + K;                           // K
  float* logz = kappa + K;                          // K

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const size_t KT = size_t(K) * T;
  const bool has_sal = sal_in != nullptr;

  for (int d = 0; d < D; ++d)
    for (int t = tid; t < T; t += nthreads)
      ys[d * Tp + t] = y[(n * D + d) * T + t];
  if (has_sal)
    for (int t = tid; t < T; t += nthreads) sal[t] = sal_in[n * T + t];
  for (size_t i = tid; i < KT; i += nthreads)
    aw[i] = aff0[n * KT + i] * (has_sal ? sal_in[n * T + i % T] : 1.f);
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const bool warm = it > 0 && warm_sweeps >= 0;

    // ---- M-step sums, scatter sum / max(asum, tiny), weight ----------
    scatter_sums<D>(ys, Tp, aw, aw, Su, wsum, K, T);
    covariance_from_sums<D>(Su, wsum, S, K, 1.f);
    for (int k = tid; k < K; k += nthreads)
      wgt[k] = mixture_weight(wsum, k, K, has_sal, float(T));
    __syncthreads();

    // ---- eigh: the column Jacobi; the dominant eigenpair, kappa, log Z
    column_eigh<D, JacobiOrder::kWavefront>(
        S, V, K, warm, warm ? warm_sweeps : sweeps,
        [&](int k, int jc, float lam, const float2 (&v)[D], int jbase,
            bool jown) {
          // the largest eigenvalue of the class, ties to the highest
          // column
          int best = 0;
          float top = __shfl_sync(kFullMask, lam, jbase);
#pragma unroll
          for (int m = 1; m < D; ++m) {
            const float l = __shfl_sync(kFullMask, lam, jbase + m);
            if (l >= top) {
              top = l;
              best = m;
            }
          }
          if (jown) {
#pragma unroll
            for (int i = 0; i < D; ++i) V[k * DD + i * D + jc] = v[i];
            if (jc == best) {
#pragma unroll
              for (int i = 0; i < D; ++i) mode[k * D + i] = v[i];
              const float kap =
                  table_concentration(lam, r0, dr, table, table_size);
              kappa[k] = kap;
              logz[k] = watson_log_norm(kap, D, log2pi_d, lgamma_d);
            }
          }
        });
    __syncthreads();

    // ---- E-step: a thread per frame; the last one is written out -----
    const bool last = it == iterations - 1;
    float* out = aff_out + n * KT;
    for (int t = tid; t < T; t += nthreads) {
      float2 yf[D];
#pragma unroll
      for (int d = 0; d < D; ++d) yf[d] = ys[d * Tp + t];
      watson_e_step_frame([&](int d) { return yf[d]; }, mode, kappa, logz,
                          wgt, aw + t, T, D, K);
      if (last) {
        for (int k = 0; k < K; ++k) out[k * T + t] = aw[k * T + t];
      } else if (has_sal) {
        const float s = sal[t];
        for (int k = 0; k < K; ++k) aw[k * T + t] *= s;
      }
    }
    __syncthreads();
  }

  for (int k = tid; k < K; k += nthreads) {
    weight_out[n * K + k] = wgt[k];
    kappa_out[n * K + k] = kappa[k];
  }
  for (int i = tid; i < K * D; i += nthreads)
    mode_out[n * K * D + i] = mode[i];
  if (vec_out != nullptr)
    for (int i = tid; i < K * DD; i += nthreads)
      vec_out[n * K * DD + i] = V[i];
}

template <int D>
cudaError_t launch(int N, int threads, size_t bytes, cudaStream_t stream,
                   const void* y, const void* aff0, const void* sal,
                   const void* table, void* weight, void* mode, void* kappa,
                   void* aff, void* vec, int K, int T, int iterations,
                   int sweeps,
                   int warm_sweeps, float r0, float dr, int table_size,
                   float log2pi_d, float lgamma_d) {
  cudaError_t err = cudaFuncSetAttribute(
      cwmm_em_full_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return err;
  cwmm_em_full_kernel<D><<<N, threads, bytes, stream>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(sal), static_cast<const float*>(table),
      static_cast<float*>(weight), static_cast<float2*>(mode),
      static_cast<float*>(kappa), static_cast<float*>(aff),
      static_cast<float2*>(vec), K, T,
      iterations, sweeps, warm_sweeps, r0, dr, table_size, log2pi_d,
      lgamma_d);
  return cudaGetLastError();
}

}  // namespace

// Launch the whole-fit Watson EM on `stream` for N independent bins,
// `threads` threads (a multiple of 32, at most 256) per bin. sal and vec
// (the last eigenvectors) may be null. Returns a cudaError_t (0 on
// success); neither synchronizes nor allocates.
extern "C" int cwmm_em_full_launch(
    const void* y, const void* aff0, const void* sal, const void* table,
    void* weight, void* mode, void* kappa, void* aff, void* vec, int N,
    int D, int K, int T, int threads, int iterations, int sweeps,
    int warm_sweeps, float r0, float dr, int table_size, float log2pi_d,
    float lgamma_d, void* stream) {
  if (threads % 32 != 0 || threads < 32 || threads > kMaxThreads)
    return int(cudaErrorInvalidValue);
  const size_t bytes = cwmm_smem_bytes(D, K, T, sal != nullptr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(DV)                                                             \
  int(launch<DV>(N, threads, bytes, s, y, aff0, sal, table, weight, mode,    \
                 kappa, aff, vec, K, T, iterations, sweeps, warm_sweeps, r0, \
                 dr, table_size, log2pi_d, lgamma_d))
  switch (D) {
    case 1: return CALL(1); case 2: return CALL(2);
    case 3: return CALL(3); case 4: return CALL(4);
    case 5: return CALL(5); case 6: return CALL(6);
    case 7: return CALL(7); case 8: return CALL(8);
    case 9: return CALL(9); case 10: return CALL(10);
    case 11: return CALL(11); case 12: return CALL(12);
    case 13: return CALL(13); case 14: return CALL(14);
    case 15: return CALL(15); case 16: return CALL(16);
    default: return int(cudaErrorInvalidValue);
  }
#undef CALL
}
