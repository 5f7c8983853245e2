// Whole-fit cACGMM EM: every EM iteration of a fit in ONE launch.
//
// Replaces pb_bss_tpu/ops/pallas_em_loop.py:cacgmm_em_full (the Pallas
// TPU kernel). Frequency bins are independent, so one CTA owns one
// (utterance, bin) and runs all iterations for it:
//
//   load y (D x T complex), the initial affiliations and quadratic
//   forms, and the optional saliency and source-activity mask into
//   shared memory once; then per iteration
//     M-step  a = aff * saliency, w = a / max(q, 10 tiny), the weight
//             sums and the K D(D+1)/2 Hermitian scatter sums over T
//             (m_stats, em_common.cuh: a warp per sum, lanes over T,
//             shuffle reduction, D sum / max(asum, tiny)), the mixture
//             weight (the mean over T, or with saliency the sums
//             L1-normalized over classes),
//     eigh    the K D x D Jacobis (a warp per class, jacobi.cuh): cold
//             at `sweeps` in iteration 0, then warm-started from the
//             previous eigenbasis at `warm_sweeps`,
//             eigenvalue max-normalization and floor, log-determinant,
//             inverse covariance V diag(1/l) V^H,
//     E-step  threads over T: quadratic form through the inverse
//             covariance, log-pdf, max-shift softmax with the mixture
//             weight, the source-activity mask on the numerators,
//             affiliation_eps clipping (none in the final iteration, so
//             the result equals predict()).
//
// What bounds it on the H100: y is read from device memory once per
// fit, so the kernel is bound by fp32 FMAs and the log/exp of the
// E-step, not by bytes. The whole working set of a bin lives in shared
// memory: 8 (D T + 4 K D^2) + 4 (2 K T + K D + 3 K), plus 4 T with
// saliency and 4 K T with the mask, which must fit the 227 KB a block
// may opt into (T <= 3178 at D=6, K=3; 2600 with both extras); the
// Python wrapper gates on the same formula.
//
// There is no padding: loops run over the real T and the grid has
// exactly one CTA per bin, so no padded lane can feed 0 * inf into a
// reduction.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2;
// aff0/qf0/aff/mask (N, K, T) float; sal (N, T); weight (N, K); eig
// (N, K, D) unsorted; V (N, K, D, D) complex64, eigenvectors in columns.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kThreads = 256;

inline size_t em_smem_bytes(int D, int K, int T, bool has_sal,
                            bool has_mask) {
  return sizeof(float2) * (size_t(D) * T + 4 * size_t(K) * D * D) +
         sizeof(float) * (2 * size_t(K) * T + size_t(K) * D + 3 * K +
                          (has_sal ? size_t(T) : 0) +
                          (has_mask ? size_t(K) * T : 0));
}

__global__ void __launch_bounds__(kThreads)
cacgmm_em_full_kernel(const float2* __restrict__ y,
                      const float* __restrict__ aff0,
                      const float* __restrict__ qf0,
                      const float* __restrict__ sal_in,
                      const float* __restrict__ mask_in,
                      float* __restrict__ weight_out,
                      float* __restrict__ eig_out,
                      float2* __restrict__ v_out,
                      float* __restrict__ aff_out,
                      int D, int K, int T, int iterations, int sweeps,
                      int warm_sweeps, float eigenvalue_floor,
                      float affiliation_eps) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D*T
  float2* S = ys + size_t(D) * T;                    // K*D*D scatter/eig
  float2* V = S + K * DD;                            // K*D*D eigvecs
  float2* C = V + K * DD;                            // K*D*D scratch
  float2* Ci = C + K * DD;                           // K*D*D inverse cov
  float* aff = reinterpret_cast<float*>(Ci + K * DD);  // K*T
  float* qw = aff + size_t(K) * T;   // K*T quadratic form, then weights
  float* eig = qw + size_t(K) * T;   // K*D
  float* wsum = eig + K * D;         // K
  float* wgt = wsum + K;             // K
  float* logdet = wgt + K;           // K
  float* sal = logdet + K;           // T, with saliency
  float* mask = sal + (sal_in != nullptr ? T : 0);  // K*T, with the mask

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const size_t DT = size_t(D) * T;
  const size_t KT = size_t(K) * T;
  const float tiny = FLT_MIN;
  const bool has_sal = sal_in != nullptr;

  for (size_t i = tid; i < DT; i += blockDim.x) ys[i] = y[n * DT + i];
  for (size_t i = tid; i < KT; i += blockDim.x) {
    aff[i] = aff0[n * KT + i];
    qw[i] = qf0[n * KT + i];
    if (mask_in != nullptr) mask[i] = mask_in[n * KT + i];
  }
  if (has_sal)
    for (int t = tid; t < T; t += blockDim.x) sal[t] = sal_in[n * T + t];
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const bool warm = it > 0 && warm_sweeps >= 0;

    // ---- M-step: a <- aff * saliency, qw <- a / max(q, 10 tiny), then
    // the weight sums and the scatter S_k = D sum_t qw y y^H / max(wsum,
    // tiny) ---------------------------------------------------------------
    for (size_t i = tid; i < KT; i += blockDim.x) {
      const float a = has_sal ? aff[i] * sal[i % T] : aff[i];
      aff[i] = a;
      qw[i] = a / fmaxf(qw[i], 10.f * tiny);
    }
    __syncthreads();
    m_stats(ys, aff, qw, S, wsum, nullptr, D, K, T, float(D));

    // ---- mixture weight, eigendecomposition, normalization, inverse
    // covariance ----------------------------------------------------------
    for (int k = warp; k < K; k += nwarps) {
      float2* Sk = S + k * DD;
      float2* Vk = V + k * DD;
      if (lane == 0) wgt[k] = mixture_weight(wsum, k, K, has_sal, float(T));
      if (warm) {
        warp_warm_rotate(Sk, Vk, C + k * DD, D);
        warp_jacobi(Sk, Vk, D, warm_sweeps);
      } else {
        warp_set_identity(Vk, D);
        warp_jacobi(Sk, Vk, D, sweeps);
      }
      warp_floor_eigenvalues(Sk, eig + k * D, D, eigenvalue_floor);
      if (lane == 0) {
        float ld = 0.f;
        for (int i = 0; i < D; ++i) ld += logf(eig[k * D + i]);
        logdet[k] = ld;
      }
      const float* eigk = eig + k * D;
      warp_inverse_covariance(
          Vk, [&](int i) { return 1.f / eigk[i]; }, Ci + k * DD, D);
      __syncwarp();
    }
    __syncthreads();

    // ---- E-step ------------------------------------------------------
    const float eps = (it == iterations - 1) ? 0.f : affiliation_eps;
    for (int t = tid; t < T; t += blockDim.x)
      e_step_frame([&](int d) { return ys[d * T + t]; }, Ci, logdet, wgt,
                   mask_in != nullptr ? mask + t : nullptr, T, eps, aff + t,
                   qw + t, T, D, K);
    __syncthreads();
  }

  for (int k = tid; k < K; k += blockDim.x) weight_out[n * K + k] = wgt[k];
  for (int i = tid; i < K * D; i += blockDim.x)
    eig_out[n * K * D + i] = eig[i];
  for (int i = tid; i < K * DD; i += blockDim.x)
    v_out[n * K * DD + i] = V[i];
  for (size_t i = tid; i < KT; i += blockDim.x) aff_out[n * KT + i] = aff[i];
}

}  // namespace

// Launch the whole-fit EM on `stream` for N independent bins. sal and
// mask may be null. Returns a cudaError_t (0 on success); neither
// synchronizes nor allocates.
extern "C" int cacgmm_em_full_launch(
    const void* y, const void* aff0, const void* qf0, const void* sal,
    const void* mask, void* weight, void* eig, void* v, void* aff, int N,
    int D, int K, int T, int iterations, int sweeps, int warm_sweeps,
    float eigenvalue_floor, float affiliation_eps, void* stream) {
  const size_t bytes =
      em_smem_bytes(D, K, T, sal != nullptr, mask != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      cacgmm_em_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  cacgmm_em_full_kernel<<<N, kThreads, bytes,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(qf0), static_cast<const float*>(sal),
      static_cast<const float*>(mask), static_cast<float*>(weight),
      static_cast<float*>(eig), static_cast<float2*>(v),
      static_cast<float*>(aff), D, K, T, iterations, sweeps, warm_sweeps,
      eigenvalue_floor, affiliation_eps);
  return int(cudaGetLastError());
}
