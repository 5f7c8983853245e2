// Whole-fit complex Watson mixture EM: every EM iteration of a fit in ONE
// launch.
//
// Replaces pb_bss_tpu/ops/pallas_cwmm_loop.py:cwmm_em_full (the Pallas
// TPU kernel). Frequency bins are independent, so one CTA owns one
// (utterance, bin) and runs all iterations for it, as the whole-fit
// cACGMM kernel (em_loop.cu) does:
//
//   load y (D x T complex), the initial affiliations and the optional
//   saliency into shared memory once; then per iteration
//     M-step  a = aff * saliency, the weight sums and the K D(D+1)/2
//             Hermitian scatter sums sum_t a y y^H / max(asum, tiny)
//             (m_stats, em_common.cuh: a warp per sum, lanes over T),
//             the mixture weight (the mean over T, or with saliency the
//             sums L1-normalized over classes),
//     eigh    the K D x D Jacobis (a warp per class, jacobi.cuh): cold at
//             `sweeps` in iteration 0, then warm-started from the
//             previous eigenbasis at `warm_sweeps`,
//     Watson  the dominant eigenpair (ties to the highest index), the
//             concentration from the uniform ratio table (one pair of
//             loads), the switched log-norm (watson.cuh),
//     E-step  threads over T: kappa |<y, m>|^2 - log Z, max-shift softmax
//             with the weight, max(den, tiny). The last one is
//             CWMM.predict (no clipping), so the fit returns its
//             posterior with no extra pass.
//
// What bounds it on the H100: y is read from device memory once per
// fit, so the kernel is bound by the fp32 FMAs of the scatter and the
// E-step and the exp of the softmax, not by bytes. A bin's working set
// lives in shared memory: 8 (D T + 3 K D^2 + K D) + 4 (K T + 4 K), plus
// 4 T with saliency, which must fit the 227 KB a block may opt into
// (T <= 3827 at D=6, K=3: no quadratic form, so above the cACGMM
// kernel's 3178); the Python wrapper gates on the same formula.
//
// There is no padding: loops run over the real T and the grid has
// exactly one CTA per bin, so no padded frame reaches a sum.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; aff0/aff
// (N, K, T) float; sal (N, T); table (G) float; weight/kappa (N, K);
// mode (N, K, D) complex64.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"
#include "watson.cuh"

namespace {

constexpr int kThreads = 256;

inline size_t cwmm_smem_bytes(int D, int K, int T, bool has_sal) {
  return sizeof(float2) *
             (size_t(D) * T + 3 * size_t(K) * D * D + size_t(K) * D) +
         sizeof(float) * (size_t(K) * T + (has_sal ? size_t(T) : 0) + 4 * K);
}

__global__ void __launch_bounds__(kThreads)
cwmm_em_full_kernel(const float2* __restrict__ y,
                    const float* __restrict__ aff0,
                    const float* __restrict__ sal_in,
                    const float* __restrict__ table,
                    float* __restrict__ weight_out,
                    float2* __restrict__ mode_out,
                    float* __restrict__ kappa_out,
                    float* __restrict__ aff_out, int D, int K, int T,
                    int iterations, int sweeps, int warm_sweeps, float r0,
                    float dr, int table_size, float log2pi_d,
                    float lgamma_d) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D*T
  float2* S = ys + size_t(D) * T;                    // K*D*D scatter/eig
  float2* V = S + K * DD;                            // K*D*D eigvecs
  float2* C = V + K * DD;                            // K*D*D scratch
  float2* mode = C + K * DD;                         // K*D
  float* aff = reinterpret_cast<float*>(mode + K * D);  // K*T
  float* sal = aff + size_t(K) * T;  // T, with saliency
  float* wsum = sal + (sal_in != nullptr ? T : 0);  // K
  float* wgt = wsum + K;             // K
  float* kappa = wgt + K;            // K
  float* logz = kappa + K;           // K

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const size_t DT = size_t(D) * T;
  const size_t KT = size_t(K) * T;
  const bool has_sal = sal_in != nullptr;

  for (size_t i = tid; i < DT; i += blockDim.x) ys[i] = y[n * DT + i];
  for (size_t i = tid; i < KT; i += blockDim.x) aff[i] = aff0[n * KT + i];
  if (has_sal)
    for (int t = tid; t < T; t += blockDim.x) sal[t] = sal_in[n * T + t];
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const bool warm = it > 0 && warm_sweeps >= 0;

    // ---- M-step: a <- aff * saliency, the sums and the scatter -------
    if (has_sal) {
      for (size_t i = tid; i < KT; i += blockDim.x) aff[i] *= sal[i % T];
      __syncthreads();
    }
    m_stats(ys, aff, aff, S, wsum, nullptr, D, K, T, 1.f);

    // ---- weight, eigendecomposition, dominant eigenpair, kappa, log Z
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
      const int best = dominant_index(Sk, D);
      if (lane < D) mode[k * D + lane] = Vk[lane * D + best];
      if (lane == 0) {
        const float kap = table_concentration(Sk[best * D + best].x, r0, dr,
                                              table, table_size);
        kappa[k] = kap;
        logz[k] = watson_log_norm(kap, D, log2pi_d, lgamma_d);
      }
      __syncwarp();
    }
    __syncthreads();

    // ---- E-step ------------------------------------------------------
    for (int t = tid; t < T; t += blockDim.x)
      watson_e_step_frame([&](int d) { return ys[d * T + t]; }, mode, kappa,
                          logz, wgt, aff + t, T, D, K);
    __syncthreads();
  }

  for (int k = tid; k < K; k += blockDim.x) {
    weight_out[n * K + k] = wgt[k];
    kappa_out[n * K + k] = kappa[k];
  }
  for (int i = tid; i < K * D; i += blockDim.x)
    mode_out[n * K * D + i] = mode[i];
  for (size_t i = tid; i < KT; i += blockDim.x) aff_out[n * KT + i] = aff[i];
}

}  // namespace

// Launch the whole-fit Watson EM on `stream` for N independent bins. sal
// may be null. Returns a cudaError_t (0 on success); neither
// synchronizes nor allocates.
extern "C" int cwmm_em_full_launch(
    const void* y, const void* aff0, const void* sal, const void* table,
    void* weight, void* mode, void* kappa, void* aff, int N, int D, int K,
    int T, int iterations, int sweeps, int warm_sweeps, float r0, float dr,
    int table_size, float log2pi_d, float lgamma_d, void* stream) {
  const size_t bytes = cwmm_smem_bytes(D, K, T, sal != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      cwmm_em_full_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  cwmm_em_full_kernel<<<N, kThreads, bytes,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(sal), static_cast<const float*>(table),
      static_cast<float*>(weight), static_cast<float2*>(mode),
      static_cast<float*>(kappa), static_cast<float*>(aff), D, K, T,
      iterations, sweeps, warm_sweeps, r0, dr, table_size, log2pi_d,
      lgamma_d);
  return int(cudaGetLastError());
}
