// cACGMM EM with FREQUENCY-CONSTANT mixture weights: one launch per EM
// iteration.
//
// Replaces pb_bss_tpu/ops/pallas_em_step.py:cacgmm_em_fc, whose two
// Pallas TPU kernels are _m_init_kernel (the first M-step) and
// _em_step_kernel (one EM iteration). With weight_constant_axis=(-3, -1)
// every M-step reduces the affiliation sums over all bins of an
// utterance, and the CTAs of one launch cannot share that reduction. So
// the fit is split at the one global reduction, as the TPU kernels split
// it: each launch writes the per-(bin, class) affiliation sums, and the
// wrapper reduces them over the bins of each utterance into the (B, K)
// weight that the next launch reads (pb_bss_tpu_torch/ops/em_step.py).
//
//   grid: one CTA per (utterance, bin) n = b * F + f; the bin's y
//   (D x T complex) sits in shared memory for the launch.
//
//   em_fc_init_kernel (the first M-step): a = aff0 * saliency,
//     w = a / max(qf0, 10 tiny), asum_k = sum_t a, the K D(D+1)/2
//     Hermitian scatter sums (a warp per sum, lanes over T),
//     S_k = D sum / max(asum_k, tiny), the cold Jacobi at `sweeps`
//     (a warp per class, jacobi.cuh), eigenvalue max-normalization and
//     floor. Writes V, eig (unsorted) and asum.
//   em_fc_step_kernel (one EM iteration): the scaled eigenbases
//     W = V diag(l^{-1/2}) and log-determinants from the previous state,
//     the E-step (a thread per frame: the quadratic form as the
//     projection sum_i |(W^H y)_i|^2, log-pdf, max-shift
//     softmax with the utterance's weight, source-activity mask, clip to
//     [eps, 1 - eps]); the posterior is written out when the inline
//     aligner needs it (clipped, before saliency, as the scan path's
//     model._predict returns it); then saliency, the scatter as above,
//     and the Jacobi warm-started from the previous eigenbasis
//     (warp_warm_rotate + `warm_sweeps` sweeps), floor. Writes V, eig,
//     asum.
//
// The guard ladder: the covariance is D sum / max(asum, tiny), a
// division (m_stats, em_common.cuh), so a class silenced in a real bin
// stays finite at D >= 5. There is no padding (exact loop bounds, one CTA
// per real bin), so no padded lane feeds the weight reduction.
//
// What bounds it on the H100: y is read from device memory once per
// launch (59 MB at B=8, F=513, D=6, T=300, ~18 us at 3.35 TB/s) and the
// work is ~1 GFLOP per launch at that shape, so by the card's peaks a
// step is bound by the bytes; the design reads y once, coalesced, and
// keeps the posterior, the weights w and the Jacobi state in shared
// memory. The measured time is in PERF.md.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2;
// aff0/qf0/mask/aff_out (N, K, T) float; sal (N, T); weight (B, K) for
// N = B * F bins; V (N, K, D, D) complex64, eigenvectors in columns;
// eig (N, K, D); asum (N, K).
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace {

constexpr int kThreads = 256;

// The step kernel's shared memory, the larger of the two: y, the (K, T)
// posterior and weights, and per class the eigenvectors, the scatter and
// the scaled eigenbasis (which is the warm rotation's scratch once the
// E-step is done), eigenvalues, sums, log-determinants and weights.
inline size_t step_smem_bytes(int D, int K, int T) {
  return sizeof(float2) * (size_t(D) * T + 3 * size_t(K) * D * D) +
         sizeof(float) * (2 * size_t(K) * T + size_t(K) * D + 3 * K);
}

__device__ void load_y(const float2* __restrict__ y, float2* ys, size_t n,
                       int D, int T) {
  const size_t DT = size_t(D) * T;
  for (size_t i = threadIdx.x; i < DT; i += blockDim.x) ys[i] = y[n * DT + i];
}

__device__ void store_state(const float2* V, const float* eig,
                            float2* __restrict__ v_out,
                            float* __restrict__ eig_out, size_t n, int D,
                            int K) {
  const int DD = D * D;
  for (int i = threadIdx.x; i < K * DD; i += blockDim.x)
    v_out[n * K * DD + i] = V[i];
  for (int i = threadIdx.x; i < K * D; i += blockDim.x)
    eig_out[n * K * D + i] = eig[i];
}

__global__ void __launch_bounds__(kThreads)
em_fc_init_kernel(const float2* __restrict__ y,
                  const float* __restrict__ aff0,
                  const float* __restrict__ qf0,
                  const float* __restrict__ sal,
                  float2* __restrict__ v_out, float* __restrict__ eig_out,
                  float* __restrict__ asum_out, int D, int K, int T,
                  int sweeps, float eigenvalue_floor) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * T
  float2* S = ys + size_t(D) * T;                    // K * DD
  float2* V = S + K * DD;                            // K * DD
  float* aff = reinterpret_cast<float*>(V + K * DD);  // K * T
  float* wq = aff + size_t(K) * T;                    // K * T
  float* eig = wq + size_t(K) * T;                    // K * D
  float* asum = eig + K * D;                          // K

  const size_t n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t KT = size_t(K) * T;

  load_y(y, ys, n, D, T);
  for (size_t i = threadIdx.x; i < KT; i += blockDim.x) {
    const int t = int(i % T);
    const float a = aff0[n * KT + i] * (sal != nullptr ? sal[n * T + t] : 1.f);
    aff[i] = a;
    wq[i] = a / fmaxf(qf0[n * KT + i], 10.f * FLT_MIN);
  }
  __syncthreads();

  m_stats(ys, aff, wq, S, asum, asum_out + n * K, D, K, T, float(D));

  for (int k = warp; k < K; k += nwarps) {
    warp_set_identity(V + k * DD, D);
    warp_jacobi(S + k * DD, V + k * DD, D, sweeps);
    warp_floor_eigenvalues(S + k * DD, eig + k * D, D, eigenvalue_floor);
  }
  __syncthreads();
  store_state(V, eig, v_out, eig_out, n, D, K);
}

__global__ void __launch_bounds__(kThreads)
em_fc_step_kernel(const float2* __restrict__ y,
                  const float2* __restrict__ v_in,
                  const float* __restrict__ eig_in,
                  const float* __restrict__ weight,
                  const float* __restrict__ sal,
                  const float* __restrict__ mask,
                  float2* __restrict__ v_out, float* __restrict__ eig_out,
                  float* __restrict__ asum_out,
                  float* __restrict__ aff_out, int F, int D, int K, int T,
                  int warm_sweeps, float eigenvalue_floor,
                  float affiliation_eps) {
  extern __shared__ float4 smem_raw[];
  const int DD = D * D;
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D * T
  float2* S = ys + size_t(D) * T;                    // K * DD scatter
  float2* V = S + K * DD;                            // K * DD eigvecs
  float2* Wh = V + K * DD;  // K * DD scaled eigenbasis, then scratch
  float* aff = reinterpret_cast<float*>(Wh + K * DD);  // K * T
  float* wq = aff + size_t(K) * T;   // K * T quadratic form, then weights
  float* eig = wq + size_t(K) * T;   // K * D
  float* asum = eig + K * D;         // K
  float* logdet = asum + K;          // K
  float* wgt = logdet + K;           // K

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const size_t KT = size_t(K) * T;

  load_y(y, ys, n, D, T);
  for (int i = tid; i < K * DD; i += blockDim.x) V[i] = v_in[n * K * DD + i];
  __syncthreads();
  for (int k = warp; k < K; k += nwarps) {
    const float* lk = eig_in + (n * K + k) * D;
    warp_scaled_basis(V + k * DD, [&](int i) { return 1.f / sqrtf(lk[i]); },
                      Wh + k * DD, D);
    if (lane == 0) {
      float ld = 0.f;
      for (int i = 0; i < D; ++i) ld += logf(lk[i]);
      logdet[k] = ld;
      wgt[k] = weight[(n / F) * K + k];  // the utterance's weight
    }
  }
  __syncthreads();

  // ---- E-step: aff <- posterior, wq <- quadratic form; then saliency
  // and w = a / max(q, 10 tiny) ----------------------------------------
  for (int t = tid; t < T; t += blockDim.x) {
    e_step_frame(
        [&](int k) {
          return projection_form([&](int d) { return ys[d * T + t]; },
                                 Wh + k * DD, D);
        },
        logdet, wgt, mask == nullptr ? nullptr : mask + n * KT + t, T,
        affiliation_eps, aff + t, wq + t, T, D, K);
    const float s = (sal != nullptr) ? sal[n * T + t] : 1.f;
    for (int k = 0; k < K; ++k) {
      const float a = aff[k * T + t];
      if (aff_out != nullptr) aff_out[n * KT + size_t(k) * T + t] = a;
      aff[k * T + t] = a * s;
      wq[k * T + t] = a * s / fmaxf(wq[k * T + t], 10.f * FLT_MIN);
    }
  }
  __syncthreads();

  m_stats(ys, aff, wq, S, asum, asum_out + n * K, D, K, T, float(D));

  // ---- Jacobi warm-started from the previous eigenbasis -------------
  for (int k = warp; k < K; k += nwarps) {
    warp_warm_rotate(S + k * DD, V + k * DD, Wh + k * DD, D);
    warp_jacobi(S + k * DD, V + k * DD, D, warm_sweeps);
    warp_floor_eigenvalues(S + k * DD, eig + k * D, D, eigenvalue_floor);
  }
  __syncthreads();
  store_state(V, eig, v_out, eig_out, n, D, K);
}

}  // namespace

// Launch the first M-step on `stream` for N bins. sal may be null.
// Returns a cudaError_t (0 on success); neither synchronizes nor
// allocates.
extern "C" int em_fc_init_launch(const void* y, const void* aff0,
                                 const void* qf0, const void* sal, void* v,
                                 void* eig, void* asum, int N, int D, int K,
                                 int T, int sweeps, float eigenvalue_floor,
                                 void* stream) {
  const size_t bytes = step_smem_bytes(D, K, T);
  cudaError_t err = cudaFuncSetAttribute(
      em_fc_init_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  em_fc_init_kernel<<<N, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<const float*>(aff0),
      static_cast<const float*>(qf0), static_cast<const float*>(sal),
      static_cast<float2*>(v), static_cast<float*>(eig),
      static_cast<float*>(asum), D, K, T, sweeps, eigenvalue_floor);
  return int(cudaGetLastError());
}

// Launch one EM iteration on `stream` for N = B * F bins. sal, mask and
// aff_out may be null (aff_out non-null: write the posterior). Returns a
// cudaError_t (0 on success); neither synchronizes nor allocates.
extern "C" int em_fc_step_launch(const void* y, const void* v_in,
                                 const void* eig_in, const void* weight,
                                 const void* sal, const void* mask,
                                 void* v_out, void* eig_out, void* asum,
                                 void* aff_out, int N, int F, int D, int K,
                                 int T, int warm_sweeps,
                                 float eigenvalue_floor,
                                 float affiliation_eps, void* stream) {
  const size_t bytes = step_smem_bytes(D, K, T);
  cudaError_t err = cudaFuncSetAttribute(
      em_fc_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  em_fc_step_kernel<<<N, kThreads, bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(y), static_cast<const float2*>(v_in),
      static_cast<const float*>(eig_in), static_cast<const float*>(weight),
      static_cast<const float*>(sal), static_cast<const float*>(mask),
      static_cast<float2*>(v_out), static_cast<float*>(eig_out),
      static_cast<float*>(asum), static_cast<float*>(aff_out), F, D, K, T,
      warm_sweeps, eigenvalue_floor, affiliation_eps);
  return int(cudaGetLastError());
}
