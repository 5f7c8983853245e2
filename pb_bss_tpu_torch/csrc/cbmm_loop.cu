// Whole-fit complex Bingham mixture EM: every EM iteration of a fit in ONE
// launch.
//
// Replaces pb_bss_tpu/ops/pallas_cbmm_loop.py:cbmm_em_full (the Pallas TPU
// kernel, frequency bins in the lanes, the chord solver of
// pallas_bingham.py inlined). Frequency bins are independent, so one CTA
// owns one (utterance, bin) and runs all iterations for it, as the
// whole-fit Watson kernel (cwmm_loop.cu) does:
//
//   load y (D x T complex), the initial affiliations and the optional
//   saliency into shared memory once; then per iteration
//     M-step  a = aff * saliency, the weight sums and the K D(D+1)/2
//             Hermitian scatter sums sum_t a y y^H / max(asum, tiny)
//             (m_stats, em_common.cuh), the mixture weight (the mean over
//             T, or with saliency the sums L1-normalized over classes),
//     eigh    the K D x D Jacobis (a warp per class, jacobi.cuh): cold at
//             `sweeps` in iteration 0, then warm-started from the
//             previous eigenbasis at `warm_sweeps`,
//     sort    the moments max(eigenvalue, 0) ascending by a bubble
//             network that swaps the eigenvector columns with them, then
//             the minimum spacing spacing_eps,
//     solve   the moment inversion grad log c(lambda) = s by chord
//             Gauss-Newton (bingham.cuh, a group of 8 lanes per class):
//             iteration 0 from the -1/s start floored at -(cap_init - j)
//             with `cold_rounds` rounds of `cold_steps` steps, later
//             iterations one round of `warm_steps` from the previous
//             eigenvalues (kept in shared memory); then the floor at
//             -max_concentration and the spacing again when it is finite,
//     log c   one more cascade: log 2 + D log pi + log exp[lambda],
//     E-step  the forms B_k = V diag(lambda) V^H (a warp per class), then
//             threads over T: y^H B_k y - log c_k, max-shift softmax with
//             the weight, max(den, tiny), the clip to [eps, 1 - eps]
//             except in the last iteration, which is CBMM.predict.
//
// What bounds it on the H100: the cascades of the solve. One cascade is
// about 12 kFLOP at D=6 and a fit of 20 iterations runs 3 (1 + 5 + 10) + 1
// of them per class in the first iteration and 1 + 5 + 16 + 1 after it, so
// the fit is bound by fp32 operations, not by the y it reads once. The
// design keeps each cascade in the registers of 8 lanes and runs the K
// classes' solves at once in K groups of a two-warp CTA; the other warp
// waits during the solve (the serial part of each iteration; a faster
// version can spread the D - 1 finite-difference cascades of a class over more
// groups). A bin's working set lives in shared memory:
// 8 (D T + 3 K D^2) + 4 (K T + 19 K + K 384), plus 4 T with saliency,
// within the 227 KB a block may opt into; the Python wrapper gates on the
// same formula.
//
// There is no padding: loops run over the real T and the grid has
// exactly one CTA per bin.
//
// Layouts (all contiguous): y (N, D, T) complex64 as float2; aff0/aff
// (N, K, T) float; sal (N, T); weight/logz (N, K); lamb (N, K, D);
// vec (N, K, D, D) complex64, eigenvectors in columns.
#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "bingham.cuh"
#include "em_common.cuh"

namespace {

// Two warps a CTA: the solve runs on one of them (K <= 4 classes of 8
// lanes), so small CTAs let more bins' solves share an SM (128 registers
// a thread at D >= 6 and ~27 KB of shared memory at the slice shape leave
// 8 such CTAs an SM, against 2 CTAs of 256 threads).
constexpr int kThreads = 64;

inline size_t cbmm_smem_bytes(int D, int K, int T, bool has_sal) {
  return sizeof(float2) * (size_t(D) * T + 3 * size_t(K) * D * D) +
         sizeof(float) * (size_t(K) * T + (has_sal ? size_t(T) : 0) +
                          3 * size_t(K) + 2 * kRowStride * size_t(K) +
                          size_t(K) * kGroupFloats);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
cbmm_em_full_kernel(const float2* __restrict__ y,
                    const float* __restrict__ aff0,
                    const float* __restrict__ sal_in,
                    float* __restrict__ weight_out,
                    float* __restrict__ lamb_out,
                    float2* __restrict__ vec_out,
                    float* __restrict__ logz_out,
                    float* __restrict__ aff_out, int K, int T,
                    int iterations, int sweeps, int warm_sweeps,
                    int cold_rounds, int cold_steps, int warm_steps,
                    float spacing_eps, float lower, float upper,
                    float fd_step, float affiliation_eps, float cap_init,
                    float max_concentration, float log2pi_d) {
  extern __shared__ float4 smem_raw[];
  constexpr int DD = D * D;
  float2* ys = reinterpret_cast<float2*>(smem_raw);  // D*T
  float2* S = ys + size_t(D) * T;                    // K*D*D scatter/eig
  float2* V = S + K * DD;                            // K*D*D eigvecs
  float2* C = V + K * DD;                            // K*D*D scratch, B
  float* aff = reinterpret_cast<float*>(C + K * DD);  // K*T
  float* sal = aff + size_t(K) * T;                 // T, with saliency
  float* wsum = sal + (sal_in != nullptr ? T : 0);  // K
  float* wgt = wsum + K;                            // K
  float* logz = wgt + K;                            // K
  float* lamb = logz + K;                           // K*8 eigenvalues
  float* sreg = lamb + kRowStride * K;              // K*8 moments
  float* scratch = sreg + kRowStride * K;           // K*kGroupFloats

  const size_t n = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int group = tid / kGroup;
  const int ngroups = blockDim.x / kGroup;
  const bool leader = (tid & 7) == 0;
  const size_t DT = size_t(D) * T;
  const size_t KT = size_t(K) * T;
  const bool has_sal = sal_in != nullptr;

  for (size_t i = tid; i < DT; i += blockDim.x) ys[i] = y[n * DT + i];
  for (size_t i = tid; i < KT; i += blockDim.x) aff[i] = aff0[n * KT + i];
  if (has_sal)
    for (int t = tid; t < T; t += blockDim.x) sal[t] = sal_in[n * T + t];
  __syncthreads();

  for (int it = 0; it < iterations; ++it) {
    const bool warm = it > 0;

    // ---- M-step: a <- aff * saliency, the sums and the scatter -------
    if (has_sal) {
      for (size_t i = tid; i < KT; i += blockDim.x) aff[i] *= sal[i % T];
      __syncthreads();
    }
    m_stats(ys, aff, aff, S, wsum, nullptr, D, K, T, 1.f);

    // ---- weight, eigendecomposition, ascending sort, spacing ---------
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
      float sn[D];
#pragma unroll
      for (int j = 0; j < D; ++j) sn[j] = fmaxf(Sk[j * D + j].x, 0.f);
#pragma unroll
      for (int pass = 0; pass < D - 1; ++pass) {
#pragma unroll
        for (int j = 0; j < D - 1 - pass; ++j) {
          if (sn[j] > sn[j + 1]) {  // the same decision on every lane
            const float tmp = sn[j];
            sn[j] = sn[j + 1];
            sn[j + 1] = tmp;
            if (lane < D) {  // each lane swaps within its own row
              const float2 v = Vk[lane * D + j];
              Vk[lane * D + j] = Vk[lane * D + j + 1];
              Vk[lane * D + j + 1] = v;
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) {
        float acc = sn[0];
        sreg[k * kRowStride] = acc;
#pragma unroll
        for (int j = 1; j < D; ++j) {
          acc += fmaxf(sn[j] - sn[j - 1], spacing_eps);
          sreg[k * kRowStride + j] = acc;
        }
      }
    }
    __syncthreads();

    // ---- moment inversion and log c: a group of 8 lanes per class ----
    for (int k = group; k < K; k += ngroups) {
      float* sk = scratch + k * kGroupFloats;
      float s[D], u[D - 1], lam[D], g[D];
#pragma unroll
      for (int j = 0; j < D; ++j) s[j] = sreg[k * kRowStride + j];
      int rounds, steps;
      if (warm) {
#pragma unroll
        for (int j = 0; j < D; ++j) lam[j] = lamb[k * kRowStride + j];
        rounds = 1;
        steps = warm_steps;
      } else {
        // lambda ~ -1/s, the largest pinned to 0, floored into the
        // cascade's exact domain
#pragma unroll
        for (int j = 0; j < D; ++j) {
          const float x0 = (j < D - 1) ? -1.f / fmaxf(s[j], 1e-12f) : 0.f;
          lam[j] = fmaxf(x0, -(cap_init - float(j)));
        }
        rounds = cold_rounds;
        steps = cold_steps;
      }
#pragma unroll
      for (int j = 0; j < D - 1; ++j)
        u[j] = clip_diff(lam[j] - lam[j + 1], lower, upper);
      for (int r = 0; r < rounds; ++r)
        bingham_chord_round<D>(s, u, steps, lower, upper, fd_step, sk);
      lam_of_u<D>(u, lam);
      if (max_concentration > 0.f) {
        // the floor can collapse the lowest eigenvalues onto -mc: space
        // them again
        float prev = fmaxf(lam[0], -max_concentration);
        float acc = prev;
        lam[0] = acc;
#pragma unroll
        for (int j = 1; j < D; ++j) {
          const float node = fmaxf(lam[j], -max_concentration);
          acc += fmaxf(node - prev, spacing_eps);
          prev = node;
          lam[j] = acc;
        }
      }
      const float dd =
          bingham_cascade<D>(lam, g, sk + 2 * kRowStride * kRowStride);
      if (leader) {
#pragma unroll
        for (int j = 0; j < D; ++j) lamb[k * kRowStride + j] = lam[j];
        logz[k] = log2pi_d + logf(dd);
      }
    }
    __syncthreads();

    // ---- E-step ------------------------------------------------------
    for (int k = warp; k < K; k += nwarps)
      warp_bingham_form(V + k * DD, lamb + k * kRowStride, C + k * DD, D);
    __syncthreads();
    const float eps = (it == iterations - 1) ? 0.f : affiliation_eps;
    for (int t = tid; t < T; t += blockDim.x)
      bingham_e_step_frame([&](int d) { return ys[d * T + t]; }, C, logz,
                           wgt, eps, aff + t, T, D, K);
    __syncthreads();
  }

  for (int k = tid; k < K; k += blockDim.x) {
    weight_out[n * K + k] = wgt[k];
    logz_out[n * K + k] = logz[k];
  }
  for (int i = tid; i < K * D; i += blockDim.x)
    lamb_out[n * K * D + i] = lamb[(i / D) * kRowStride + i % D];
  for (int i = tid; i < K * DD; i += blockDim.x)
    vec_out[n * K * DD + i] = V[i];
  for (size_t i = tid; i < KT; i += blockDim.x) aff_out[n * KT + i] = aff[i];
}

template <int D>
int launch(const float2* y, const float* aff0, const float* sal,
           float* weight, float* lamb, float2* vec, float* logz, float* aff,
           int N, int K, int T, int iterations, int sweeps, int warm_sweeps,
           int cold_rounds, int cold_steps, int warm_steps,
           float spacing_eps, float lower, float upper, float fd_step,
           float affiliation_eps, float cap_init, float max_concentration,
           float log2pi_d, cudaStream_t stream) {
  const size_t bytes = cbmm_smem_bytes(D, K, T, sal != nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      cbmm_em_full_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(bytes));
  if (err != cudaSuccess) return int(err);
  cbmm_em_full_kernel<D><<<N, kThreads, bytes, stream>>>(
      y, aff0, sal, weight, lamb, vec, logz, aff, K, T, iterations, sweeps,
      warm_sweeps, cold_rounds, cold_steps, warm_steps, spacing_eps, lower,
      upper, fd_step, affiliation_eps, cap_init, max_concentration,
      log2pi_d);
  return int(cudaGetLastError());
}

}  // namespace

// Launch the whole-fit Bingham EM on `stream` for N independent bins
// (2 <= D <= 8). sal may be null; max_concentration <= 0 means unbounded.
// Returns a cudaError_t (0 on success; cudaErrorInvalidValue for an
// unsupported D); neither synchronizes nor allocates.
extern "C" int cbmm_em_full_launch(
    const void* y, const void* aff0, const void* sal, void* weight,
    void* lamb, void* vec, void* logz, void* aff, int N, int D, int K,
    int T, int iterations, int sweeps, int warm_sweeps, int cold_rounds,
    int cold_steps, int warm_steps, float spacing_eps, float lower,
    float upper, float fd_step, float affiliation_eps, float cap_init,
    float max_concentration, float log2pi_d, void* stream) {
#define CBMM_LAUNCH(DIM)                                                     \
  return launch<DIM>(                                                       \
      static_cast<const float2*>(y), static_cast<const float*>(aff0),       \
      static_cast<const float*>(sal), static_cast<float*>(weight),          \
      static_cast<float*>(lamb), static_cast<float2*>(vec),                 \
      static_cast<float*>(logz), static_cast<float*>(aff), N, K, T,         \
      iterations, sweeps, warm_sweeps, cold_rounds, cold_steps, warm_steps, \
      spacing_eps, lower, upper, fd_step, affiliation_eps, cap_init,        \
      max_concentration, log2pi_d, static_cast<cudaStream_t>(stream))
  switch (D) {
    case 2: CBMM_LAUNCH(2);
    case 3: CBMM_LAUNCH(3);
    case 4: CBMM_LAUNCH(4);
    case 5: CBMM_LAUNCH(5);
    case 6: CBMM_LAUNCH(6);
    case 7: CBMM_LAUNCH(7);
    case 8: CBMM_LAUNCH(8);
    default: return int(cudaErrorInvalidValue);
  }
#undef CBMM_LAUNCH
}
