// The complex Watson pieces shared by the whole-fit Watson EM
// (cwmm_loop.cu) and the streamed Watson statistics (mm_stream.cu): the
// E-step of one frame, the dominant eigenpair of a Jacobi result, the
// uniform-table concentration inverse and the switched log-norm.
//
// Replaces what the JAX package's Pallas kernels write out in each
// kernel (pb_bss_tpu/ops/pallas_cwmm_loop.py: _cwmm_kernel and
// _log_norm; pallas_mm_stream.py: the Watson branch of
// _mm_stats_stream_kernel). There the bins lay in the TPU's lanes and
// the eigenpair and the table lookup were one-hot sums, the TPU's way
// around gathers; here a thread owns a frame or a class, and the lookup
// is one pair of loads.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "jacobi.cuh"

// The E-step of one frame: for each class k the log-density
// kappa_k |<y, m_k>|^2 - logz_k (<y, m> = sum_d y_d conj(m_d)), then the
// max-shift softmax with the linear weights wgt and max(den, tiny).
// `y(d)` gives the frame's entry d; mode is (K, D) row-major. Writes
// the posterior to aff[k * ld] (which doubles as scratch for the
// log-densities).
template <class Y>
__device__ __forceinline__ void watson_e_step_frame(
    Y y, const float2* mode, const float* kappa, const float* logz,
    const float* wgt, float* aff, int ld, int D, int K) {
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) {
    float2 z = make_float2(0.f, 0.f);
    for (int d = 0; d < D; ++d) z = c_add(z, c_mul_conj(y(d), mode[k * D + d]));
    const float lp = kappa[k] * (z.x * z.x + z.y * z.y) - logz[k];
    aff[k * ld] = lp;
    mx = fmaxf(mx, lp);
  }
  float den = 0.f;
  for (int k = 0; k < K; ++k) {
    const float num = expf(aff[k * ld] - mx) * wgt[k];
    aff[k * ld] = num;
    den += num;
  }
  den = fmaxf(den, FLT_MIN);
  for (int k = 0; k < K; ++k) aff[k * ld] /= den;
}

// Index of the largest diagonal entry of the D x D matrix A (the
// eigenvalues after a Jacobi); ties go to the highest index, as the JAX
// kernel's comparison counting and a stable ascending sort both give.
__device__ __forceinline__ int dominant_index(const float2* A, int D) {
  int best = 0;
  for (int i = 1; i < D; ++i)
    if (A[i * D + i].x >= A[best * D + best].x) best = i;
  return best;
}

// Concentration of the dominant eigenvalue `lam` from the uniform table
// kappa(r0 + g dr), g < G: linear interpolation, clamped at both ends.
__device__ __forceinline__ float table_concentration(float lam, float r0,
                                                     float dr,
                                                     const float* table,
                                                     int G) {
  const float idx = fminf(fmaxf((lam - r0) / dr, 0.f), float(G - 1));
  const int i0 = min(int(idx), G - 2);
  const float f = idx - float(i0);
  return table[i0] * (1.f - f) + table[i0 + 1] * f;
}

// log 2 pi^D - lgamma(D) + log(sum_{j < terms} prod_{i < j} k / (D + i)):
// the Taylor series of 1F1(1; D; k).
__device__ __forceinline__ float watson_log_norm_series(float kappa, int D,
                                                        int terms,
                                                        float log2pi_d,
                                                        float lgamma_d) {
  float term = 1.f;
  float acc = 0.f;
  for (int j = 0; j < terms; ++j) {
    term *= kappa / float(D + j);
    acc += term;
  }
  return log2pi_d - lgamma_d + log1pf(acc);
}

// log Z(kappa) of the complex Watson (the switched form of
// models/complex_watson.py): the 20-term series below 1/D; Mardia Eq. 3,
// log 2 pi^D + (1 - D) log k + k + log(1 - sum_{r < D-1} e^-k k^r / r!)
// with k = max(kappa, 1e-2), from D - 1 on; and between them the series
// with 20 + 2 D terms, where Eq. 3's 1 - sum cancels to nothing in f32.
// log2pi_d = log 2 + D log pi and lgamma_d = lgamma(D) come from the
// host in double precision.
__device__ __forceinline__ float watson_log_norm(float kappa, int D,
                                                 float log2pi_d,
                                                 float lgamma_d) {
  if (kappa < 1.f / float(D))
    return watson_log_norm_series(kappa, D, 20, log2pi_d, lgamma_d);
  if (kappa < float(D - 1))
    return watson_log_norm_series(kappa, D, 20 + 2 * D, log2pi_d, lgamma_d);
  const float ks = fmaxf(kappa, 1e-2f);
  const float e = expf(-ks);
  float s = e;
  float kr = 1.f;
  double fact = 1.;
  for (int r = 1; r < D - 1; ++r) {
    kr *= ks;
    fact *= r;
    s += kr * e * float(1. / fact);
  }
  return log2pi_d + (1.f - float(D)) * logf(ks) + ks + logf(1.f - s);
}
