// The cACGMM E-step and M-step scatter pieces shared by the EM kernels:
// the whole-fit EM (em_loop.cu), the streamed statistics (em_stream.cu),
// the frequency-constant-weight step (em_step.cu), the opt-in E-step
// kernels (em_estep.cu) and, for the statistics and the mixture weight,
// the whole-fit Watson EM (cwmm_loop.cu).
//
// Replaces what the JAX package's Pallas kernels write out again in each
// kernel (pb_bss_tpu/ops/pallas_em_loop.py, pallas_em_stream.py,
// pallas_em_step.py, pallas_em.py): the inverse covariance of a class,
// the E-step of one frame (a thread per frame) and one upper-triangle
// scatter sum (a warp per sum, lanes over frames). The loop structure
// around them (what lives in shared memory, how T is walked) stays in
// each kernel.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "jacobi.cuh"

// Ci = V diag(inv_lam) V^H of one class (V row-major D x D, eigenvectors
// in columns; Ci row-major), by one warp: lane owns entries de = lane,
// lane + 32, ... `inv_lam(i)` gives the reciprocal of eigenvalue i.
template <class InvLam>
__device__ __forceinline__ void warp_inverse_covariance(const float2* V,
                                                        InvLam inv_lam,
                                                        float2* Ci, int D) {
  const int lane = threadIdx.x & 31;
  const int DD = D * D;
  for (int de = lane; de < DD; de += 32) {
    const int d = de / D;
    const int e = de % D;
    float2 acc = make_float2(0.f, 0.f);
    for (int i = 0; i < D; ++i)
      acc = c_add(acc, c_scale(inv_lam(i), c_mul_conj(V[d * D + i],
                                                      V[e * D + i])));
    Ci[de] = acc;
  }
}

// The E-step of one frame: for each class k the quadratic form y^H Ci_k y
// (2 Re over the upper triangle), max(q, tiny), the log-pdf
// -D log q - logdet_k, then the max-shift softmax with the linear weights
// wgt, the source-activity mask on the numerators (mask == nullptr: none;
// else mask[k * mask_stride]), max(den, tiny) and the clip to
// [eps, 1 - eps] when eps != 0. `y(d)` gives the frame's entry d. Writes
// the posterior to aff[k * ld] and the quadratic form to qf[k * ld]; aff
// doubles as scratch for the log-pdfs.
template <class Y>
__device__ __forceinline__ void e_step_frame(Y y, const float2* Ci,
                                             const float* logdet,
                                             const float* wgt,
                                             const float* mask,
                                             int mask_stride, float eps,
                                             float* aff, float* qf, int ld,
                                             int D, int K) {
  const int DD = D * D;
  const float tiny = FLT_MIN;
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) {
    const float2* Cik = Ci + k * DD;
    float q = 0.f;
    for (int d = 0; d < D; ++d) {
      const float2 yd = y(d);
      q += Cik[d * D + d].x * (yd.x * yd.x + yd.y * yd.y);
      for (int e = d + 1; e < D; ++e) {
        // 2 Re(Cinv_de conj(y_d) y_e) with p = y_d conj(y_e)
        const float2 p = c_mul_conj(yd, y(e));
        q += 2.f * (Cik[d * D + e].x * p.x + Cik[d * D + e].y * p.y);
      }
    }
    q = fmaxf(q, tiny);
    const float lp = -float(D) * logf(q) - logdet[k];
    qf[k * ld] = q;
    aff[k * ld] = lp;
    mx = fmaxf(mx, lp);
  }
  float den = 0.f;
  for (int k = 0; k < K; ++k) {
    float num = expf(aff[k * ld] - mx) * wgt[k];
    if (mask != nullptr) num *= mask[k * mask_stride];
    aff[k * ld] = num;
    den += num;
  }
  den = fmaxf(den, tiny);
  for (int k = 0; k < K; ++k) {
    float a = aff[k * ld] / den;
    if (eps != 0.f) a = fminf(fmaxf(a, eps), 1.f - eps);
    aff[k * ld] = a;
  }
}

// (d, e), d <= e, of upper-triangle entry r (row-major over the upper
// triangle of a D x D matrix).
__device__ __forceinline__ void upper_entry(int r, int D, int* d, int* e) {
  int row = 0;
  while (r >= D - row) {
    r -= D - row;
    ++row;
  }
  *d = row;
  *e = row + r;
}

// sum_{t < nt} w[t] yd[t] conj(ye[t]) by one warp (lanes over t, shuffle
// reduction); every lane returns the sum.
__device__ __forceinline__ float2 warp_weighted_pair_sum(const float2* yd,
                                                         const float2* ye,
                                                         const float* w,
                                                         int nt) {
  const int lane = threadIdx.x & 31;
  float re = 0.f, im = 0.f;
  for (int t = lane; t < nt; t += 32) {
    const float wt = w[t];
    const float2 p = c_mul_conj(yd[t], ye[t]);
    re += wt * p.x;
    im += wt * p.y;
  }
  return make_float2(warp_sum(re), warp_sum(im));
}

// sum_{t < nt} a[t] by one warp; every lane returns the sum.
__device__ __forceinline__ float warp_frame_sum(const float* a, int nt) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int t = lane; t < nt; t += 32) acc += a[t];
  return warp_sum(acc);
}

// The M-step statistics of one bin held in shared memory, by the whole
// block: asum_k = sum_t aff[k, t] (aff already saliency-weighted), then
// the K D(D+1)/2 upper-triangle sums of wq y y^H (a warp per sum),
// written Hermitian into S as num * sum / max(asum_k, tiny). num is D
// for the cACG covariance and 1 for the Watson scatter. It is a
// division, never the sum times num / max(asum, tiny): at D >= 5 that
// factor overflows to inf when a class's sum is 0 in a real bin (a
// source-activity mask with affiliation_eps=0 silences a class there),
// and 0 * inf would poison the scatter; the division gives 0 / tiny = 0,
// as the scan path does. asum_out (may be null) receives the K sums.
// Starts and ends with the block synchronized.
__device__ void m_stats(const float2* ys, const float* aff, const float* wq,
                        float2* S, float* asum, float* asum_out, int D,
                        int K, int T, float num) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int DD = D * D;
  const int P = D * (D + 1) / 2;
  for (int k = warp; k < K; k += nwarps) {
    const float acc = warp_frame_sum(aff + k * T, T);
    if (lane == 0) {
      asum[k] = acc;
      if (asum_out != nullptr) asum_out[k] = acc;
    }
  }
  __syncthreads();
  for (int item = warp; item < K * P; item += nwarps) {
    const int k = item / P;
    int d, e;
    upper_entry(item % P, D, &d, &e);
    const float2 s = warp_weighted_pair_sum(ys + d * T, ys + e * T,
                                            wq + k * T, T);
    if (lane == 0) {
      const float den = fmaxf(asum[k], FLT_MIN);
      const float re = num * s.x / den;
      const float im = num * s.y / den;
      float2* Sk = S + k * DD;
      if (d == e) {
        Sk[d * D + d] = make_float2(re, 0.f);
      } else {
        Sk[d * D + e] = make_float2(re, im);
        Sk[e * D + d] = make_float2(re, -im);
      }
    }
  }
  __syncthreads();
}

// The mixture weight of class k from the K affiliation sums of a bin
// (or an utterance): with saliency, the sums L1-normalized over classes
// (a zero norm divides by 1e-10, estimate_mixture_weight's 'where'
// style); without, the mean over `count` frames.
__device__ __forceinline__ float mixture_weight(const float* asum, int k,
                                                int K, bool saliency,
                                                float count) {
  if (!saliency) return asum[k] / count;
  float norm = 0.f;
  for (int j = 0; j < K; ++j) norm += asum[j];
  if (norm == 0.f) norm = 1e-10f;
  return asum[k] / norm;
}

// Eigenvalue max-normalization and floor of one class after its Jacobi
// (the eigenvalues on the diagonal of A), by one warp:
// eig[i] = max(A_ii / max(max_j A_jj, tiny), floor).
__device__ __forceinline__ void warp_floor_eigenvalues(const float2* A,
                                                       float* eig, int D,
                                                       float floor) {
  const int lane = threadIdx.x & 31;
  float lmax = A[0].x;
  for (int i = 1; i < D; ++i) lmax = fmaxf(lmax, A[i * D + i].x);
  lmax = fmaxf(lmax, FLT_MIN);
  if (lane < D) eig[lane] = fmaxf(A[lane * D + lane].x / lmax, floor);
  __syncwarp();
}
