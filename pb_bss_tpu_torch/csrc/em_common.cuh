// The cACGMM E-step and M-step scatter pieces shared by the EM kernels:
// the whole-fit EM (em_loop.cu), the streamed statistics (em_stream.cu),
// the frequency-constant-weight step (em_step.cu), the opt-in E-step
// kernels (em_estep.cu), for the statistics and the mixture weight the
// whole-fit Bingham EM (cbmm_loop.cu) and for the mixture weight the
// whole-fit Watson EM (cwmm_loop.cu).
//
// Replaces what the JAX package's Pallas kernels write out again in each
// kernel (pb_bss_tpu/ops/pallas_em_loop.py, pallas_em_stream.py,
// pallas_em_step.py, pallas_em.py): the quadratic form on the per-class
// basis, the E-step of one frame (a thread per frame) and one
// upper-triangle scatter sum (a warp per sum, lanes over frames). The
// loop structure around them (what lives in shared memory, how T is
// walked) stays in each kernel. The JAX kernels take the quadratic form
// through the assembled inverse covariance; these take the projection on
// the scaled eigenbasis, as the JAX scan path and the plain twins do
// (projection_form).
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "jacobi.cuh"

// The quadratic form y^H C^-1 y of one frame as the projection on the
// scaled eigenbasis, q = sum_i |(W^H y)_i|^2 = sum_i |v_i^H y|^2 /
// lambda_i: a sum of non-negative terms. (Through the assembled inverse
// V diag(1 / lambda) V^H it cancels once an eigenvalue sits at the floor:
// entries ~1e10 whose f32 errors, ~1e3, swamp a true q of O(1).) Wh is the
// scaled eigenbasis of one class stored conjugate-transposed,
// Wh[i * D + d] = conj(V[d * D + i]) lambda_i^{-1/2} (V row-major D x D,
// eigenvectors in columns), so that (W^H y)_i = sum_d Wh[i * D + d] y_d
// with W = V diag(lambda^{-1/2}). D is known at compile time and the frame
// sits in registers (the loops unroll; Wh is read as broadcasts, two
// entries a read for even D, where Wh must be 16-byte aligned).
template <int D>
__device__ __forceinline__ float projection_form(const float2 (&y)[D],
                                                 const float2* Wh) {
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float zr = 0.f, zi = 0.f;
    if constexpr (D % 2 == 0) {
#pragma unroll
      for (int d = 0; d < D; d += 2) {
        const float4 w = *reinterpret_cast<const float4*>(Wh + i * D + d);
        zr = fmaf(w.x, y[d].x, fmaf(-w.y, y[d].y, zr));
        zi = fmaf(w.x, y[d].y, fmaf(w.y, y[d].x, zi));
        zr = fmaf(w.z, y[d + 1].x, fmaf(-w.w, y[d + 1].y, zr));
        zi = fmaf(w.z, y[d + 1].y, fmaf(w.w, y[d + 1].x, zi));
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float2 w = Wh[i * D + d];
        zr = fmaf(w.x, y[d].x, fmaf(-w.y, y[d].y, zr));
        zi = fmaf(w.x, y[d].y, fmaf(w.y, y[d].x, zi));
      }
    }
    q = fmaf(zr, zr, fmaf(zi, zi, q));
  }
  return q;
}

// The E-step of one frame: for each class k the quadratic form
// qform(k) (projection_form), max(q, tiny), the log-pdf
// -D log q - logdet_k, then the max-shift softmax with the linear weights
// wgt, the source-activity mask on the numerators (mask == nullptr: none;
// else mask[k * mask_stride]), max(den, tiny) and the clip to
// [eps, 1 - eps] when eps != 0. Writes the posterior to aff[k * ld] and
// the quadratic form to qf[k * ld]; aff doubles as scratch for the
// log-pdfs. The log, the exp and the normalization take the card's fast
// intrinsics (a few ulp; the posterior moves by ~1e-6).
template <class QForm>
__device__ __forceinline__ void e_step_frame(QForm qform,
                                             const float* logdet,
                                             const float* wgt,
                                             const float* mask,
                                             int mask_stride, float eps,
                                             float* aff, float* qf, int ld,
                                             int D, int K) {
  const float tiny = FLT_MIN;
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) {
    const float q = fmaxf(qform(k), tiny);
    const float lp = -float(D) * __logf(q) - logdet[k];
    qf[k * ld] = q;
    aff[k * ld] = lp;
    mx = fmaxf(mx, lp);
  }
  float den = 0.f;
  for (int k = 0; k < K; ++k) {
    float num = __expf(aff[k * ld] - mx) * wgt[k];
    if (mask != nullptr) num *= mask[k * mask_stride];
    aff[k * ld] = num;
    den += num;
  }
  den = fmaxf(den, tiny);
  for (int k = 0; k < K; ++k) {
    float a = __fdividef(aff[k * ld], den);
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
