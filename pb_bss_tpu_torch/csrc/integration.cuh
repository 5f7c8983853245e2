// The integration-model E-step, shared by the per-iteration kernel
// (integration_em.cu, K10) and the whole-fit kernel
// (integration_em_loop.cu, K12).
//
// Replaces what the JAX package's two Pallas kernels write out each in
// its own body (pb_bss_tpu/ops/pallas_integration_em.py:_e_stats_kernel
// and pallas_integration_em_loop.py:_loop_kernel): the joint log-pdf of a
// frame under the spatial cACG of its bin and the GLOBAL spectral model of
// its utterance, and the posterior. There the bins lay in the TPU's lanes;
// here a thread takes one frame, the frame in registers (D a template
// parameter of the callers):
//
//   E-step  the spatial quadratic form through the eigenvectors,
//           z = V^H y and q = sum_i |z_i|^2 / lam_i (projection_quad_h),
//           then max(q, tiny), -D log q - logdet;
//           the spectral log-pdf, vMF kappa mu.e / |e| - log C or Gaussian
//           (P m).e - e.diag(P).e / 2 - const; the weighted sum of the two
//           (spatial_weight, spectral_weight), the max-shift softmax with
//           the mixture weight, max(den, tiny), the clip to [eps, 1 - eps];
//           then saliency multiplies the posterior, and the scatter weight
//           is a / max(q, 10 tiny).
//
// The sums the M-step needs are each kernel's own (K10: lanes over the
// items of a class, K12: two passes over the tile), both in registers
// with one cross-warp reduction in a fixed order.
//
// The quadratic form is not taken through the assembled inverse
// V diag(1 / lam) V^H, as the JAX package's kernels take it: once an
// eigenvalue reaches the floor (1e-10) its entries are ~1e10, the form
// cancels catastrophically, a q <= 0 is floored at tiny and its frame gets
// the weight a / tiny ~ 1e37 in the scatter (the integration fits from a
// k-means start reach that regime within a few iterations). The
// projection is a sum of non-negative terms, as in the plain E-step.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace integration {

constexpr int kVmf = 0;
constexpr int kGaussian = 1;
constexpr int kThreads = 256;  // a thread per frame of a tile

// The spectral state of one utterance in shared memory: vMF mean (K*E),
// concentration (K), log normalizer (K); Gaussian precision-scaled mean
// (K*E), per-dimension precision (K*E), constant
// E/2 log 2pi - log|P|/2 + m.P.m / 2 (K).
struct Spectral {
  float* vec;    // K*E: mu or P m
  float* prec;   // K*E: P (Gaussian)
  float* scale;  // K: kappa (vMF)
  float* cnst;   // K: log C or const
};

// The spatial quadratic form q = sum_i |v_i^H y|^2 / lam_i of the frame yf
// under one class, from its eigenvectors conjugate-transposed
// (Vh[i * D + d] = conj(V[d * D + i]): row i is v_i^H, two entries a load
// for even D, where Vh is 16-byte aligned) and its reciprocal eigenvalues.
template <int D>
__device__ __forceinline__ float projection_quad_h(const float2 (&yf)[D],
                                                   const float2* Vh,
                                                   const float* inv_lam) {
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float2 z = make_float2(0.f, 0.f);
    if constexpr (D % 2 == 0) {
#pragma unroll
      for (int d = 0; d < D; d += 2) {
        const float4 w = *reinterpret_cast<const float4*>(Vh + i * D + d);
        z = c_add(z, c_mul(make_float2(w.x, w.y), yf[d]));
        z = c_add(z, c_mul(make_float2(w.z, w.w), yf[d + 1]));
      }
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) z = c_add(z, c_mul(Vh[i * D + d], yf[d]));
    }
    q += inv_lam[i] * (z.x * z.x + z.y * z.y);
  }
  return q;
}

// The E-step of one frame (see the top of the file). quad(k) gives the
// frame's spatial quadratic form under class k (projection_quad_h) and
// emb(e) its embedding's entries; `gaussian` picks the spectral model. Writes the posterior (saliency
// applied) to aff[k * ld] and a / max(q, 10 tiny) to wq[k * ld]; aff
// doubles as the scratch of the log-pdfs.
template <class Quad, class Emb>
__device__ __forceinline__ void e_step_frame(
    Quad quad, Emb emb, const float* logdet, const float* wgt,
    const Spectral& sp, bool gaussian, float spatial_weight,
    float spectral_weight, float eps, float sal, float* aff, float* wq,
    int ld, int D, int K, int E) {
  const float tiny = FLT_MIN;
  float inv_norm = 0.f;
  if (!gaussian) {
    float en = 0.f;
    for (int e = 0; e < E; ++e) {
      const float v = emb(e);
      en += v * v;
    }
    inv_norm = rsqrtf(fmaxf(en, tiny));
  }
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) {
    const float q = fmaxf(quad(k), tiny);
    float spec;
    if (!gaussian) {
      float dot = 0.f;
      for (int e = 0; e < E; ++e) dot += sp.vec[k * E + e] * emb(e);
      spec = sp.scale[k] * dot * inv_norm - sp.cnst[k];
    } else {
      float acc = 0.f;
      for (int e = 0; e < E; ++e) {
        const float v = emb(e);
        acc += sp.vec[k * E + e] * v - 0.5f * sp.prec[k * E + e] * v * v;
      }
      spec = acc - sp.cnst[k];
    }
    const float lp = spatial_weight * (-float(D) * logf(q) - logdet[k]) +
                     spectral_weight * spec;
    wq[k * ld] = q;
    aff[k * ld] = lp;
    mx = fmaxf(mx, lp);
  }
  float den = 0.f;
  for (int k = 0; k < K; ++k) {
    const float num = expf(aff[k * ld] - mx) * wgt[k];
    aff[k * ld] = num;
    den += num;
  }
  den = fmaxf(den, tiny);
  for (int k = 0; k < K; ++k) {
    float a = aff[k * ld] / den;
    if (eps != 0.f) a = fminf(fmaxf(a, eps), 1.f - eps);
    a *= sal;
    aff[k * ld] = a;
    wq[k * ld] = a / fmaxf(wq[k * ld], 10.f * tiny);
  }
}

}  // namespace integration
