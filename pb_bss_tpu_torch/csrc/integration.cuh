// The integration-model E-step, shared by the per-iteration kernel
// (integration_em.cu, K10) and the whole-fit kernel
// (integration_em_loop.cu, K12), and K10's M-step statistics (K12 sums in
// registers on the cACGMM iteration body).
//
// Replaces what the JAX package's two Pallas kernels write out each in
// its own body (pb_bss_tpu/ops/pallas_integration_em.py:_e_stats_kernel
// and pallas_integration_em_loop.py:_loop_kernel): the joint log-pdf of a
// frame under the spatial cACG of its bin and the GLOBAL spectral model of
// its utterance, the posterior, and the sums the M-step needs. There the
// bins lay in the TPU's lanes; here a CTA owns one bin and walks its
// frames in tiles held in shared memory:
//
//   E-step  a thread per frame: the spatial quadratic form through the
//           eigenvectors, z = V^H y and q = sum_i |z_i|^2 / lam_i, then
//           max(q, tiny), -D log q - logdet;
//           the spectral log-pdf, vMF kappa mu.e / |e| - log C or Gaussian
//           (P m).e - e.diag(P).e / 2 - const; the weighted sum of the two
//           (spatial_weight, spectral_weight), the max-shift softmax with
//           the mixture weight, max(den, tiny), the clip to [eps, 1 - eps];
//           then saliency multiplies the posterior.
//   sums    a warp per (class, item): the upper-triangle scatter entries of
//           sum_t a / max(q, 10 tiny) y y^H, sum_t a, the resultants
//           sum_t a e on the raw embedding and, for the Gaussian, the second
//           moments sum_t a e^2; lanes over the tile's frames, shuffle
//           reduction, added into the CTA's accumulator by the one warp
//           that owns it (a fixed order: runs repeat bit for bit).
//
// The quadratic form is not taken through the assembled inverse
// V diag(1 / lam) V^H, as the JAX package's kernels take it: once an
// eigenvalue reaches the floor (1e-10) its entries are ~1e10, the form
// cancels catastrophically, a q <= 0 is floored at tiny and its frame gets
// the weight a / tiny ~ 1e37 in the scatter (the integration fits from a
// k-means start reach that regime within a few iterations). The
// projection is a sum of non-negative terms, as in the plain E-step.
//
// There is no padding: loops run over the real frames, so no padded frame
// can feed 0 * inf into a sum.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

namespace integration {

constexpr int kVmf = 0;
constexpr int kGaussian = 1;
constexpr int kTile = 256;     // frames per shared-memory tile
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

// The CTA's accumulators of one bin: the upper-triangle scatter entries
// (K*P complex, row-major over the triangle), sum_t a (K), the resultants
// (K*E) and the second moments (K*E, Gaussian).
struct Accum {
  float2* scatter;
  float* asum;
  float* res;
  float* m2;
};

// The tile buffers: y (D*kTile complex), the embedding (E*kTile), the
// posterior and the scatter weights (K*kTile each).
struct Tile {
  float2* y;
  float* emb;
  float* aff;
  float* wq;
};

// The spatial quadratic form of frame y(d) under one class,
// q = sum_i |v_i^H y|^2 / lam_i, from its eigenvectors V (D x D, in
// columns) and reciprocal eigenvalues inv_lam (D).
template <class Y>
__device__ __forceinline__ float projection_quad(Y y, const float2* V,
                                                 const float* inv_lam,
                                                 int D) {
  float q = 0.f;
  for (int i = 0; i < D; ++i) {
    // z_i = v_i^H y
    float2 z = make_float2(0.f, 0.f);
    for (int d = 0; d < D; ++d) z = c_add(z, c_conj_mul(V[d * D + i], y(d)));
    q += inv_lam[i] * (z.x * z.x + z.y * z.y);
  }
  return q;
}

// The E-step of one frame (see the top of the file). quad(k) gives the
// frame's spatial quadratic form under class k (projection_quad, or the
// caller's unrolled form of it) and emb(e) its embedding's entries;
// `gaussian` picks the spectral model. Writes the posterior (saliency
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

// sum_{t < nt} a[t] x[t] (power 1) or a[t] x[t]^2 (power 2) by one warp;
// every lane returns the sum.
template <int POWER>
__device__ __forceinline__ float warp_weighted_sum(const float* a,
                                                   const float* x, int nt) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int t = lane; t < nt; t += 32) {
    const float v = x[t];
    acc += a[t] * (POWER == 2 ? v * v : v);
  }
  return warp_sum(acc);
}

// Items of one class in the sums: P scatter entries, the affiliation sum,
// E resultants and, for the Gaussian, E second moments.
template <int MODE>
__device__ __forceinline__ int items_per_class(int D, int E) {
  return D * (D + 1) / 2 + 1 + E + (MODE == kGaussian ? E : 0);
}

// Zero the accumulators (by the whole block; no barrier).
template <int MODE>
__device__ __forceinline__ void zero_accum(const Accum& acc, int D, int K,
                                           int E) {
  const int P = D * (D + 1) / 2;
  for (int i = threadIdx.x; i < K * P; i += blockDim.x)
    acc.scatter[i] = make_float2(0.f, 0.f);
  for (int i = threadIdx.x; i < K; i += blockDim.x) acc.asum[i] = 0.f;
  for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
    acc.res[i] = 0.f;
    if (MODE == kGaussian) acc.m2[i] = 0.f;
  }
}

// Walk the frames [t_begin, t_end) of bin n in tiles, by the whole block:
// the E-step of each frame, then the tile's sums added into `acc`. y
// (N, D, T) complex, emb (N, E, T), sal (N, T) or null, all in device
// memory. V / inv_lam / logdet / wgt / sp hold the bin's model in shared
// memory. Starts and ends with the block synchronized.
template <int MODE>
__device__ void accumulate_frames(
    const float2* __restrict__ y, const float* __restrict__ emb,
    const float* __restrict__ sal, size_t n, int t_begin, int t_end, int T,
    const Tile& tile, const float2* V, const float* inv_lam,
    const float* logdet, const float* wgt, const Spectral& sp,
    const Accum& acc,
    float spatial_weight, float spectral_weight, float eps, int D, int K,
    int E) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int nwarps = blockDim.x >> 5;
  const int P = D * (D + 1) / 2;
  const int items = items_per_class<MODE>(D, E);
  for (int t0 = t_begin; t0 < t_end; t0 += kTile) {
    const int nt = min(kTile, t_end - t0);
    for (int i = tid; i < D * nt; i += blockDim.x) {
      const int d = i / nt;
      const int t = i - d * nt;
      tile.y[d * kTile + t] = y[(n * D + d) * T + t0 + t];
    }
    for (int i = tid; i < E * nt; i += blockDim.x) {
      const int e = i / nt;
      const int t = i - e * nt;
      tile.emb[e * kTile + t] = emb[(n * E + e) * T + t0 + t];
    }
    __syncthreads();

    for (int t = tid; t < nt; t += blockDim.x) {
      const auto yt = [&](int d) { return tile.y[d * kTile + t]; };
      e_step_frame(
          [&](int k) {
            return projection_quad(yt, V + k * D * D, inv_lam + k * D, D);
          },
          [&](int e) { return tile.emb[e * kTile + t]; }, logdet, wgt, sp,
          MODE == kGaussian, spatial_weight, spectral_weight, eps,
          sal != nullptr ? sal[n * T + t0 + t] : 1.f, tile.aff + t,
          tile.wq + t, kTile, D, K, E);
    }
    __syncthreads();

    for (int item = warp; item < K * items; item += nwarps) {
      const int k = item / items;
      const int r = item % items;
      const float* ak = tile.aff + k * kTile;
      if (r < P) {
        int d, e;
        upper_entry(r, D, &d, &e);
        const float2 v = warp_weighted_pair_sum(
            tile.y + d * kTile, tile.y + e * kTile, tile.wq + k * kTile, nt);
        if (lane == 0) {
          acc.scatter[k * P + r].x += v.x;
          acc.scatter[k * P + r].y += v.y;
        }
      } else if (r == P) {
        const float v = warp_frame_sum(ak, nt);
        if (lane == 0) acc.asum[k] += v;
      } else if (r < P + 1 + E) {
        const int e = r - P - 1;
        const float v = warp_weighted_sum<1>(ak, tile.emb + e * kTile, nt);
        if (lane == 0) acc.res[k * E + e] += v;
      } else {
        const int e = r - P - 1 - E;
        const float v = warp_weighted_sum<2>(ak, tile.emb + e * kTile, nt);
        if (lane == 0) acc.m2[k * E + e] += v;
      }
    }
    __syncthreads();
  }
}

// The bin's cACG model in shared memory from its eigenvalues lam (K, D)
// and weights (K), in device or shared memory, by the whole block:
// inv_lam = 1 / lam, logdet = sum log lam, the weights copied to wgt (the
// eigenvectors stay as they are). Ends with the block synchronized.
__device__ __forceinline__ void load_cacg(const float* lam,
                                          const float* weight, float* inv_lam,
                                          float* logdet, float* wgt, int D,
                                          int K) {
  for (int i = threadIdx.x; i < K * D; i += blockDim.x)
    inv_lam[i] = 1.f / lam[i];
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float ld = 0.f;
    for (int i = 0; i < D; ++i) ld += logf(lam[k * D + i]);
    logdet[k] = ld;
    wgt[k] = weight[k];
  }
  __syncthreads();
}

// The spectral state of utterance u from device memory into `sp` (by the
// whole block; no barrier): vec (U, K, E), prec_or_scale (U, K, E) for the
// Gaussian or (U, K) for the vMF, cnst (U, K).
// No __restrict__: the whole-fit kernel rewrites the state between grid
// syncs, so its loads must not take the non-coherent read-only path.
template <int MODE>
__device__ __forceinline__ void load_spectral(const float* vec,
                                              const float* prec_or_scale,
                                              const float* cnst, size_t u,
                                              const Spectral& sp, int K,
                                              int E) {
  for (int i = threadIdx.x; i < K * E; i += blockDim.x) {
    sp.vec[i] = vec[u * K * E + i];
    if (MODE == kGaussian) sp.prec[i] = prec_or_scale[u * K * E + i];
  }
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    if (MODE == kVmf) sp.scale[k] = prec_or_scale[u * K + k];
    sp.cnst[k] = cnst[u * K + k];
  }
}

}  // namespace integration
