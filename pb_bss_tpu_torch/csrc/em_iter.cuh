// The cACGMM EM iteration body shared by the whole-fit EM (em_loop.cu)
// and the frequency-constant-weight EM (em_step.cu); its scatter sums and
// column Jacobi also carry the whole-fit Watson EM (cwmm_loop.cu), its
// covariance and column Jacobi the whole-fit integration EM
// (integration_em_loop.cu), its wavefront Jacobi with the twin's rotation
// the batched Jacobi (eigh.cu) and the fused GEV (gev.cu). All of it is
// templated on D, so every loop over the channels unrolls:
//
//   scatter_sums     the M-step sums of one bin held in shared memory:
//                    lanes over the upper-triangle entries of y y^H (and
//                    one more lane for the affiliation sum), warps over
//                    frames, a group of kScatterGroup classes summed in
//                    registers at once, then one cross-warp reduction,
//                    warp by warp in a fixed order (runs repeat bit for
//                    bit). The frequency-constant-weight and Watson
//                    EMs', and the whole-fit EM's at D <= 3.
//   scatter_sums_grouped  the same sums for the whole-fit EM, from groups
//                    of G frames: a lane reads its group of its two rows
//                    of y and each class's weights in 16-byte loads, forms
//                    the G products once for a class group sized to K.
//   covariance_from_sums  num sum / max(asum, tiny), Hermitian: a
//                    division, never the sum times num / max(asum, tiny)
//                    (at D >= 5 that factor overflows when a class's sum
//                    is 0 in a real bin, and 0 * inf would poison the
//                    scatter).
//   column_eigh      the complex Jacobi in registers: a lane owns one
//                    column of A and of V of one class, floor(32 / D)
//                    classes to a warp; in the parallel (round-robin)
//                    order a sweep is D - 1 steps of D / 2 disjoint
//                    rotations, in the cyclic one D (D - 1) / 2 rotations
//                    in turn, or the same cyclic rotations in 2 D - 3
//                    steps of disjoint ones (the wavefront); the column
//                    exchange is a shuffle. Cold from the identity, or
//                    warm-started from the previous eigenbasis
//                    (A = V^H S V by the column lanes).
//   e_step_pass      the E-step, a thread per frame: the frame in
//                    registers, the quadratic form as the projection on
//                    the scaled eigenbasis (projection_form), the max-shift
//                    softmax, the source-activity mask, the clip; then
//                    saliency and the scatter weights w = a / max(q, 10
//                    tiny).
//
// Replaces the iteration body that the JAX package's Pallas kernels
// (pb_bss_tpu/ops/pallas_em_loop.py, pallas_em_step.py) write out in each
// kernel; the rotation algebra is theirs (_jacobi_rounds).
//
// Shared-memory layouts are the caller's: y is D rows of stride Tp (an odd
// Tp puts the channels of a frame in distinct banks; scatter_sums_grouped
// takes an even one), the per-class matrices K x D x D row-major, the
// (K, T) arrays class-major (rows of stride Tw in scatter_sums_grouped and
// e_step_pass).
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "em_common.cuh"

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kScatterGroup = 4;  // classes summed in registers at once

// The round-robin (circle) schedule of Dn = D + (D & 1) indices: step s
// pairs (s, Dn - 1) and ((s + m) mod (Dn - 1), (s - m) mod (Dn - 1)) for
// m = 1 .. Dn / 2 - 1; the Dn - 1 steps pair every two indices once. A
// pair with the padding index D is skipped.
__host__ __device__ constexpr int rr_a(int Dn, int s, int m) {
  return m == 0 ? s : (s + m) % (Dn - 1);
}
__host__ __device__ constexpr int rr_b(int Dn, int s, int m) {
  return m == 0 ? Dn - 1 : (s - m + Dn - 1) % (Dn - 1);
}

// The rotation of pair (p, q) from a_pp, a_qq, a_pq: the JAX package's
// algebra (tau = (a_qq - a_pp) / 2|a_pq|, t = sign(tau) / (|tau| +
// sqrt(1 + tau^2)) with t = 1 at tau = 0, c = 1 / sqrt(1 + t^2),
// s = t c a_pq / |a_pq|, none when a_pq is zero) in the card's fast
// reciprocal square roots: a Jacobi rotation only has to be applied
// consistently to rows, columns and V, which the shared (c, s) ensure,
// and the sweeps then converge to f32 rounding as with exact parameters.
// An |a_pq| below 1e-18 (of entries ~1) counts as zero.
__device__ __forceinline__ void rotation(float app, float aqq, float2 apq,
                                         float* c_out, float2* s_out) {
  const float n2 = fmaf(apq.x, apq.x, apq.y * apq.y);
  const bool rotate = n2 > 1e-36f;
  const float inv = rotate ? rsqrtf(n2) : 0.f;
  const float tau = 0.5f * (aqq - app) * inv;
  const float t = copysignf(
      __frcp_rn(fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f))), tau);
  const float c = rotate ? rsqrtf(fmaf(t, t, 1.f)) : 1.f;
  const float sr = rotate ? t * c * inv : 0.f;
  *c_out = c;
  *s_out = make_float2(sr * apq.x, sr * apq.y);
}

// The same rotation at any scale, as the plain twin takes it
// (ops/linalg.py:_jacobi_rotate): |a_pq| without squaring it (hypotf), so
// that entries of 1e-20 neither underflow nor count as zero; safe =
// max(|a_pq|, tiny), tau = (a_qq - a_pp) / 2 safe, t = 1 at tau = 0,
// s = t c a_pq / safe, and no rotation (c = 1, s = 0 exactly, as the
// twin's select) only where a_pq is zero or NaN.
// The batched Jacobi (eigh.cu, K1) is a public op on matrices of any
// scale; the EM kernels' covariances are normalized and keep rotation().
__device__ __forceinline__ void twin_rotation(float app, float aqq,
                                              float2 apq, float* c_out,
                                              float2* s_out) {
  const float absa = hypotf(apq.x, apq.y);
  const float inv = __frcp_rn(fmaxf(absa, FLT_MIN));
  const float tau = 0.5f * (aqq - app) * inv;
  const float t = tau == 0.f ? 1.f : copysignf(
      __frcp_rn(fabsf(tau) + sqrtf(fmaf(tau, tau, 1.f))), tau);
  const float c = rsqrtf(fmaf(t, t, 1.f));
  const float sr = t * c * inv;
  const bool rotate = absa > 0.f;  // false for a NaN a_pq too
  *c_out = rotate ? c : 1.f;
  *s_out = rotate ? make_float2(sr * apq.x, sr * apq.y)
                  : make_float2(0.f, 0.f);
}

// `sweeps` parallel Jacobi sweeps on the Hermitian matrices whose columns
// the lanes hold: lane `base + j` holds column j of A (a) and of V (v) of
// its class, j = lane - base < D (`own` false for lanes without a
// column). In each step the two lanes of a pair compute its rotation from
// their own entries (each lane's diagonal and its entry in the partner's
// row), the step's D / 2 rotations reach every lane by shuffle for the
// row updates, and the two lanes exchange their columns by shuffle.
// Afterwards a[j].x is the lane's eigenvalue.
template <int D>
__device__ __forceinline__ void column_jacobi(float2 (&a)[D], float2 (&v)[D],
                                              int base, int j, bool own,
                                              int sweeps) {
  constexpr int Dn = D + (D & 1);
  constexpr int M = Dn / 2;
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int s = 0; s < Dn - 1; ++s) {
      // this lane's partner in step s of the circle schedule
      int partner = j == Dn - 1 ? s
          : j == s ? Dn - 1 : (2 * s - j + 2 * (Dn - 1)) % (Dn - 1);
      if (!own || partner >= D) partner = j;
      const bool is_p = j < partner;
      float2 diag = a[0], off = a[0];
#pragma unroll
      for (int i = 1; i < D; ++i) {
        if (i == j) diag = a[i];
        if (i == partner) off = a[i];
      }
      // the partner's diagonal, and A[p][q] from the q lane (its entry in
      // row p)
      const float other = __shfl_sync(kFullMask, diag.x, base + partner);
      const float2 off_q = make_float2(
          __shfl_sync(kFullMask, off.x, base + partner),
          __shfl_sync(kFullMask, off.y, base + partner));
      float c = 1.f;
      float2 sv = make_float2(0.f, 0.f);
      if (partner != j)
        rotation(is_p ? diag.x : other, is_p ? other : diag.x,
                 is_p ? off_q : off, &c, &sv);
      // rows p and q of the lane's column, for every pair of the step:
      // A[p] = c A[p] - s A[q]; A[q] = conj(s) A[p] + c A[q]
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const int p0 = rr_a(Dn, s, m), q0 = rr_b(Dn, s, m);
        const int p = p0 < q0 ? p0 : q0, q = p0 < q0 ? q0 : p0;
        if (q < D) {
          const float cm = __shfl_sync(kFullMask, c, base + q);
          const float2 sm = make_float2(
              __shfl_sync(kFullMask, sv.x, base + q),
              __shfl_sync(kFullMask, sv.y, base + q));
          const float2 rp = a[p], rq = a[q];
          a[p] = c_sub(c_scale(cm, rp), c_mul(sm, rq));
          a[q] = c_add(c_mul(c_conj(sm), rp), c_scale(cm, rq));
        }
      }
      // columns: A[:,p] = c A[:,p] - conj(s) A[:,q];
      // A[:,q] = s A[:,p] + c A[:,q] (V the same), the partner's column
      // by shuffle
      const float2 coef = is_p ? make_float2(-sv.x, sv.y) : sv;
      const int src = base + partner;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float2 xa = make_float2(__shfl_sync(kFullMask, a[i].x, src),
                                      __shfl_sync(kFullMask, a[i].y, src));
        const float2 xv = make_float2(__shfl_sync(kFullMask, v[i].x, src),
                                      __shfl_sync(kFullMask, v[i].y, src));
        a[i] = c_add(c_scale(c, a[i]), c_mul(coef, xa));
        v[i] = c_add(c_scale(c, v[i]), c_mul(coef, xv));
      }
    }
  }
}

// The same sweeps in the cyclic order (p, q) = (0, 1), (0, 2), ..,
// (D - 2, D - 1), one rotation after another, as the JAX package's
// _jacobi_rounds and the plain twins' eigh_jacobi take them: where the
// sweeps given do not converge to f32 rounding (a warm start two sweeps
// from a matrix that the new statistics moved), the order decides what
// is left off the diagonal, and this one leaves what the twins leave.
// Every lane of a class computes each rotation from the pair's entries
// (shuffled from lanes p and q), updates rows p and q of its column, and
// lanes p and q exchange their columns by shuffle.
template <int D>
__device__ __forceinline__ void column_jacobi_cyclic(float2 (&a)[D],
                                                     float2 (&v)[D],
                                                     int base, int j,
                                                     int sweeps) {
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < D - 1; ++p) {
#pragma unroll
      for (int q = p + 1; q < D; ++q) {
        const float app = __shfl_sync(kFullMask, a[p].x, base + p);
        const float aqq = __shfl_sync(kFullMask, a[q].x, base + q);
        const float2 apq =
            make_float2(__shfl_sync(kFullMask, a[p].x, base + q),
                        __shfl_sync(kFullMask, a[p].y, base + q));
        float c;
        float2 sv;
        rotation(app, aqq, apq, &c, &sv);
        // rows: A[p] = c A[p] - s A[q]; A[q] = conj(s) A[p] + c A[q]
        const float2 rp = a[p], rq = a[q];
        a[p] = c_sub(c_scale(c, rp), c_mul(sv, rq));
        a[q] = c_add(c_mul(c_conj(sv), rp), c_scale(c, rq));
        // columns: A[:,p] = c A[:,p] - conj(s) A[:,q];
        // A[:,q] = s A[:,p] + c A[:,q] (V the same)
        const bool is_p = j == p, is_q = j == q;
        const int src = base + (is_p ? q : (is_q ? p : j));
        const float2 coef = is_p ? make_float2(-sv.x, sv.y)
                                 : (is_q ? sv : make_float2(0.f, 0.f));
        const float cc = (is_p || is_q) ? c : 1.f;
#pragma unroll
        for (int i = 0; i < D; ++i) {
          const float2 xa = make_float2(__shfl_sync(kFullMask, a[i].x, src),
                                        __shfl_sync(kFullMask, a[i].y, src));
          const float2 xv = make_float2(__shfl_sync(kFullMask, v[i].x, src),
                                        __shfl_sync(kFullMask, v[i].y, src));
          a[i] = c_add(c_scale(cc, a[i]), c_mul(coef, xa));
          v[i] = c_add(c_scale(cc, v[i]), c_mul(coef, xv));
        }
      }
    }
  }
}

// The cyclic sweeps of column_jacobi_cyclic in 2 D - 3 steps: step t
// takes the rotations (p, q) with p + q = t, which are disjoint, and every
// rotation of the cyclic order that shares an index with (p, q) has a
// smaller p + q if it comes before it and a larger one if after. So each
// rotation is computed from the entries that the cyclic order computes it
// from, and the result is the cyclic one but for the order in which two
// disjoint rotations of a step round their shared entries A[p][r] (f32
// rounding, where the orders themselves part by what two unconverged sweeps
// leave off the diagonal). The lanes of a pair compute its rotation, the
// step's rotations reach every lane by shuffle for the row updates, and the
// two lanes exchange their columns by shuffle, as in column_jacobi.
// kTwinRotation: the plain twin's rotation at any scale (twin_rotation,
// for K1 and K3) in place of the EM kernels' rotation().
template <int D, bool kTwinRotation = false>
__device__ __forceinline__ void column_jacobi_wavefront(float2 (&a)[D],
                                                        float2 (&v)[D],
                                                        int base, int j,
                                                        bool own,
                                                        int sweeps) {
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int t = 1; t <= 2 * D - 3; ++t) {
      // this lane's partner in step t
      int partner = t - j;
      if (!own || partner < 0 || partner >= D || partner == j) partner = j;
      const bool is_p = j < partner;
      float2 diag = a[0], off = a[0];
#pragma unroll
      for (int i = 1; i < D; ++i) {
        if (i == j) diag = a[i];
        if (i == partner) off = a[i];
      }
      // the partner's diagonal, and A[p][q] from the q lane (its entry in
      // row p)
      const float other = __shfl_sync(kFullMask, diag.x, base + partner);
      const float2 off_q = make_float2(
          __shfl_sync(kFullMask, off.x, base + partner),
          __shfl_sync(kFullMask, off.y, base + partner));
      float c = 1.f;
      float2 sv = make_float2(0.f, 0.f);
      if (partner != j) {
        if constexpr (kTwinRotation)
          twin_rotation(is_p ? diag.x : other, is_p ? other : diag.x,
                        is_p ? off_q : off, &c, &sv);
        else
          rotation(is_p ? diag.x : other, is_p ? other : diag.x,
                   is_p ? off_q : off, &c, &sv);
      }
      // rows p and q of the lane's column, for every pair of the step:
      // A[p] = c A[p] - s A[q]; A[q] = conj(s) A[p] + c A[q]
#pragma unroll
      for (int p = t > D - 1 ? t - (D - 1) : 0; 2 * p < t; ++p) {
        const int q = t - p;
        const float cm = __shfl_sync(kFullMask, c, base + q);
        const float2 sm = make_float2(
            __shfl_sync(kFullMask, sv.x, base + q),
            __shfl_sync(kFullMask, sv.y, base + q));
        const float2 rp = a[p], rq = a[q];
        a[p] = c_sub(c_scale(cm, rp), c_mul(sm, rq));
        a[q] = c_add(c_mul(c_conj(sm), rp), c_scale(cm, rq));
      }
      // columns: A[:,p] = c A[:,p] - conj(s) A[:,q];
      // A[:,q] = s A[:,p] + c A[:,q] (V the same), the partner's column
      // by shuffle
      const float2 coef = is_p ? make_float2(-sv.x, sv.y) : sv;
      const int src = base + partner;
#pragma unroll
      for (int i = 0; i < D; ++i) {
        const float2 xa = make_float2(__shfl_sync(kFullMask, a[i].x, src),
                                      __shfl_sync(kFullMask, a[i].y, src));
        const float2 xv = make_float2(__shfl_sync(kFullMask, v[i].x, src),
                                      __shfl_sync(kFullMask, v[i].y, src));
        a[i] = c_add(c_scale(c, a[i]), c_mul(coef, xa));
        v[i] = c_add(c_scale(c, v[i]), c_mul(coef, xv));
      }
    }
  }
}

// The orders of column_eigh's sweeps: the parallel (round-robin) steps of
// column_jacobi, the cyclic rotations one at a time (column_jacobi_cyclic)
// or in disjoint steps (column_jacobi_wavefront).
enum class JacobiOrder { kParallel, kCyclic, kWavefront };

// The eigendecompositions of the K Hermitian matrices S (K x D x D) by
// column Jacobi sweeps in the order kOrder, floor(32 / D)
// classes to a warp, the block's warps over
// the classes: cold from the identity, or (`warm`) from the eigenbasis in
// V, whose rotations it then carries. `sweeps` sweeps. Then every lane of
// a class's columns calls epilogue(k, j, lam, v, base, own): its class k,
// its column j, the column's eigenvalue lam and eigenvector v (D entries;
// zeros for lanes without a column, own false; every lane of the warp
// calls it, so the epilogue may shuffle within the lanes base .. base +
// D - 1). The caller synchronizes the block afterwards.
template <int D, JacobiOrder kOrder = JacobiOrder::kParallel,
          class Epilogue>
__device__ __forceinline__ void column_eigh(const float2* S, const float2* V,
                                            int K, bool warm, int sweeps,
                                            Epilogue epilogue) {
  constexpr int DD = D * D;
  constexpr int kClassesPerWarp = 32 / D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // this lane's column: column jc of the warp's class jslot
  const int jslot = lane / D;
  const int jc = lane - jslot * D;
  const int jbase = jslot * D;
  for (int k0 = warp * kClassesPerWarp; k0 < K;
       k0 += nwarps * kClassesPerWarp) {
    const bool jown = jslot < kClassesPerWarp && k0 + jslot < K;
    const int k = jown ? k0 + jslot : 0;
    const float2* Sk = S + k * DD;
    const float2* Vk = V + k * DD;
    float2 a[D], v[D];
    if (!jown) {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        a[i] = make_float2(0.f, 0.f);
        v[i] = make_float2(0.f, 0.f);
      }
    } else if (warm) {
      // A = V^H S V: this lane's column V^H (S v_j)
      float2 sv[D];
#pragma unroll
      for (int i = 0; i < D; ++i) v[i] = Vk[i * D + jc];
#pragma unroll
      for (int r = 0; r < D; ++r) {
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int b = 0; b < D; ++b)
          acc = c_add(acc, c_mul(Sk[r * D + b], v[b]));
        sv[r] = acc;
      }
#pragma unroll
      for (int i = 0; i < D; ++i) {
        float2 acc = make_float2(0.f, 0.f);
#pragma unroll
        for (int r = 0; r < D; ++r)
          acc = c_add(acc, c_conj_mul(Vk[r * D + i], sv[r]));
        a[i] = i == jc ? make_float2(acc.x, 0.f) : acc;
      }
    } else {
#pragma unroll
      for (int i = 0; i < D; ++i) {
        a[i] = Sk[i * D + jc];
        v[i] = make_float2(i == jc ? 1.f : 0.f, 0.f);
      }
    }
    if constexpr (kOrder == JacobiOrder::kCyclic)
      column_jacobi_cyclic<D>(a, v, jbase, jc, sweeps);
    else if constexpr (kOrder == JacobiOrder::kWavefront)
      column_jacobi_wavefront<D>(a, v, jbase, jc, jown, sweeps);
    else
      column_jacobi<D>(a, v, jbase, jc, jown, sweeps);
    float lam = 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i)
      if (i == jc) lam = a[i].x;
    epilogue(k, jc, lam, v, jbase, jown);
  }
}

// Max-normalized and floored eigenvalue of this lane's column (its class's
// largest from the lanes base .. base + D - 1 by shuffle) and, in
// *logdet, the class's log-determinant of the floored eigenvalues.
template <int D>
__device__ __forceinline__ float floored_eigenvalue(float lam, int base,
                                                    float eigenvalue_floor,
                                                    float* logdet) {
  float lmax = -INFINITY;
  for (int m = 0; m < D; ++m)
    lmax = fmaxf(lmax, __shfl_sync(kFullMask, lam, base + m));
  lmax = fmaxf(lmax, FLT_MIN);
  const float ev = fmaxf(lam / lmax, eigenvalue_floor);
  float ld = 0.f;
  for (int m = 0; m < D; ++m)
    ld += logf(__shfl_sync(kFullMask, ev, base + m));
  *logdet = ld;
  return ev;
}

// The M-step sums of one bin, by the whole block: Su[k * P + r] =
// sum_t wq[k, t] y_d(t) conj(y_e(t)) for the upper-triangle entries
// r = (d, e), d <= e, and wsum[k] = sum_t aw[k, t]. Lanes over the entries
// (and the sum), warps over frames, then one cross-warp reduction, warp by
// warp. Ends with the block synchronized.
template <int D>
__device__ void scatter_sums(const float2* ys, int Tp, const float* aw,
                             const float* wq, float2* Su, float* wsum,
                             int K, int T) {
  constexpr int P = D * (D + 1) / 2;
  constexpr int E = (P + 1 + 31) / 32;  // entries (and the sum) per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // this lane's scatter entries: (d, e) of r = lane + 32 j, or the
  // affiliation sum (r == P); lanes past it point at (0, 0), unused
  int ed[E], ee[E], er[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    er[j] = lane + 32 * j;
    upper_entry(er[j] < P ? er[j] : 0, D, &ed[j], &ee[j]);
  }
  for (int g0 = 0; g0 < K; g0 += kScatterGroup) {
    const int G = min(kScatterGroup, K - g0);
    float2 acc[E][kScatterGroup];
#pragma unroll
    for (int j = 0; j < E; ++j)
#pragma unroll
      for (int c = 0; c < kScatterGroup; ++c)
        acc[j][c] = make_float2(0.f, 0.f);
#pragma unroll 4
    for (int t = warp; t < T; t += nwarps) {
      float w[kScatterGroup], a[kScatterGroup];
#pragma unroll
      for (int c = 0; c < kScatterGroup; ++c) {
        w[c] = c < G ? wq[(g0 + c) * T + t] : 0.f;
        a[c] = c < G ? aw[(g0 + c) * T + t] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const bool is_sum = er[j] == P;
        float2 p = c_mul_conj(ys[ed[j] * Tp + t], ys[ee[j] * Tp + t]);
        if (is_sum) p = make_float2(1.f, 0.f);
#pragma unroll
        for (int c = 0; c < kScatterGroup; ++c) {
          const float f = is_sum ? a[c] : w[c];
          acc[j][c].x = fmaf(f, p.x, acc[j][c].x);
          acc[j][c].y = fmaf(f, p.y, acc[j][c].y);
        }
      }
    }
    // the cross-warp reduction, warp by warp in a fixed order
    for (int w = 0; w < nwarps; ++w) {
      if (warp == w) {
#pragma unroll
        for (int j = 0; j < E; ++j) {
#pragma unroll
          for (int c = 0; c < kScatterGroup; ++c) {
            if (c >= G || er[j] > P) continue;
            const int k = g0 + c;
            if (er[j] == P) {
              wsum[k] = (w == 0 ? 0.f : wsum[k]) + acc[j][c].x;
            } else {
              float2* su = Su + k * P + er[j];
              *su = w == 0 ? acc[j][c] : c_add(*su, acc[j][c]);
            }
          }
        }
      }
      __syncthreads();
    }
  }
}

// G consecutive frames of one row at p (16-byte aligned for G >= 2) in
// 16-byte loads.
template <int G>
__device__ __forceinline__ void load_frames(const float2* p,
                                            float2 (&v)[G]) {
#pragma unroll
  for (int i = 0; i < G; i += 2) {
    const float4 c = *reinterpret_cast<const float4*>(p + i);
    v[i] = make_float2(c.x, c.y);
    v[i + 1] = make_float2(c.z, c.w);
  }
}

// G consecutive weights at p (aligned to 4 G bytes) in one load.
template <int G>
__device__ __forceinline__ void load_weights(const float* p, float (&w)[G]) {
  if constexpr (G == 4) {
    const float4 c = *reinterpret_cast<const float4*>(p);
    w[0] = c.x;
    w[1] = c.y;
    w[2] = c.z;
    w[3] = c.w;
  } else {
    const float2 c = *reinterpret_cast<const float2*>(p);
    w[0] = c.x;
    w[1] = c.y;
  }
}

// The sums of scatter_sums_grouped for the KG classes g0 .. g0 + KG - 1.
template <int D, int G, int KG>
__device__ __forceinline__ void scatter_class_group(
    const float2* ys, int Tp, const float2* ones, const float* aw,
    const float* wq, int Tw, float2* Su, float* wsum, int g0, int T) {
  constexpr int P = D * (D + 1) / 2;
  constexpr int E = (P + 1 + 31) / 32;  // entries (and the sum) per lane
  constexpr int JS = P / 32;            // the slot of the affiliation sum
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  // this lane's entries: rows d and e of y for r = lane + 32 j, or the
  // run of ones at a stride of 0 for the affiliation sum (r == P); lanes
  // past it read rows (0, 0), unused. Slot JS takes its weights from aw
  // in the sum's lane, every other slot from wq.
  int er[E], stride[E];
  const float2 *rd[E], *re[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    er[j] = lane + 32 * j;
    int d, e;
    upper_entry(er[j] < P ? er[j] : 0, D, &d, &e);
    const bool is_sum = er[j] == P;
    rd[j] = is_sum ? ones : ys + d * Tp;
    re[j] = is_sum ? ones : ys + e * Tp;
    stride[j] = is_sum ? 0 : 1;
  }
  const float* wsl = (er[JS] == P ? aw : wq) + size_t(g0) * Tw;
  const float* wrest = wq + size_t(g0) * Tw;
  float2 acc[E][KG];
#pragma unroll
  for (int j = 0; j < E; ++j)
#pragma unroll
    for (int c = 0; c < KG; ++c) acc[j][c] = make_float2(0.f, 0.f);

  // whole groups of G frames, warps over groups
  const int groups = T / G;
  {
    const float2 *pd[E], *pe[E];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      pd[j] = rd[j] + stride[j] * warp * G;
      pe[j] = re[j] + stride[j] * warp * G;
    }
    const float* ps = wsl + warp * G;
    const float* pr = wrest + warp * G;
    const int step = nwarps * G;
    for (int g = warp; g < groups; g += nwarps) {
      float2 prod[E][G];
#pragma unroll
      for (int j = 0; j < E; ++j) {
        float2 a[G], b[G];
        load_frames<G>(pd[j], a);
        load_frames<G>(pe[j], b);
#pragma unroll
        for (int f = 0; f < G; ++f) prod[j][f] = c_mul_conj(a[f], b[f]);
        pd[j] += stride[j] * step;
        pe[j] += stride[j] * step;
      }
#pragma unroll
      for (int c = 0; c < KG; ++c) {
        float ws[G], wr[G];
        load_weights<G>(ps + c * Tw, ws);
        if constexpr (E > 1) load_weights<G>(pr + c * Tw, wr);
#pragma unroll
        for (int j = 0; j < E; ++j) {
#pragma unroll
          for (int f = 0; f < G; ++f) {
            const float w = j == JS ? ws[f] : wr[f];
            acc[j][c].x = fmaf(w, prod[j][f].x, acc[j][c].x);
            acc[j][c].y = fmaf(w, prod[j][f].y, acc[j][c].y);
          }
        }
      }
      ps += step;
      pr += step;
    }
  }
  // the frames of T mod G, one by one, by the warp next in turn
  if (warp == groups % nwarps) {
    for (int t = groups * G; t < T; ++t) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float2 p =
            c_mul_conj(rd[j][stride[j] * t], re[j][stride[j] * t]);
#pragma unroll
        for (int c = 0; c < KG; ++c) {
          const float w = (j == JS ? wsl : wrest)[c * Tw + t];
          acc[j][c].x = fmaf(w, p.x, acc[j][c].x);
          acc[j][c].y = fmaf(w, p.y, acc[j][c].y);
        }
      }
    }
  }
  // the cross-warp reduction, warp by warp in a fixed order
  for (int w = 0; w < nwarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < E; ++j) {
        if (er[j] > P) continue;
#pragma unroll
        for (int c = 0; c < KG; ++c) {
          const int k = g0 + c;
          if (er[j] == P) {
            wsum[k] = (w == 0 ? 0.f : wsum[k]) + acc[j][c].x;
          } else {
            float2* su = Su + k * P + er[j];
            *su = w == 0 ? acc[j][c] : c_add(*su, acc[j][c]);
          }
        }
      }
    }
    __syncthreads();
  }
}

// The M-step sums of scatter_sums (Su[k * P + r] = sum_t wq[k, t] y_d(t)
// conj(y_e(t)) for the upper-triangle entries r = (d, e), wsum[k] = sum_t
// aw[k, t]) for the whole-fit EM (em_loop.cu), from groups of G = 2 or 4
// consecutive frames. scatter_sums issues ~30 instructions a lane and
// frame of which ~10 are arithmetic: a scalar broadcast load of each of
// four classes' weights (and of the affiliation), two loads of y, a select
// for the sum lane, and the FMAs of a fixed group of four classes. Here a
// lane reads its group's frames of its rows d and e in 16-byte loads and
// each class's G weights in one broadcast load, forms the G products once,
// and adds them into a class group sized to K (1-4 classes, picked by a
// switch outside the frame loop, so K = 3 issues no FMAs on zeros): ~16
// instructions a lane and frame at G = 2, ~13 at G = 4 (D = 6, K = 3).
// The affiliation-sum lane reads aw for its weights and, for its rows, a
// run of G complex ones at a stride of 0 (written here into `ones`,
// 16-byte aligned, free during the scatter), so its product is exactly 1
// with no per-frame select. Warps
// over groups; the frames of T mod G one by one by the warp next in turn;
// then one cross-warp reduction per class group, warp by warp in a fixed
// order (runs repeat bit for bit; the order of the sums differs from
// scatter_sums', so the results differ at f32 rounding). Layouts: y is D
// rows of an even stride Tp (each row on a 16-byte boundary), aw and wq K
// rows of a stride Tw that is a multiple of G (each group's weights on a
// 4 G-byte boundary). Starts after the block's previous phase has
// synchronized; ends with the block synchronized.
template <int D, int G>
__device__ __forceinline__ void scatter_sums_grouped(
    const float2* ys, int Tp, float2* ones, const float* aw, const float* wq,
    int Tw, float2* Su, float* wsum, int K, int T) {
  static_assert(G == 2 || G == 4, "groups of 2 or 4 frames");
  if (threadIdx.x < G) ones[threadIdx.x] = make_float2(1.f, 0.f);
  __syncthreads();
  for (int g0 = 0; g0 < K; g0 += 4) {
    switch (min(4, K - g0)) {
      case 1:
        scatter_class_group<D, G, 1>(ys, Tp, ones, aw, wq, Tw, Su, wsum, g0,
                                     T);
        break;
      case 2:
        scatter_class_group<D, G, 2>(ys, Tp, ones, aw, wq, Tw, Su, wsum, g0,
                                     T);
        break;
      case 3:
        scatter_class_group<D, G, 3>(ys, Tp, ones, aw, wq, Tw, Su, wsum, g0,
                                     T);
        break;
      default:
        scatter_class_group<D, G, 4>(ys, Tp, ones, aw, wq, Tw, Su, wsum, g0,
                                     T);
        break;
    }
  }
}

// S_k = num Su_k / max(wsum_k, tiny), Hermitian from the upper-triangle
// sums, by the whole block (num is D for the cACG covariance, 1 for the
// Bingham scatter). The caller synchronizes the block afterwards.
template <int D>
__device__ __forceinline__ void covariance_from_sums(const float2* Su,
                                                     const float* wsum,
                                                     float2* S, int K,
                                                     float num) {
  constexpr int DD = D * D;
  constexpr int P = D * (D + 1) / 2;
  for (int id = threadIdx.x; id < K * DD; id += blockDim.x) {
    const int k = id / DD;
    const int d = (id - k * DD) / D;
    const int e = id - k * DD - d * D;
    const int lo = min(d, e), hi = max(d, e);
    const float2 s = Su[k * P + lo * D - lo * (lo - 1) / 2 + hi - lo];
    const float den = fmaxf(wsum[k], FLT_MIN);
    const float re = num * s.x / den;
    const float im = num * s.y / den;
    S[id] = d == e ? make_float2(re, 0.f)
                   : make_float2(re, d < e ? im : -im);
  }
}

// The E-step of every frame of one bin, a thread per frame, from the
// scaled eigenbases Wh (K x D x D, in projection_form's layout) and
// the log-determinants: the posterior into aw and the quadratic form into
// wq (then, with `update`, the saliency-weighted posterior a s into aw
// and the scatter weight a s / max(q, 10 tiny) into wq). aw and wq are K
// rows of stride Tw (T where not given). mask (at the bin, rows of T; may
// be null) gates the numerators, eps clips; aff_out (at the bin, rows of
// T; may be null) receives the posterior before saliency; sal (at the
// bin; may be null) is the frames' saliency. The caller synchronizes the
// block afterwards.
template <int D>
__device__ __forceinline__ void e_step_pass(
    const float2* ys, int Tp, const float2* Wh, const float* logdet,
    const float* wgt, const float* mask, const float* sal, float eps,
    float* aw, float* wq, float* aff_out, bool update, int K, int T,
    int Tw = 0) {
  constexpr int DD = D * D;
  if (Tw == 0) Tw = T;
  for (int t = threadIdx.x; t < T; t += blockDim.x) {
    float2 yf[D];
#pragma unroll
    for (int d = 0; d < D; ++d) yf[d] = ys[d * Tp + t];
    e_step_frame(
        [&](int k) { return projection_form<D>(yf, Wh + k * DD); }, logdet,
        wgt, mask != nullptr ? mask + t : nullptr, T, eps, aw + t, wq + t,
        Tw, D, K);
    const float s = sal != nullptr ? sal[t] : 1.f;
    for (int k = 0; k < K; ++k) {
      const float a = aw[k * Tw + t];
      if (aff_out != nullptr) aff_out[size_t(k) * T + t] = a;
      if (update) {
        aw[k * Tw + t] = a * s;
        wq[k * Tw + t] = a * s / fmaxf(wq[k * Tw + t], 10.f * FLT_MIN);
      }
    }
  }
}
