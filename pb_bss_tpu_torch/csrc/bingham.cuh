// The complex Bingham pieces shared by the chord-solve kernel (bingham.cu),
// the whole-fit Bingham EM (cbmm_loop.cu) and the Bingham family of the
// streamed statistics (mm_stream.cu): the block-Frechet divided-difference
// cascade, one chord Gauss-Newton round of the moment inversion, and the
// E-step of one frame.
//
// Replaces pb_bss_tpu/ops/pallas_bingham.py (_grad_cascade, _lam_of_u,
// _chord_round), whose problems lay in the TPU's lanes with the cascade
// state in VMEM planes. Here a GROUP of 8 lanes of one warp owns one
// problem (one (bin, class) moment vector): lane i holds row i of the
// cascade's matrices in registers (rows >= D idle). The Taylor phase
// multiplies by the bidiagonal J, a shift-and-scale of each row, so it
// needs no communication; each of the 15 squarings (E, X) <- (E E,
// E X + X E) publishes the rows to the group's shared scratch (double
// buffered, one __syncwarp of the group per squaring) and every lane
// forms its new rows from them. A whole cascade in one thread's
// registers would spill (4 matrices of up to 64 floats); a lane per row
// keeps 4 rows of 8.
//
// Every lane of a group computes the chord round's small linear algebra
// (the residual, J^T r, Minv J^T r, the clipped update) redundantly on
// the same values, so u stays identical across the group without
// broadcasts; the finite-difference Jacobian and the inverse normal matrix
// live in the group's scratch, written by the group's first lane.
//
// Every lane of a group must call these functions together (they
// synchronize the group with __syncwarp over its 8 lanes); groups of one
// warp are independent.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "jacobi.cuh"

constexpr int kGroup = 8;         // lanes per problem, one per matrix row
constexpr int kRowStride = 8;     // padded row stride of the group scratch
constexpr int kSquarings = 15;    // exact domain |lambda| <= 2^15
constexpr int kTaylorTerms = 13;
// floats of shared scratch per group: J and Minv (8 x 8 each) and the
// double-buffered exchange of the E and X rows (2 x 2 x 8 x 8)
constexpr int kGroupFloats = 2 * 64 + 4 * 64;

__device__ __forceinline__ unsigned group_mask() {
  return 0xffu << (threadIdx.x & 24);
}

__device__ __forceinline__ float clip_diff(float v, float lower,
                                           float upper) {
  return fminf(fmaxf(v, lower), upper);
}

// lambda_j = sum_{i >= j} u_i with lambda_{D-1} = 0 (ascending, max 0).
template <int D>
__device__ __forceinline__ void lam_of_u(const float (&u)[D > 1 ? D - 1 : 1],
                                         float (&lam)[D]) {
  float acc = 0.f;
  lam[D - 1] = 0.f;
#pragma unroll
  for (int j = D - 2; j >= 0; --j) {
    acc += u[j];
    lam[j] = acc;
  }
}

// grad log Z at the ascending nodes lam (each <= 0) into g (every lane of
// the group receives all D entries); returns dd = exp[lam_1..lam_D]
// (floored at FLT_MIN). ex: the group's 256-float exchange scratch.
template <int D>
__device__ float bingham_cascade(const float (&lam)[D], float (&g)[D],
                                 float* ex) {
  const unsigned mask = group_mask();
  const int lane = threadIdx.x & 31;
  const int base = lane & ~7;
  const int i = lane & 7;  // the row this lane owns
  const bool owns = i < D;
  const float cs = 1.f / 32768.f;
  float t[D], tx[D], e[D], x[D];
  // Taylor init: term_1 = A = cs J (row i: cs lam_i at i, cs at i + 1);
  // E = I + A; the Frechet part starts as cs e_{D-1} e_0^T
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const float a = (j == i) ? cs * lam[j] : (j == i + 1 ? cs : 0.f);
    t[j] = owns ? a : 0.f;
    e[j] = owns ? ((j == i ? 1.f : 0.f) + a) : 0.f;
    tx[j] = (i == D - 1 && j == 0) ? cs : 0.f;
    x[j] = tx[j];
  }
#pragma unroll
  for (int k = 2; k <= kTaylorTerms; ++k) {
    const float csk = float(1.0 / 32768.0 / k);
    const float t_last = t[D - 1];
    // M A = cs (M * lam_cols + shift(M)): new column j from old j, j - 1
#pragma unroll
    for (int j = D - 1; j >= 0; --j) {
      const float xn = ((j == 0 ? t_last : 0.f) + tx[j] * lam[j] +
                        (j > 0 ? tx[j - 1] : 0.f)) * csk;
      const float tn = (t[j] * lam[j] + (j > 0 ? t[j - 1] : 0.f)) * csk;
      tx[j] = xn;
      t[j] = tn;
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      e[j] += t[j];
      x[j] += tx[j];
    }
  }
  // squarings: (E, X) <- (E E, E X + X E); E stays upper triangular
#pragma unroll 1
  for (int s = 0; s < kSquarings; ++s) {
    float* bufE = ex + (s & 1) * (2 * kRowStride * kRowStride);
    float* bufX = bufE + kRowStride * kRowStride;
    if (owns) {
#pragma unroll
      for (int j = 0; j < D; ++j) {
        bufE[i * kRowStride + j] = e[j];
        bufX[i * kRowStride + j] = x[j];
      }
    }
    __syncwarp(mask);
    float ne[D], nx[D];
#pragma unroll
    for (int j = 0; j < D; ++j) ne[j] = nx[j] = 0.f;
#pragma unroll
    for (int m = 0; m < D; ++m) {
      float er[D], xr[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        er[j] = bufE[m * kRowStride + j];
        xr[j] = bufX[m * kRowStride + j];
      }
      const float wm = (m >= i) ? e[m] : 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        ne[j] += wm * er[j];
        nx[j] += wm * xr[j];
        nx[j] += x[m] * er[j];
      }
    }
#pragma unroll
    for (int j = 0; j < D; ++j) {
      e[j] = owns ? ne[j] : 0.f;
      x[j] = owns ? nx[j] : 0.f;
    }
  }
  float x_diag = 0.f;
#pragma unroll
  for (int j = 0; j < D; ++j)
    if (j == i) x_diag = x[j];
  const float dd = fmaxf(__shfl_sync(mask, e[D - 1], base), FLT_MIN);
  const float inv_dd = 1.f / dd;
#pragma unroll
  for (int j = 0; j < D; ++j)
    g[j] = __shfl_sync(mask, x_diag, base + j) * inv_dd;
  return dd;
}

// One chord round on u (diffs, in place) for the sorted moments s: the
// residual and D-1 finite-difference cascades (relative step
// fd_step * max(1, |u|); a column whose clipped step is below 1% of the
// intended one is zeroed), the inverse of J^T J (1 + 1e-5) + 1e-20 by an
// unrolled Cholesky (first lane of the group), then `iterations` steps
// u <- clip(u - clip(Minv J^T (g(u) - s), +-1e3)). scratch: the group's
// kGroupFloats floats.
template <int D>
__device__ void bingham_chord_round(const float (&s)[D],
                                    float (&u)[D > 1 ? D - 1 : 1],
                                    int iterations, float lower, float upper,
                                    float fd_step, float* scratch) {
  constexpr int D1 = D - 1;
  const unsigned mask = group_mask();
  const bool leader = (threadIdx.x & 7) == 0;
  float* Jm = scratch;                             // D1 rows of D
  float* Mi = scratch + kRowStride * kRowStride;   // D1 rows of D1
  float* ex = scratch + 2 * kRowStride * kRowStride;
  float lam[D], g0[D], g[D];

  lam_of_u<D>(u, lam);
  bingham_cascade<D>(lam, g0, ex);
#pragma unroll 1
  for (int c = 0; c < D1; ++c) {
    float us[D1];
    float h = 0.f, h_int = 0.f;
#pragma unroll
    for (int j = 0; j < D1; ++j) {
      const float shift = (j == c) ? fd_step * fmaxf(1.f, fabsf(u[j])) : 0.f;
      us[j] = clip_diff(u[j] + shift, lower, upper);
      h += us[j] - u[j];
      h_int += shift;
    }
    lam_of_u<D>(us, lam);
    bingham_cascade<D>(lam, g, ex);
    const bool dead = fabsf(h) < 0.01f * fabsf(h_int);
    const float inv_h = dead ? 0.f : 1.f / h;
    if (leader) {
#pragma unroll
      for (int d = 0; d < D; ++d)
        Jm[c * kRowStride + d] = (g[d] - g0[d]) * inv_h;
    }
  }
  __syncwarp(mask);
  if (leader) {
    float L[D1][D1];
#pragma unroll
    for (int a = 0; a < D1; ++a) {
#pragma unroll
      for (int b = a; b < D1; ++b) {
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d)
          acc += Jm[a * kRowStride + d] * Jm[b * kRowStride + d];
        if (b == a) acc = acc * (1.f + 1e-5f) + 1e-20f;
        L[b][a] = acc;  // J^T J, lower triangle
      }
    }
#pragma unroll
    for (int a = 0; a < D1; ++a) {
      float acc = L[a][a];
#pragma unroll
      for (int k = 0; k < a; ++k) acc -= L[a][k] * L[a][k];
      const float inv_diag = rsqrtf(fmaxf(acc, FLT_MIN));
      L[a][a] = 1.f / inv_diag;
#pragma unroll
      for (int b = a + 1; b < D1; ++b) {
        float acc2 = L[b][a];
#pragma unroll
        for (int k = 0; k < a; ++k) acc2 -= L[b][k] * L[a][k];
        L[b][a] = acc2 * inv_diag;
      }
    }
#pragma unroll
    for (int col = 0; col < D1; ++col) {
      float y[D1], xs[D1];
#pragma unroll
      for (int a = 0; a < D1; ++a) {
        float acc = (a == col) ? 1.f : 0.f;
#pragma unroll
        for (int k = 0; k < a; ++k) acc -= L[a][k] * y[k];
        y[a] = acc / L[a][a];
      }
#pragma unroll
      for (int a = D1 - 1; a >= 0; --a) {
        float acc = y[a];
#pragma unroll
        for (int k = a + 1; k < D1; ++k) acc -= L[k][a] * xs[k];
        xs[a] = acc / L[a][a];
      }
#pragma unroll
      for (int a = 0; a < D1; ++a) Mi[a * kRowStride + col] = xs[a];
    }
  }
  __syncwarp(mask);
#pragma unroll 1
  for (int it = 0; it < iterations; ++it) {
    lam_of_u<D>(u, lam);
    bingham_cascade<D>(lam, g, ex);
    float r[D], b[D1];
#pragma unroll
    for (int d = 0; d < D; ++d) r[d] = g[d] - s[d];
#pragma unroll
    for (int a = 0; a < D1; ++a) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc += Jm[a * kRowStride + d] * r[d];
      b[a] = acc;
    }
#pragma unroll
    for (int a = 0; a < D1; ++a) {
      float delta = 0.f;
#pragma unroll
      for (int k = 0; k < D1; ++k) delta += Mi[a * kRowStride + k] * b[k];
      delta = fminf(fmaxf(delta, -1e3f), 1e3f);
      u[a] = clip_diff(u[a] - delta, lower, upper);
    }
  }
}

// The Bingham E-step of one frame: for each class k the log-density
// y^H B_k y - logz_k (B_k = V diag(lambda) V^H, Hermitian D x D, 2 Re over
// the upper triangle), the max-shift softmax with the linear weights wgt,
// max(den, tiny) and the clip to [eps, 1 - eps] when eps != 0. `y(d)`
// gives the frame's entry d. Writes the posterior to aff[k * ld] (which
// doubles as scratch for the log-densities).
template <class Y>
__device__ __forceinline__ void bingham_e_step_frame(
    Y y, const float2* Bm, const float* logz, const float* wgt, float eps,
    float* aff, int ld, int D, int K) {
  const int DD = D * D;
  float mx = -INFINITY;
  for (int k = 0; k < K; ++k) {
    const float2* Bk = Bm + k * DD;
    float q = 0.f;
    for (int d = 0; d < D; ++d) {
      const float2 yd = y(d);
      q += Bk[d * D + d].x * (yd.x * yd.x + yd.y * yd.y);
      for (int e = d + 1; e < D; ++e) {
        const float2 p = c_mul_conj(yd, y(e));
        q += 2.f * (Bk[d * D + e].x * p.x + Bk[d * D + e].y * p.y);
      }
    }
    const float lp = q - logz[k];
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
  for (int k = 0; k < K; ++k) {
    float a = aff[k * ld] / den;
    if (eps != 0.f) a = fminf(fmaxf(a, eps), 1.f - eps);
    aff[k * ld] = a;
  }
}

// B = V diag(lam) V^H of one class (V row-major, eigenvectors in columns),
// by one warp: lane owns entries de = lane, lane + 32, ...
__device__ __forceinline__ void warp_bingham_form(const float2* V,
                                                  const float* lam,
                                                  float2* Bm, int D) {
  const int lane = threadIdx.x & 31;
  for (int de = lane; de < D * D; de += 32) {
    const int d = de / D;
    const int e = de % D;
    float2 acc = make_float2(0.f, 0.f);
    for (int i = 0; i < D; ++i)
      acc = c_add(acc, c_scale(lam[i], c_mul_conj(V[d * D + i],
                                                  V[e * D + i])));
    Bm[de] = acc;
  }
}
