// The complex Bingham pieces shared by the chord-solve kernel (bingham.cu),
// the whole-fit Bingham EM (cbmm_loop.cu) and the Bingham family of the
// streamed statistics (mm_stream.cu): the block-Frechet divided-difference
// cascade on one thread, the inverse normal matrix of a chord round, and
// the E-step of one frame.
//
// Replaces pb_bss_tpu/ops/pallas_bingham.py (_grad_cascade, _lam_of_u,
// _chord_round), whose problems lay in the TPU's lanes with the cascade
// state in VMEM planes. Here the cascade's state lives in one thread's
// registers (chord_cascade<D>): E's upper triangle and X, 21 + 36 floats at
// D=6, 36 + 64 at D=8. It needs neither shared memory nor shuffles, so it
// has no bank conflicts; what bounds it is the latency of its ~6 k fp32
// instructions a cascade at D=6, issued by the few warps that carry a
// problem's serial chain.
#pragma once

#include <cfloat>
#include <cmath>
#include <cuda_runtime.h>

#include "jacobi.cuh"

constexpr int kSquarings = 15;    // exact domain |lambda| <= 2^15
constexpr int kTaylorTerms = 13;

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

// grad log Z at the ascending nodes lam (each <= 0) into g; returns dd =
// exp[lam_1..lam_D] (floored at FLT_MIN). expm of the doubled-node
// bidiagonal [[J, C], [0, J]] as [[E, X], [0, E]]: 13 Taylor terms at the
// scaling 2^-15 (a shift-and-scale of each row, T <- T J / k and TX <- (T
// e_{D-1} e_0^T + TX J) / k), then 15 squarings (E, X) <- (E E, E X + X E);
// g_i = X[i][i] / E[0][D-1].
//
// One thread runs the whole cascade. Every row index is known where the
// code is compiled, so the thread skips every entry known to be zero (T_k =
// J^k / k! has bandwidth k, TX_k fills the corner (D - 1 - i) + j <= k - 1,
// E is upper triangular) and squares in place: X's new rows first,
// ascending, each from X's old rows >= i and the old E, then E's, each from
// E's old rows >= i, a temporary row at a time. Every entry's sum runs over
// m ascending, E's product before X's, as the first port's row-per-lane
// cascade summed it; a product with an exact zero leaves a sum as it is, so
// the values are that cascade's as far as FMA contraction allows.
template <int D>
__device__ __forceinline__ float chord_cascade(const float (&lam)[D],
                                               float (&g)[D]) {
  const float cs = 1.f / 32768.f;
  float e[D][D], x[D][D];
  // Taylor: each row on its own (the terms of one row need no other row)
#pragma unroll
  for (int i = 0; i < D; ++i) {
    float t[D], tx[D];
    // term_1 = A = cs J (row i: cs lam_i at i, cs at i + 1); E = I + A; the
    // Frechet part starts as cs e_{D-1} e_0^T
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const float a = (j == i) ? cs * lam[j] : (j == i + 1 ? cs : 0.f);
      t[j] = a;
      e[i][j] = (j == i ? 1.f : 0.f) + a;
      tx[j] = (i == D - 1 && j == 0) ? cs : 0.f;
      x[i][j] = tx[j];
    }
#pragma unroll
    for (int k = 2; k <= kTaylorTerms; ++k) {
      const float csk = float(1.0 / 32768.0 / k);
      const float t_last = t[D - 1];
      // M A = cs (M * lam_cols + shift(M)): new column j from old j, j - 1
#pragma unroll
      for (int j = D - 1; j >= 0; --j) {
        if ((D - 1 - i) + j <= k - 1)
          tx[j] = ((j == 0 ? t_last : 0.f) + tx[j] * lam[j] +
                   (j > 0 ? tx[j - 1] : 0.f)) * csk;
        if (j >= i && j <= i + k)
          t[j] = (t[j] * lam[j] + (j > 0 ? t[j - 1] : 0.f)) * csk;
      }
#pragma unroll
      for (int j = 0; j < D; ++j) {
        if (j >= i && j <= i + k) e[i][j] += t[j];
        if ((D - 1 - i) + j <= k - 1) x[i][j] += tx[j];
      }
    }
  }
  // squarings
#pragma unroll 1
  for (int q = 0; q < kSquarings; ++q) {
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float row[D];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int m = 0; m < D; ++m) {
          if (m >= i) acc = fmaf(e[i][m], x[m][j], acc);
          if (m <= j) acc = fmaf(x[i][m], e[m][j], acc);
        }
        row[j] = acc;
      }
#pragma unroll
      for (int j = 0; j < D; ++j) x[i][j] = row[j];
    }
#pragma unroll
    for (int i = 0; i < D; ++i) {
      float row[D];
#pragma unroll
      for (int j = i; j < D; ++j) {
        float acc = 0.f;
#pragma unroll
        for (int m = i; m <= j; ++m) acc = fmaf(e[i][m], e[m][j], acc);
        row[j] = acc;
      }
#pragma unroll
      for (int j = i; j < D; ++j) e[i][j] = row[j];
    }
  }
  const float dd = fmaxf(e[0][D - 1], FLT_MIN);
  const float inv_dd = 1.f / dd;
#pragma unroll
  for (int j = 0; j < D; ++j) g[j] = x[j][j] * inv_dd;
  return dd;
}

// The inverse of J^T J (1 + 1e-5) + 1e-20 for the Jacobian rows Jm
// (D - 1 rows of D, stride 8) into Mi (D - 1 rows of D - 1, stride 8), by
// one thread: an unrolled Cholesky and D - 1 pairs of triangular solves.
template <int D>
__device__ __forceinline__ void normal_inverse(const float* Jm, float* Mi) {
  constexpr int D1 = D - 1;
  float L[D1][D1];
#pragma unroll
  for (int a = 0; a < D1; ++a) {
#pragma unroll
    for (int b = a; b < D1; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) acc += Jm[a * 8 + d] * Jm[b * 8 + d];
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
    for (int a = 0; a < D1; ++a) Mi[a * 8 + col] = xs[a];
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
